"""All 8 variant presets on catch in concurrent mode with AdamW, pixel
observations (frame_size 10, the ``tiny`` net), against the JAX
reference (``torch_presets.check_preset``)."""

import pytest

from torch_presets import PRESETS, check_preset


@pytest.mark.parametrize("variant", PRESETS)
def test_preset_on_catch_pixels_matches_reference(variant):
    check_preset(variant, "pixels")
