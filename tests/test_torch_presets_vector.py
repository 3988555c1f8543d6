"""All 8 variant presets on catch in concurrent mode with AdamW, vector
observations (the ``mlp_tiny`` net on stacked state vectors), against
the JAX reference (``torch_presets.check_preset``)."""

import pytest

from torch_presets import PRESETS, check_preset


@pytest.mark.parametrize("variant", PRESETS)
def test_preset_on_catch_vector_matches_reference(variant):
    check_preset(variant, "vector")
