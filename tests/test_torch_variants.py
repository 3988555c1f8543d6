"""Every variant preset's cycle against the JAX reference.

``tests/test_torch_cycle.py`` holds rainbow (all six toggles at once) and
dqn over two cycles; here each of the other presets (one toggle, or
rainbow_lite's four) runs one cycle from a carry carried over from JAX,
at the same small size: pong at frame_size 10, the ``tiny`` net, W=4,
C=32, a 256-slot replay, minibatch 8, prepopulate 64. Integer state
must match exactly, floats to 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from repro.api import build_trainer
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.configs.dqn_nature import get_variant as jax_variant
from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
from repro_torch.api.trainers import ConcurrentTrainer
from repro_torch.configs.dqn_nature import get_variant
from repro_torch.convert import carry_from_jax

FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
SCHED = dict(cycles=2, cycle_steps=32, prepopulate=64)
ALGO = dict(minibatch_size=8, replay_capacity=256, optimizer="rmsprop")
TOP = dict(env="pong", mode="concurrent", envs=4, frame_size=10, net="tiny")


def _leaves(carry, prefix=""):
    if isinstance(carry, dict):
        for k, v in carry.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(carry, tuple) and hasattr(carry, "_fields"):
        for k, v in zip(carry._fields, carry):
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, carry


@pytest.mark.parametrize("variant", ["double", "dueling", "per", "c51",
                                     "noisy", "rainbow_lite"])
def test_variant_cycle_matches_reference(variant):
    torch.set_num_threads(1)
    jt = build_trainer(JSpec(variant=jax_variant(variant),
                             schedule=JSched(**SCHED), algo=JAlgo(**ALGO),
                             **TOP))
    j0 = jt.init_carry()
    j1, jm = jt.cycle(j0)
    j0, j1, jm = jax.device_get((j0, j1, jm))
    tt = ConcurrentTrainer(ExperimentSpec(variant=get_variant(variant),
                                          schedule=ScheduleSpec(**SCHED),
                                          algo=AlgoSpec(**ALGO), **TOP),
                           device="cpu")
    t1, tm = tt.cycle(carry_from_jax(j0))
    np.testing.assert_allclose(float(tm["loss"][0]), float(jm["loss"][0]),
                               **FLOAT_TOL)
    got = dict(_leaves(t1))
    want = dict(_leaves(j1))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = got[path].numpy(), np.asarray(w)
        assert g.shape == w.shape, path
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=path, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)
