"""The preset check shared by ``test_torch_presets_pixels.py`` and
``test_torch_presets_vector.py`` (two files, so the 16 cases spread over
the test workers).

A preset's concurrent cycle on catch with AdamW, at
``test_torch_variants.py``'s sizes (W=4, C=32, a 256-slot replay,
minibatch 8, prepopulate 64): one cycle of the port from a carry
carried over from JAX against the JAX cycle, integers exactly, floats
to 1e-4.
"""

import jax
import numpy as np
import torch

from repro.api import build_trainer as jbuild
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.configs.dqn_nature import get_variant as jvariant
from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
from repro_torch.api.trainers import build_trainer
from repro_torch.configs.dqn_nature import VARIANTS, get_variant
from repro_torch.convert import carry_from_jax

PRESETS = sorted(VARIANTS)
FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
SCHED = dict(cycles=2, cycle_steps=32, prepopulate=64)
ALGO = dict(minibatch_size=8, replay_capacity=256, optimizer="adamw")
OBS = {"pixels": dict(obs_mode="pixels", frame_size=10, net="tiny"),
       "vector": dict(obs_mode="vector", net="mlp_tiny")}


def _leaves(carry, prefix=""):
    if isinstance(carry, dict):
        for k, v in carry.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(carry, tuple) and hasattr(carry, "_fields"):
        for k, v in zip(carry._fields, carry):
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, carry


def check_preset(variant: str, obs: str) -> None:
    torch.set_num_threads(1)
    top = dict(env="catch", mode="concurrent", envs=4, **OBS[obs])
    jt = jbuild(JSpec(variant=jvariant(variant), schedule=JSched(**SCHED),
                      algo=JAlgo(**ALGO), **top))
    j0 = jt.init_carry()
    j1, jm = jt.cycle(j0)
    j0, j1, jm = jax.device_get((j0, j1, jm))
    tt = build_trainer(ExperimentSpec(variant=get_variant(variant),
                                      schedule=ScheduleSpec(**SCHED),
                                      algo=AlgoSpec(**ALGO), **top),
                       device="cpu")
    t1, tm = tt.cycle(carry_from_jax(j0))
    np.testing.assert_allclose(float(tm["loss"][0]), float(jm["loss"][0]),
                               **FLOAT_TOL)
    for k in ("reward", "episodes"):
        assert float(tm[k][0]) == float(jm[k][0]), k
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
