"""The port's Table 1 apparatus (``core.host_runner``) against the JAX
package's, on the CPU.

All four variants (standard, concurrent, synchronized, both) at W=4 run
64 timed steps in both packages from the same parameters and seed: the
transaction counts, the replay (every action taken, reward, done and
frame stack) and the cursor must be equal, the parameters within 1e-4.
The reference's own invariants hold: synchronized inference transactions
are steps / W plus the warm-up call, standard ones steps plus it, and
updates steps / F plus it. Terminal transitions store the pre-reset
view, as the port's ``sync_round`` does. ``launch.table1`` runs its 14
cells at a tiny size.
"""

import jax
import numpy as np
import pytest
import torch

from repro.config import DQNConfig as JDQN
from repro.configs.dqn_nature import NatureCNNConfig as JNCfg
from repro.core.host_runner import HostDQNRunner as JRunner
from repro.models.nature_cnn import q_forward as jq_forward
from repro.models.nature_cnn import q_init as jq_init
from repro_torch import rng
from repro_torch.config import DQNConfig
from repro_torch.configs.dqn_nature import NatureCNNConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.host_runner import HostDQNRunner
from repro_torch.core.synchronized import sampler_init, sync_round
from repro_torch.envs.games import get_env
from repro_torch.launch import table1
from repro_torch.models.nature_cnn import q_forward, q_init

FS = 10
STEPS = 64
NET = dict(frame_size=FS, frame_stack=2, convs=((8, 3, 1),), hidden=16,
           n_actions=3)
DQN = dict(minibatch_size=8, replay_capacity=1024, target_update_period=32,
           train_period=4, frame_stack=2)


def _pair(concurrent, synchronized, W, seed=0):
    jn, tn = JNCfg(**NET), NatureCNNConfig(**NET)
    params = jq_init(jn, 3, jax.random.PRNGKey(seed))
    jr = JRunner(lambda p, o: jq_forward(p, o, jn), params,
                 JDQN(n_envs=W, **DQN), concurrent=concurrent,
                 synchronized=synchronized, n_envs=W, frame_size=FS,
                 seed=seed)
    tr = HostDQNRunner(lambda p, o: q_forward(p, o, tn),
                       params_from_jax(jax.device_get(params)),
                       DQNConfig(n_envs=W, **DQN), concurrent=concurrent,
                       synchronized=synchronized, n_envs=W, frame_size=FS,
                       seed=seed, device="cpu")
    return jr, tr


@pytest.mark.parametrize("synchronized", [False, True])
@pytest.mark.parametrize("concurrent", [False, True])
def test_variant_matches_reference(concurrent, synchronized):
    torch.set_num_threads(1)
    jr, tr = _pair(concurrent, synchronized, W=4)
    jres = jr.run(STEPS, prepopulate=64)
    tres = tr.run(STEPS, prepopulate=64)
    assert tres.steps == jres.steps == STEPS and tres.seconds > 0
    assert tres.inference_transactions == jres.inference_transactions
    assert tres.update_transactions == jres.update_transactions
    assert tres.update_transactions == STEPS // 4 + 1
    want_infer = STEPS // 4 + 1 if synchronized else STEPS + 1
    assert tres.inference_transactions == want_infer
    assert (tr.cursor, tr.rsize) == (jr.cursor, jr.rsize) == (128, 128)
    assert not tr.staging and not tr.pending
    for k, v in jr.replay.items():
        np.testing.assert_array_equal(tr.replay[k], v, err_msg=k)
    np.testing.assert_array_equal(tr.stacks, jr.stacks)
    for k, v in jax.device_get(jr.params).items():
        np.testing.assert_allclose(tr.params[k].numpy(), v, atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    for k, v in jax.device_get(jr.target).items():
        np.testing.assert_allclose(tr.target[k].numpy(), v, atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_synchronized_transactions_independent_of_w():
    per_w = {}
    for W in (2, 8):
        _, tr = _pair(concurrent=False, synchronized=True, W=W)
        per_w[W] = tr.run(STEPS, prepopulate=32).inference_transactions
    assert per_w == {2: STEPS // 2 + 1, 8: STEPS // 8 + 1}


def _pre_reset_view_holds(obs, next_obs):
    """next_obs is the terminal frame pushed onto the un-zeroed history:
    all but its newest channel equal all but the oldest of obs."""
    np.testing.assert_array_equal(next_obs[..., :-1], obs[..., 1:])


def test_terminal_transition_parity_host_vs_sync_round():
    """The host runner and the port's sync_round agree on what a terminal
    transition's next_obs is: the pre-reset view, never a stack zeroed
    before the store."""
    torch.set_num_threads(1)
    _, tr = _pair(concurrent=False, synchronized=True, W=4)
    tr.run(STEPS, prepopulate=64)
    done = tr.replay["done"][:tr.rsize]
    assert done.any(), "no terminal transition observed"
    h_obs = tr.replay["obs"][:tr.rsize][done]
    _pre_reset_view_holds(h_obs, tr.replay["next_obs"][:tr.rsize][done])
    # catch episodes run 9 steps, so the 2-deep history is populated at
    # the terminal: a zeroed-stack store would differ
    assert h_obs[..., 1:].any()

    spec = get_env("catch")
    tn = NatureCNNConfig(**NET)
    params = q_init(tn, 3, rng.PRNGKey(0))
    s = sampler_init(spec, DQNConfig(n_envs=4, **DQN), rng.PRNGKey(1), FS)
    staged = []
    with torch.no_grad():
        for _ in range(12):                  # > one catch episode
            s, t = sync_round(spec, lambda p, o: q_forward(p, o, tn), params,
                              s, torch.full((), 0.5), FS)
            staged.append({k: v.numpy() for k, v in t.items()})
    done = np.concatenate([t["done"] for t in staged])
    assert done.any()
    j_obs = np.concatenate([t["obs"] for t in staged])[done]
    _pre_reset_view_holds(
        j_obs, np.concatenate([t["next_obs"] for t in staged])[done])
    assert j_obs[..., 1:].any()


def test_table1_runs_every_cell():
    """The 14 cells at 10x10 and 64 steps on the CPU: the "—" cells
    skipped, Standard-1 the 100% row, the transaction counts exact."""
    torch.set_num_threads(1)
    rows = table1.run_table1(steps=64, frame_size=10, device="cpu",
                             prepopulate=32)
    assert len(rows) == 14
    cells = {(r["variant"], r["threads"]) for r in rows}
    assert ("synchronized", 1) not in cells and ("both", 1) not in cells
    base = rows[0]
    assert (base["variant"], base["threads"]) == ("standard", 1)
    assert base["pct_of_std1"] == 100.0 and base["speedup"] == 1.0
    for r in rows:
        sync = r["variant"] in ("synchronized", "both")
        assert r["infer_tx"] == (64 // r["threads"] if sync else 64) + 1
        assert r["update_tx"] == 64 // 4 + 1
    text = table1.format_tables(rows)
    assert text.count("—") == 2
