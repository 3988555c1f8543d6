"""In-process simulated clients for the policy server: the port of
``repro.api.policy_client``.

Many concurrent "players" over the port's batched envs
(``envs/games.py``), on a chosen device: each tick every client sends
its RAW current observation (a pixel frame or a state vector, per the
spec's ``obs_mode``) to a :class:`repro_torch.api.serve.PolicyServer`,
the server answers with dynamically microbatched actions, and the
clients step their envs with them (autoreset: the ``first`` flags tell
the server to zero a stream's frame stack exactly when the sampler
would). The fleet is one batched env over n streams, so a thousand
clients cost one env step per tick. Used by ``launch/serve_policy.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import rng
from repro_torch.api.spec import ExperimentSpec
from repro_torch.envs.games import make_env, step_autoreset
from repro_torch.envs.preprocess import obs_batch, pixel_obs, vector_obs

__all__ = ["SimulatedClients", "drive"]


class SimulatedClients:
    """n concurrent simulated players of one spec's env and obs mode,
    their env states on ``device``."""

    def __init__(self, spec: ExperimentSpec, n: int, seed: int = 0,
                 device="cuda"):
        if n < 1:
            raise ValueError(f"need at least one client, got n={n}")
        env = make_env(spec.env, **spec.env_params)
        self.env = env
        self.pipe = (vector_obs(env) if spec.obs_mode == "vector"
                     else pixel_obs(spec.frame_size))
        self.n = n
        self.ids: List[int] = list(range(n))
        keys = rng.split(rng.PRNGKey(seed, device=device))
        self._key = keys[1]
        self.states = env.reset(rng.split(keys[0], n))
        # every stream starts an episode: the first submit carries
        # first=True so the server zeroes its (fresh) stack
        self.first = np.ones((n,), bool)
        self.returns = np.zeros((n,), np.float64)
        self.finished_return_sum = 0.0
        self.episodes = 0

    def observations(self) -> np.ndarray:
        """The raw per-stream observations clients send this tick:
        (n, *obs_shape) in the pipe's dtype."""
        return obs_batch(self.pipe, self.env, self.states).cpu().numpy()

    def step(self, actions: np.ndarray) -> None:
        """Advance every stream with its served action (autoreset)."""
        ks = rng.split(self._key)
        self._key = ks[0]
        dev = self._key.device
        a = torch.from_numpy(np.asarray(actions, np.int32)).to(dev)
        self.states, rewards, dones = step_autoreset(
            self.env, self.states, a, rng.split(ks[1], self.n))
        # one copy to the host for both
        host = torch.stack([rewards.to(torch.float64),
                            dones.to(torch.float64)]).cpu().numpy()
        rewards, dones = host[0], host[1] > 0
        self.returns += rewards
        self.finished_return_sum += float(self.returns[dones].sum())
        self.episodes += int(dones.sum())
        self.returns[dones] = 0.0
        self.first = dones      # next obs is the reset state's first frame

    def mean_return(self) -> float:
        """Mean return over finished episodes (0.0 before any finish)."""
        return (self.finished_return_sum / self.episodes
                if self.episodes else 0.0)


def drive(server, clients: SimulatedClients, ticks: int) -> Dict:
    """Run the closed loop for ``ticks`` server ticks and return the
    sustained-load statistics.

    Per tick: every client submits its raw observation, the server
    drains the queue as microbatches (one Q call per bucket-padded
    chunk), and the clients step with the returned actions. Latency is
    per request: submit to action on the host."""
    server.drain_latencies()
    mb0 = server.microbatches
    t0 = time.perf_counter()
    for _ in range(ticks):
        obs = clients.observations()
        server.submit_many(clients.ids, obs, clients.first)
        acts = server.flush()
        actions = np.fromiter((acts[i] for i in clients.ids),
                              np.int32, count=clients.n)
        clients.step(actions)
    wall = time.perf_counter() - t0
    lat = np.asarray(server.drain_latencies())
    n_actions = ticks * clients.n
    return {
        "clients": clients.n,
        "ticks": ticks,
        "actions": n_actions,
        "wall_s": wall,
        "actions_per_s": n_actions / wall,
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "microbatches_per_tick": (server.microbatches - mb0) / ticks,
        "episodes": clients.episodes,
        "mean_return": clients.mean_return(),
    }
