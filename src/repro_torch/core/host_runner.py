"""The wall-clock host runner, the Table 1 apparatus: the port of
``repro.core.host_runner``.

Environments step in host Python and NumPy (the paper's CPU side);
Q-inference and updates run on the card (the paper's GPU side). In the
reference JAX's asynchronous dispatch plays the trainer thread; here the
trainer thread is a CUDA stream:

  standard      per-env inference transactions; every F steps one update
                whose result the policy waits for (θ acts); one stream;
  concurrent    θ⁻ acts, from a copy on the sampler's stream, so updates
                are queued on a trainer stream of their own and only
                awaited at the C boundary; inference does not queue
                behind them; staged experiences flush to 𝒟 there;
  synchronized  the W envs' stacks go to ONE batched inference call per
                round (transactions ∝ 1/W);
  both          all of the above: Algorithm 1.

Every variant shares the same update and inference functions, replay
and env code. The runner counts device transactions (``n_infer``,
``n_update``) exactly as the reference does: one per inference call and
per update, the untimed warm-up call of each included. The streams
change timing only: the same seed gives the same actions, replay
contents and parameters. On the CPU everything runs in order on the
host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.config import DQNConfig
from repro_torch.core.dqn import make_update_fn
from repro_torch.envs.host_envs import HostCatch
from repro_torch.optim.rmsprop import centered_rmsprop
from repro_torch.runtime import configure


@dataclasses.dataclass
class RunResult:
    seconds: float
    steps: int
    inference_transactions: int
    update_transactions: int

    @property
    def steps_per_second(self) -> float:
        return self.steps / max(self.seconds, 1e-9)


class HostDQNRunner:
    """One ablation variant. ``q_forward(params, obs)`` takes
    (B, size, size, stack) uint8 observations on ``device``;
    ``init_params`` are copied to ``device``."""

    def __init__(self, q_forward: Callable,
                 init_params: Dict[str, torch.Tensor],
                 cfg: DQNConfig, *, concurrent: bool, synchronized: bool,
                 n_envs: int, frame_size: int = 84, seed: int = 0,
                 device: str = "cuda"):
        self.device = configure(device)
        self.cfg = cfg
        self.concurrent = concurrent
        self.synchronized = synchronized
        self.W = n_envs
        self.size = frame_size
        self.envs = [HostCatch(seed * 1000 + j) for j in range(n_envs)]
        self.stacks = np.zeros((n_envs, frame_size, frame_size,
                                cfg.frame_stack), np.uint8)
        for j, e in enumerate(self.envs):
            self._push(j, self._frame(e))
        self.rng = np.random.RandomState(seed)

        # the sampler's stream, and (concurrent variants) the trainer's
        cuda = self.device.type == "cuda"
        self.sampler_stream = torch.cuda.Stream(self.device) if cuda else None
        self.trainer_stream = (torch.cuda.Stream(self.device)
                               if cuda and concurrent else self.sampler_stream)
        with self._on(self.sampler_stream):
            self.params = {k: v.to(self.device, copy=True)
                           for k, v in init_params.items()}
            self.target = {k: v.clone() for k, v in self.params.items()}
            opt = centered_rmsprop(cfg.learning_rate, cfg.rmsprop_decay,
                                   cfg.rmsprop_eps, cfg.rmsprop_centered)
            self.opt_state = opt.init(self.params)
        if cuda:
            torch.cuda.synchronize(self.device)
        self._update = make_update_fn(q_forward, opt, cfg)

        def infer(p, o):
            with torch.no_grad():
                return torch.argmax(q_forward(p, o), dim=-1)
        self._infer = infer

        cap = cfg.replay_capacity
        shape = (cap, frame_size, frame_size, cfg.frame_stack)
        self.replay = {
            "obs": np.zeros(shape, np.uint8),
            "action": np.zeros((cap,), np.int32),
            "reward": np.zeros((cap,), np.float32),
            "next_obs": np.zeros(shape, np.uint8),
            "done": np.zeros((cap,), np.bool_),
        }
        self.cursor = 0
        self.rsize = 0
        self.staging = []
        self.pending = []          # dispatched, not yet awaited: their batches
        self.n_infer = 0
        self.n_update = 0

    # ------------------------------------------------------------------
    def _on(self, stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    def _wait_trainer(self):
        """The host waits for every queued update."""
        if self.trainer_stream is not None:
            self.trainer_stream.synchronize()

    def _frame(self, env: HostCatch) -> np.ndarray:
        if self.size == 84:
            return env.gray84()
        w = np.linspace(1.0, 0.4, env.channels)
        return (np.clip(env.render() @ w, 0, 1) * 255).astype(np.uint8)

    def _push(self, j: int, frame: np.ndarray):
        self.stacks[j, :, :, :-1] = self.stacks[j, :, :, 1:]
        self.stacks[j, :, :, -1] = frame

    def _replay_add(self, tr):
        i = self.cursor % self.cfg.replay_capacity
        for k, v in tr.items():
            self.replay[k][i] = v
        self.cursor += 1
        self.rsize = min(self.rsize + 1, self.cfg.replay_capacity)

    def _sample_batch(self) -> Dict[str, np.ndarray]:
        idx = self.rng.randint(0, max(self.rsize, 1), self.cfg.minibatch_size)
        return {k: v[idx] for k, v in self.replay.items()}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the card. From pageable memory the copy waits
        for the current stream, which the sampler's calls want."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def _act(self, eps: float, js) -> np.ndarray:
        """ε-greedy actions for env indices js. Synchronized variants make
        one batched device call; standard ones one call per env."""
        acting_params = self.target if self.concurrent else self.params
        with self._on(self.sampler_stream):
            if self.synchronized:
                greedy = self._infer(acting_params,
                                     self._to_device(self.stacks[js]))
                greedy = greedy.cpu().numpy()
                self.n_infer += 1
            else:
                greedy = np.empty(len(js), np.int32)
                for n, j in enumerate(js):
                    q = self._infer(acting_params,
                                    self._to_device(self.stacks[j][None]))
                    greedy[n] = int(q[0])
                    self.n_infer += 1
        rand = self.rng.randint(0, self.envs[0].n_actions, len(js))
        explore = self.rng.rand(len(js)) < eps
        return np.where(explore, rand, greedy).astype(np.int32)

    def _env_step(self, j: int, action: int):
        obs = self.stacks[j].copy()
        _, reward, done = self.envs[j].step(int(action))
        frame = self._frame(self.envs[j])
        # the stored next_obs is the pre-reset view (the new frame pushed
        # onto the un-zeroed history), as sync_round stores it; only the
        # live stack restarts from a zeroed history on terminals
        next_obs = np.concatenate([self.stacks[j][:, :, 1:],
                                   frame[:, :, None]], axis=-1)
        if done:
            self.stacks[j][:] = 0
        self._push(j, frame)
        tr = {"obs": obs, "action": action, "reward": reward,
              "next_obs": next_obs, "done": done}
        if self.concurrent:
            self.staging.append(tr)      # flushed at the C boundary
        else:
            self._replay_add(tr)

    def _dispatch_update(self, block: bool):
        host = self._sample_batch()
        with self._on(self.trainer_stream):
            if self.device.type == "cuda":
                # pinned, so the copy queues on the trainer's stream and
                # the host goes on
                batch = {k: torch.from_numpy(v).pin_memory().to(
                    self.device, non_blocking=True) for k, v in host.items()}
            else:
                batch = {k: torch.from_numpy(v) for k, v in host.items()}
            self.params, self.opt_state, _, _ = self._update(
                self.params, self.target, self.opt_state, batch)
        self.n_update += 1
        if block:
            self._wait_trainer()                # the sequential lock
        else:
            self.pending.append(batch)          # the trainer thread's queue

    def _sync_boundary(self):
        """θ⁻ ← θ: wait for the trainer, flush the staging, copy θ on the
        sampler's stream (which the trainer's then waits for)."""
        self._wait_trainer()
        self.pending.clear()
        for tr in self.staging:
            self._replay_add(tr)
        self.staging.clear()
        with self._on(self.sampler_stream):
            self.target = {k: v.clone() for k, v in self.params.items()}
        if self.trainer_stream is not None:
            self.trainer_stream.wait_stream(self.sampler_stream)

    # ------------------------------------------------------------------
    def run(self, total_steps: int, eps: float = 0.1,
            prepopulate: int = 256) -> RunResult:
        # prepopulate with random actions (not timed)
        for t in range(prepopulate):
            j = t % self.W
            a = self.rng.randint(0, self.envs[j].n_actions)
            self._env_step(j, a)
        if self.concurrent:
            for tr in self.staging:
                self._replay_add(tr)
            self.staging.clear()
        # warm up (not timed; counted, as in the reference)
        self._act(eps, list(range(self.W)) if self.synchronized else [0])
        self._dispatch_update(block=True)

        t0 = time.perf_counter()
        t = 0
        while t < total_steps:
            if self.synchronized:
                js = list(range(self.W))
                actions = self._act(eps, js)
                for j, a in zip(js, actions):
                    self._env_step(j, a)
                    t += 1
                    self._maybe_train(t)
            else:
                j = t % self.W
                a = self._act(eps, [j])[0]
                self._env_step(j, a)
                t += 1
                self._maybe_train(t)
        self._wait_trainer()
        dt = time.perf_counter() - t0
        self.pending.clear()
        return RunResult(dt, total_steps, self.n_infer, self.n_update)

    def _maybe_train(self, t: int):
        cfg = self.cfg
        if t % cfg.train_period == 0:
            self._dispatch_update(block=not self.concurrent)
        if t % cfg.target_update_period == 0:
            if self.concurrent:
                self._sync_boundary()
            else:
                with self._on(self.sampler_stream):
                    self.target = {k: v.clone()
                                   for k, v in self.params.items()}
