"""Policy serving, the port of ``repro.api.serve``: a server is a spec
plus a carry.

    loaded = load_policy(ckpt_dir)              # spec.json + the newest
                                                # restorable step_*.npz
    server = make_server(loaded, ServeSpec(policy="egreedy"))
    server.warm_start(n_streams=1024)           # run every bucket once
    ...
    server.submit(stream_id, raw_obs, first=episode_started)
    actions = server.flush()                    # ONE batched Q call

Observations from clients arriving within a tick are stacked into one
``q_forward`` call (dynamic microbatching), padded up to a fixed set of
bucket sizes, so the shapes the card sees stay fixed per bucket;
``warm_start`` runs every bucket once (cuDNN's choice per shape).

Clients send RAW observations (a rendered uint8 frame or a state
vector); each stream's frame-stack history lives on the server's
device, updated by the sampler's ``push_frame`` and zero-on-episode-
start rule. Actions come from :func:`repro_torch.core.policy.policy_step`,
the primitive inside ``evaluate``, with per-stream keys, so a served
action equals evaluation's choice for the same (params, stack, key), and
neither padding nor batch composition changes the action a stream gets.

The reference pads a microbatch with the out-of-range slot ``cap`` and
lets XLA clamp the gather and drop the scatter. Torch raises on such an
index (on the card as an asynchronous device assert), so here the pad
rows gather a clamped slot and only the real rows are written back: the
padding never touches real stream state.

Policies: ``greedy`` (ε=0 argmax), ``egreedy`` (ε = ``ServeSpec.eps``,
0.05 by default, as evaluation), ``noisy`` (NoisyNet parameter noise
drawn once per tick, ε=0).

Telemetry (``tracer=``, :mod:`repro_torch.telemetry`): each flush is a
``serve.flush`` span; each microbatch records ``serve.queue_wait`` (the
oldest submit to the start of compute: the latency the batching window
adds) and ``serve.compute`` (through the card's completion); the
``serve.actions`` counter counts the actions served.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.api.spec import ExperimentSpec, load_run_spec
from repro_torch.core.policy import policy_step
from repro_torch.core.population import with_replicas
from repro_torch.envs.preprocess import ObsPipeline, push_frame
from repro_torch.telemetry import NullTracer

__all__ = ["POLICIES", "ServeSpec", "PolicyServer", "LoadedPolicy",
           "load_policy", "make_server"]

POLICIES = ("greedy", "egreedy", "noisy")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The serving-side knobs (the experiment side is the
    :class:`ExperimentSpec`: a server is that spec plus a carry)."""

    policy: str = "egreedy"   # one of POLICIES
    eps: float = 0.05         # exploration rate for policy="egreedy"
    max_batch: int = 1024     # microbatch ceiling per Q call
    # bucket sizes a microbatch is padded up to; () derives powers of two
    # up to max_batch
    buckets: Tuple[int, ...] = ()
    replica: int = 0          # population checkpoints: which replica
    seed: int = 0             # serve-side RNG stream (ε draws, noise)

    def validate(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown serving policy {self.policy!r}; one of "
                f"{POLICIES}")
        if not 0.0 <= self.eps <= 1.0:
            raise ValueError(f"eps must be in [0, 1], got {self.eps}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        if self.replica < 0:
            raise ValueError(f"replica must be >= 0, got {self.replica}")

    def resolved_buckets(self) -> Tuple[int, ...]:
        """Ascending bucket sizes, always ending at ``max_batch``."""
        if self.buckets:
            return tuple(sorted({min(b, self.max_batch)
                                 for b in self.buckets} | {self.max_batch}))
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        return tuple(out + [self.max_batch])


class PolicyServer:
    """Microbatching action server over fixed parameters on their device.

    Per stream: ``submit(stream_id, obs, first=...)`` enqueues the
    stream's raw current observation (``first=True`` on an episode's
    first observation: the server zeroes that stream's stack history, as
    the sampler's autoreset does); ``flush()`` drains the queue in
    arrival order as microbatches of at most ``ServeSpec.max_batch``
    rows, each padded to the smallest bucket that holds it, and returns
    ``{stream_id: action}``.

    Stream s's t-th action draws from
    ``fold_in(fold_in(PRNGKey(seed), s), t)``: a function of the serve
    seed, the stream id and the stream's own action count, so a
    reconnecting client replays identically and no draw depends on the
    batch. ``flush(keys=...)`` overrides the keys row for row. The
    ``noisy`` policy's noise key for tick n is
    ``fold_in(fold_in(PRNGKey(seed), 7), n)``.
    """

    def __init__(self, params, q_forward: Callable, pipe: ObsPipeline,
                 frame_stack: int, n_actions: int,
                 serve: ServeSpec = ServeSpec(), tracer=None):
        serve.validate()
        # the default NullTracer keeps the request path free of clock
        # reads and waits
        self.tracer = tracer if tracer is not None else NullTracer()
        self.params = params
        self.q_forward = q_forward
        self.pipe = pipe
        self.frame_stack = frame_stack
        self.n_actions = n_actions
        self.serve = serve
        self.device = next(iter(params.values())).device
        self._obs_dtype = torch.empty((), dtype=pipe.dtype).numpy().dtype
        self._buckets = serve.resolved_buckets()
        self._eps = torch.full((), serve.eps if serve.policy == "egreedy"
                               else 0.0, dtype=torch.float32,
                               device=self.device)
        self._noisy = serve.policy == "noisy"
        self._base = rng.PRNGKey(serve.seed, device=self.device)
        # a constant tag: per-stream action keys and per-tick noise keys
        # are distinct streams of one seed
        self._noise_base = rng.fold_in(self._base, 7)
        self._slots: Dict[Any, int] = {}       # stream id -> stack row
        self._steps: List[int] = []            # per-slot action count
        self._stacks: Optional[torch.Tensor] = None   # (cap, *obs, K)
        self._cap = 0
        self._queue: List[Tuple[Any, int, np.ndarray, bool, float]] = []
        self._tick = 0
        self._latencies: List[float] = []
        self.microbatches = 0                  # Q calls served so far

    # -- stream table ------------------------------------------------------

    def _grow(self, cap: int) -> None:
        cap = max(cap, 1)
        if cap <= self._cap:
            return
        new = torch.zeros((cap,) + self.pipe.shape + (self.frame_stack,),
                          dtype=self.pipe.dtype, device=self.device)
        if self._stacks is not None and self._cap > 0:
            new[: self._cap] = self._stacks
        self._stacks = new
        self._cap = cap

    def _slot(self, stream_id) -> int:
        slot = self._slots.get(stream_id)
        if slot is None:
            slot = len(self._slots)
            self._slots[stream_id] = slot
            self._steps.append(0)
            if slot >= self._cap:
                self._grow(max(2 * self._cap, 1))
        return slot

    @property
    def n_streams(self) -> int:
        return len(self._slots)

    # -- request path ------------------------------------------------------

    def submit(self, stream_id, obs, first: bool = False) -> None:
        """Enqueue one stream's raw observation for the next flush."""
        self._queue.append((stream_id, self._slot(stream_id),
                            np.asarray(obs), bool(first),
                            time.perf_counter()))

    def submit_many(self, stream_ids: Sequence, obs_batch, first) -> None:
        """Vectorised submit: obs_batch (n, *obs), first (n,) bools."""
        obs_batch = np.asarray(obs_batch)
        first = np.asarray(first)
        now = time.perf_counter()
        for i, sid in enumerate(stream_ids):
            self._queue.append((sid, self._slot(sid), obs_batch[i],
                                bool(first[i]), now))

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _keys(self, sids: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
        """(b,) stream ids and action counts -> (b, 2) action keys."""
        return rng.fold_in(rng.fold_in(self._base, sids), steps)

    def _serve(self, slots: torch.Tensor, n_real: int, obs: torch.Tensor,
               first: torch.Tensor, keys: torch.Tensor,
               noise_key: Optional[torch.Tensor]) -> torch.Tensor:
        """One bucket-shaped step: gather each row's stack (pad rows read
        a clamped slot), zero it where an episode starts, push the frame,
        act, and write back the first ``n_real`` rows only."""
        with torch.no_grad():
            rows = self._stacks[torch.clamp(slots, max=self._cap - 1)]
            zero = first.reshape((-1,) + (1,) * (rows.dim() - 1))
            rows = push_frame(torch.where(zero, torch.zeros_like(rows),
                                          rows), obs)
            actions = policy_step(self.q_forward, self.params, rows,
                                  self._eps, keys, noise_key)
            if n_real:
                self._stacks.index_copy_(0, slots[:n_real], rows[:n_real])
        return actions

    def flush(self, keys: Optional[np.ndarray] = None) -> Dict[Any, int]:
        """Serve every queued request; returns ``{stream_id: action}``.

        ``keys`` (optional) overrides the per-stream keys row for row in
        queue order: shape (len(queue), 2) of uint32 words."""
        queue, self._queue = self._queue, []
        if keys is not None:
            keys = np.asarray(keys)
            if keys.shape[0] != len(queue):
                raise ValueError(f"keys has {keys.shape[0]} rows for "
                                 f"{len(queue)} queued requests")
        noise_key = (rng.fold_in(self._noise_base, self._tick)
                     if self._noisy else None)
        out: Dict[Any, int] = {}
        mb = self.serve.max_batch
        with self.tracer.span("serve.flush", tick=self._tick,
                              requests=len(queue)):
            for lo in range(0, len(queue), mb):
                self._serve_chunk(queue[lo: lo + mb], keys, lo, noise_key,
                                  out)
            self.tracer.count("serve.actions", len(queue))
        self._tick += 1
        return out

    def _serve_chunk(self, chunk, keys, lo: int, noise_key,
                     out: Dict[Any, int]) -> None:
        """One microbatch: pad to a bucket, run it, hand actions back.
        Telemetry: a ``serve.queue_wait`` span (oldest submit -> compute
        start) then a ``serve.compute`` span, fenced on the card."""
        B = len(chunk)
        bucket = self._bucket_for(B)
        if self.tracer.enabled and chunk:
            self.tracer.complete("serve.queue_wait",
                                 min(t0 for *_x, t0 in chunk),
                                 time.perf_counter(), batch=B)
        with self.tracer.span("serve.compute", batch=B, bucket=bucket):
            obs = np.zeros((bucket,) + self.pipe.shape, self._obs_dtype)
            # one int32 table (slot, stream id, action count, first) per
            # row, so the request's indices cross to the device in one copy
            meta = np.zeros((4, bucket), np.int32)
            meta[0] = self._cap                    # pad rows: out of range
            for i, (sid, slot, ob, fr, _t0) in enumerate(chunk):
                obs[i] = ob
                # integer stream ids key the RNG directly (stable across
                # reconnects); other ids fall back to the slot
                meta[:, i] = (slot, int(sid) if isinstance(
                    sid, (int, np.integer)) else slot, self._steps[slot], fr)
            meta_t = torch.from_numpy(meta).to(self.device)
            obs_t = torch.from_numpy(obs).to(self.device)
            if keys is None:
                kchunk = self._keys(meta_t[1], meta_t[2])
            else:
                kpad = np.zeros((bucket, 2), np.int64)
                kpad[:B] = keys[lo: lo + B]
                kchunk = torch.from_numpy(kpad).to(self.device)
            actions = self._serve(meta_t[0].long(), B, obs_t,
                                  meta_t[3].bool(), kchunk, noise_key)
            actions = self.tracer.fence(actions)
            acts = actions[:B].cpu().numpy()       # the batch is served
        done_t = time.perf_counter()
        self.microbatches += 1
        for i, (sid, slot, _ob, _fr, t0) in enumerate(chunk):
            out[sid] = int(acts[i])
            self._steps[slot] += 1
            self._latencies.append(done_t - t0)

    # -- operations --------------------------------------------------------

    def warm_start(self, n_streams: int = 0) -> int:
        """Pre-size the stream table for ``n_streams`` and run every
        bucket shape once with all rows padded (no state is written), so
        no serve tick pays a first call's set-up. Returns the number of
        buckets run."""
        if n_streams:
            cap = 1
            while cap < n_streams:
                cap *= 2
            self._grow(cap)
        self._grow(1)
        noise_key = (rng.fold_in(self._noise_base, -1)
                     if self._noisy else None)
        for b in self._buckets:
            obs = torch.zeros((b,) + self.pipe.shape, dtype=self.pipe.dtype,
                              device=self.device)
            slots = torch.full((b,), self._cap, dtype=torch.int64,
                               device=self.device)
            zero = torch.zeros((b,), dtype=torch.int32, device=self.device)
            keys = self._keys(zero, zero)
            self._serve(slots, 0, obs, zero.bool(), keys, noise_key)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(self._buckets)

    def drain_latencies(self) -> List[float]:
        """Per-request submit-to-action latencies (seconds) since the
        last drain."""
        out, self._latencies = self._latencies, []
        return out


# ---------------------------------------------------------------------------
# Loading: spec.json + the newest restorable checkpoint -> serving pieces
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoadedPolicy:
    """Everything serving needs, taken from one checkpoint dir."""

    spec: ExperimentSpec
    params: Any                   # single-replica policy params
    q_forward: Callable           # (params, obs[, noise_key]) -> (B, A)
    pipe: ObsPipeline
    frame_stack: int
    n_actions: int
    step: int                     # the checkpoint step being served
    skipped: List[str]            # corrupt checkpoints passed over


def load_policy(ckpt_dir: str, spec: Optional[ExperimentSpec] = None,
                step: Optional[int] = None, replica: int = 0,
                device: str = "cuda") -> LoadedPolicy:
    """Serving state from a training checkpoint directory, with the
    parameters on ``device``.

    The spec is the dir's ``spec.json`` unless given; the carry is
    ``step`` or the newest *restorable* step (a torn checkpoint is
    skipped, its path recorded in ``LoadedPolicy.skipped``). A
    population checkpoint (either package's ``population`` mode: the
    concurrent carry with a leading replica axis) serves replica
    ``replica``."""
    from repro_torch.api.trainers import _Components, build_trainer
    from repro_torch.checkpoint import restore_checkpoint, restore_latest

    spec = spec or load_run_spec(ckpt_dir)
    if spec is None:
        raise ValueError(
            f"{ckpt_dir} holds no spec.json — pass the run's "
            "ExperimentSpec explicitly (rl_train --print-spec emits it)")
    population = spec.mode == "population"
    run = (dataclasses.replace(spec, mode="concurrent", seeds=1)
           if population else spec)
    trainer = build_trainer(run, device=device)
    template = trainer.init_template()
    if population:
        if not 0 <= replica < spec.seeds:
            raise ValueError(f"replica {replica} out of range for a "
                             f"{spec.seeds}-replica checkpoint")
        template = with_replicas(template, spec.seeds)
    # the carry is read on the host; only the parameters go to the device
    skipped: List[str] = []
    if step is None:
        step, carry, skipped = restore_latest(ckpt_dir, template)
        if carry is None:
            detail = ":\n  " + "\n  ".join(skipped) if skipped else ""
            raise ValueError(
                f"no restorable checkpoint in {ckpt_dir}{detail}")
    else:
        carry = restore_checkpoint(ckpt_dir, step, template)
    params = {k: (v[replica] if population else v).to(trainer.device)
              for k, v in carry.params.items()}
    c = _Components(run)
    return LoadedPolicy(spec, params, c.qf, c.obs, c.dcfg.frame_stack,
                        c.env.n_actions, step, skipped)


def make_server(loaded: LoadedPolicy, serve: ServeSpec = ServeSpec(),
                tracer=None) -> PolicyServer:
    """A :class:`PolicyServer` over a loaded checkpoint (the spec and the
    carry: nothing else crosses from training to serving). ``tracer``
    (:mod:`repro_torch.telemetry`) records queue-wait and compute spans
    per flush; None is a :class:`NullTracer`, which costs nothing."""
    if serve.policy == "noisy" and not loaded.spec.variant.noisy:
        raise ValueError(
            f"serving policy 'noisy' needs a NoisyNet checkpoint; "
            f"variant {loaded.spec.variant.name!r} has no noise "
            "parameters — use 'greedy' or 'egreedy'")
    return PolicyServer(loaded.params, loaded.q_forward, loaded.pipe,
                        loaded.frame_stack, loaded.n_actions, serve,
                        tracer=tracer)
