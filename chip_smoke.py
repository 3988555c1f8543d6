#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc,
   sm_90a), with the build time;
3. kernel parity on the card against the plain PyTorch versions, at the
   main path's shapes and at edge cases: the segment tree bit for bit,
   the C51 projection to 1e-6;
4. kernel times from CUDA events (median of 200 launches) beside the
   plain versions' times, a one-call PyTorch yardstick where one exists,
   and the bound the card's peak rates set;
5. the main path: ConcurrentTrainer on examples/specs/dqn_nature84.json
   with the rainbow variant (84x84x4 pong frames, the Nature CNN, W=8,
   C=512, F=2, a 16384-slot replay): init_carry, 2 cycles and one eval,
   with each kernel's launches counted, then one torch.profiler capture
   of a cycle (C cut to 32) split by the cycle's phases;
6. agreement with the port's CPU path (held against the JAX reference
   by tests/test_torch_cycle.py) on a small rainbow configuration;
7. determinism: two runs of one full-size cycle from one carry are
   bitwise equal.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check exits non-zero before
printing it. Without a CUDA device, or without the repository's src/
beside it, the script fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

SPEC = ROOT / "examples" / "specs" / "dqn_nature84.json"
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
TIMED_RUNS = 200
# C of the profiled cycle: 4 synchronized rounds and 16 updates at W=8, F=2
PROFILED_STEPS = 32


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of one call, from a CUDA event pair per call.

    The host takes longer to launch these small calls than the card takes
    to run them. So each block of calls is queued while a sleep kernel
    holds the stream, and a block counts only if all of it was queued
    before the sleep ended (the event after the sleep had not completed
    when the last call was queued): the events then time the device, not
    the launches. A block that missed (sleep too short, or the driver's
    launch queue full) is thrown away and the next one is half as long."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host_s = (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    per_block = max(1, min(runs, int(0.05 / host_s)))
    samples, misses = [], 0
    while len(samples) < runs:
        torch.cuda._sleep(int((4.0 * per_block * host_s + 0.005) * 2e9))
        held = torch.cuda.Event()
        held.record()
        pairs = []
        for _ in range(per_block):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        queued_in_time = not held.query()
        torch.cuda.synchronize()
        if queued_in_time:
            samples += [a.elapsed_time(b) for a, b in pairs]
            continue
        misses += 1
        check(misses < 20, "could not queue a timed block behind the sleep")
        per_block = max(1, per_block // 2)
    return statistics.median(samples)


def tree_case(P: int, n: int, gen: torch.Generator, dev):
    """Random float masses over the first 3/4 of the leaves, a zero tail,
    and targets spread over [0, 1.05 * total) so some exceed the total."""
    from repro_torch.kernels.segment_tree import tree_build
    leaves = torch.rand(P, generator=gen, dtype=torch.float64).float()
    leaves[(3 * P) // 4:] = 0.0
    tree = tree_build(leaves.to(dev))
    total = float(tree[1])
    targets = (torch.rand(n, generator=gen, dtype=torch.float64)
               * 1.05 * total).float().to(dev)
    targets[-1] = total                    # exactly the total
    return tree, targets


def projection_case(B: int, K: int, gen: torch.Generator, dev):
    logits = 3.0 * torch.randn(B, K, generator=gen)
    probs = torch.softmax(logits, dim=-1)
    probs[0] = 0.0
    probs[0, K // 2] = 1.0                  # one peaked row
    rewards = 15.0 * torch.randn(B, generator=gen)   # many outside the support
    dones = torch.rand(B, generator=gen) < 0.3
    dones[:2] = True
    return probs.to(dev), rewards.to(dev), dones.to(dev)


def phase_parity(dev):
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import segment_tree as st
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for P, n in ((16384, 32), (16384, 4096), (1, 3), (8, 5), (2048, 64)):
        tree, targets = tree_case(P, n, gen, dev)
        got = st.segment_tree_sample(tree, targets)
        want = st.segment_tree_sample_plain(tree, targets)
        torch.cuda.synchronize()
        err = float((got.long() - want.long()).abs().max())
        check(torch.equal(got, want) and err == 0.0,
              f"segment_tree differs from the plain version at P={P} n={n}: "
              f"max abs err {err}")
        if (P, n) == (16384, 32):
            errs["segment_tree"] = err
            # zero-mass tail leaves are never reached below the total
            inside = targets < tree[1]
            check(bool((got[inside] < (3 * P) // 4).all()),
                  "segment_tree sampled a zero-mass leaf")
    say(f"parity segment_tree: bitwise equal at P in (16384, 1, 8, 2048)")
    gamma_n = 0.9 ** 3
    cases = [(32, 51, -10.0, 10.0, gamma_n), (7, 1, -1.0, -1.0, 0.99),
             (7, 8, 2.0, 2.0, 0.9), (64, 512, -10.0, 10.0, gamma_n),
             (13, 51, -10.0, 10.0, 1.0)]
    for B, K, v_min, v_max, g in cases:
        probs, rewards, dones = projection_case(B, K, gen, dev)
        kw = dict(v_min=v_min, v_max=v_max, gamma_n=g)
        got = cp.categorical_projection(probs, rewards, dones, **kw)
        want = cp.categorical_projection_plain(probs, rewards,
                                               dones.float(), **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=1e-6, rtol=1e-6),
              f"categorical_projection differs from the plain version at "
              f"B={B} K={K} v=[{v_min}, {v_max}]: max abs err {err}")
        check(torch.allclose(got.sum(-1), probs.sum(-1), atol=1e-5),
              "categorical_projection lost mass")
        if (B, K) == (32, 51):
            errs["categorical_projection"] = err
    say(f"parity categorical_projection: within 1e-6 on {len(cases)} cases "
        f"(K=1, v_min=v_max, rewards outside the support, dones); max abs "
        f"err at B=32 K=51: {errs['categorical_projection']:.3e}")
    return errs


def phase_times(dev):
    """Kernel, plain and yardstick times at the main path's shapes."""
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import segment_tree as st
    gen = torch.Generator().manual_seed(1)
    out = {}
    P, n = 16384, 32
    tree, targets = tree_case(P, n, gen, dev)
    leaves = tree[P:]
    depth = P.bit_length() - 1
    k_ms = time_ms(lambda: st.segment_tree_sample(tree, targets))
    p_ms = time_ms(lambda: st.segment_tree_sample_plain(tree, targets))
    l_ms = time_ms(lambda: torch.searchsorted(
        torch.cumsum(leaves, 0), targets, right=True).clamp_(max=P - 1))
    # the descent touches depth nodes per target, reads the targets once
    # and writes one index each; 3 f32 operations per level
    nbytes = n * depth * 4 + n * 4 + n * 4
    nops = n * depth * 3
    out["segment_tree"] = (k_ms, p_ms, l_ms, nbytes, nops)
    B, K = 32, 51
    probs, rewards, dones = projection_case(B, K, gen, dev)
    kw = dict(v_min=-10.0, v_max=10.0, gamma_n=0.9 ** 3)
    d32 = dones.float()
    k_ms = time_ms(lambda: cp.categorical_projection(probs, rewards, d32, **kw))
    p_ms = time_ms(lambda: cp.categorical_projection_plain(
        probs, rewards, d32, **kw))
    # probs, rewards, dones read once, (B, K) written once. The function
    # needs, per row, g = gamma_n * (1 - d) (2 ops) and, per (row, source
    # atom j), b_j (mul, add, max, min, sub, div), its floor and ceiling
    # (2), the two weights (2), and two products and two adds (4): 14.
    # The kernel's gather loop does K times more (a hat weight per (i, j)),
    # but that is its choice, not the function's work.
    nbytes = (2 * B * K + 2 * B) * 4
    nops = B * 2 + B * K * 14
    out["categorical_projection"] = (k_ms, p_ms, None, nbytes, nops)
    for name, (k_ms, p_ms, l_ms, nbytes, nops) in out.items():
        say(f"time {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"library {'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, "
            f"{nbytes} bytes, {nops} f32 ops")
    return out


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_clone(v) for v in obj])
    return obj


def _paths(obj, prefix=""):
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _paths(v, f"{prefix}.{k}")
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for k, v in zip(obj._fields, obj):
            yield from _paths(v, f"{prefix}.{k}")


def phase_main_path(dev):
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.api.trainers import ConcurrentTrainer
    from repro_torch.configs.dqn_nature import get_variant
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import segment_tree as st
    spec = ExperimentSpec.from_json(SPEC.read_text())
    spec = dataclasses.replace(spec, variant=get_variant("rainbow"),
                               mode="concurrent")
    trainer = ConcurrentTrainer(spec, device="cuda")
    C = spec.schedule.cycle_steps
    per_cycle = C // spec.algo.train_period
    st.segment_tree_sample.launches = 0
    cp.categorical_projection.launches = 0
    t0 = time.perf_counter()
    carry = trainer.init_carry()
    torch.cuda.synchronize()
    say(f"main init_carry: {time.perf_counter() - t0:.2f} s (prepopulate "
        f"{spec.schedule.prepopulate}, replay {spec.algo.replay_capacity})")
    first = None
    for i in range(2):
        t0 = time.perf_counter()
        carry, m = trainer.cycle(carry)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss = float(m["loss"][0])
        say(f"main cycle {i + 1}: {dt:.3f} s, {C / dt:.1f} env-steps/s, "
            f"loss {loss:.6f}")
        check(torch.isfinite(m["loss"]).all().item(), "non-finite loss")
        for name, fn in (("segment_tree", st.segment_tree_sample),
                         ("categorical_projection",
                          cp.categorical_projection)):
            check(fn.launches == per_cycle * (i + 1),
                  f"{name} launched {fn.launches} times after {i + 1} "
                  f"cycle(s), expected {per_cycle * (i + 1)}")
        if first is None:
            first = _clone(carry)
    t0 = time.perf_counter()
    evals = trainer.eval(carry, trainer.eval_key(1))
    torch.cuda.synchronize()
    say(f"main eval: {time.perf_counter() - t0:.2f} s, return "
        f"{float(evals[0]):+.3f} over {spec.schedule.eval_episodes} streams")
    launches = {"segment_tree": st.segment_tree_sample.launches,
                "categorical_projection": cp.categorical_projection.launches}
    check(torch.isfinite(evals).all().item(), "non-finite eval return")
    for path, t in _paths(carry, "carry"):
        check(t.device.type == "cuda", f"{path} is on {t.device}")
    check(tuple(carry.replay["obs"].shape) == (16384, 84, 84, 4)
          and carry.replay["obs"].dtype == torch.uint8,
          "replay frames are not (16384, 84, 84, 4) uint8")
    W, n_step = spec.envs, spec.variant.n_step
    want_size = spec.schedule.prepopulate + 2 * (C // W - (n_step - 1)) * W
    check(int(carry.replay["size"]) == want_size,
          f"replay size {int(carry.replay['size'])} after prepopulate and "
          f"2 cycles, expected {want_size}")
    say(f"main launches over init_carry + 2 cycles + eval: {launches}")
    return trainer, first, launches


def phase_profile(spec, carry):
    """Where a cycle's time goes: one torch.profiler capture around a
    real ``trainer.cycle`` at full width, with C cut to PROFILED_STEPS
    (the full cycle repeats the same rounds and updates, in the same 1:4
    ratio), split by the cycle's labelled phases: host time, kernel
    launches and device busy time in each."""
    from repro_torch.api.trainers import ConcurrentTrainer
    short = dataclasses.replace(spec, schedule=dataclasses.replace(
        spec.schedule, cycle_steps=PROFILED_STEPS))
    trainer = ConcurrentTrainer(short, device="cuda")
    carry = _clone(carry)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.cycle(carry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    spans = {e.name: e.time_range for e in events
             if e.name.startswith("cycle.")
             and e.device_type == torch.autograd.DeviceType.CPU}
    check(set(spans) == {"cycle.sampler", "cycle.trainer", "cycle.flush"},
          f"profile holds the phases {sorted(spans)}")
    spans["outside the phases"] = None
    launch = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"}
    rows = {name: [0.0, 0, 0.0] for name in spans}  # host us, launches, dev us

    def phase_of(t):
        for name, r in spans.items():
            if r is not None and r.start <= t < r.end:
                return name
        return "outside the phases"

    for e in events:
        # the labels' own device-side spans cover their kernels: skip them
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in spans):
            rows[phase_of(e.time_range.start)][2] += e.time_range.elapsed_us()
        elif e.name in launch:
            rows[phase_of(e.time_range.start)][1] += 1
    for name, r in spans.items():
        if r is not None:
            rows[name][0] = r.elapsed_us()
    rows["outside the phases"][0] = max(
        wall * 1e6 - sum(r.elapsed_us() for r in spans.values() if r), 0.0)
    dev_us = sum(r[2] for r in rows.values())
    n_launch = sum(r[1] for r in rows.values())
    check(dev_us <= wall * 1e6, f"device busy {dev_us / 1e3:.1f} ms "
          f"exceeds the cycle's {wall * 1e3:.1f} ms: events counted twice")
    say(f"profile of one cycle with C={PROFILED_STEPS} "
        f"({PROFILED_STEPS // spec.envs} rounds, "
        f"{PROFILED_STEPS // spec.algo.train_period} updates; the profiler "
        f"slows the host): {wall:.3f} s wall, {n_launch} kernel launches, "
        + (f"device busy {dev_us / 1e3:.3f} ms "
           f"({100 * dev_us / 1e6 / wall:.2f}%)" if dev_us > 0 else
           "device time not measured (no device events recorded)"))
    for name, (host_us, n, d_us) in rows.items():
        say(f"profile {name}: host {host_us / 1e3:.2f} ms "
            f"({100 * host_us / 1e6 / wall:.1f}% of the cycle), {n} "
            f"launches, device busy {d_us / 1e3:.3f} ms")


def phase_against_cpu():
    """A small rainbow run on the card against the same run on the CPU."""
    from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
    from repro_torch.api.trainers import ConcurrentTrainer
    from repro_torch.configs.dqn_nature import get_variant
    spec = ExperimentSpec(
        env="pong", mode="concurrent", variant=get_variant("rainbow"),
        envs=4, frame_size=10, net="tiny",
        schedule=ScheduleSpec(cycles=1, cycle_steps=32, prepopulate=64),
        algo=AlgoSpec(minibatch_size=8, replay_capacity=256,
                      optimizer="rmsprop"))
    runs = {}
    for device in ("cpu", "cuda"):
        trainer = ConcurrentTrainer(spec, device=device)
        carry = trainer.init_carry()
        carry, _ = trainer.cycle(carry)
        runs[device] = dict(_paths(carry, "carry"))
    worst = 0.0
    for path, a in runs["cpu"].items():
        b = runs["cuda"][path].cpu()
        if a.dtype.is_floating_point:
            err = float((a - b).abs().max()) if a.numel() else 0.0
            worst = max(worst, err)
            check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
                  f"{path}: card and CPU differ by {err}")
        else:
            check(torch.equal(a, b), f"{path}: card and CPU differ")
    say(f"agreement with the CPU path (pong 10x10, tiny net, rainbow, 1 "
        f"cycle): integer state equal, floats within 1e-4 (max {worst:.2e})")


def phase_determinism(trainer, carry):
    a, _ = trainer.cycle(_clone(carry))
    b, _ = trainer.cycle(_clone(carry))
    torch.cuda.synchronize()
    pb = dict(_paths(b))
    n = 0
    for path, t in _paths(a):
        check(torch.equal(t, pb[path]), f"carry{path} differs between runs")
        n += 1
    say(f"determinism: two cycles from one carry bitwise equal ({n} tensors)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # the port itself, from src/ beside this script: without it, fail here
    from repro_torch.kernels import build
    from repro_torch.runtime import configure
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    say(smi.stdout.strip().splitlines()[0])          # name, power limit
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = configure("cuda")
    t0 = time.perf_counter()
    reports = build.build_all()
    say(f"build: {time.perf_counter() - t0:.2f} s for {sorted(reports)}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "bytes stack" in line:
                say(f"  {name}: {line.strip()}")

    errs = phase_parity(dev)
    times = phase_times(dev)
    trainer, carry, launches = phase_main_path(dev)
    phase_profile(trainer.spec, carry)
    phase_against_cpu()
    phase_determinism(trainer, carry)

    replaces = {
        "segment_tree": ("src/repro_torch/kernels/csrc/segment_tree.cu",
                         "src/repro/kernels/segment_tree.py:95"),
        "categorical_projection": (
            "src/repro_torch/kernels/csrc/categorical_projection.cu",
            "src/repro/kernels/categorical_projection.py:98"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        k_ms, p_ms, l_ms, nbytes, nops = times[name]
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_F32_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": l_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
