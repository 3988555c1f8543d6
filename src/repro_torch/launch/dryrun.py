"""Production-mesh dry run: trace every (architecture x input shape x
mesh) step on a fake process group and count what each device runs.

The port of ``repro.launch.dryrun``. Where the reference lowers and
compiles a jitted step over ``ShapeDtypeStruct``s for a 256- or
512-device host mesh, this builds the mesh over a ``fake`` process
group of that many ranks in one process (``launch/mesh.py``), places
the parameters, the optimizer state, the inputs and the caches as
DTensors whose local shards are fake tensors (``sharding/rules.py``),
and runs the port's own step once under ``FakeTensorMode`` with the
cost counter (``roofline/cost.py``): no memory is allocated and no
kernel runs, and each collective DTensor issues is counted, not sent.
Each record has the reference's keys, with ``trace_s`` in place of
``lower_s`` and ``compile_s``. A failure is recorded and the grid goes
on; the exit code is 1 if any record failed.

``--arch dqn`` runs each variant preset's dryrun-sized cycle
(``dqn_variant_spec``) once for real on ``--device`` under the counter,
its kernels counted by their analytic work; its records are 1x1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh both --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dqn \
      --device cuda
  PYTHONPATH=src python -m repro_torch.launch.dryrun \
      --out results/dryrun_torch.json --against results/dryrun.json

``--against`` prints the records of ``--out`` against the reference's
records of the same flags (``python -m repro.launch.dryrun --out``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import (ExecConfig, INPUT_SHAPES, ShapeConfig,
                                TrainConfig)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.specs import decode_is_ring, needs_memory, shape_specs
from repro_torch.launch.steps import (abstract_train_state, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.transformer import abstract_params
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.roofline.cost import CostCounter
from repro_torch.sharding import rules as R
from repro_torch.sharding.partition import cache_placements


def fake_world(n: int) -> None:
    """A ``fake`` process group of n ranks in this process (rank 0): the
    collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(multi_pod: bool, device: str):
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod,
                                device_type=torch.device(device).type)


def _tree(fn, *trees):
    """``fn`` over the leaves of parallel nested dicts, lists or tuples
    (the first tree's leaves are tensors)."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree(fn, *[t[k] for t in trees]) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_tree(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def place(abstract: torch.Tensor, spec, mesh, fake_mode, device: str):
    """A DTensor of ``abstract``'s shape and dtype placed by ``spec`` on
    ``mesh``, its local shard a fake tensor on ``device``."""
    from torch.distributed.tensor import DTensor
    pl = R.placements(spec, mesh)
    local, _ = R.local_offset(abstract.shape, mesh, pl)
    with fake_mode:
        shard = torch.empty(local, dtype=abstract.dtype, device=device)
    return DTensor.from_local(shard, mesh, pl, run_check=False,
                              shape=abstract.shape, stride=abstract.stride())


def shard_like_params(opt_state, pspecs):
    """Optimizer state mirrors the parameter tree under m/v; its other
    entries (the step) are replicated."""
    return {k: (pspecs if k in ("m", "v") else _tree(lambda _: (), v))
            for k, v in opt_state.items()}


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0

    def add(t):
        nonlocal total
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    _tree(add, tree)
    return total


def lower_one(arch: str, shape_name: str, multi_pod: bool, ec: ExecConfig,
              tc: TrainConfig, device: str = "cuda") -> Dict[str, Any]:
    """Trace one (arch, shape, production mesh) step and count it."""
    rec = trace_step(get_config(arch), INPUT_SHAPES[shape_name],
                     make_mesh(multi_pod, device), ec, tc, device)
    rec.update(arch=arch, shape=shape_name,
               mesh="2x16x16" if multi_pod else "16x16")
    return rec


def trace_step(cfg, shape: ShapeConfig, mesh, ec: ExecConfig,
               tc: TrainConfig, device: str = "cuda") -> Dict[str, Any]:
    """The step of ``shape``'s kind traced on fake tensors placed by the
    rules on ``mesh`` (over a running process group) and counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.compat import use_mesh
    axes = R.mesh_axes(mesh)
    rec: Dict[str, Any] = {"n_chips": mesh.size()}
    fake_mode = FakeTensorMode()

    def put(tree, specs):
        return _tree(lambda t, s: place(t, s, mesh, fake_mode, device), tree,
                     specs)

    pspecs = R.param_placements(cfg, axes, ec)
    specs = shape_specs(cfg, ec, shape)
    B = shape.global_batch
    if shape.kind == "decode":
        ispecs = {"tokens": (R.batch_axes(axes, B), None)}
        ispecs["cache"] = cache_placements(cfg, axes, ec, B,
                                           specs["cache"])
    else:
        ispecs = {k: v for k, v in R.input_placements(
            axes, B, needs_memory(cfg)).items() if k in specs}
    inputs = put(specs, ispecs)
    if shape.kind == "train":
        step, _ = make_train_step(cfg, ec, tc)
        params, opt_state = abstract_train_state(cfg, ec, tc)
        args = (put(params, pspecs),
                put(opt_state, shard_like_params(opt_state, pspecs)), inputs)
        tokens = B * shape.seq_len
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, ec)
        args = (put(abstract_params(cfg, ec), pspecs), inputs)
        tokens = B * shape.seq_len
    else:
        step = make_serve_step(cfg, ec, ring=decode_is_ring(shape))
        args = (put(abstract_params(cfg, ec), pspecs), inputs["cache"],
                inputs["tokens"])
        tokens = B
    arg_bytes = _local_bytes(args)
    counter = CostCounter()
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    t0 = time.perf_counter()
    with grad, use_mesh(mesh), fake_mode, implicit_replication(), counter:
        step(*args)
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    _record_costs(rec, counter)
    rec["argument_bytes"] = arg_bytes
    rec["hbm_gb_per_device"] = (arg_bytes + counter.peak_bytes) / 1e9
    rec["mem"] = {"argument_mb": arg_bytes / 1e6,
                  "peak_live_mb": counter.peak_bytes / 1e6}
    useful, total_p, active_p = model_flops(
        cfg, tokens, "train" if shape.kind == "train" else "infer")
    rec["model_flops_global"] = useful
    rec["params_total"] = total_p
    rec["params_active"] = active_p
    global_flops = rec["flops_per_device"] * rec["n_chips"]
    rec["useful_ratio"] = useful / global_flops if global_flops else 0.0
    return rec


def _record_costs(rec: Dict[str, Any], counter: CostCounter) -> None:
    rec["flops_per_device"] = counter.flops
    rec["bytes_per_device"] = counter.bytes
    rec["collectives"] = {k: v for k, v in counter.collectives.items() if v}
    rec["collective_bytes_per_device"] = counter.collective_bytes
    rec["kernel_calls"] = {k[len("kernel."):]: v
                           for k, v in sorted(counter.ops.items())
                           if k.startswith("kernel.")}
    rec.update(roofline_terms(counter.flops, counter.bytes,
                              counter.collective_bytes))


def dqn_variant_spec(variant_name: str, mode: str = "concurrent",
                     env: str = "catch", obs_mode: str = "pixels"):
    """The dryrun-sized ExperimentSpec for one variant preset: the
    ``tiny`` network (or its ``mlp_tiny`` vector-mode analogue) on
    catch, a 32-step cycle; the reference's."""
    from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
    from repro_torch.configs.dqn_nature import get_variant

    return ExperimentSpec(
        env=env, mode=mode, variant=get_variant(variant_name),
        obs_mode=obs_mode, envs=4, frame_size=10,
        net="mlp_tiny" if obs_mode == "vector" else "tiny",
        schedule=ScheduleSpec(cycles=1, cycle_steps=32, prepopulate=64,
                              eval_every=1, eval_episodes=8),
        algo=AlgoSpec(minibatch_size=8, replay_capacity=512,
                      train_period=4, eps_anneal_steps=1000),
        exec=ExecConfig(compute_dtype="float32"))


def run_dqn_variant(variant_name: str, device: str = "cuda",
                    env: str = "catch",
                    obs_mode: str = "pixels") -> Dict[str, Any]:
    """One off-policy DQN variant's C-cycle (the concurrent super-step,
    the PER segment tree and the C51 projection included) run once on
    ``device`` under the counter, built as the launcher builds it."""
    from repro_torch.api.trainers import build_trainer
    from repro_torch.runtime import configure
    configure(device)
    trainer = build_trainer(dqn_variant_spec(variant_name, env=env,
                                             obs_mode=obs_mode),
                            device=device)
    carry = trainer.init_carry()
    rec: Dict[str, Any] = {"arch": "dqn", "shape": f"variant_{variant_name}",
                           "mesh": "1x1", "n_chips": 1}
    counter = CostCounter()
    t0 = time.perf_counter()
    with counter:
        trainer.cycle(carry)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    _record_costs(rec, counter)
    return rec


MESH_DATA_WAYS = {"16x16": 16, "2x16x16": 32}


def versus(rec: Dict[str, Any], ref_flops: float,
           ec: ExecConfig = ExecConfig(remat=True)) -> Tuple[float, float]:
    """(ratio, adjusted): a port record's per-device flops over the
    reference's ``ref_flops`` for the same (arch, shape, mesh) and
    flags ``ec``, as they are and with the masked attention pairs the
    reference counts (``analysis.masked_pairs``) added to the port's."""
    from repro_torch.roofline.analysis import masked_pairs
    m = masked_pairs(get_config(rec["arch"]), INPUT_SHAPES[rec["shape"]],
                     MESH_DATA_WAYS[rec["mesh"]],
                     heads_sharded=not ec.kv_seq_shard, remat=ec.remat)
    port = rec["flops_per_device"]
    return port / ref_flops, (port + m) / ref_flops


def against(port: list, reference: list, ec: ExecConfig) -> str:
    """A markdown table of the port's records against the reference's
    (``python -m repro.launch.dryrun`` records of the same flags): per
    (arch, shape, mesh) the per-device flops of each, their ratio and
    the ratio with the masked pairs added back (``versus``), and the
    collective bytes of each; a failed record shows its error."""
    ref = {(r["arch"], r["shape"], r["mesh"]): r for r in reference}
    rows = ["| arch | shape | mesh | port flop/dev | ref flop/dev | ratio "
            "| + masked | port coll B | ref coll B |",
            "|---|---|---|---|---|---|---|---|---|"]
    for p in port:
        key = (p["arch"], p["shape"], p["mesh"])
        r = ref.get(key, {"error": "no record"})
        if "error" in p or "error" in r:
            err = lambda x: ("fails: " + x["error"].splitlines()[0][:60]
                             if "error" in x else "%.4e" % x[
                                 "flops_per_device"])  # noqa: E731
            rows.append(f"| {' | '.join(key)} | {err(p)} | {err(r)} "
                        f"| | | | |")
            continue
        pf, rf = p["flops_per_device"], r["flops_per_device"]
        ratio, adjusted = versus(p, rf, ec)
        rows.append(f"| {' | '.join(key)} | {pf:.4e} | {rf:.4e} "
                    f"| {ratio:.3f} | {adjusted:.3f} "
                    f"| {p['collective_bytes_per_device']:.3e} "
                    f"| {r['collective_bytes_per_device']:.3e} |")
    return "\n".join(rows)


def _load(path: str) -> list:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def _save(path: str, results: list) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def _main_dqn(args) -> int:
    from repro_torch.configs.dqn_nature import VARIANTS, get_variant
    from repro_torch.envs.games import make_env
    try:
        make_env(args.env)       # fail fast, listing the available games
    except ValueError as e:
        print(f"invalid --env: {e}", flush=True)
        return 2
    if args.variant == "baseline":          # the LLM grid's default tag
        names = sorted(VARIANTS)
    else:
        get_variant(args.variant)           # KeyError on typos
        names = [args.variant]
    results = _load(args.out)
    failed = []
    for name in names:
        print(f"=== dqn x {name}", flush=True)
        try:
            rec = run_dqn_variant(name, args.device, env=args.env,
                                  obs_mode=args.obs_mode)
            rec["variant"] = name
            print(f"    trace {rec['trace_s']}s | "
                  f"{rec['flops_per_device']:.3e} flop/dev | kernels "
                  f"{rec['kernel_calls']}", flush=True)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {"arch": "dqn", "shape": f"variant_{name}", "mesh": "1x1",
                   "variant": name, "error": str(e),
                   "traceback": traceback.format_exc()[-2000:]}
            failed.append(name)
            print(f"    FAILED [variant={name}]: {e}", flush=True)
        results = [r for r in results if not (
            r.get("arch") == "dqn" and r.get("variant") == name)]
        results.append(rec)
        _save(args.out, results)
    print(f"\n{len(names) - len(failed)} OK, {len(failed)} failed"
          + (f" ({', '.join(failed)})" if failed else ""))
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moe-impl", default="scatter",
                    choices=["scatter", "dense", "expert_parallel"])
    ap.add_argument("--kv-seq-shard", action="store_true")
    # the reference's --slstm-unroll and --decode-repeat-kv are left out:
    # the sLSTM scan and decode attention are kernels here (no XLA scan to
    # unroll, and the decode kernel reads grouped KV heads as they are)
    ap.add_argument("--mlstm-recurrent", action="store_true",
                    help="the mLSTM's step recurrence in place of its "
                         "chunkwise-parallel form")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (LLM grid) or the one "
                         "the DQN cycles run on (--arch dqn)")
    ap.add_argument("--env", default="catch",
                    help="(--arch dqn) env registry name")
    ap.add_argument("--obs-mode", default="pixels",
                    choices=["pixels", "vector"],
                    help="(--arch dqn) observation mode of the grid")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--against", default=None,
                    help="the reference's records (python -m "
                         "repro.launch.dryrun --out) of the same flags: "
                         "print --out's records against them, trace "
                         "nothing")
    args = ap.parse_args(argv)
    ec = ExecConfig(remat=not args.no_remat, fsdp=args.fsdp,
                    moe_impl=args.moe_impl, kv_seq_shard=args.kv_seq_shard,
                    mlstm_chunked=not args.mlstm_recurrent)
    if args.against:
        print(against(_load(args.out), _load(args.against), ec))
        return 0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.arch == "dqn":
        return _main_dqn(args)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    tc = TrainConfig(remat=not args.no_remat)
    results = _load(args.out)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))
            for r in results if "error" not in r}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                key = (arch, shape, mesh_name, args.variant)
                if key in done and not args.force:
                    print(f"skip {key} (done)")
                    continue
                print(f"=== {arch} x {shape} x {mesh_name} [{args.variant}]",
                      flush=True)
                try:
                    rec = lower_one(arch, shape, mp, ec, tc, args.device)
                    rec["variant"] = args.variant
                    print(f"    trace {rec['trace_s']}s "
                          f"| {rec['flops_per_device']:.3e} flop/dev "
                          f"| {rec['bytes_per_device']:.3e} B/dev "
                          f"| coll {rec['collective_bytes_per_device']:.3e} B "
                          f"| dominant {rec['dominant']}", flush=True)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "variant": args.variant, "error": str(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"    FAILED: {e}", flush=True)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"],
                               r.get("variant", "baseline")) != key]
                results.append(rec)
                _save(args.out, results)
    errs = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(errs)} OK, {len(errs)} failed")
    return 1 if errs else 0


if __name__ == "__main__":
    raise SystemExit(main())
