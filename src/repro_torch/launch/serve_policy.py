"""Serve a checkpointed policy to many concurrent client streams, on the
card unless asked for the CPU.

  # checkpoint a run, then serve it
  PYTHONPATH=src python -m repro_torch.launch.rl_train --dryrun \\
      --spec examples/specs/baseline_catch.json --ckpt-dir runs/catch
  PYTHONPATH=src python -m repro_torch.launch.serve_policy \\
      --ckpt-dir runs/catch --clients 256 --ticks 100 --warm-start \\
      [--device cpu]

A server is a spec plus a carry (``repro_torch.api.serve``): the run's
``spec.json`` and the newest *restorable* ``step_*.npz`` in
``--ckpt-dir`` (written by either package) determine the network, the
observation pipeline and the frame stack. Torn checkpoints are skipped
with a named warning, as ``rl_train --resume`` does.

Client load is the in-process simulated fleet
(``repro_torch.api.policy_client``): ``--clients`` streams over the
port's batched envs, each sending raw observations and receiving
actions from the server's microbatches. ``--warm-start`` runs every
batch bucket once and pre-sizes the stream table before serving;
``--policy`` picks greedy, egreedy (``--eps``) or noisy (NoisyNet
checkpoints only); ``--replica`` the population member to serve.
``--smoke`` asserts the round trip. ``--trace FILE`` records each
flush's ``serve.flush``, ``serve.queue_wait`` and ``serve.compute`` spans
and the ``serve.actions`` counter as JSON lines, with a Perfetto twin
beside it (``python -m repro_torch.launch.trace_report FILE`` summarizes
it).
"""

from __future__ import annotations

import argparse

from repro_torch.api.policy_client import SimulatedClients, drive
from repro_torch.api.serve import POLICIES, ServeSpec, load_policy, make_server
from repro_torch.api.spec import ExperimentSpec
from repro_torch.telemetry import chrome_path_for, device_meta, make_tracer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_policy")
    ap.add_argument("--ckpt-dir", required=True,
                    help="training checkpoint dir (spec.json + step_*.npz)")
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="ExperimentSpec JSON overriding the stored "
                         "spec.json")
    ap.add_argument("--step", type=int, default=None,
                    help="serve this checkpoint step (default: the newest "
                         "restorable)")
    ap.add_argument("--replica", type=int, default=0,
                    help="population checkpoints: which replica to serve")
    ap.add_argument("--policy", default="egreedy", choices=list(POLICIES))
    ap.add_argument("--eps", type=float, default=0.05,
                    help="exploration rate for --policy egreedy")
    ap.add_argument("--max-batch", type=int, default=1024,
                    help="microbatch ceiling per Q call")
    ap.add_argument("--clients", type=int, default=64,
                    help="simulated concurrent client streams")
    ap.add_argument("--ticks", type=int, default=50,
                    help="serve ticks to drive")
    ap.add_argument("--seed", type=int, default=0,
                    help="serve-side RNG seed (the client fleet uses "
                         "seed+1)")
    ap.add_argument("--warm-start", action="store_true",
                    help="run every batch bucket once and pre-size the "
                         "stream table before serving")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record queue-wait and compute spans per flush "
                         "(JSON lines + a Perfetto twin; "
                         "launch/trace_report.py summarizes)")
    ap.add_argument("--smoke", action="store_true",
                    help="assert the round trip and print SERVE OK")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = None
    if args.spec:
        with open(args.spec) as f:
            spec = ExperimentSpec.from_json(f.read())
    try:
        loaded = load_policy(args.ckpt_dir, spec=spec, step=args.step,
                             replica=args.replica, device=args.device)
    except (ValueError, FileNotFoundError) as e:
        print(f"cannot serve {args.ckpt_dir}: {e}", flush=True)
        return 2
    for s in loaded.skipped:
        print(f"WARNING: skipped unrestorable checkpoint {s}", flush=True)
    serve = ServeSpec(policy=args.policy, eps=args.eps,
                      max_batch=args.max_batch, replica=args.replica,
                      seed=args.seed)
    tracer = make_tracer(args.trace, meta={
        "kind": "serve_policy", "env": loaded.spec.env,
        "variant": loaded.spec.variant.name, "policy": args.policy,
        "clients": args.clients, "max_batch": args.max_batch,
        **(device_meta(args.device) if args.trace else {})})
    try:
        server = make_server(loaded, serve, tracer=tracer)
    except ValueError as e:
        tracer.close()
        print(f"invalid serving config: {e}", flush=True)
        return 2
    print(f"serving {loaded.spec.env}/{loaded.spec.variant.name} "
          f"step {loaded.step} ({loaded.pipe.mode} obs, "
          f"policy={args.policy})", flush=True)
    if args.warm_start:
        n = server.warm_start(args.clients)
        print(f"warm start: {n} buckets run once, stream table sized "
              f"for {args.clients}", flush=True)

    clients = SimulatedClients(loaded.spec, args.clients,
                               seed=args.seed + 1, device=server.device)
    try:
        stats = drive(server, clients, args.ticks)
    finally:
        tracer.close()
    if args.trace:
        print(f"trace written: {args.trace} (+ Perfetto twin "
              f"{chrome_path_for(args.trace)})", flush=True)
    print(f"{stats['clients']} streams x {stats['ticks']} ticks: "
          f"{stats['actions_per_s']:.0f} actions/s, "
          f"latency p50 {stats['p50_ms']:.2f} ms "
          f"p99 {stats['p99_ms']:.2f} ms | "
          f"{stats['episodes']} episodes finished, "
          f"mean return {stats['mean_return']:+.2f}", flush=True)

    if args.smoke:
        if stats["actions"] != args.clients * args.ticks \
                or not stats["actions_per_s"] > 0:
            print(f"SERVE FAILED: {stats}", flush=True)
            return 1
        print(f"SERVE OK policy={args.policy} obs={loaded.pipe.mode} "
              f"clients={args.clients} ticks={args.ticks}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
