"""Summarize, diff, and regression-gate JSONL traces (no card needed).

  # where does the wall clock go? (per-phase p50/p95, % of parent,
  # compile-vs-steady split, counters with derived rates)
  PYTHONPATH=src python -m repro_torch.launch.trace_report \
      runs/x/trace.jsonl

  # did a change move any phase? (steady-p50 deltas, phase by phase)
  PYTHONPATH=src python -m repro_torch.launch.trace_report before.jsonl \
      --diff after.jsonl

  # the bench-regression gate CI runs: every trace span matching a
  # committed BENCH row by name must be within --tolerance x of it
  PYTHONPATH=src python -m repro_torch.launch.trace_report \
      bench_trace.jsonl --against BENCH_9.json --tolerance 10

  # the trace-smoke contract: fail unless these phases were recorded
  PYTHONPATH=src python -m repro_torch.launch.trace_report \
      runs/x/trace.jsonl --require-phases cycle,eval,checkpoint

Exit codes: 0 = ok, 1 = gate failure (missing required phase, bench
regression beyond tolerance, or coverage below --min-coverage),
2 = unusable input. The port of ``repro.launch.trace_report``; it reads
either package's traces (the record format is shared).
"""

from __future__ import annotations

import argparse

from repro_torch.telemetry import report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="summarize / diff / gate repro telemetry traces")
    ap.add_argument("trace", help="JSONL trace (Tracer + JsonlSink output)")
    ap.add_argument("--diff", default=None, metavar="OTHER",
                    help="second trace: print phase-by-phase steady-p50 "
                         "deltas (positive = OTHER slower)")
    ap.add_argument("--against", default=None, metavar="BENCH.json",
                    help="committed benchmarks/run.py --record file: "
                         "compare same-named spans/rows, exit 1 on any "
                         "row slower than --tolerance x")
    ap.add_argument("--tolerance", type=float, default=3.0,
                    help="--against slack factor (default 3.0; CI uses "
                         "a generous one — machines differ, 50x doesn't)")
    ap.add_argument("--require-phases", default=None, metavar="A,B,...",
                    help="exit 1 unless every named phase has at least "
                         "one span (the CI trace-smoke contract)")
    ap.add_argument("--min-coverage", type=float, default=None,
                    metavar="FRAC",
                    help="exit 1 if the root span's child phases cover "
                         "less than FRAC of its wall clock (e.g. 0.95)")
    ap.add_argument("--root", default="train",
                    help="root span for --min-coverage (default: train)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        trace = report.load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"cannot read trace: {e}", flush=True)
        return 2
    if not trace["spans"]:
        print(f"{args.trace} holds no spans — was the tracer enabled "
              "(repro_torch.launch.rl_train --trace FILE)?", flush=True)
        return 2

    print(report.render_summary(trace), flush=True)
    failed = False

    if args.require_phases:
        required = [p.strip() for p in args.require_phases.split(",")
                    if p.strip()]
        have = {s["name"] for s in trace["spans"]}
        missing = [p for p in required if p not in have]
        if missing:
            print(f"\nFAIL: required phase(s) never recorded: "
                  f"{', '.join(missing)} (have: {', '.join(sorted(have))})",
                  flush=True)
            failed = True
        else:
            print(f"\nrequired phases present: {', '.join(required)}",
                  flush=True)

    if args.min_coverage is not None:
        cov = report.phase_coverage(trace, args.root)
        if cov is None:
            print(f"\nFAIL: no '{args.root}' root span (or no children) "
                  "to measure coverage on", flush=True)
            failed = True
        elif cov < args.min_coverage:
            print(f"\nFAIL: child phases cover {100 * cov:.1f}% of "
                  f"'{args.root}' wall clock "
                  f"(< {100 * args.min_coverage:.0f}%)", flush=True)
            failed = True
        else:
            print(f"\ncoverage gate ok: {100 * cov:.1f}% of "
                  f"'{args.root}' attributed", flush=True)

    if args.diff:
        try:
            other = report.load_trace(args.diff)
        except (OSError, ValueError) as e:
            print(f"cannot read --diff trace: {e}", flush=True)
            return 2
        print("\n" + report.render_diff(report.diff(trace, other),
                                        args.trace, args.diff), flush=True)

    if args.against:
        try:
            bench = report.load_bench(args.against)
            rows = report.against(trace, bench, tolerance=args.tolerance)
        except (OSError, ValueError) as e:
            print(f"\nFAIL: bench gate unusable: {e}", flush=True)
            return 1
        print("\n" + report.render_against(rows, args.against,
                                           args.tolerance), flush=True)
        if any(not r["ok"] for r in rows):
            failed = True

    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
