"""Trace analysis: summaries, diffs, and the bench-regression gate.

Consumes the JSONL traces :class:`repro_torch.telemetry.JsonlSink` writes
(or the JAX package's: the record format is shared) and
answers the three questions an optimization PR has to answer:

* *Where does a cycle's wall clock go?* — :func:`summarize`: per-phase
  count / total / p50 / p95, percent of the parent phase, and the
  compile-vs-steady split (the first occurrence of a phase pays the
  kernels' build or load, and cuDNN's and cuBLAS's first-call set-up;
  ``steady_p50`` excludes it).
* *Did it change?* — :func:`diff` compares two traces phase-by-phase
  (steady-state p50 deltas).
* *Did it regress?* — :func:`against` compares a trace's spans to a
  committed ``BENCH_<n>.json`` row-by-row (names match exactly — the
  benchmark harness mirrors each recorded row into its trace as a
  same-named span via ``Tracer.point``), failing any span slower than
  ``tolerance``× its committed row. CI runs this so perf drift fails
  loudly instead of silently accumulating.

The port of ``repro.telemetry.report``. CLI:
``python -m repro_torch.launch.trace_report``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["load_trace", "load_bench", "summarize", "phase_coverage",
           "render_summary", "diff", "render_diff", "against",
           "render_against"]


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_trace(path: str) -> Dict[str, Any]:
    """Parse a JSONL trace into ``{"meta", "spans", "compiles",
    "events", "counters"}``. Unknown record types are preserved under
    ``"other"`` so newer traces stay readable."""
    out: Dict[str, Any] = {"meta": {}, "spans": [], "compiles": [],
                           "events": [], "counters": {}, "other": []}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno}: not a JSON record ({e})") from None
            t = rec.get("t")
            if t == "meta":
                out["meta"] = rec
            elif t == "span":
                out["spans"].append(rec)
            elif t == "compile":
                out["compiles"].append(rec)
            elif t == "event":
                out["events"].append(rec)
            elif t == "counter":
                out["counters"][rec["name"]] = rec["value"]
            else:
                out["other"].append(rec)
    return out


def load_bench(path: str) -> Dict[str, Any]:
    """Parse a ``benchmarks/run.py --record`` file; returns the payload
    with rows additionally indexed by name under ``"by_name"``."""
    with open(path) as f:
        payload = json.load(f)
    if "rows" not in payload:
        raise ValueError(f"{path} has no 'rows' — not a --record file?")
    payload["by_name"] = {r["name"]: r for r in payload["rows"]}
    return payload


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------

def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted sequence."""
    if not sorted_vals:
        return 0.0
    idx = min(int(round(q * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[idx]


def summarize(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-phase rows (ordered by first appearance): ``name, parent,
    count, total_us, p50_us, p95_us, first_us, steady_p50_us,
    pct_of_parent``. ``steady_p50_us`` drops each phase's first
    occurrence when there is more than one — that first span carries
    the first call's set-up (a kernel build or load), and mixing it
    into a latency claim is how compile cost hides inside "steady
    state"."""
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    order: List[str] = []
    for s in trace["spans"]:
        if s["name"] not in by_name:
            by_name[s["name"]] = []
            order.append(s["name"])
        by_name[s["name"]].append(s)

    totals = {n: sum(s["dur"] for s in spans)
              for n, spans in by_name.items()}
    rows = []
    for name in order:
        spans = sorted(by_name[name], key=lambda s: s["seq"])
        durs = sorted(s["dur"] for s in spans)
        steady = sorted(s["dur"] for s in spans[1:]) or durs
        # parent attribution: spans of one name may appear under
        # different parents (rare); attribute to the most common one
        parents = [s.get("parent") for s in spans]
        parent = max(set(parents), key=parents.count)
        pct = (100.0 * totals[name] / totals[parent]
               if parent in totals and totals[parent] > 0 else None)
        rows.append({
            "name": name, "parent": parent, "count": len(spans),
            "total_us": totals[name],
            "p50_us": _percentile(durs, 0.50),
            "p95_us": _percentile(durs, 0.95),
            "first_us": spans[0]["dur"],
            "steady_p50_us": _percentile(steady, 0.50),
            "pct_of_parent": pct,
        })
    return rows


def phase_coverage(trace: Dict[str, Any], root: str) -> Optional[float]:
    """Fraction of the ``root`` span's wall clock accounted for by its
    direct children — the "do the phase durations sum to the measured
    total" check (acceptance target: >= 0.95). None when ``root`` is
    absent or childless."""
    root_total = sum(s["dur"] for s in trace["spans"] if s["name"] == root)
    child_total = sum(s["dur"] for s in trace["spans"]
                      if s.get("parent") == root)
    if root_total <= 0 or child_total == 0:
        return None
    return child_total / root_total


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}us"


def render_summary(trace: Dict[str, Any]) -> str:
    """The human-readable report: phase table, coverage lines, compile
    totals, counters (with derived rates when wall clock is known)."""
    rows = summarize(trace)
    lines = []
    meta = trace["meta"]
    prov = (meta.get("provenance") or {}) if meta else {}
    attrs = (meta.get("attrs") or {}) if meta else {}
    if prov or attrs:
        bits = [f"{k}={v}" for k, v in sorted(attrs.items())]
        if prov.get("git_sha"):
            sha = prov["git_sha"][:12]
            bits.append(f"sha={sha}{'+dirty' if prov.get('git_dirty') else ''}")
        lines.append("# " + " ".join(bits))
    lines.append(f"{'phase':28s} {'count':>6s} {'total':>9s} {'p50':>9s} "
                 f"{'p95':>9s} {'first':>9s} {'steady50':>9s} {'%parent':>8s}")
    for r in rows:
        indent = "  " if r["parent"] else ""
        pct = f"{r['pct_of_parent']:7.1f}%" if r["pct_of_parent"] is not None \
            else "       -"
        lines.append(
            f"{indent + r['name']:28s} {r['count']:6d} "
            f"{_fmt_us(r['total_us']):>9s} {_fmt_us(r['p50_us']):>9s} "
            f"{_fmt_us(r['p95_us']):>9s} {_fmt_us(r['first_us']):>9s} "
            f"{_fmt_us(r['steady_p50_us']):>9s} {pct}")

    roots = sorted({r["parent"] for r in rows if r["parent"]} &
                   {r["name"] for r in rows})
    for root in roots:
        cov = phase_coverage(trace, root)
        if cov is not None:
            lines.append(f"coverage[{root}]: {100 * cov:.1f}% of its wall "
                         "clock attributed to child phases")

    if trace["compiles"]:
        by_event: Dict[str, List[float]] = {}
        for c in trace["compiles"]:
            by_event.setdefault(c["name"], []).append(c["dur"])
        total = sum(sum(v) for v in by_event.values())
        lines.append(f"compile/build (duration events): "
                     f"{_fmt_us(total)} total")
        for name in sorted(by_event):
            durs = by_event[name]
            lines.append(f"  {name:48s} {len(durs):4d}x "
                         f"{_fmt_us(sum(durs)):>9s}")

    if trace["counters"]:
        span_end = max((s["ts"] + s["dur"] for s in trace["spans"]),
                       default=0.0)
        lines.append("counters:")
        for name in sorted(trace["counters"]):
            val = trace["counters"][name]
            rate = (f"  ({val / (span_end / 1e6):.1f}/s)"
                    if span_end > 0 else "")
            lines.append(f"  {name:28s} {val:>14.0f}{rate}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Diff: trace vs trace
# ---------------------------------------------------------------------------

def diff(a: Dict[str, Any], b: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Phase-by-phase steady-p50 comparison of two traces. Rows:
    ``name, a_us, b_us, delta_pct`` (positive = b slower); phases
    present in only one trace get ``None`` on the missing side."""
    ra = {r["name"]: r for r in summarize(a)}
    rb = {r["name"]: r for r in summarize(b)}
    rows = []
    for name in list(ra) + [n for n in rb if n not in ra]:
        xa = ra.get(name)
        xb = rb.get(name)
        va = xa["steady_p50_us"] if xa else None
        vb = xb["steady_p50_us"] if xb else None
        delta = (100.0 * (vb - va) / va
                 if va and vb is not None and va > 0 else None)
        rows.append({"name": name, "a_us": va, "b_us": vb,
                     "delta_pct": delta})
    return rows


def render_diff(rows: List[Dict[str, Any]], a_label: str,
                b_label: str) -> str:
    lines = [f"{'phase':28s} {'a (steady p50)':>15s} {'b':>12s} "
             f"{'delta':>8s}   a={a_label} b={b_label}"]
    for r in rows:
        a = _fmt_us(r["a_us"]) if r["a_us"] is not None else "-"
        b = _fmt_us(r["b_us"]) if r["b_us"] is not None else "-"
        d = f"{r['delta_pct']:+7.1f}%" if r["delta_pct"] is not None \
            else "       -"
        lines.append(f"{r['name']:28s} {a:>15s} {b:>12s} {d}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The regression gate: trace vs committed BENCH_<n>.json
# ---------------------------------------------------------------------------

def against(trace: Dict[str, Any], bench: Dict[str, Any],
            tolerance: float = 3.0) -> List[Dict[str, Any]]:
    """Match trace spans to bench rows by exact name and compare the
    span's steady p50 to the committed ``us_per_call``. Rows: ``name,
    trace_us, bench_us, ratio, ok`` — ``ok`` is False when the trace
    is more than ``tolerance``× slower (faster never fails; commit a
    new BENCH_<n>.json to bank an improvement).

    Raises ``ValueError`` when not a single name matches: a gate that
    silently compares nothing is worse than no gate."""
    if tolerance <= 0:
        raise ValueError(f"tolerance must be > 0, got {tolerance}")
    summary = {r["name"]: r for r in summarize(trace)}
    rows = []
    for name, bench_row in bench["by_name"].items():
        if name not in summary:
            continue
        bench_us = float(bench_row["us_per_call"])
        trace_us = summary[name]["steady_p50_us"]
        if bench_us <= 0:
            continue
        ratio = trace_us / bench_us
        rows.append({"name": name, "trace_us": trace_us,
                     "bench_us": bench_us, "ratio": ratio,
                     "ok": ratio <= tolerance})
    if not rows:
        raise ValueError(
            "no trace span matches any bench row by name — the gate "
            "compared nothing (did the benchmark section names change "
            "without re-recording BENCH_<n>.json?)")
    return rows


def render_against(rows: List[Dict[str, Any]], bench_label: str,
                   tolerance: float) -> str:
    lines = [f"{'row':36s} {'trace':>10s} {'bench':>10s} {'ratio':>7s}  "
             f"gate (tolerance {tolerance:g}x vs {bench_label})"]
    for r in rows:
        verdict = "ok" if r["ok"] else "REGRESSION"
        lines.append(f"{r['name']:36s} {_fmt_us(r['trace_us']):>10s} "
                     f"{_fmt_us(r['bench_us']):>10s} {r['ratio']:6.2f}x"
                     f"  {verdict}")
    n_bad = sum(1 for r in rows if not r["ok"])
    lines.append(f"{len(rows)} row(s) compared, {n_bad} regression(s)")
    return "\n".join(lines)
