"""The port's telemetry (``repro_torch.telemetry``) against the JAX
package's, on the CPU:

1. spans nest and order (depth, parent, seq), counters, ``point`` and
   ``complete``; the JSONL and Chrome sinks round-trip;
2. fed the same records, both packages' sinks write the same bytes, and
   each package's ``summarize`` reads the other's traces;
3. ``NullTracer`` has ``Tracer``'s API method for method (and the
   reference's), writes nothing and fences nothing; ``fence`` waits on
   every CUDA device its value holds and returns the value;
4. the kernels' build and load reach a trace as ``compile`` records
   through ``kernels.build``'s duration listeners, only while a tracer
   is active, with the phase that was open;
5. ``report`` summarizes (first versus steady, coverage), diffs, and
   gates against a BENCH file; the ``trace_report`` CLI;
6. the policy server's ``serve.flush``, ``serve.queue_wait`` and
   ``serve.compute`` spans and ``serve.actions`` counter
   (``serve_policy --trace``: tests/test_torch_serve_policy.py);
7. a traced launcher run is bitwise equal to an untraced one, and its
   trace holds the reference's spans and counters.
"""

import inspect
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.telemetry as jtel
from repro.telemetry import report as jreport
from repro_torch.kernels import build
from repro_torch.launch import trace_report as trace_report_cli
from repro_torch.telemetry import (JsonlSink, MemorySink, NullTracer, Tracer,
                                   chrome_path_for, device_meta, make_tracer,
                                   report)
from repro_torch.telemetry import tracer as tracer_mod

ROOT = Path(__file__).resolve().parents[1]


def _records(tr):
    """A fixed span/event/counter stream into ``tr``."""
    with tr.span("train", cycles=2):
        for i in range(2):
            with tr.span("cycle", index=i + 1):
                with tr.span("inner"):
                    pass
            tr.count("cycles", 1)
            tr.count("env_steps", 128)
        tr.event("marker", note="hi")
        tr.point("cycle_dqn_p1", 1500.0, derived="x")
        a = time.perf_counter()
        tr.complete("queue_wait", a - 0.01, a, batch=4)
    tr.close()


# ---------------------------------------------------------------------------
# 1. spans, nesting, sinks
# ---------------------------------------------------------------------------

def test_span_nesting_depth_parent_seq():
    sink = MemorySink()
    tr = Tracer([sink], capture_compiles=False, with_provenance=False)
    with tr.span("train"):
        with tr.span("cycle"):
            with tr.span("inner"):
                pass
        with tr.span("eval"):
            pass
    tr.close()
    spans = {r["name"]: r for r in sink.records if r["t"] == "span"}
    assert set(spans) == {"train", "cycle", "inner", "eval"}
    assert spans["train"]["depth"] == 1 and spans["train"]["parent"] is None
    assert spans["cycle"]["depth"] == 2 and spans["cycle"]["parent"] == "train"
    assert spans["inner"]["depth"] == 3 and spans["inner"]["parent"] == "cycle"
    assert spans["eval"]["parent"] == "train"
    assert (spans["inner"]["seq"] < spans["cycle"]["seq"]
            < spans["eval"]["seq"] < spans["train"]["seq"])
    for child, parent in (("inner", "cycle"), ("cycle", "train"),
                          ("eval", "train")):
        c, p = spans[child], spans[parent]
        assert c["ts"] >= p["ts"] - 1e-6
        assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-6
    assert sink.closed


def test_counters_point_and_complete():
    sink = MemorySink()
    tr = Tracer([sink], capture_compiles=False, with_provenance=False)
    tr.count("env_steps", 128)
    tr.count("env_steps", 128)
    tr.count("cycles")
    assert tr.counters == {"env_steps": 256.0, "cycles": 1.0}
    tr.point("cycle_dqn_p1", 1500.0, derived="x")
    a = time.perf_counter()
    tr.complete("queue_wait", a, a + 0.01, batch=4)
    tr.close()
    tr.close()                          # idempotent: no second counters
    counters = {r["name"]: r["value"] for r in sink.records
                if r["t"] == "counter"}
    assert counters == {"env_steps": 256.0, "cycles": 1.0}
    assert sum(r["t"] == "counter" for r in sink.records) == 2
    spans = {r["name"]: r for r in sink.records if r["t"] == "span"}
    assert spans["cycle_dqn_p1"]["dur"] == pytest.approx(1500.0)
    assert spans["cycle_dqn_p1"]["attrs"]["point"] is True
    assert spans["queue_wait"]["dur"] == pytest.approx(1e4, rel=1e-3)
    assert spans["queue_wait"]["attrs"] == {"batch": 4}


def test_jsonl_and_chrome_round_trip(tmp_path):
    path = str(tmp_path / "x" / "t.jsonl")        # parent dir created
    tr = make_tracer(path, meta={"env": "catch"}, capture_compiles=False)
    assert tr.enabled
    _records(tr)
    trace = report.load_trace(path)
    assert trace["meta"]["attrs"] == {"env": "catch"}
    assert set(trace["meta"]["provenance"]) >= {
        "git_sha", "git_dirty", "platform", "cpu_model", "python_version"}
    assert [s["name"] for s in trace["spans"]][:3] == \
        ["inner", "cycle", "inner"]
    assert trace["counters"] == {"cycles": 2.0, "env_steps": 256.0}
    assert [e["name"] for e in trace["events"]] == ["marker"]
    chrome = chrome_path_for(path)
    assert chrome == str(tmp_path / "x" / "t.chrome.json")
    assert chrome_path_for("t.log") == "t.log.chrome.json"
    with open(chrome) as f:
        doc = json.load(f)
    byname = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    c, p = byname["cycle"], byname["train"]
    assert c["ts"] >= p["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"]
    assert any(e["ph"] == "C" and e["args"] == {"cycles": 2.0}
               for e in doc["traceEvents"])
    assert doc["otherData"]["attrs"] == {"env": "catch"}
    # counter-only: counters work, nothing is written
    tr = make_tracer(None)
    assert not tr.enabled
    with tr.span("cycle"):
        tr.count("cycles", 1)
    assert tr.counters == {"cycles": 1.0}
    tr.close()


def test_jsonl_extra_meta_per_sink(tmp_path):
    pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    tr = Tracer([JsonlSink(pa, extra_meta={"run": "run000"}),
                 JsonlSink(pb, extra_meta={"run": "run001"})],
                meta={"fleet": "fleet000"}, capture_compiles=False,
                with_provenance=False)
    with tr.span("cycle"):
        pass
    tr.close()
    ta, tb = report.load_trace(pa), report.load_trace(pb)
    assert ta["meta"]["attrs"] == {"fleet": "fleet000", "run": "run000"}
    assert tb["meta"]["attrs"] == {"fleet": "fleet000", "run": "run001"}
    assert ta["spans"] == tb["spans"]


# ---------------------------------------------------------------------------
# 2. across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["jsonl", "chrome", "jsonl-extra"])
def test_sinks_write_the_reference_bytes(tmp_path, kind):
    """The same records through both packages' sinks, byte for byte."""
    sink = MemorySink()
    _records(Tracer([sink], meta={"env": "catch"}, capture_compiles=False,
                    with_provenance=False))
    paths = []
    for pkg, mod in (("t", sys.modules["repro_torch.telemetry.sinks"]),
                     ("j", sys.modules["repro.telemetry.sinks"])):
        path = str(tmp_path / f"{pkg}.out")
        s = (mod.ChromeTraceSink(path) if kind == "chrome" else
             mod.JsonlSink(path, extra_meta={"run": "r"}
                           if kind == "jsonl-extra" else None))
        for rec in sink.records:
            s.write(rec)
        s.close()
        paths.append(path)
    assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()


def test_each_report_reads_the_others_traces(tmp_path):
    tpath, jpath = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    _records(make_tracer(tpath, capture_compiles=False))
    _records(jtel.make_tracer(jpath, capture_compiles=False))
    for path in (tpath, jpath):
        mine, theirs = report.load_trace(path), jreport.load_trace(path)
        assert report.summarize(mine) == jreport.summarize(theirs)
        assert report.summarize(theirs) == jreport.summarize(mine)
        assert (report.phase_coverage(mine, "train")
                == jreport.phase_coverage(theirs, "train"))
    rows = report.summarize(report.load_trace(jpath))
    assert [r["name"] for r in rows] == ["inner", "cycle", "cycle_dqn_p1",
                                         "queue_wait", "train"]
    assert {r["name"]: r["count"] for r in rows}["cycle"] == 2


# ---------------------------------------------------------------------------
# 3. NullTracer, fence
# ---------------------------------------------------------------------------

def _public_api(cls):
    # parameters only: return annotations legitimately differ
    return {n: str(inspect.signature(m).parameters.values()) for n, m in
            inspect.getmembers(cls, callable)
            if not n.startswith("_") or n in ("__enter__", "__exit__")}


@pytest.mark.parametrize("pair", ["port", "reference"])
def test_null_tracer_api_parity(pair):
    real = _public_api(Tracer if pair == "port" else jtel.Tracer)
    null = _public_api(NullTracer)
    assert real == null
    assert set(_public_api(Tracer)) == set(_public_api(jtel.Tracer))
    for prop in ("counters", "enabled"):
        assert isinstance(inspect.getattr_static(NullTracer, prop), property)


def test_null_tracer_is_inert(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    tr = NullTracer()
    with tr.span("cycle", index=1):
        with tr.span("inner"):
            pass
    tr.count("cycles", 5)
    tr.event("x")
    tr.point("y", 10.0)
    tr.complete("z", 0.0, 1.0)
    x = torch.arange(3)
    assert tr.fence(x) is x
    assert tr.counters == {} and not tr.enabled
    tr.close()
    assert os.listdir(tmp_path) == [] and synced == []


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for fence's walk."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", self._index)


def test_fence_waits_on_each_cuda_device_and_returns_value(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    tr = Tracer((), capture_compiles=False)
    x = torch.arange(4)
    value = (x, {"a": x, "b": [x]})
    assert tr.fence(value) is value and synced == []
    a = torch.zeros(2).as_subclass(_OnCard)
    a._index = 0
    b = torch.zeros(2).as_subclass(_OnCard)
    b._index = 1
    nested = {"m": (x, [a]), "n": {"k": b}, "o": "not a tensor", "p": 3}
    assert tr.fence(nested) is nested
    assert sorted(d.index for d in synced) == [0, 1]
    tr.close()


# ---------------------------------------------------------------------------
# 4. compile records from the kernels' build and load
# ---------------------------------------------------------------------------

def test_build_events_captured_only_while_active():
    sink = MemorySink()
    tr = Tracer([sink], with_provenance=False)
    with tr.span("cycle"):
        build.record_event_duration_secs("/repro_torch/kernels/load/x", 0.5)
    tr.close()
    build.record_event_duration_secs("/repro_torch/kernels/load/late", 0.5)
    off = Tracer([MemorySink()], capture_compiles=False)
    build.record_event_duration_secs("/repro_torch/kernels/load/off", 0.5)
    off.close()
    compiles = [r for r in sink.records if r["t"] == "compile"]
    assert [(c["name"], c["attrs"]) for c in compiles] == [
        ("/repro_torch/kernels/load/x", {"phase": "cycle"})]
    assert compiles[0]["dur"] == pytest.approx(5e5)
    assert tracer_mod._ACTIVE == []


def test_build_all_reports_each_nvcc_build(tmp_path, monkeypatch):
    """build_all with a stand-in compiler (it writes the library file):
    one duration event per source built, none once they exist."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys, time\n"
                    "time.sleep(0.05)\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'w').write('lib')\nprint('ok', sys.argv[-1])\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    path = str(tmp_path / "t.jsonl")
    tr = make_tracer(path)
    with tr.span("init"):
        reports = build.build_all()
    tr.close()
    assert sorted(reports) == sorted(build.SOURCES)
    assert all("ok" in text for text in reports.values())
    trace = report.load_trace(path)
    got = sorted(c["name"] for c in trace["compiles"])
    assert got == sorted(f"/repro_torch/kernels/nvcc/{n}"
                         for n in build.SOURCES)
    assert all(c["attrs"] == {"phase": "init"} and c["dur"] >= 5e4
               for c in trace["compiles"])
    assert "compile/build" in report.render_summary(trace)
    assert build.build_all() == {}


# ---------------------------------------------------------------------------
# 5. report and the CLI
# ---------------------------------------------------------------------------

def _synthetic_trace(path, cycle_us, extra=()):
    ts, seq = 0.0, 0
    records = [{"t": "meta", "version": 1, "clock": "perf_counter_us",
                "provenance": None, "attrs": {}}]
    for i, dur in enumerate(cycle_us):
        seq += 1
        records.append({"t": "span", "name": "cycle", "ts": ts, "dur": dur,
                        "depth": 2, "parent": "train", "seq": seq,
                        "attrs": {"index": i + 1}})
        ts += dur
    for name, dur in extra:
        seq += 1
        records.append({"t": "span", "name": name, "ts": ts, "dur": dur,
                        "depth": 2, "parent": "train", "seq": seq,
                        "attrs": {}})
        ts += dur
    records.append({"t": "span", "name": "train", "ts": 0.0, "dur": ts,
                    "depth": 1, "parent": None, "seq": seq + 1, "attrs": {}})
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _bench_file(path, rows):
    with open(path, "w") as f:
        json.dump({"meta": {}, "rows": rows}, f)
    return str(path)


def test_summarize_diff_and_against(tmp_path):
    trace = report.load_trace(_synthetic_trace(
        tmp_path / "a.jsonl", [1000.0, 100.0, 110.0, 90.0, 100.0]))
    rows = {r["name"]: r for r in report.summarize(trace)}
    assert rows["cycle"]["count"] == 5
    assert rows["cycle"]["first_us"] == pytest.approx(1000.0)
    assert rows["cycle"]["steady_p50_us"] == pytest.approx(100.0)
    assert rows["cycle"]["p95_us"] == pytest.approx(1000.0)
    assert rows["cycle"]["pct_of_parent"] == pytest.approx(100.0)
    assert report.phase_coverage(trace, "train") == pytest.approx(1.0)
    assert "coverage[train]" in report.render_summary(trace)

    a = _synthetic_trace(tmp_path / "b.jsonl", [500.0, 100.0, 100.0],
                         extra=[("only_a", 50.0)])
    b = _synthetic_trace(tmp_path / "c.jsonl", [500.0, 150.0, 150.0])
    drows = {r["name"]: r for r in
             report.diff(report.load_trace(a), report.load_trace(b))}
    assert drows["cycle"]["delta_pct"] == pytest.approx(50.0)
    assert drows["only_a"]["b_us"] is None
    assert "+50.0%" in report.render_diff(list(drows.values()), "a", "b")

    trace = report.load_trace(
        _synthetic_trace(tmp_path / "t.jsonl", [900.0, 100.0, 100.0]))
    bench = report.load_bench(_bench_file(
        tmp_path / "bench.json",
        [{"name": "cycle", "us_per_call": 80.0, "derived": ""},
         {"name": "unrelated", "us_per_call": 1.0, "derived": ""}]))
    rows = report.against(trace, bench, tolerance=2.0)
    assert len(rows) == 1 and rows[0]["ok"]
    assert rows[0]["ratio"] == pytest.approx(1.25)
    rows = report.against(trace, bench, tolerance=1.1)
    assert not rows[0]["ok"]
    assert "REGRESSION" in report.render_against(rows, "bench.json", 1.1)
    empty = report.load_bench(_bench_file(
        tmp_path / "none.json", [{"name": "x", "us_per_call": 1.0}]))
    with pytest.raises(ValueError, match="no trace span matches"):
        report.against(trace, empty)


def test_trace_report_cli(tmp_path, capsys):
    path = _synthetic_trace(tmp_path / "t.jsonl", [900.0, 100.0, 100.0],
                            extra=[("eval", 30.0)])
    ok = _bench_file(tmp_path / "ok.json",
                     [{"name": "cycle", "us_per_call": 90.0}])
    bad = _bench_file(tmp_path / "bad.json",
                      [{"name": "cycle", "us_per_call": 1.0}])
    main = trace_report_cli.main
    assert main([path]) == 0
    assert main([path, "--require-phases", "cycle,eval",
                 "--min-coverage", "0.95", "--root", "train"]) == 0
    assert main([path, "--require-phases", "cycle,checkpoint"]) == 1
    assert main([path, "--min-coverage", "0.95", "--root", "nope"]) == 1
    assert main([path, "--against", ok, "--tolerance", "3"]) == 0
    assert main([path, "--against", bad, "--tolerance", "3"]) == 1
    assert main([path, "--diff", path]) == 0
    assert main([str(tmp_path / "missing.jsonl")]) == 2
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps({"t": "meta", "attrs": {}}) + "\n")
    assert main([str(empty)]) == 2
    out = capsys.readouterr().out
    assert "steady50" in out and "FAIL: required phase(s)" in out


# ---------------------------------------------------------------------------
# 6. serving
# ---------------------------------------------------------------------------

def test_policy_server_flush_spans():
    from repro_torch.api.serve import PolicyServer, ServeSpec
    from repro_torch.envs.preprocess import ObsPipeline

    pipe = ObsPipeline("vector", (3,), torch.float32)

    def qf(params, obs, noise_key=None):
        return torch.tensor([0.0, 1.0]).repeat(obs.shape[0], 1)

    params = {"w": torch.zeros(1)}
    sink = MemorySink()
    tracer = Tracer([sink], capture_compiles=False, with_provenance=False)
    server = PolicyServer(params, qf, pipe, frame_stack=2, n_actions=2,
                          serve=ServeSpec(policy="greedy", max_batch=4),
                          tracer=tracer)
    for sid in range(6):                     # 6 requests, max_batch 4
        server.submit(sid, np.zeros(3, np.float32), first=True)
    actions = server.flush()
    tracer.close()
    assert len(actions) == 6
    spans = [r for r in sink.records if r["t"] == "span"]
    names = [s["name"] for s in spans]
    assert names.count("serve.compute") == 2
    assert names.count("serve.queue_wait") == 2
    assert names.count("serve.flush") == 1
    flush = next(s for s in spans if s["name"] == "serve.flush")
    assert flush["attrs"] == {"tick": 0, "requests": 6}
    compute = [s for s in spans if s["name"] == "serve.compute"]
    assert sorted(c["attrs"]["batch"] for c in compute) == [2, 4]
    assert all(c["parent"] == "serve.flush" for c in compute)
    assert {r["name"]: r["value"] for r in sink.records
            if r["t"] == "counter"} == {"serve.actions": 6.0}
    # the same server without a tracer serves the same actions
    server2 = PolicyServer(params, qf, pipe, frame_stack=2, n_actions=2,
                           serve=ServeSpec(policy="greedy", max_batch=4))
    for sid in range(6):
        server2.submit(sid, np.zeros(3, np.float32), first=True)
    assert server2.flush() == actions


# ---------------------------------------------------------------------------
# 7. the launcher: traced and untraced runs are bitwise equal
# ---------------------------------------------------------------------------

def test_traced_launcher_run_is_bitwise_untraced(tmp_path, capsys):
    from repro_torch.launch import rl_train
    torch.set_num_threads(1)
    spec = tmp_path / "spec.json"
    spec.write_text((ROOT / "examples" / "specs" /
                     "rainbow_fleet.json").read_text())
    outs = {}
    for name, extra in (("plain", ()),
                        ("traced", ("--trace", str(tmp_path / "t.jsonl")))):
        d = tmp_path / name
        assert rl_train.main([
            "--spec", str(spec), "--device", "cpu", "--seeds", "2",
            "--envs", "4", "--cycles", "2", "--cycle-steps", "16",
            "--prepopulate", "32", "--eval-every", "1",
            "--ckpt-dir", str(d), "--metrics-jsonl", str(d / "m.jsonl"),
            *extra]) == 0
        outs[name] = d
    assert "trace written" in capsys.readouterr().out
    a, b = outs["plain"], outs["traced"]
    assert (a / "m.jsonl").read_bytes() == (b / "m.jsonl").read_bytes()
    with np.load(a / "step_00000002.npz") as xa, \
            np.load(b / "step_00000002.npz") as xb:
        assert sorted(xa.files) == sorted(xb.files)
        for k in xa.files:
            np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)
    trace = report.load_trace(str(tmp_path / "t.jsonl"))
    names = [s["name"] for s in trace["spans"]]
    assert names.count("cycle") == 2 and names.count("eval") == 2
    assert {"init", "train", "metrics", "checkpoint"} <= set(names)
    assert trace["counters"] == {"cycles": 2.0, "env_steps": 2 * 2 * 16.0}
    assert report.phase_coverage(trace, "train") >= 0.9
    attrs = trace["meta"]["attrs"]
    assert attrs["kind"] == "rl_train" and attrs["seeds"] == 2
    assert attrs == {**attrs, **device_meta("cpu")}
    assert os.path.exists(tmp_path / "t.chrome.json")
    # the reference's report and CLI read the port's trace
    assert (jreport.summarize(jreport.load_trace(str(tmp_path / "t.jsonl")))
            == report.summarize(trace))
