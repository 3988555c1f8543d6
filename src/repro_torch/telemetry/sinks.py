"""Trace sinks: where :class:`repro_torch.telemetry.Tracer` records go,
the port of ``repro.telemetry.sinks``. Fed the same records, each sink
writes the same bytes as the reference's, so either package's
``report`` reads the other's traces.

A sink is anything with ``write(record: dict)`` and ``close()``. The
tracer hands every sink the same flat records (schema below); the sink
owns the on-disk format. Two formats ship:

* :class:`JsonlSink` — one JSON object per line, appendable and
  greppable; the machine format ``trace_report`` and the tests consume.
* :class:`ChromeTraceSink` — the Chrome ``trace_event`` JSON format
  (``{"traceEvents": [...]}``), loadable in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``. Buffered and
  written at close, since the format is one JSON document.

Record schema (every record carries ``"t"``, the record type):

=========  ==============================================================
``meta``     trace header: ``provenance``, ``clock``, tracer ``attrs``
``span``     ``name, ts, dur, depth, parent, seq, attrs`` — a closed
             phase span; ``ts``/``dur`` are microseconds on the
             tracer's monotonic clock (``ts`` = span start)
``event``    ``name, ts, attrs`` — an instant
``compile``  ``name, ts, dur, attrs`` — a duration event: in the port a
             kernel source's ``nvcc`` build or its library's load
             (``kernels.build``); ``ts`` = start, like spans
``counter``  ``name, value, ts`` — final counter totals, one record
             each, emitted when the tracer closes
=========  ==============================================================
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

__all__ = ["JsonlSink", "ChromeTraceSink", "MemorySink"]


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)


class MemorySink:
    """Keeps records in a list — tests and in-process consumers."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self.closed = False

    def write(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    def close(self) -> None:
        self.closed = True


class JsonlSink:
    """Append-only JSON-lines trace file.

    ``extra_meta`` merges into the tracer's meta record for this sink
    only — how a packed sweep fleet writes the same span stream into
    each member run's ``trace.jsonl`` with per-run identity attached.
    """

    def __init__(self, path: str,
                 extra_meta: Optional[Dict[str, Any]] = None) -> None:
        _ensure_parent(path)
        self.path = path
        self._extra = dict(extra_meta or {})
        self._f = open(path, "w", buffering=1)

    def write(self, record: Dict[str, Any]) -> None:
        if record.get("t") == "meta" and self._extra:
            record = {**record, "attrs": {**record.get("attrs", {}),
                                          **self._extra}}
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()


# Chrome trace_event thread ids: phase spans on tid 0, compile events
# (the kernels' build and load) on tid 1, so Perfetto renders them as
# two lanes and a phase's overlap with the build it triggered shows.
# The lane keeps the reference's name, so both packages write the same
# bytes.
_TID_PHASE = 0
_TID_COMPILE = 1


class ChromeTraceSink:
    """Chrome ``trace_event`` exporter (open the file in Perfetto)."""

    def __init__(self, path: str, process_name: str = "repro") -> None:
        _ensure_parent(path)
        self.path = path
        self._events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": process_name}},
            {"ph": "M", "name": "thread_name", "pid": 0,
             "tid": _TID_PHASE, "args": {"name": "phases"}},
            {"ph": "M", "name": "thread_name", "pid": 0,
             "tid": _TID_COMPILE, "args": {"name": "jax compile"}},
        ]
        self._meta: Dict[str, Any] = {}
        self._closed = False

    def write(self, record: Dict[str, Any]) -> None:
        t = record.get("t")
        if t == "meta":
            self._meta = {k: v for k, v in record.items() if k != "t"}
        elif t == "span":
            self._events.append(
                {"ph": "X", "name": record["name"], "cat": "phase",
                 "pid": 0, "tid": _TID_PHASE, "ts": record["ts"],
                 "dur": record["dur"],
                 "args": dict(record.get("attrs", {}))})
        elif t == "compile":
            self._events.append(
                {"ph": "X", "name": record["name"], "cat": "compile",
                 "pid": 0, "tid": _TID_COMPILE, "ts": record["ts"],
                 "dur": record["dur"],
                 "args": dict(record.get("attrs", {}))})
        elif t == "event":
            self._events.append(
                {"ph": "i", "name": record["name"], "cat": "event",
                 "pid": 0, "tid": _TID_PHASE, "ts": record["ts"],
                 "s": "t", "args": dict(record.get("attrs", {}))})
        elif t == "counter":
            self._events.append(
                {"ph": "C", "name": record["name"], "pid": 0,
                 "tid": _TID_PHASE, "ts": record["ts"],
                 "args": {record["name"]: record["value"]}})

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        doc = {"traceEvents": self._events,
               "displayTimeUnit": "ms",
               "otherData": self._meta}
        with open(self.path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
