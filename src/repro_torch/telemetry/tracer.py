"""The tracer: phase-scoped spans, counters, compile-event capture. The
port of ``repro.telemetry.tracer``, with the same records, clock,
``seq`` and ``depth``.

Usage — the outer loop every launcher runs::

    tracer = make_tracer("runs/x/trace.jsonl", meta={"env": "catch"})
    with tracer.span("train"):
        for i in range(cycles):
            with tracer.span("cycle", index=i + 1):
                carry, m = trainer.cycle(carry)
                tracer.fence(m)            # the card has finished: the
            tracer.count("cycles", 1)      # span's close is device-complete
            tracer.count("env_steps", P * cycle_steps)
    tracer.close()

Design rules (as the reference's):

* **Host-side only.** A span is two clock reads on the host around
  eager work; it launches nothing and changes no tensor, so a traced run
  is bitwise equal to an untraced one (tests/test_torch_telemetry.py).
  The spans sit in the launcher's loop (cycle, eval, metrics,
  checkpoint); spans inside a cycle are not recorded.
* **Explicit fencing.** CUDA work is queued; a span that closes without
  :meth:`Tracer.fence` measures the host's enqueue, not the card.
  ``fence`` waits for the whole device (``torch.cuda.synchronize``), not
  for an event on the current stream: ``core/host_runner.py`` queues
  updates on a trainer stream of its own, which an event on the current
  stream would not wait for. :class:`NullTracer`'s ``fence`` does
  nothing; waiting changes no value, so both stay bitwise equal.
* **Zero cost when off.** :class:`NullTracer` has the identical public
  surface with every method a no-op returning the same types; hot paths
  take a tracer unconditionally.
* **Compile visibility.** The reference records ``jax.monitoring``'s
  compile events. The port's counterpart is the kernels' ``nvcc`` build
  and library load (``kernels.build``'s duration listeners): they are
  recorded while a tracer is active, with the phase that was open, so
  ``trace_report``'s first-versus-steady split shows a first cycle's
  build or load.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.telemetry.provenance import provenance
from repro_torch.telemetry.sinks import ChromeTraceSink, JsonlSink

__all__ = ["Tracer", "NullTracer", "make_tracer", "chrome_path_for"]

# ---------------------------------------------------------------------------
# kernels.build's duration events fan out to the active tracers: one
# process-wide listener, registered once (the build module keeps its
# listeners for the life of the process), and tracers add and remove
# themselves.
# ---------------------------------------------------------------------------

_ACTIVE: List["Tracer"] = []
_LISTENER_LOCK = threading.Lock()
_LISTENER_INSTALLED = False


def _dispatch_duration(event: str, duration: float, **kwargs) -> None:
    for tracer in list(_ACTIVE):
        tracer._on_monitor_event(event, duration)


def _install_listener() -> None:
    """Register the fan-out listener with ``kernels.build`` once."""
    global _LISTENER_INSTALLED
    with _LISTENER_LOCK:
        if not _LISTENER_INSTALLED:
            from repro_torch.kernels import build
            build.register_event_duration_secs_listener(_dispatch_duration)
            _LISTENER_INSTALLED = True


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value``'s dicts, lists and
    tuples (named tuples included)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class _Span:
    """Reusable span context: records one ``span`` record on exit."""

    __slots__ = ("_tracer", "_name", "_attrs", "_start")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._tracer._stack.append(self._name)
        self._start = self._tracer._now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = self._tracer._now_us()
        tr = self._tracer
        tr._stack.pop()
        tr._emit_span(self._name, self._start, end - self._start,
                      depth=len(tr._stack) + 1,
                      parent=tr._stack[-1] if tr._stack else None,
                      attrs=self._attrs)


class Tracer:
    """Records phase spans, counters and compile events into sinks.

    ``sinks`` is any iterable of objects with ``write(dict)``/
    ``close()`` (see :mod:`repro_torch.telemetry.sinks`); an empty list
    is a *counter-only* tracer — spans still tick the clock (so
    throughput lines can be derived) but nothing is written anywhere.
    ``meta`` lands in the trace header beside :func:`provenance`.
    """

    def __init__(self, sinks: Iterable = (),
                 meta: Optional[Dict[str, Any]] = None,
                 capture_compiles: bool = True,
                 with_provenance: bool = True) -> None:
        self._sinks = list(sinks)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._stack: List[str] = []
        self._seq = 0
        self._counters: Dict[str, float] = {}
        self._closed = False
        if self._sinks:
            self._write({"t": "meta", "version": 1,
                         "clock": "perf_counter_us",
                         "provenance": provenance() if with_provenance
                         else None,
                         "attrs": dict(meta or {})})
        if capture_compiles:
            _install_listener()
            _ACTIVE.append(self)

    # -- clock -------------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _to_us(self, perf_counter_s: float) -> float:
        """A raw ``time.perf_counter()`` reading -> this trace's clock."""
        return (perf_counter_s - self._t0) * 1e6

    # -- record emission ---------------------------------------------------

    def _write(self, record: Dict[str, Any]) -> None:
        with self._lock:
            for sink in self._sinks:
                sink.write(record)

    def _emit_span(self, name: str, ts: float, dur: float, depth: int,
                   parent: Optional[str], attrs: Dict[str, Any]) -> None:
        self._seq += 1
        if self._sinks:
            self._write({"t": "span", "name": name, "ts": round(ts, 3),
                         "dur": round(dur, 3), "depth": depth,
                         "parent": parent, "seq": self._seq,
                         "attrs": attrs})

    def _on_monitor_event(self, event: str, duration_s: float) -> None:
        if self._closed or not self._sinks:
            return
        dur = duration_s * 1e6
        now = self._now_us()
        self._write({"t": "compile", "name": event,
                     "ts": round(max(now - dur, 0.0), 3),
                     "dur": round(dur, 3),
                     "attrs": {"phase": self._stack[-1]
                               if self._stack else None}})

    # -- public API (NullTracer mirrors every method below) ----------------

    def span(self, name: str, **attrs) -> _Span:
        """Context manager timing one phase; nest freely."""
        return _Span(self, name, attrs)

    def count(self, name: str, n: float = 1) -> None:
        """Accumulate a monotonic counter (totals written at close)."""
        self._counters[name] = self._counters.get(name, 0.0) + n

    def event(self, name: str, **attrs) -> None:
        """An instant marker."""
        if self._sinks:
            self._write({"t": "event", "name": name,
                         "ts": round(self._now_us(), 3), "attrs": attrs})

    def point(self, name: str, dur_us: float, **attrs) -> None:
        """A pre-measured duration, recorded as a span ending now — how a
        benchmark mirrors its recorded rows into the trace so that
        ``trace_report --against BENCH_<n>.json`` matches rows to spans
        by name."""
        end = self._now_us()
        self._emit_span(name, max(end - dur_us, 0.0), dur_us,
                        depth=len(self._stack) + 1,
                        parent=self._stack[-1] if self._stack else None,
                        attrs=dict(attrs, point=True))

    def complete(self, name: str, start_s: float, end_s: float,
                 **attrs) -> None:
        """A span from explicit ``time.perf_counter()`` readings — for
        durations that began before a code block was entered (e.g. a
        request's queue wait, clocked from its submit timestamp)."""
        self._emit_span(name, self._to_us(start_s),
                        (end_s - start_s) * 1e6,
                        depth=len(self._stack) + 1,
                        parent=self._stack[-1] if self._stack else None,
                        attrs=attrs)

    def fence(self, value):
        """Wait until the card has finished everything queued, if any
        tensor of ``value`` (through its dicts, lists and tuples) lives
        on CUDA, so that a span closes on device-complete rather than
        on enqueue-complete. Returns ``value`` unchanged."""
        for device in _cuda_devices(value, set()):
            torch.cuda.synchronize(device)
        return value

    @property
    def counters(self) -> Dict[str, float]:
        """Current counter totals (a live view for throughput lines)."""
        return dict(self._counters)

    @property
    def enabled(self) -> bool:
        """True when records are being written anywhere."""
        return bool(self._sinks)

    def close(self) -> None:
        """Flush counter totals and close every sink. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        now = round(self._now_us(), 3)
        if self._sinks:
            for name in sorted(self._counters):
                self._write({"t": "counter", "name": name,
                             "value": self._counters[name], "ts": now})
        for sink in self._sinks:
            sink.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class _NullSpan:
    """The shared no-op span context (one instance, zero allocation)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """API-parity no-op tracer: hot paths hold one of these when tracing
    is off and pay nothing — no clock reads, no dict writes, no waiting
    on the card. tests/test_torch_telemetry.py asserts the public
    surface matches :class:`Tracer` method for method."""

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str, n: float = 1) -> None:
        return None

    def event(self, name: str, **attrs) -> None:
        return None

    def point(self, name: str, dur_us: float, **attrs) -> None:
        return None

    def complete(self, name: str, start_s: float, end_s: float,
                 **attrs) -> None:
        return None

    def fence(self, value):
        return value

    @property
    def counters(self) -> Dict[str, float]:
        return {}

    @property
    def enabled(self) -> bool:
        return False

    def close(self) -> None:
        return None

    def __enter__(self) -> "NullTracer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


def chrome_path_for(jsonl_path: str) -> str:
    """The Chrome-trace twin of a JSONL trace path
    (``x.jsonl`` -> ``x.chrome.json``; other names get the suffix)."""
    base = jsonl_path[:-6] if jsonl_path.endswith(".jsonl") else jsonl_path
    return base + ".chrome.json"


def make_tracer(path: Optional[str] = None,
                meta: Optional[Dict[str, Any]] = None,
                chrome: bool = True,
                capture_compiles: bool = True) -> Tracer:
    """The standard launcher wiring: ``path=None`` builds a counter-only
    :class:`Tracer` (throughput lines work, nothing is written); a path
    builds a JSONL sink there plus — when ``chrome`` — the Perfetto
    twin at :func:`chrome_path_for`. Traces overwrite (a resumed run
    records a fresh trace; the training state is what resumes, not the
    diagnostics)."""
    if path is None:
        return Tracer((), meta=meta, capture_compiles=False)
    sinks: List[Any] = [JsonlSink(path)]
    if chrome:
        sinks.append(ChromeTraceSink(chrome_path_for(path)))
    return Tracer(sinks, meta=meta, capture_compiles=capture_compiles)
