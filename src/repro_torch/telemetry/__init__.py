"""Structured runtime observability for the port's training and serving
paths: the port of ``repro.telemetry``, with the same record formats,
so each package's ``report`` reads the other's traces.

* :class:`Tracer` — phase-scoped spans (``with tracer.span("cycle"):``,
  arbitrarily nested), monotonically-accumulating counters
  (env-steps, cycles), explicit ``fence()`` (``torch.cuda.synchronize``
  where a value lives on the card) so a span's close is an honest
  device-complete timestamp, and the kernels' build and load captured as
  ``compile`` records through ``kernels.build``'s duration listeners.
* :class:`NullTracer` — same public API, every method a no-op, so hot
  paths take a tracer unconditionally and pay nothing when tracing is
  off (tests/test_torch_telemetry.py locks the API parity).
* Sinks — :class:`JsonlSink` (append-only JSON lines, the diffable
  machine format) and :class:`ChromeTraceSink` (Chrome ``trace_event``
  JSON, loadable in Perfetto / ``chrome://tracing``).
* :mod:`repro_torch.telemetry.report` — per-phase p50/p95 summaries,
  compile-vs-steady split, trace-vs-trace diff and trace-vs-committed
  ``BENCH_<n>.json`` checks (CLI:
  ``python -m repro_torch.launch.trace_report``).
* :func:`provenance` — git SHA + dirty flag, platform/CPU model, Python
  version; :func:`device_meta` — torch and CUDA versions and the card's
  name and power limit. The launchers stamp both into every trace
  header.

Tracing is host-side only: it launches nothing on the card, so a traced
run is bitwise equal to an untraced one (locked by test).
"""

from repro_torch.telemetry.device import device_meta
from repro_torch.telemetry.provenance import provenance
from repro_torch.telemetry.sinks import ChromeTraceSink, JsonlSink, MemorySink
from repro_torch.telemetry.tracer import (NullTracer, Tracer, chrome_path_for,
                                          make_tracer)

__all__ = [
    "Tracer", "NullTracer", "make_tracer", "chrome_path_for",
    "JsonlSink", "ChromeTraceSink", "MemorySink",
    "provenance", "device_meta",
]
