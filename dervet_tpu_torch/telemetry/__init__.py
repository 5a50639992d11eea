"""Telemetry plane: request tracing, metrics registry, ops surface.

Three stdlib-only modules (importable from the deepest solver code
without dragging torch/pandas in):

* :mod:`.trace` — span trees following one request across admission →
  batch round → dispatch groups → certification (and the design
  phases), exported per request as ``trace.<rid>.json`` plus a Chrome
  trace-event timeline; and the product entry's own trace: every phase
  of ``DERVET.solve`` (prep, dispatch with its assembly, staging, groups,
  rungs, solver builds, captures and certification, the outage walks,
  post) is a :func:`~.trace.phase` under one ``valuation`` root.  A
  phase is always timed — ``Result.phase_seconds`` is summed from the
  phases — and records a span only when telemetry is on and its parent
  records, so direct solver calls and service rounds leave nothing in
  the collector.  The call's spans stay in memory as ``Result.trace``;
  an operator writes them with
  ``trace.export_chrome_trace(result.trace, path)``.  Their
  ``t_start`` is wall time (``time.time()``), the profiler's clock, so
  they join the PyTorch profiler's device trace as they are.
* :mod:`.registry` — thread-safe counters/gauges/histograms (fixed
  log buckets, so percentiles merge exactly across replicas) with
  bounded ring-buffer time series and a Prometheus text exposition the
  serve loop publishes next to its heartbeat (``telemetry.prom``).
* :mod:`.ops` — the ``status`` / ``trace`` CLIs.

``DERVET_TPU_TELEMETRY=0`` is a true kill switch: spans become the
shared no-op instance, phases only time themselves, registry population
is skipped, and no telemetry file is ever written — result artifacts
are byte-identical either way.
"""
from . import registry, trace  # noqa: F401
from .registry import get_registry  # noqa: F401
from .trace import (NOOP, Phase, Span, enabled, phase, span,  # noqa: F401
                    start_span, trace_id_for)

__all__ = ["trace", "registry", "get_registry", "enabled", "span",
           "start_span", "phase", "trace_id_for", "Span", "Phase", "NOOP"]
