"""Telemetry plane: request tracing, metrics registry, ops surface.

Three stdlib-only modules (importable from the deepest solver code
without dragging torch/pandas in):

* :mod:`.trace` — span trees following one request across admission →
  batch round → dispatch groups → certification (and the design
  phases), exported per request as ``trace.<rid>.json`` plus a Chrome
  trace-event timeline.
* :mod:`.registry` — thread-safe counters/gauges/histograms (fixed
  log buckets, so percentiles merge exactly across replicas) with
  bounded ring-buffer time series and a Prometheus text exposition the
  serve loop publishes next to its heartbeat (``telemetry.prom``).
* :mod:`.ops` — the ``status`` / ``trace`` CLIs.

``DERVET_TPU_TELEMETRY=0`` is a true kill switch: spans become the
shared no-op instance, registry population is skipped, and no telemetry
file is ever written — result artifacts are byte-identical either way.
"""
from . import registry, trace  # noqa: F401
from .registry import get_registry  # noqa: F401
from .trace import NOOP, Span, enabled, span, start_span, trace_id_for  # noqa: F401

__all__ = ["trace", "registry", "get_registry", "enabled", "span",
           "start_span", "trace_id_for", "Span", "NOOP"]
