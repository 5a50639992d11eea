"""Telemetry plane: request tracing (``trace``).  Stdlib only."""
from . import trace  # noqa: F401
from .trace import NOOP, Span, enabled, span, start_span, trace_id_for  # noqa: F401

__all__ = ["trace", "enabled", "span", "start_span", "trace_id_for", "Span",
           "NOOP"]
