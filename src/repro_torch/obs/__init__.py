"""Observability: per-query tracing (``trace``).  ``NULL_TRACER`` is the
~zero-cost disabled tracer the engine carries by default.  Stdlib only."""
from .trace import (NULL_SPAN, NULL_TRACER, NullTracer, Span, Trace,
                    Tracer)

__all__ = ["Tracer", "NullTracer", "Span", "Trace", "NULL_TRACER",
           "NULL_SPAN"]
