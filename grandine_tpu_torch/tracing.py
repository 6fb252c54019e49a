"""The disabled tracer (counterpart of grandine_tpu/tracing.py
`NULL_TRACER`, a `Tracer` with recording off): the span vocabulary the
verify scheduler and the backends open — `span(name, attrs)`, and the
cross-thread hop `capture()` on the dispatcher, `attach(ctx)` on the
settle thread — at no cost. A caller that wants spans passes its own
tracer with these three methods; the port has no recording tracer yet."""

from __future__ import annotations

from contextlib import nullcontext


class NullTracer:
    """Every span is a no-op context; `capture` hands over nothing."""

    enabled = False

    def span(self, name: str, attrs=None):
        return nullcontext()

    def capture(self):
        return None

    def attach(self, parent):
        return nullcontext()


#: the shared disabled tracer: modules default to it and never check for
#: None before opening spans
NULL_TRACER = NullTracer()

__all__ = ["NULL_TRACER", "NullTracer"]
