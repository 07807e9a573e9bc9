"""Observability: the span tracer, the task registry, the profiler and
the slow logs (port of elasticsearch_tpu/tracing/).

This module owns the combined wire context: :func:`wire_context`
captures the active span and task as one JSON-safe header dict that the
TCP transport attaches to every frame (utils/wire.py::attach_ctx), and
:func:`adopt_wire_context` restores both on the receiving node, so a
coordinator's search is one trace over every remote shard owner and
cancelling a coordinator's task reaches its remote children.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional

from elasticsearch_tpu_torch.tracing import tasks as _tasks
from elasticsearch_tpu_torch.tracing import tracer as _tracer
from elasticsearch_tpu_torch.tracing.tasks import (TaskCancelledException,
                                                   TaskRegistry,
                                                   check_cancelled,
                                                   current_task)
from elasticsearch_tpu_torch.tracing.tracer import Span, Tracer

__all__ = ["Tracer", "Span", "TaskRegistry", "TaskCancelledException",
           "check_cancelled", "current_task", "wire_context",
           "adopt_wire_context"]


def wire_context() -> Optional[dict]:
    """The active span and task as one wire-header dict (None when the
    current flow is untraced and untasked)."""
    out = {}
    trace = _tracer.trace_header()
    if trace:
        out["trace"] = trace
    task = _tasks.task_header()
    if task:
        out["task"] = task
    return out or None


@contextmanager
def adopt_wire_context(ctx: Optional[dict]) -> Iterator[None]:
    """Adopt a received wire context for the duration of a handler:
    spans join the sender's trace, registered tasks become children of
    the sender's task."""
    if not ctx:
        yield
        return
    with _tracer.adopt(ctx.get("trace")):
        with _tasks.adopt_parent(ctx.get("task")):
            yield
