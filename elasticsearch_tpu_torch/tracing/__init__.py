"""Observability: the span tracer, the task registry, the profiler and
the slow logs (port of elasticsearch_tpu/tracing/). The reference's
combined wire context, which carries a span and a task across the
transport, comes with the multi-node layer (ROADMAP A10f)."""
from __future__ import annotations

from elasticsearch_tpu_torch.tracing.tasks import (TaskCancelledException,
                                                   TaskRegistry,
                                                   check_cancelled,
                                                   current_task)
from elasticsearch_tpu_torch.tracing.tracer import Span, Tracer

__all__ = ["Tracer", "Span", "TaskRegistry", "TaskCancelledException",
           "check_cancelled", "current_task"]
