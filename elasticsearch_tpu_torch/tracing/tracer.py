"""Span tracer: monotonic-clock spans with parent/child links.

Port of elasticsearch_tpu/tracing/tracer.py. ES 2.x has no tracer; its
closest ancestors are the search Profile API's timing tree
(search/profile/Profiler.java) and the task manager's start times. Each
instrumented layer opens a span; the profiler and the slow logs read
the same clocks. The node's ``Tracer`` (``Node.tracer``) is handed to its
residency registry, where every rehydration of an evicted device copy
files a ``tpu.rehydrate`` span with its label, tier and bytes.

Clock discipline: span durations come from ``time.perf_counter()``;
the wall clock (``time.time()``) only stamps the epoch-millis display
timestamp a span carries for humans.

Propagation is ``contextvars``-based, so a span follows the request
across nested calls in one flow of execution; ``trace_header`` and
``adopt`` carry it across a process boundary as a header dict.
"""
from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


@dataclass(frozen=True)
class SpanContext:
    """The propagated identity of an active span (local or remote)."""

    trace_id: str
    span_id: str


# the active span context for THIS logical flow of execution; survives
# nested tracer.span() blocks and is restored on exit
_ACTIVE: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("estpu-active-span", default=None)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    node: str
    # perf_counter seconds at open; duration filled on close
    start: float
    duration: float = 0.0
    # wall-clock display timestamp (epoch millis) — NOT used for any
    # duration math
    timestamp_ms: int = 0
    thread: int = 0
    tags: Dict[str, Any] = field(default_factory=dict)
    error: Optional[str] = None

    def to_json(self) -> dict:
        out = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "node": self.node,
            "timestamp_ms": self.timestamp_ms,
            "duration_nanos": int(self.duration * 1e9),
        }
        if self.tags:
            out["tags"] = dict(self.tags)
        if self.error:
            out["error"] = self.error
        return out


def current_context() -> Optional[SpanContext]:
    return _ACTIVE.get()


def trace_header() -> Optional[dict]:
    """The active span as a wire-header dict (None when untraced)."""
    ctx = _ACTIVE.get()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


@contextmanager
def adopt(header: Optional[dict]) -> Iterator[None]:
    """Adopt a remote parent span from a wire header: spans opened inside
    join the remote trace as children of the sender's span."""
    if not header or not header.get("trace_id"):
        yield
        return
    token = _ACTIVE.set(SpanContext(str(header["trace_id"]),
                                    str(header.get("span_id") or "")))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


class Tracer:
    """Per-node span recorder with a bounded finished-span ring.

    The ring bounds memory the way the translog-recovery event ring does
    (monitor/stats.py): counters stay exact forever, per-span detail is
    last-N. 4096 spans ≈ a few hundred requests of full detail — enough
    for the flamegraph dump to show the recent past.
    """

    def __init__(self, node_id: str = "", max_spans: int = 4096):
        self.node_id = node_id
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        self.started_total = 0
        self.finished_total = 0
        # optional finished-span sink (monitor/metrics.py::span_sink):
        # every close also lands in a latency histogram, so the span
        # substrate doubles as continuous time-series
        self._sink = None

    def set_sink(self, sink) -> None:
        """``sink(span)`` called after every span close (outside the
        ring lock). It must be cheap; a sink failure is swallowed —
        dropping one metric sample must never fail the request the span
        measured."""
        self._sink = sink

    @contextmanager
    def span(self, name: str, **tags: Any) -> Iterator[Span]:
        parent = _ACTIVE.get()
        trace_id = parent.trace_id if parent else _new_id()
        sp = Span(name=name, trace_id=trace_id, span_id=_new_id(),
                  parent_id=parent.span_id if parent else None,
                  node=self.node_id, start=time.perf_counter(),
                  timestamp_ms=int(time.time() * 1000),
                  thread=threading.get_ident(), tags=dict(tags))
        with self._lock:
            self.started_total += 1
        token = _ACTIVE.set(SpanContext(trace_id, sp.span_id))
        try:
            yield sp
        except BaseException as e:
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            _ACTIVE.reset(token)
            sp.duration = time.perf_counter() - sp.start
            with self._lock:
                self.finished_total += 1
                self._spans.append(sp)
            sink = self._sink
            if sink is not None:
                try:
                    sink(sp)
                except Exception:  # one dropped sample, never a failure
                    pass

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def stats(self) -> dict:
        with self._lock:
            return {"started_total": self.started_total,
                    "finished_total": self.finished_total,
                    "retained": len(self._spans)}

    def chrome_trace(self) -> dict:
        """The finished-span ring in Chrome trace-event format (chrome://
        tracing, Perfetto, speedscope all read it): complete events
        ("ph": "X") with microsecond ts/dur on the perf_counter timebase,
        one row per originating thread."""
        events = []
        pid = os.getpid()
        for sp in self.spans():
            args = {"trace_id": sp.trace_id, "span_id": sp.span_id,
                    "node": sp.node}
            if sp.parent_id:
                args["parent_id"] = sp.parent_id
            args.update({k: v for k, v in sp.tags.items()
                         if isinstance(v, (str, int, float, bool))})
            if sp.error:
                args["error"] = sp.error
            events.append({
                "name": sp.name, "cat": "estpu", "ph": "X",
                "ts": int(sp.start * 1e6),
                "dur": max(1, int(sp.duration * 1e6)),
                "pid": pid, "tid": sp.thread, "args": args,
            })
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"node": self.node_id}}


def find_trace_ids(spans: List[Span]) -> Dict[str, List[Span]]:
    """Group spans by trace id (test/debug helper)."""
    out: Dict[str, List[Span]] = {}
    for sp in spans:
        out.setdefault(sp.trace_id, []).append(sp)
    return out
