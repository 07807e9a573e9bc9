"""Search profiler: per-shard phase timings of ``profile: true``.

Copy of elasticsearch_tpu/tracing/profiler.py (reference:
org/elasticsearch/search/profile/ — the ``?profile=true`` response
tree). The per-shard profile keeps the reference's envelope
(``profile.shards[].searches[].query[]``, ``rewrite_time``,
``collector``) and its extras section under the reference's key
(``tpu``), with the reference's phase names, so one client reads both:

  rewrite         query parse (host)
  executor_build  SegmentContext construction (host)
  device_compile  time inside device calls during which ``ops/build.py``
                  built or loaded a kernel library (nvcc, dlopen)
  device_execute  time inside every other device call
  topk            top-k and sort selection, result packing (device)
  host_sync       device-to-host copies of packed results
  aggs            aggregation partials (device + host)
  rehydrate       fielddata re-placed after an eviction
                  (``resources/residency.py`` files each rehydration's
                  time through ``record_rehydrate``, inside the query
                  phase's ``attached`` scope; its ``tpu.rehydrate`` span
                  goes to the node's tracer)
  fuse, rerank    hybrid fusion and stage-2 re-rank

A device call waits for the card with ``torch.cuda.synchronize`` on the
device of a CUDA tensor it returns, so its time is the device's. It
never swallows an exception: a fault on the card fails the request.
``retraces`` counts the first-touch events of the shard's query phase on
its thread (``tracing/retrace.py``: a kernel library built or loaded, a
dispatch key's first run in the process); an identical second request
reports 0.

Clock discipline: all durations from ``time.perf_counter()``.
"""
from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from elasticsearch_tpu_torch.ops import build
from elasticsearch_tpu_torch.tracing import retrace

PHASES = ("rewrite", "executor_build", "device_compile", "device_execute",
          "topk", "host_sync", "aggs", "rehydrate", "fuse", "rerank")

# the PhaseTimer of the profiled query phase running on THIS logical
# flow — lets out-of-band instrumentation file time without threading
# the timer through every layer. Explicitly scoped by attached(): a
# stale pointer must never absorb a later request's time.
_ACTIVE_TIMER: contextvars.ContextVar[Optional["PhaseTimer"]] = \
    contextvars.ContextVar("estpu-active-phase-timer", default=None)


def attached(timer: Optional["PhaseTimer"]):
    """Context manager scoping ``timer`` as the flow's rehydrate sink
    (no-op for None — unprofiled requests pay nothing)."""
    if timer is None:
        return nullcontext()

    @contextmanager
    def _cm():
        tok = _ACTIVE_TIMER.set(timer)
        try:
            yield
        finally:
            _ACTIVE_TIMER.reset(tok)

    return _cm()


def record_rehydrate(ns: int) -> None:
    """File ``ns`` under the attached timer's `rehydrate` phase (dropped
    when no profile is active)."""
    t = _ACTIVE_TIMER.get()
    if t is not None:
        t.nanos["rehydrate"] = t.nanos.get("rehydrate", 0) + int(ns)


def _cuda_device(out: Any) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``out`` (a tensor or a
    tuple/list of them), or None."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for x in items:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return None


class PhaseTimer:
    """Accumulates named phase durations (nanos) for ONE shard's query
    phase. Not thread-safe — one per query_phase call."""

    def __init__(self):
        self.nanos: Dict[str, int] = {p: 0 for p in PHASES}
        self.device_calls = 0
        self.segments = 0
        self._snap = retrace.snapshot()
        self._t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.nanos[name] = self.nanos.get(name, 0) + int(
                (time.perf_counter() - t0) * 1e9)

    def device_call(self, fn: Callable[[], Any],
                    bucket: Optional[str] = None) -> Any:
        """Run a device call, wait for the card, and file its wall time
        under device_compile (a kernel library was built or loaded
        meanwhile) or device_execute. ``bucket`` also files the time
        under a named phase (e.g. "topk")."""
        loads = build.LOADS
        t0 = time.perf_counter()
        out = fn()
        dev = _cuda_device(out)
        if dev is not None:
            torch.cuda.synchronize(dev)
        ns = int((time.perf_counter() - t0) * 1e9)
        self.device_calls += 1
        self.nanos["device_compile" if build.LOADS != loads
                   else "device_execute"] += ns
        if bucket is not None:
            self.nanos[bucket] = self.nanos.get(bucket, 0) + ns
        return out

    def to_json(self) -> dict:
        return {
            "phases": {f"{k}_nanos": v for k, v in self.nanos.items()},
            # wall time since the timer opened, not a phase sum: a
            # bucket (topk) also counts under device_compile/execute
            "query_total_nanos": int(
                (time.perf_counter() - self._t0) * 1e9),
            "retraces": retrace.traces_since(self._snap),
            "device_calls": self.device_calls,
            "segments": self.segments,
        }


def shard_profile_entry(shard_label: str, query_nanos: int,
                        tpu: Optional[dict],
                        description: str = "whole-segment score/mask "
                                           "program") -> dict:
    """One ``profile.shards[]`` element: reference envelope + extras."""
    out: Dict[str, Any] = {
        "id": shard_label,
        "searches": [{
            "query": [{
                "type": "CompiledSegmentProgram",
                "description": description,
                "time_in_nanos": int(query_nanos),
            }],
            "rewrite_time": (tpu or {}).get("phases", {}).get(
                "rewrite_nanos", 0),
            "collector": [{
                "name": "TopKMaskCollector",
                "reason": "search_top_hits",
                "time_in_nanos": (tpu or {}).get("phases", {}).get(
                    "topk_nanos", 0),
            }],
        }],
    }
    if tpu is not None:
        out["tpu"] = tpu
    return out
