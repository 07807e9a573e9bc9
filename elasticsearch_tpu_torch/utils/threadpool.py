"""Named, sized thread pools with bounded queues and rejection accounting.

Port of elasticsearch_tpu/utils/threadpool.py, unchanged but for its
imports. Reference: org/elasticsearch/threadpool/ThreadPool.java:1-688 — ES sizes a
fixed pool per workload (search/index/bulk/get/…), bounds its queue, and
REJECTS work beyond that with EsRejectedExecutionException (HTTP 429), so
overload degrades by shedding instead of by queueing unboundedly. The REST
layer here dispatches each request through the pool named for its route;
`_nodes/stats` and `_cat/thread_pool` surface the counters.

Sizing follows the reference's defaults scaled to `os.cpu_count()`:
  search: 3*cores/2 + 1, queue 1000   index: cores, queue 200
  bulk:   cores,          queue 50    get:   cores, queue 1000
  management: 2,          queue 100 (cluster/admin endpoints)
Kernels on the card run in their own stream order, so pool sizes bound
CONCURRENT REQUESTS (host prep + launch), not device occupancy.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException


class EsRejectedExecutionException(ElasticsearchTpuException):
    status = 429
    error_type = "es_rejected_execution_exception"


class _Work:
    __slots__ = ("fn", "args", "kwargs", "done", "result", "error",
                 "enqueued")

    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        # monotonic enqueue time: the watchdog's starvation detector
        # reads queue AGE (how long the head has waited), which queue
        # depth alone can't distinguish from a healthy burst
        self.enqueued = time.monotonic()


class FixedThreadPool:
    """One named fixed pool: `size` workers over a `queue_size`-bounded
    queue; a full queue rejects immediately (the reference's fixed pool)."""

    def __init__(self, name: str, size: int, queue_size: int):
        self.name = name
        self.size = size
        self.queue_size = queue_size
        self._q: "queue.Queue[_Work]" = queue.Queue(maxsize=queue_size)
        self._lock = threading.Lock()
        self._closed = False
        self.active = 0
        self.completed = 0
        self.rejected = 0
        self.largest = 0
        self._workers = [
            threading.Thread(target=self._run, name=f"tpu[{name}][{i}]",
                             daemon=True)
            for i in range(size)
        ]
        for w in self._workers:
            w.start()

    def _run(self):
        while True:
            work = self._q.get()
            if work is None:  # shutdown sentinel
                return
            with self._lock:
                self.active += 1
                self.largest = max(self.largest, self.active)
            try:
                work.result = work.fn(*work.args, **work.kwargs)
            except BaseException as e:  # delivered to the submitter
                work.error = e
            finally:
                with self._lock:
                    self.active -= 1
                    self.completed += 1
                work.done.set()

    def execute(self, fn: Callable, *args, **kwargs):
        """Submit and WAIT (the REST handler thread blocks on its pool slot
        — bounded concurrency with backpressure). Raises
        EsRejectedExecutionException when the queue is full."""
        work = _Work(fn, args, kwargs)
        # closed-check and enqueue are one atomic step w.r.t. shutdown()'s
        # flag write: work can never land BEHIND the shutdown sentinels
        # (where no worker would ever run it and the submitter would wait
        # forever on work.done)
        with self._lock:
            if self._closed:
                raise EsRejectedExecutionException(
                    f"thread pool [{self.name}] is shut down")
            try:
                self._q.put_nowait(work)
            except queue.Full:
                self.rejected += 1
                raise EsRejectedExecutionException(
                    f"rejected execution on thread pool [{self.name}] "
                    f"(queue capacity {self.queue_size})")
        work.done.wait()
        if work.error is not None:
            raise work.error
        return work.result

    def oldest_queue_age(self) -> Optional[float]:
        """Age in seconds of the oldest QUEUED (not yet claimed) work
        item, or None when the queue is empty — the watchdog's
        starvation signal: old head + every worker busy = requests aging
        behind wedged workers. Peeks the head under the queue's own
        mutex; shutdown sentinels (None) don't count."""
        with self._q.mutex:
            head = self._q.queue[0] if self._q.queue else None
        t0 = getattr(head, "enqueued", None)
        if t0 is None:
            return None
        return time.monotonic() - t0

    def stats(self) -> dict:
        with self._lock:
            return {
                "threads": self.size,
                "queue": self._q.qsize(),
                "queue_size": self.queue_size,
                "active": self.active,
                "largest": self.largest,
                "completed": self.completed,
                "rejected": self.rejected,
            }

    def shutdown(self):
        """Stop accepting work, then hand every worker its sentinel with a
        BLOCKING put — workers drain queued work first, so a momentarily
        full queue must not leak live threads (put_nowait would silently
        drop the sentinel)."""
        with self._lock:
            # paired with execute()'s locked check-and-enqueue: once this
            # releases, every later execute() rejects, so the sentinels
            # below are guaranteed to be the LAST queue entries
            self._closed = True
        for _ in self._workers:
            try:
                self._q.put(None, timeout=5.0)  # type: ignore[arg-type]
            except queue.Full:
                break  # workers wedged on user work; daemon threads reap


class ThreadPool:
    """The node's pool registry (reference: ThreadPool.Names)."""

    def __init__(self):
        cores = os.cpu_count() or 4
        self.pools: Dict[str, FixedThreadPool] = {
            "search": FixedThreadPool("search", 3 * cores // 2 + 1, 1000),
            "index": FixedThreadPool("index", cores, 200),
            "bulk": FixedThreadPool("bulk", cores, 50),
            "get": FixedThreadPool("get", cores, 1000),
            "management": FixedThreadPool("management", 2, 100),
        }

    def execute(self, pool: str, fn: Callable, *args, **kwargs):
        p = self.pools.get(pool)
        if p is None:
            return fn(*args, **kwargs)  # unpooled action: run inline
        return p.execute(fn, *args, **kwargs)

    def stats(self) -> Dict[str, dict]:
        return {name: p.stats() for name, p in self.pools.items()}

    def shutdown(self):
        for p in self.pools.values():
            p.shutdown()
