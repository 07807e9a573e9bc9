"""Cross-request adaptive micro-batching: the query coalescer.

Port of elasticsearch_tpu/serving/coalescer.py. There is no coalescer
in ES 2.x: searches execute one by one. Here an ``_msearch`` batch runs
as one device pass per segment (``search/batch.py``), so the serving
front-end turns *concurrent independent* single searches into the same
shape: each eligible request parks briefly in a micro-batch queue keyed
by ``(index, query-shape bucket)``; a drain thread flushes the bucket as
one batch (``execute_batch``) and hands each request its response on its
own thread. On an index with replicas a flush reads one copy of each
shard for the whole batch (``ReplicationGroup.reader``: the next copy in
turn), as one search would.

Drain policy (adaptive):

- **solo bypass**: when no other eligible search is in flight and no
  batch is forming, the request runs the normal path untouched, so a
  lone request pays no added latency (``mode=adaptive``, the default);
- **full**: a bucket reaching ``max_batch`` flushes at once;
- **deadline**: a forming batch flushes a wait window after its first
  entry; the window follows the observed arrival rate (an EWMA of
  inter-arrival gaps, clamped to ``max_wait``);
- **idle**: no new arrival for ``idle_gap`` flushes early.

``mode=always`` parks every eligible request, ``mode=off`` or
``enabled: false`` (or ``ESTPU_COALESCER=0`` in the environment) parks
none. Ineligible bodies (keys beyond query/size/from/_source/profile, a
query no batch tier takes) run the normal path unchanged; a ``profile``
body parks but runs on its own thread at the flush, as in the reference,
and its response's ``profile.coalescer`` reports its queue wait, batch
size and flush reason.
A failure of the batch is raised on every request of the batch: the
port has no fallback that would hide a device fault.

Every wait here has a timeout, and parking happens outside the lock.

Around the queue, as in the reference:

- the wait is a ``serving.queue_wait`` span in the node's tracer;
- a parked request registers a *pending* task in the node's registry
  (``indices:data/read/search[coalesced]``), so ``POST
  /_tasks/{id}/_cancel`` evicts it before it reaches the card;
- the ``estpu_coalescer_*`` families (batch size, queue wait, flush and
  bypass reasons) ride the node's metrics registry; ``stats()`` reads
  its counts from them;
- a coalesced search reaches the index's slow log with its queue wait
  and the batch's time;
- ``oldest_queue_age`` is the probe the stall watchdog's
  ``coalescer_drain`` detector reads (monitor/watchdog.py).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


#: body keys a parked request may carry; `profile` parks too (its queue
#: wait is real) but executes on its own thread at the flush. A body with
#: any other key (`aggs` among them) runs its own path unparked
PARK_KEYS = frozenset({"query", "size", "from", "_source", "profile"})

#: sentinel result: the waiter executes its own body on its own thread
RUN_SELF = object()

#: upper bounds of the batch-size histogram's buckets
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class _Entry:
    """One parked request."""

    __slots__ = ("svc", "body", "query", "claimed", "done", "result",
                 "error", "task", "enqueued", "claimed_at", "batch_size",
                 "flush_reason")

    def __init__(self, svc, body: dict, query):
        self.svc = svc
        self.body = body
        self.query = query
        self.claimed = threading.Event()  # left the queue (exec started)
        self.done = threading.Event()     # result/error available
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.task = None
        self.enqueued = time.perf_counter()
        self.claimed_at: Optional[float] = None
        self.batch_size = 0
        self.flush_reason = ""

    def resolve(self, result: Any = None,
                error: Optional[BaseException] = None) -> None:
        self.result = result
        self.error = error
        if self.claimed_at is None:
            self.claimed_at = time.perf_counter()
        self.claimed.set()
        self.done.set()


def _parse_duration_s(v, default: float) -> float:
    """A time value ("10ms", "1s", "2m", "1h", or bare millis) in
    seconds; ``default`` when absent or malformed."""
    if v is None:
        return default
    s = str(v).strip().lower()
    for suf, mul in (("ms", 1e-3), ("s", 1.0), ("m", 60.0), ("h", 3600.0)):
        if s.endswith(suf) and s[: -len(suf)].replace(".", "", 1).isdigit():
            return float(s[: -len(suf)]) * mul
    try:
        return float(s) * 1e-3
    except ValueError:
        return default


def _env_enabled() -> bool:
    return os.environ.get("ESTPU_COALESCER", "1").lower() not in (
        "0", "false", "off")


class QueryCoalescer:
    """Micro-batch queue in front of the search path."""

    #: EWMA smoothing for the inter-arrival gap estimate
    _ALPHA = 0.2
    #: wait window = this many estimated gaps (room for several joiners)
    _GAP_FACTOR = 4.0
    #: floor so a dense burst still holds long enough to fill a batch
    _MIN_WINDOW_S = 2e-4

    def __init__(self, node):
        self.node = node
        self._cv = threading.Condition()
        # (index name, shape bucket) -> forming batch
        self._queues: Dict[Tuple[str, str], List[_Entry]] = {}
        self._flush_at: Dict[Tuple[str, str], float] = {}
        self._last_arrival: Optional[float] = None
        self._ewma_gap: Optional[float] = None
        self._active = 0  # bypassed eligible searches currently executing
        self._outstanding = 0  # parked entries not yet fully served
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.enabled = _env_enabled()
        self.mode = "adaptive"  # adaptive | always | off
        self.max_batch = 256
        self.max_wait_s = 0.004
        self.idle_gap_s = 0.001
        # the node's estpu_coalescer_* families, which stats() reads too
        m = node.metrics
        self._m_batch = m.histogram(
            "estpu_coalescer_batch_size",
            "Requests per coalesced device batch",
            buckets=_BATCH_BUCKETS)
        self._m_wait = m.histogram(
            "estpu_coalescer_queue_wait_seconds",
            "Time a request spent parked in the micro-batch queue")
        self._m_flush = m.counter(
            "estpu_coalescer_flush_total",
            "Batch flushes by drain reason (full/deadline/idle/close)",
            ("reason",))
        self._m_bypass = m.counter(
            "estpu_coalescer_bypass_total",
            "Searches that bypassed the queue, by reason", ("reason",))

    # -- settings ------------------------------------------------------------

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        """Idempotent from the merged map (an absent key = its default)."""
        with self._cv:
            v = flat.get("serving.coalescer.enabled")
            self.enabled = (str(v).lower() not in ("false", "0", "off")
                            if v is not None else _env_enabled())
            v = flat.get("serving.coalescer.mode")
            self.mode = (str(v) if v in ("adaptive", "always", "off")
                         else "adaptive")
            v = flat.get("serving.coalescer.max_batch")
            self.max_batch = max(2, int(v)) if v is not None else 256
            self.max_wait_s = _parse_duration_s(
                flat.get("serving.coalescer.max_wait"), 0.004)
            self.idle_gap_s = _parse_duration_s(
                flat.get("serving.coalescer.idle_gap"), 0.001)
            self._cv.notify_all()

    # -- submission ----------------------------------------------------------

    def execute(self, svc, body: dict, run) -> Optional[dict]:
        """The serving front door for one single-index search. Returns
        the response (coalesced, or from ``run()``, the caller's normal
        path), or None when the body is ineligible and the caller must
        run its own path (parse errors keep their typed surface there)."""
        if (not self.enabled or self.mode == "off" or self._closed
                or not isinstance(body, dict) or set(body) - PARK_KEYS):
            return None
        try:
            frm, size = int(body.get("from", 0)), int(body.get("size", 10))
        except (TypeError, ValueError):
            return None
        if frm + size < 1 or frm + size > 10_000:
            return None
        now = time.perf_counter()
        with self._cv:
            window = self._note_arrival(now)
            park = (self.mode == "always" or self._active > 0
                    or bool(self._queues))
            if not park:
                # solo: the normal path untouched; _active marks the
                # overlap window so a concurrent burst starts coalescing
                self._active += 1
        if not park:
            try:
                self._m_bypass.labels("solo").inc()
                return run()
            finally:
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()  # close() may be draining
        # coalescing is warranted: now pay for the shape analysis
        made = self._make_entry(svc, body)
        if made is None:
            self._m_bypass.labels("shape").inc()
            return None
        entry, field = made
        return self._park(entry, field, window, run)

    def _make_entry(self, svc, body: dict) -> Optional[Tuple[_Entry, str]]:
        from elasticsearch_tpu_torch.search.batch import batch_field
        from elasticsearch_tpu_torch.search.queries import parse_query

        try:
            query = parse_query(body.get("query"))
        except Exception:
            return None  # the normal path reports the typed error
        field = batch_field(svc, query)
        if field is None:
            return None
        return _Entry(svc, body, query), field

    def _park(self, entry: _Entry, field: str, window: float, run) -> dict:
        key = (entry.svc.name, field)
        with self._cv:
            self._outstanding += 1
        # pending child task: listed by /_tasks and cancellable while
        # parked; on_cancel evicts the entry before the card sees it
        entry.task = self.node.tasks.register(
            "indices:data/read/search[coalesced]",
            description=f"indices[{entry.svc.name}] queued[{field}]",
            status="pending",
            on_cancel=lambda t, e=entry: self._evict(e))
        try:
            with self._cv:
                if entry.error is None:  # not born cancelled
                    q = self._queues.get(key)
                    if q is None:
                        q = self._queues[key] = []
                        self._flush_at[key] = entry.enqueued + window
                    q.append(entry)
                    self._ensure_thread()
                    self._cv.notify_all()
            # the wait as a span, closed at the claim: execution time is
            # the search's, not the queue's
            with self.node.tracer.span("serving.queue_wait",
                                       index=entry.svc.name, bucket=field):
                while not entry.claimed.wait(timeout=0.05):
                    with self._cv:
                        dead = (self._thread is None
                                or not self._thread.is_alive())
                    if dead and self._reclaim(entry, key):
                        break
            while not entry.done.wait(timeout=0.05):
                pass
            queue_s = (entry.claimed_at or entry.enqueued) - entry.enqueued
            self._m_wait.observe(queue_s)
            if entry.error is not None:
                raise entry.error
            resp = run() if entry.result is RUN_SELF else entry.result
            if isinstance(resp, dict):
                if "took" in resp:
                    resp["took"] = int(resp["took"]) + int(queue_s * 1000)
                if isinstance(resp.get("profile"), dict):
                    # a profiled request's time in the queue and the
                    # batch it was flushed with
                    resp["profile"]["coalescer"] = {
                        "queue_wait_nanos": int(queue_s * 1e9),
                        "batch_size": entry.batch_size,
                        "flush_reason": entry.flush_reason or "self",
                    }
            return resp
        finally:
            self.node.tasks.unregister(entry.task)
            with self._cv:
                self._outstanding -= 1
                self._cv.notify_all()  # close() may be draining

    def _note_arrival(self, now: float) -> float:
        """Caller holds _cv. Update the EWMA inter-arrival estimate and
        return the wait window for a batch formed now."""
        if self._last_arrival is not None:
            gap = min(now - self._last_arrival, 1.0)
            self._ewma_gap = (gap if self._ewma_gap is None
                              else (1 - self._ALPHA) * self._ewma_gap
                              + self._ALPHA * gap)
        self._last_arrival = now
        if self.mode == "always":
            return self.max_wait_s
        if self._ewma_gap is None:
            return self._MIN_WINDOW_S
        return min(self.max_wait_s,
                   max(self._ewma_gap * self._GAP_FACTOR,
                       self._MIN_WINDOW_S))

    def _reclaim(self, entry: _Entry, key) -> bool:
        """Dead drain thread: pull the entry back and run it ourselves
        (never wedge a client on a crashed drain loop)."""
        with self._cv:
            q = self._queues.get(key)
            if q is not None and entry in q:
                q.remove(entry)
                if not q:
                    self._queues.pop(key, None)
                    self._flush_at.pop(key, None)
                entry.resolve(result=RUN_SELF)
                return True
            return entry.done.is_set()

    def _evict(self, entry: _Entry) -> None:
        """on_cancel hook (on the cancelling thread): take a still-parked
        entry out of its queue and fail it with the task's typed error,
        so it never reaches the card. A claimed entry is past eviction;
        its flush resolves it."""
        from elasticsearch_tpu_torch.tracing.tasks import \
            TaskCancelledException

        with self._cv:
            for key, q in list(self._queues.items()):
                if entry in q:
                    q.remove(entry)
                    if not q:
                        self._queues.pop(key, None)
                        self._flush_at.pop(key, None)
                    break
            if not entry.claimed.is_set():
                task = entry.task
                reason = (task.cancel_reason if task is not None
                          else None) or "by user request"
                tid = task.tagged_id if task is not None else "?"
                entry.resolve(error=TaskCancelledException(
                    f"task [{tid}] (indices:data/read/search[coalesced]) "
                    f"was cancelled [{reason}] while queued"))
            self._cv.notify_all()

    # -- drain thread --------------------------------------------------------

    def _ensure_thread(self) -> None:
        """Caller holds _cv. A lazy drain thread (a Node that never
        coalesces never starts one)."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drain_loop, name="estpu-coalescer",
                daemon=True)
            self._thread.start()

    def _due(self, now: float) -> Optional[Tuple[Tuple[str, str], str]]:
        """Caller holds _cv. The first bucket due to flush, with reason."""
        for key, q in self._queues.items():
            if not q:
                continue
            if len(q) >= self.max_batch:
                return key, "full"
            if now >= self._flush_at.get(key, now):
                return key, "deadline"
            if (self._last_arrival is not None
                    and now - self._last_arrival >= self.idle_gap_s):
                return key, "idle"
        return None

    def _next_wakeup(self, now: float) -> float:
        """Caller holds _cv. Seconds until the earliest possible flush."""
        t = 0.5  # idle heartbeat: re-check config/close periodically
        if self._queues:
            for key in self._queues:
                t = min(t, self._flush_at.get(key, now) - now)
            if self._last_arrival is not None:
                t = min(t, self._last_arrival + self.idle_gap_s - now)
        return max(t, 1e-4)

    def _drain_loop(self) -> None:
        while True:
            batch: List[_Entry] = []
            reason = ""
            with self._cv:
                while True:
                    if self._closed:
                        for q in self._queues.values():
                            for e in q:
                                e.resolve(result=RUN_SELF)
                        self._queues.clear()
                        self._flush_at.clear()
                        return
                    now = time.perf_counter()
                    due = self._due(now)
                    if due is not None:
                        key, reason = due
                        q = self._queues.pop(key, [])
                        self._flush_at.pop(key, None)
                        batch = q[: self.max_batch]
                        rest = q[self.max_batch:]
                        if rest:
                            self._queues[key] = rest
                            self._flush_at[key] = now
                        break
                    self._cv.wait(timeout=self._next_wakeup(now))
            if batch:
                try:
                    self._flush(batch, reason)
                except Exception as e:
                    # raised on every waiter: a device fault must show
                    self._m_bypass.labels("batch_error").inc()
                    for en in batch:
                        if not en.done.is_set():
                            en.resolve(error=e)

    def _flush(self, batch: List[_Entry], reason: str) -> None:
        from elasticsearch_tpu_torch.search.batch import execute_batch

        # entries cancelled while being claimed resolve with their error
        live: List[_Entry] = []
        for e in batch:
            if e.done.is_set():
                continue
            if e.task is not None and e.task.cancelled:
                self._evict(e)
                continue
            live.append(e)
        if not live:
            return
        self._m_flush.labels(reason).inc()
        # profile bodies pay the queue wait like everyone but execute on
        # their own threads: a batch cannot attribute device time to one
        # request
        fused = [e for e in live if "profile" not in e.body]
        rest = [e for e in live if "profile" in e.body]
        now = time.perf_counter()
        for e in live:
            if e.task is not None:
                e.task.start()
            e.claimed_at = now
            e.batch_size = len(fused) if "profile" not in e.body else 1
            e.flush_reason = reason
            e.claimed.set()
        # the remainder does not wait for the batch: released first, it
        # runs on its own threads alongside the batch
        for e in rest:
            e.resolve(result=RUN_SELF)
        responses = None
        if len(fused) >= 2:
            responses = execute_batch(fused[0].svc, [e.body for e in fused],
                                      queries=[e.query for e in fused])
        if responses is not None:
            self._m_batch.observe(len(fused))
            batch_ms = (time.perf_counter() - now) * 1000
            for e, r in zip(fused, responses):
                # the slow log sees coalesced searches too, at this
                # request's queue wait plus the batch's time
                try:
                    e.svc.slowlog.on_search(
                        batch_ms + (e.claimed_at - e.enqueued) * 1000,
                        e.body, r)
                except Exception:
                    pass  # logging must never fail the batch
                e.resolve(result=r)
        else:
            for e in fused:
                e.resolve(result=RUN_SELF)

    # -- lifecycle -----------------------------------------------------------

    def oldest_queue_age(self) -> Optional[float]:
        """Age in seconds of the oldest still-parked request across every
        forming bucket, or None when nothing is parked. Normal waits are
        below a millisecond; an age far past ``max_wait`` means the drain
        thread is wedged or dead."""
        with self._cv:
            oldest = min((e.enqueued for q in self._queues.values()
                          for e in q), default=None)
        if oldest is None:
            return None
        return time.perf_counter() - oldest

    def stats(self) -> dict:
        with self._cv:
            out = {
                "enabled": self.enabled,
                "mode": self.mode,
                "queued": sum(len(q) for q in self._queues.values()),
                "buckets": len(self._queues),
                "max_batch": self.max_batch,
                "max_wait_ms": self.max_wait_s * 1000,
            }
        # the batch-size histogram's per-bucket counts, keyed by each
        # bucket's upper bound, and the flush and bypass counters
        h = self._m_batch.labels()
        out["batch_size"] = {"count": h.count, "sum": int(h.sum),
                             "max": int(h.max),
                             "le": {int(b): c for b, c in
                                    zip(h.bounds, h.counts)}}
        for key, fam in (("flushes", self._m_flush),
                         ("bypass", self._m_bypass)):
            out[key] = {lv[0]: int(c.value) for lv, c in fam.series()}
        return out

    def close(self) -> None:
        """Stop the drain thread (parked requests resolve to run on their
        own threads) and wait, bounded, for every parked or bypassed
        request to finish, so that the caller can close the indices."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout=2.0)
        deadline = time.perf_counter() + 5.0
        with self._cv:
            while (self._outstanding > 0 or self._active > 0) \
                    and time.perf_counter() < deadline:
                self._cv.wait(timeout=0.05)
