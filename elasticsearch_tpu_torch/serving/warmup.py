"""Pre-warm service: replay the persisted census before traffic arrives.

Port of elasticsearch_tpu/serving/warmup.py. The kernel-library blob
tier (``parallel/aot.py``) makes a restarted node's first launch of each
kernel a load instead of an ``nvcc`` run; this service moves even that,
and every other first-touch cost (CUDA's lazy loading of torch's
kernels, the cuBLAS set-up, the uploads of the executor's caches and the
lazy fielddata), out of the first request: at boot (``RestServer.start``),
index open and shard-recovery graduation it replays the index's
persisted census, the canonical bodies the previous process served,
hottest first, through ``IndexService.search`` and so ``_search_inner``:
the real mesh and host-loop dispatches.

- **background, low priority**: one daemon worker thread replaying one
  body at a time; live traffic never queues behind it.
- **cancellable**: each index's replay is a ``cluster:admin/warmup``
  task; a cancel stops it at the next body boundary.
- **breaker-charged**: each body charges ``charge_bytes`` to the node's
  ``request`` breaker; a denial retries briefly, then defers the run
  (``deferred``) without failing any foreground search.
- **cooldown-guarded**: a completed index re-warms only after
  ``cooldown_s`` (``cooldown`` no-ops otherwise).
- **backend-honest**: a census taken under another backend fingerprint,
  another device count included, is refused (``backend_mismatch``).

Replays run under :func:`in_prewarm`: ``IndexService.search`` labels
their latency ``warmup="prewarm"`` and records no census body for them.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_PREWARM: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "estpu-prewarm", default=False)


def in_prewarm() -> bool:
    """True on flows executing a warmup replay (IndexService reads this
    for the metric label + census suppression)."""
    return _PREWARM.get()


class WarmupService:
    """Per-node pre-warm worker. Construction is cheap (no thread); the
    worker spins lazily on the first :meth:`kick`."""

    DEFAULTS: Dict[str, float] = {
        "cooldown_s": 300.0,     # a completed index re-warms only after
        "charge_bytes": float(1 << 20),  # request-breaker charge per body
        "defer_retries": 3.0,    # breaker-denial retries before deferring
        "defer_wait_s": 0.05,    # stop-gated wait between retries
        "max_bodies": 64.0,      # per-run replay ceiling
    }

    def __init__(self, node, **overrides: float):
        self.node = node
        self.config: Dict[str, float] = dict(self.DEFAULTS)
        for k, v in overrides.items():
            if k not in self.config:
                raise ValueError(f"unknown warmup option [{k}]")
            self.config[k] = float(v)
        self._enabled_setting: Optional[bool] = None  # cluster override
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._queue: "deque[tuple]" = deque()
        self._queued: set = set()
        self._active: Optional[str] = None
        #: per-index last run result (bounded: one entry per index name)
        self.runs: Dict[str, dict] = {}
        self._last_complete: Dict[str, float] = {}
        m = node.metrics
        self._m_runs = m.counter(
            "estpu_warmup_runs_total",
            "Pre-warm runs by terminal status "
            "(complete/deferred/canceled/no_census/backend_mismatch/"
            "cooldown/error)", ("status",))
        self._m_replayed = m.counter(
            "estpu_warmup_replayed_total",
            "Census bodies replayed through the real search path by the "
            "pre-warm service")

    # -- config ---------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        if self._enabled_setting is not None:
            return self._enabled_setting
        return os.environ.get("ESTPU_WARMUP", "1").lower() not in (
            "0", "false", "off")

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        v = flat.get("serving.warmup.enabled")
        self._enabled_setting = (None if v is None
                                 else str(v).lower() in ("1", "true"))
        cd = flat.get("serving.warmup.cooldown_seconds")
        if cd is not None:
            try:
                self.config["cooldown_s"] = float(cd)
            except (TypeError, ValueError):
                pass
        elif "cooldown_s" in self.DEFAULTS:
            self.config["cooldown_s"] = self.DEFAULTS["cooldown_s"]

    # -- kick / queue ---------------------------------------------------------

    def kick(self, reason: str, indices: Optional[List[str]] = None
             ) -> List[str]:
        """Queue warmup for ``indices`` (default: every open local
        index). Returns the names actually queued; cooldown-guarded
        indices are skipped here AND re-checked at run time (a kick can
        sit queued while a previous run completes)."""
        if not self.enabled or self._stop.is_set():
            return []
        names = indices if indices is not None else sorted(
            self.node.indices)
        queued: List[str] = []
        now = time.monotonic()
        with self._lock:
            for name in names:
                svc = self.node.indices.get(name)
                if svc is None or getattr(svc, "closed", False):
                    continue
                last = self._last_complete.get(name)
                if last is not None \
                        and now - last < self.config["cooldown_s"]:
                    self._note_cooldown_locked(name, reason)
                    continue
                if name in self._queued or name == self._active:
                    continue
                self._queue.append((name, reason))
                self._queued.add(name)
                queued.append(name)
        if queued:
            self._ensure_thread()
        return queued

    def _note_cooldown_locked(self, index: str, reason: str) -> None:
        """Record a cooldown skip WITHOUT destroying the last
        substantive run's diagnostics (an operator checking whether
        pre-warm ran must still see replayed/took_ms — a routine
        shard-sync kick inside the window must not blank them).
        Caller holds self._lock."""
        prev = self.runs.get(index)
        if prev is not None and prev.get("status") != "cooldown":
            prev["cooldown_skips"] = prev.get("cooldown_skips", 0) + 1
            prev["last_skip_reason"] = reason
        else:
            self.runs[index] = {"index": index, "reason": reason,
                                "status": "cooldown"}
        self._m_runs.labels("cooldown").inc()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="estpu-warmup", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                if not self._queue:
                    # exit when the queue drains, DEATH ANNOUNCED UNDER
                    # THE LOCK (a racing kick's _ensure_thread sees
                    # _thread None and respawns — no lost job, no
                    # forever-polling idle thread for a service that
                    # typically runs once per boot)
                    self._thread = None
                    return
                job = self._queue.popleft()
                self._queued.discard(job[0])
                self._active = job[0]
            try:
                self.run_index(job[0], job[1])
            except Exception:
                pass  # a broken replay must never kill the worker
            finally:
                with self._lock:
                    self._active = None

    # -- one index ------------------------------------------------------------

    def run_index(self, index: str, reason: str) -> dict:
        """Replay one index's persisted census synchronously (the worker
        calls this; tests and the bench call it directly for
        determinism). Returns and records the run result."""
        from elasticsearch_tpu_torch.resources import census
        from elasticsearch_tpu_torch.tracing import TaskCancelledException

        t0 = time.perf_counter()
        result = {"index": index, "reason": reason, "status": "error",
                  "replayed": 0, "errors": 0, "deferrals": 0}

        def _finish(status: str) -> dict:
            result["status"] = status
            result["took_ms"] = round(
                (time.perf_counter() - t0) * 1000.0, 3)
            with self._lock:
                self.runs[index] = result
                if status == "complete":
                    self._last_complete[index] = time.monotonic()
            self._m_runs.labels(status).inc()
            return result

        svc = self.node.indices.get(index)
        if svc is None or getattr(svc, "closed", False):
            return _finish("skipped")
        # run-time cooldown re-check (kick's contract): a kick can sit
        # queued while another trigger's run completes — replaying again
        # seconds later is exactly the steady-state tax the guard exists
        # to prevent. Returned (not stored) as the result: the stored
        # record keeps the completed run's diagnostics.
        with self._lock:
            last = self._last_complete.get(index)
            if last is not None and time.monotonic() - last \
                    < self.config["cooldown_s"]:
                self._note_cooldown_locked(index, reason)
                result["status"] = "cooldown"
                return result
        rep = census.replay(index)
        if not rep.get("found"):
            return _finish("no_census")
        if not rep.get("backend_matches"):
            result["census_backend"] = rep.get("backend")
            return _finish("backend_mismatch")
        result["keys_total"] = rep.get("total", 0)
        result["keys_warm_before"] = rep.get("warm", 0)
        bodies = rep.get("bodies", [])[: int(self.config["max_bodies"])]
        if not bodies:
            # keys-only census (pre-v2, or traffic that bypassed the
            # body recorder): nothing replayable — complete, so the
            # cooldown still guards repeated no-op kicks
            return _finish("complete")
        breaker = self.node.breakers.breaker("request")
        charge = int(self.config["charge_bytes"])
        try:
            with self.node.tasks.task(
                    "cluster:admin/warmup",
                    description=f"pre-warm [{index}] "
                                f"({reason}, {len(bodies)} bodies)"
            ) as task:
                for row in bodies:
                    task.check_cancelled()
                    if self._stop.is_set():
                        return _finish("stopped")
                    # admission: warmup yields to live traffic. A denial
                    # is EXPECTED under pressure — no trip counted, no
                    # flight entry; a brief stop-gated retry, then defer.
                    admitted = False
                    for _ in range(int(self.config["defer_retries"])):
                        if breaker.reserve(charge, count_trip=False):
                            admitted = True
                            break
                        result["deferrals"] += 1
                        if self._stop.wait(self.config["defer_wait_s"]):
                            return _finish("stopped")
                    if not admitted:
                        return _finish("deferred")
                    tok = _PREWARM.set(True)
                    try:
                        body = json.loads(row.get("body") or "{}")
                        svc.search(body)
                        result["replayed"] += 1
                        self._m_replayed.inc()
                    except TaskCancelledException:
                        raise
                    except Exception:
                        # one stale body (mapping changed, field gone)
                        # must not stop the rest of the work list
                        result["errors"] += 1
                    finally:
                        _PREWARM.reset(tok)
                        breaker.release(charge)
        except TaskCancelledException:
            return _finish("canceled")
        rep2 = census.replay(index)
        result["keys_warm_after"] = rep2.get("warm", 0)
        return _finish("complete")

    # -- views / lifecycle ----------------------------------------------------

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the queue drains and no run is active (bench and
        tests; bounded — never wedges a caller)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                idle = not self._queue and self._active is None
            if idle:
                return True
            if self._stop.wait(0.02):
                return True
        return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "queued": [name for name, _ in self._queue],
                "active": self._active,
                "runs": {k: dict(v) for k, v in sorted(self.runs.items())},
            }

    def close(self) -> None:
        self._stop.set()
        th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout=2.0)
