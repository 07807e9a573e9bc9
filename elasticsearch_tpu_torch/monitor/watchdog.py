"""Stall watchdogs: detectors that turn hangs into incidents.

Port of elasticsearch_tpu/monitor/watchdog.py. ES 2.x has no watchdog;
here the node watches itself. A background service ticks every
``interval_s`` seconds and evaluates a fixed detector set:

====================  ======================================================
detector              trips when
====================  ======================================================
``program_stall``     a device dispatch has been in flight longer than an
                      adaptive bound from that key's own execute history
                      (monitor/programs.py: ``mult x p99``, floored; a key
                      with too little history gets the absolute default).
                      The bracket closes at the host's read of the result,
                      so a kernel that hangs on the card stays in flight;
                      a mesh round's reason names its devices.
``threadpool_starve`` a named pool's oldest queued work item is older than
                      the bound while every worker is busy.
``translog_fsync``    the fsyncs since the last tick average over the
                      bound, or the slowest of them is past it.
``publish_stall``     a two-phase cluster-state publish has been in flight
                      longer than the bound, or a publish aborted inside
                      the commit window (the ``publish.commit`` fault).
``coalescer_drain``   the serving coalescer's oldest parked request has
                      waited far past the micro-batch window.
``relocation_stall``  an allocator-driven shard relocation has been in
                      flight longer than the bound. The trip also acts:
                      it cancels the move through the allocator and
                      reschedules it on another target, the wedged one
                      banned.
====================  ======================================================

A trip increments ``estpu_watchdog_trips_total{detector}``, records a
tracer span and a flight-ring entry and, outside the per-detector
cooldown, captures an incident dump: the flight rings, a one-shot
hot-threads snapshot, the dispatches in flight with each key's execute
counters, and the task list, persisted through the generic blob helpers
(monitor/flight.py::IncidentStore) so it survives a restart. Within the
cooldown the trip still counts and records, but no dump is captured.

``FAULTS.check("watchdog.program_stall")`` fires inside the program
detector's scan: an armed fault treats every dispatch in flight (or,
with none, a synthetic key) as stalled.

Each tick also persists the program census (resources/census.py) of
every index of the node whose census moved, at most once every
``census_flush_every_s``, so a killed process loses at most one interval
of the pre-warm work list.

The tick thread is a daemon whose loop waits on a stop event; ages and
bounds use ``time.monotonic()``.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.monitor import flight, programs
from elasticsearch_tpu_torch.utils.faults import FAULTS

#: detector names — the stable label set of estpu_watchdog_trips_total
DETECTORS = ("program_stall", "threadpool_starve", "translog_fsync",
             "publish_stall", "coalescer_drain", "relocation_stall")


def hot_threads_snapshot(limit: int = 32) -> List[dict]:
    """One-shot stack capture of every live thread — the incident-dump
    variant of ``/_nodes/hot_threads``: no sampling sleep (the watchdog
    must never add latency to the anomaly it is recording), just the
    exact stacks at capture time, capped at ``limit`` threads."""
    out: List[dict] = []
    frames = sys._current_frames()
    me = threading.get_ident()
    for t in threading.enumerate():
        if len(out) >= limit:
            break
        fr = frames.get(t.ident)
        if fr is None:
            continue
        # unlike the sampling endpoint, the CAPTURING thread is kept
        # (marked): when a request thread trips a detector inline, its
        # own stack is part of the evidence
        out.append({
            "name": t.name,
            "ident": t.ident,
            "daemon": t.daemon,
            "sampler": t.ident == me,
            "stack": [f"{f.filename}:{f.lineno} {f.name}"
                      for f in traceback.extract_stack(fr)],
        })
    return out


def programs_section(table: bool = False) -> dict:
    """The ``programs`` section of an incident dump (``table``) and of
    the diagnostics bundle: the compile and execute totals, the
    dispatches in flight and, with ``table``, each key's row (its
    compiles and compile seconds beside its execute counters)."""
    out = {"totals": programs.REGISTRY.stats(),
           "inflight": programs.REGISTRY.inflight_snapshot()}
    if table:
        out["table"] = programs.REGISTRY.snapshot()[:64]
    return out


class WatchdogService:
    """Per-node watchdog: detector evaluation + incident capture.

    Construction is cheap (no thread); serving entry points call
    :meth:`ensure_started`. Tests drive :meth:`run_once` directly for
    deterministic single ticks. ``ESTPU_WATCHDOG=0`` disables the
    background thread entirely (run_once still works)."""

    #: default bounds — constructor overrides for tests; generous enough
    #: that a healthy node under load never trips
    DEFAULTS: Dict[str, float] = {
        "interval_s": 1.0,
        # program_stall: bound = clamp(p99_mult × key p99, floor, none);
        # keys with < min_calls history use the absolute default
        "program_floor_s": 1.0,
        "program_p99_mult": 8.0,
        "program_default_bound_s": 30.0,
        "program_min_calls": 8,
        "threadpool_age_bound_s": 5.0,
        "fsync_bound_s": 1.0,
        "publish_bound_s": 10.0,
        "coalescer_bound_s": 2.0,
        # relocation_stall: a healthy stream finishes in seconds even
        # for big shards (ops ride one transport round); a minute of
        # flight means the stream is wedged, not slow
        "relocation_bound_s": 60.0,
        # per-detector incident cooldown: within it a trip still counts
        # and records, but no new dump is captured
        "cooldown_s": 30.0,
        # the census persists on Node.close; a kill would lose it, so
        # the tick flushes it on this cadence when it moved
        "census_flush_every_s": 60.0,
    }

    def __init__(self, node, **overrides: float):
        self.node = node
        self.config: Dict[str, float] = dict(self.DEFAULTS)
        for k, v in overrides.items():
            if k not in self.config:
                raise ValueError(f"unknown watchdog option [{k}]")
            self.config[k] = v
        self.board = flight.OpBoard()
        self.incidents = flight.IncidentStore()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self.ticks = 0
        self.trips: Dict[str, int] = {}
        self.incidents_captured = 0
        # per-detector monotonic time of the last incident capture
        self._last_incident: Dict[str, float] = {}
        # incremental-scan cursors; fsync seeds from the LIVE histogram
        # on the first tick — it is process-shared and may already hold
        # history this watchdog must not attribute to its first tick
        self._last_counters: Optional[Dict[str, float]] = None
        self._fsync_seen: Optional[Tuple[int, float, List[int]]] = None
        self._cluster_scan_ts = time.monotonic()
        # census-flush cursors: each index's last flushed generation and
        # the last flush's time: only the indices that moved, at the
        # cadence
        self._census_flushed_gens: Dict[str, int] = {}
        self._census_flush_ts = time.monotonic()
        self._m_trips = node.metrics.counter(
            "estpu_watchdog_trips_total",
            "Watchdog detector trips, by detector", ("detector",))

    # -- lifecycle -----------------------------------------------------------

    def ensure_started(self) -> None:
        """Start the tick thread (idempotent). Called by the serving
        entry points (RestServer, cluster bootstrap) — library-embedded
        Nodes that never serve don't pay for a polling thread."""
        if os.environ.get("ESTPU_WATCHDOG", "1").lower() in (
                "0", "false", "off"):
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="estpu-watchdog", daemon=True)
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout=2.0)

    @property
    def running(self) -> bool:
        th = self._thread
        return th is not None and th.is_alive() and not self._stop.is_set()

    def _loop(self) -> None:
        while not self._stop.wait(self.config["interval_s"]):
            try:
                self.run_once()
            except Exception:
                pass  # a detector bug must never kill the watchdog loop

    # -- one tick ------------------------------------------------------------

    def run_once(self) -> List[dict]:
        """Evaluate every detector once; returns the trips (tests read
        them directly, production discards — everything observable went
        through metrics/flight/incidents)."""
        self.ticks += 1
        self._sample_metrics()
        try:
            self._flush_census()
        except Exception:
            pass  # durability is best-effort; the detectors still run
        trips: List[dict] = []
        for check in (self._check_programs, self._check_threadpools,
                      self._check_fsync, self._check_publish,
                      self._check_coalescer, self._check_relocations):
            try:
                trips.extend(check())
            except Exception:
                pass  # one broken detector must not silence the others
        return trips

    def _flush_census(self) -> None:
        """Persist the census of each of this node's indices whose
        registry generation moved since its last flush, at most once
        every ``census_flush_every_s``. The time cursor advances at
        once (a failed store retries at the cadence); an index's
        generation cursor only when its store succeeded."""
        from elasticsearch_tpu_torch.resources import census

        gens = programs.REGISTRY.census_generations()
        dirty = [name for name in set(gens) & set(self.node.indices)
                 if gens[name] != self._census_flushed_gens.get(name)]
        if not dirty:
            return
        now = time.monotonic()
        if now - self._census_flush_ts < self.config["census_flush_every_s"]:
            return
        self._census_flush_ts = now
        for name in dirty:
            try:
                census.store_census(name)
            except Exception:
                continue  # this index stays dirty; the rest still flush
            self._census_flushed_gens[name] = gens[name]

    def _sample_metrics(self) -> None:
        """Metric-delta snapshot into the flight ring: which counters
        moved since the last tick (bounded at 32 keys — the ring is a
        black box, not a TSDB; /_prometheus/metrics is the full view)."""
        from elasticsearch_tpu_torch.monitor.metrics import process_counters

        try:
            now_counters = process_counters(self.node)
        except Exception:
            return
        prev = self._last_counters
        self._last_counters = now_counters
        if prev is None:
            return
        delta = {}
        for k, v in now_counters.items():
            d = v - prev.get(k, 0.0)
            if d > 0 and v >= 0 and prev.get(k, 0.0) >= 0:
                delta[k] = int(d) if d == int(d) else d
                if len(delta) >= 32:
                    break
        if delta:
            self.node.flight.record("metrics", delta=delta)

    # -- detectors -----------------------------------------------------------

    def _program_bound(self, program: str, shapes: str) -> float:
        """The adaptive bound for one key: ``mult × its own execute
        p99`` (floored) once the key has history, else the absolute
        default — a key that normally runs in 2ms is stalled at 16ms×…
        long before a 30s blanket bound would notice."""
        p99, calls = programs.REGISTRY.execute_p99(program, shapes)
        if calls >= self.config["program_min_calls"] and p99 > 0:
            return max(self.config["program_floor_s"],
                       self.config["program_p99_mult"] * p99)
        return self.config["program_default_bound_s"]

    def _check_programs(self) -> List[dict]:
        inflight = programs.REGISTRY.inflight_snapshot()
        injected = False
        try:
            FAULTS.check("watchdog.program_stall", inflight=len(inflight))
        except Exception:
            # the armed fault simulates the stall: every in-flight
            # dispatch is treated as past its bound, driving the full
            # trip → incident → persistence pipeline deterministically
            injected = True
        trips = []
        for row in inflight:
            bound = self._program_bound(row["program"], row["shapes"])
            detail = dict(row, bound_seconds=round(bound, 6),
                          injected=injected)
            if injected or row["age_seconds"] > bound:
                trips.append(self._trip(
                    "program_stall",
                    f"device program [{row['program']}|{row['shapes']}] "
                    + (f"on [{row['devices']}] " if row.get("devices")
                       else "")
                    + f"in flight {row['age_seconds']:.3f}s "
                    f"(bound {bound:.3f}s)", detail))
            elif row["age_seconds"] > bound / 2.0:
                self.node.flight.record("slow_ops", detector="program_stall",
                                        **detail)
        if injected and not inflight:
            trips.append(self._trip(
                "program_stall", "injected stall (no dispatch in flight)",
                {"program": "<injected>", "shapes": "", "injected": True}))
        return trips

    def _check_threadpools(self) -> List[dict]:
        tp = self.node._thread_pool
        if tp is None:
            return []
        trips = []
        bound = self.config["threadpool_age_bound_s"]
        for name, pool in tp.pools.items():
            age = pool.oldest_queue_age()
            if age is None:
                continue
            st = pool.stats()
            detail = {"pool": name, "oldest_age_seconds": round(age, 3),
                      "active": st["active"], "threads": st["threads"],
                      "queue": st["queue"]}
            if age > bound and st["active"] >= st["threads"]:
                trips.append(self._trip(
                    "threadpool_starve",
                    f"pool [{name}] oldest queued work is {age:.1f}s old "
                    f"with all {st['threads']} workers busy", detail))
            elif age > bound / 2.0:
                self.node.flight.record("slow_ops",
                                        detector="threadpool_starve",
                                        **detail)
        return trips

    def _check_fsync(self) -> List[dict]:
        from elasticsearch_tpu_torch.monitor.metrics import SHARED

        h = SHARED.histogram(
            "estpu_translog_fsync_duration_seconds",
            "Translog flush+fsync latency").labels()
        with h._lock:
            count, total = h.count, h.sum
            counts = list(h.counts)
        last = self._fsync_seen
        self._fsync_seen = (count, total, counts)
        if last is None:
            return []  # first tick: baseline only, history isn't news
        last_count, last_sum, last_counts = last
        bound = self.config["fsync_bound_s"]
        dc, ds = count - last_count, total - last_sum
        if dc <= 0:
            return []
        avg = ds / dc
        # per-WINDOW max lower bound from the bucket deltas: the highest
        # bucket that gained an observation this tick guarantees at
        # least one fsync above its lower edge. The average alone
        # dilutes one 5s stall among 50 fast ops, and the lifetime max
        # saturates after the first outlier — either path alone goes
        # blind to a sustained one-slow-fsync-per-tick disk.
        window_floor = 0.0
        for i, (c, lc) in enumerate(zip(counts, last_counts)):
            if c > lc:
                window_floor = h.bounds[i - 1] if i > 0 else 0.0
        detail = {"observations": dc, "avg_seconds": round(avg, 6),
                  "window_max_at_least_seconds": round(window_floor, 6)}
        if avg > bound or window_floor > bound:
            return [self._trip(
                "translog_fsync",
                f"translog fsync latency over bound ({bound:.3f}s): "
                f"{avg:.3f}s avg over {dc} ops, slowest this window "
                f">= {window_floor:.3f}s", detail)]
        if avg > bound / 2.0 or window_floor > bound / 2.0:
            self.node.flight.record("slow_ops", detector="translog_fsync",
                                    **detail)
        return []

    def _check_publish(self) -> List[dict]:
        trips = []
        bound = self.config["publish_bound_s"]
        for op in self.board.snapshot():
            if op["kind"] != "publish_commit":
                continue
            if op["age_seconds"] > bound:
                trips.append(self._trip(
                    "publish_stall",
                    f"cluster-state publish in flight "
                    f"{op['age_seconds']:.1f}s (bound {bound:.1f}s)",
                    dict(op, age_seconds=round(op["age_seconds"], 3))))
            elif op["age_seconds"] > bound / 2.0:
                self.node.flight.record("slow_ops", detector="publish_stall",
                                        **op)
        # a publish that aborted inside the commit window (the
        # publish.commit fault domain) left followers holding parked
        # uncommitted state — trip on the flight event bootstrap records.
        # The cursor advances to the newest event actually SCANNED (not
        # to now()): an event recorded between a now() read and the scan
        # would otherwise be returned twice and double-trip.
        cursor = self._cluster_scan_ts
        events = self.node.flight.events_since("cluster", cursor)
        if events:
            self._cluster_scan_ts = max(e["ts_monotonic"] for e in events)
        for ev in events:
            if ev.get("event") == "publish_commit_window_fault":
                trips.append(self._trip(
                    "publish_stall",
                    "publish aborted in the commit window (term "
                    f"{ev.get('term')}, version {ev.get('version')}) — "
                    "followers hold parked uncommitted state",
                    {k: ev.get(k) for k in ("event", "term", "version")}))
        return trips

    def _check_coalescer(self) -> List[dict]:
        serving = getattr(self.node, "serving", None)
        co = getattr(serving, "coalescer", None)
        if co is None:
            return []
        age = co.oldest_queue_age()
        if age is None:
            return []
        bound = self.config["coalescer_bound_s"]
        detail = {"oldest_age_seconds": round(age, 3), **co.stats()}
        if age > bound:
            return [self._trip(
                "coalescer_drain",
                f"coalescer's oldest parked request has waited {age:.2f}s "
                f"(bound {bound:.2f}s) — drain stalled", detail)]
        if age > bound / 2.0:
            self.node.flight.record("slow_ops", detector="coalescer_drain",
                                    **detail)
        return []

    def _check_relocations(self) -> List[dict]:
        """Stuck-relocation detector (master-side: only the master's
        allocator holds in-flight moves): a move whose stream has been
        in flight past the bound is cancelled AND rescheduled onto a
        different target — the one detector that acts, because a wedged
        relocation holds a throttle slot that starves every later move
        (drains would never converge)."""
        alloc = getattr(getattr(self.node, "multihost", None),
                        "allocator", None)
        if alloc is None:
            return []
        bound = self.config["relocation_bound_s"]
        trips = []
        for mv in alloc.inflight_snapshot():
            if mv.get("cancelled"):
                continue  # already being torn down; don't double-trip
            age = mv["age_seconds"]
            detail = dict(mv, age_seconds=round(age, 3),
                          bound_seconds=bound)
            if age > bound:
                trips.append(self._trip(
                    "relocation_stall",
                    f"relocation [{mv['index']}][{mv['shard']}] "
                    f"{mv['source']}->{mv['target']} in flight "
                    f"{age:.1f}s (bound {bound:.1f}s) — cancelling and "
                    f"rescheduling", detail))
                try:
                    alloc.cancel_relocation(
                        (mv["index"], mv["shard"], mv["target"]),
                        reschedule=True, reason="watchdog trip")
                except Exception:
                    pass  # the trip evidence stands even if the
                    # cancel races the stream finishing
            elif age > bound / 2.0:
                self.node.flight.record("slow_ops",
                                        detector="relocation_stall",
                                        **detail)
        return trips

    # -- trip → incident -----------------------------------------------------

    def _trip(self, detector: str, reason: str, detail: dict) -> dict:
        """One detector trip: counter + tracer event + flight entry, and
        an incident dump unless the detector is inside its cooldown."""
        with self._lock:
            self.trips[detector] = self.trips.get(detector, 0) + 1
        self._m_trips.labels(detector).inc()
        flight.note_trip(detector)
        self.node.flight.record("trips", detector=detector, reason=reason,
                                detail=detail)
        try:
            with self.node.tracer.span("watchdog.trip", detector=detector):
                pass
        except Exception:
            pass  # tracer trouble must not suppress the incident
        incident_id = None
        now = time.monotonic()
        last = self._last_incident.get(detector)
        if last is None or now - last > self.config["cooldown_s"]:
            self._last_incident[detector] = now
            incident_id = self._capture(detector, reason, detail)
        return {"detector": detector, "reason": reason, "detail": detail,
                "incident_id": incident_id}

    def _capture(self, detector: str, reason: str, detail: dict) -> str:
        """Assemble and persist one incident dump."""
        node = self.node
        incident_id = f"{node.node_id}:{next(self._seq)}"
        payload = {
            "version": flight.INCIDENT_VERSION,
            "id": incident_id,
            "node": node.node_id,
            "node_name": node.name,
            "detector": detector,
            "reason": reason,
            "detail": detail,
            "timestamp_ms": int(time.time() * 1000),
            "flight": node.flight.snapshot(),
            "hot_threads": hot_threads_snapshot(),
            "programs": programs_section(table=True),
            "tasks": [t.to_json() for t in node.tasks.list_tasks()][:128],
        }
        self.incidents.save(payload)
        with self._lock:
            self.incidents_captured += 1
        flight.note_incident()
        return incident_id

    # -- views ---------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            trips = dict(self.trips)
            captured = self.incidents_captured
        return {
            "running": self.running,
            "ticks": self.ticks,
            "trips": trips,
            "incidents_captured": captured,
            "inflight_ops": self.board.snapshot(),
            "config": {k: self.config[k] for k in sorted(self.config)},
        }
