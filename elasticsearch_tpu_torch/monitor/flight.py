"""Flight recorder: always-on bounded rings of runtime anomalies.

Port of elasticsearch_tpu/monitor/flight.py. ES 2.x has no flight
recorder (its ancestors are the JVM's JFR and the hot-threads and
pending-tasks endpoints). Spans, tasks and metrics are pull-observable:
a wedged dispatch or drain shows only if an operator scrapes at the
right moment, and the evidence dies with the process. This is the push
half, a node-wide black box every anomaly source appends into:

- periodic metric-delta snapshots (the watchdog's tick sampler),
- slow-op events (detector observations below their trip bound),
- breaker trips (resources/breakers.py),
- device-program compile events (monitor/programs.py: a dispatch that
  paid first-touch work),
- election and publish transitions (cluster/bootstrap.py),
- engine failures (index/engine.py tragic events),
- watchdog trips (monitor/watchdog.py).

Every entry carries a monotonic timestamp (ordering and age math), a
display-only epoch timestamp, and the active trace id when there is one,
so an incident dump joins against the span ring.

Each ``Node`` owns a :class:`FlightRecorder` (``node.flight``) and
registers it with this module. Engines and the translog have no node
back-reference: they record through the module-level :func:`record`,
which fans to every live recorder in the process. The port's breakers
belong to their node (ROADMAP C20), so a trip records into its own
node's recorder only, where the reference fans it to every recorder.
Node-scoped sources (bootstrap, watchdog) record into their node's
recorder directly.

Hot-path cost: one short lock around a deque append; nothing reads a
device value. Ring ordering and age math use ``time.monotonic()``;
``time.time()`` is the display timestamp only.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: ring name -> bounded capacity. Capacities are part of the diagnostics
#: bundle's schema contract (the tests assert snapshots never
#: exceed them): counters stay exact forever, per-event detail is last-N.
RING_CAPS: Dict[str, int] = {
    "metrics": 128,          # watchdog tick delta snapshots
    "slow_ops": 256,         # below-threshold detector observations
    "breaker_trips": 256,    # CircuitBreakingException admissions denials
    "compiles": 256,         # device-program (re)traces
    "cluster": 256,          # election / publish / step-down transitions
    "engine_failures": 64,   # tragic engine events
    "trips": 128,            # watchdog detector trips
}


class FlightRecorder:
    """One node's black box: a bounded deque per ring + exact counters."""

    def __init__(self, node_id: str = "", node_name: str = ""):
        self.node_id = node_id
        self.node_name = node_name
        self._lock = threading.Lock()
        self._rings: Dict[str, deque] = {
            name: deque(maxlen=cap) for name, cap in RING_CAPS.items()}
        self._counts: Dict[str, int] = {name: 0 for name in RING_CAPS}

    def record(self, ring: str, **fields: Any) -> None:
        """Append one event. Unknown ring names raise (a typo'd source
        would otherwise record into the void forever). The active trace
        id is attached when this flow runs under a span, so incident
        dumps join against the tracer ring."""
        entry: Dict[str, Any] = {
            "ts_monotonic": time.monotonic(),
            "timestamp_ms": int(time.time() * 1000),  # display only
        }
        try:
            from elasticsearch_tpu_torch.tracing.tracer import current_context

            ctx = current_context()
            if ctx is not None:
                entry["trace_id"] = ctx.trace_id
        except Exception:
            pass  # tracing must never fail a recording
        entry.update(fields)
        with self._lock:
            self._rings[ring].append(entry)
            self._counts[ring] += 1

    def ring(self, name: str) -> List[dict]:
        with self._lock:
            return list(self._rings[name])

    def events_since(self, ring: str, ts_monotonic: float) -> List[dict]:
        """Events recorded after ``ts_monotonic`` — the watchdog's
        incremental scan over rings fed by other threads."""
        with self._lock:
            return [e for e in self._rings[ring]
                    if e["ts_monotonic"] > ts_monotonic]

    def snapshot(self) -> dict:
        """The whole box: every ring's retained events + exact lifetime
        counts + the capacity contract. This is the ``flight`` section
        of an incident dump and of ``GET /_nodes/_local/flight``."""
        with self._lock:
            return {
                "node": self.node_id,
                "rings": {name: list(ring)
                          for name, ring in self._rings.items()},
                "counts": dict(self._counts),
                "ring_caps": dict(RING_CAPS),
            }

    def stats(self) -> dict:
        with self._lock:
            return {"counts": dict(self._counts),
                    "retained": {name: len(ring)
                                 for name, ring in self._rings.items()}}


class OpBoard:
    """In-flight named operations: ``begin`` returns a token, ``end``
    retires it, ``snapshot`` reports ages. The ONE age-board behind both
    the watchdog's publish tracking and the ProgramRegistry's in-flight
    dispatch table — a hang records nothing in any completion-fed
    counter, which is exactly the gap this closes. Monotonic clock; one
    short lock; begin/end are the only hot-path cost."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0
        self._ops: Dict[int, tuple] = {}

    def begin(self, kind: str, **detail: Any) -> int:
        with self._lock:
            self._seq += 1
            tok = self._seq
            self._ops[tok] = (kind, detail, time.monotonic())
        return tok

    def end(self, token: int) -> None:
        with self._lock:
            self._ops.pop(token, None)

    def snapshot(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            items = list(self._ops.values())
        return [{"kind": kind, "age_seconds": now - t0, **detail}
                for kind, detail, t0 in items]

    def clear(self) -> None:
        with self._lock:
            self._ops.clear()


# ---------------------------------------------------------------------------
# process-level fan: sources with no node back-reference
# ---------------------------------------------------------------------------

_REG_LOCK = threading.Lock()
_RECORDERS: List[FlightRecorder] = []


def register(rec: FlightRecorder) -> None:
    """Add a node's recorder to the process fan (Node.__init__)."""
    with _REG_LOCK:
        if rec not in _RECORDERS:
            _RECORDERS.append(rec)


def unregister(rec: FlightRecorder) -> None:
    with _REG_LOCK:
        try:
            _RECORDERS.remove(rec)
        except ValueError:
            pass


def record(ring: str, **fields: Any) -> None:
    """Record an event of a subsystem with no node back-reference (an
    engine failure) into every live node's ring: the SHARED-metrics
    rule. Near-free when no node is live."""
    with _REG_LOCK:
        recs = list(_RECORDERS)
    for rec in recs:
        try:
            rec.record(ring, **fields)
        except Exception:
            pass  # recording must never fail the recording source


# ---------------------------------------------------------------------------
# process-wide trip/incident counters (bench before/after delta)
# ---------------------------------------------------------------------------

_TRIP_LOCK = threading.Lock()
_TRIPS: Dict[str, int] = {}
_INCIDENTS_TOTAL = 0


def note_trip(detector: str) -> None:
    with _TRIP_LOCK:
        _TRIPS[detector] = _TRIPS.get(detector, 0) + 1


def note_incident() -> None:
    global _INCIDENTS_TOTAL
    with _TRIP_LOCK:
        _INCIDENTS_TOTAL += 1


def trip_counters() -> Dict[str, float]:
    """Flat counter map for monitor.metrics.process_counters(): a stall
    during a bench round shows up in its counter delta."""
    with _TRIP_LOCK:
        out = {f"watchdog.trips.{d}": float(v) for d, v in _TRIPS.items()}
        out["watchdog.trips"] = float(sum(_TRIPS.values()))
        out["watchdog.incidents"] = float(_INCIDENTS_TOTAL)
    return out


# ---------------------------------------------------------------------------
# incident persistence (the generic blob helpers of index/ivf_cache.py)
# ---------------------------------------------------------------------------

INCIDENT_VERSION = 1
_EXT = "incident"
_INDEX_KEY = "incident_index"
_INDEX_CAP = 64  # persisted incident index entries (oldest evicted)
_STORE_LOCK = threading.Lock()  # serializes index read-modify-write


def incident_key(incident_id: str) -> str:
    """Blob-cache key for one incident (filename-safe: ids carry ':')."""
    return "incident_" + hashlib.sha1(
        incident_id.encode("utf-8")).hexdigest()


class IncidentStore:
    """Bounded in-memory incident list + durable-blob persistence.

    Each saved incident becomes one digest-framed blob beside the IVF/PQ
    artifacts, and an entry in a shared index blob so a restarted
    process can list (and load) what the previous one captured. The
    index is process-shared like the blob cache itself: entries carry
    their origin node and dedup by incident id."""

    _MEM_CAP = 32  # full payloads retained in memory per store

    def __init__(self):
        self._lock = threading.Lock()
        self._payloads: "deque[dict]" = deque(maxlen=self._MEM_CAP)

    # -- save ----------------------------------------------------------------

    def save(self, incident: dict) -> str:
        """Persist one incident dump; returns its blob key. Persistence
        is best-effort (a failed disk write still leaves the in-memory
        copy and the process-shared memory blob)."""
        key = incident_key(str(incident["id"]))
        incident = dict(incident, blob_key=key)
        with self._lock:
            self._payloads.append(incident)
        try:
            from elasticsearch_tpu_torch.index import ivf_cache

            ivf_cache.store_blob(key, ivf_cache.frame_blob(incident), _EXT)
            meta = {k: incident.get(k)
                    for k in ("id", "node", "node_name", "detector",
                              "reason", "timestamp_ms", "blob_key")}
            with _STORE_LOCK:
                entries = self._load_index()
                entries = [e for e in entries if e.get("id") != meta["id"]]
                entries.append(meta)
                evicted, entries = entries[:-_INDEX_CAP], \
                    entries[-_INDEX_CAP:]
                ivf_cache.store_blob(
                    _INDEX_KEY,
                    ivf_cache.frame_blob({"version": INCIDENT_VERSION,
                                          "entries": entries}), _EXT)
            # an index entry rolling off takes its payload blob with it:
            # an unlistable incident must not leak disk forever
            for e in evicted:
                if e.get("blob_key"):
                    ivf_cache.delete_blob(e["blob_key"], _EXT)
        except Exception:
            pass  # an incident must never fail the tripping thread
        return key

    # -- list / load ---------------------------------------------------------

    @staticmethod
    def _load_index() -> List[dict]:
        from elasticsearch_tpu_torch.index import ivf_cache

        blob = ivf_cache.load_blob(_INDEX_KEY, _EXT)
        if blob is None:
            return []
        payload = ivf_cache.unframe_blob(blob)
        if payload is None or not isinstance(payload.get("entries"), list):
            ivf_cache.delete_blob(_INDEX_KEY, _EXT)  # corrupt: clean miss
            return []
        return payload["entries"]

    def list(self, include_persisted: bool = True) -> List[dict]:
        """Incident metadata, newest last: this store's live captures
        plus (by default) everything the persisted index remembers —
        dedup'd by id so a live incident isn't listed twice."""
        with self._lock:
            live = [
                {k: inc.get(k)
                 for k in ("id", "node", "node_name", "detector", "reason",
                           "timestamp_ms", "blob_key")}
                for inc in self._payloads]
        if not include_persisted:
            return live
        seen = {e["id"] for e in live}
        persisted = []
        try:
            for e in self._load_index():
                if e.get("id") not in seen:
                    persisted.append(dict(e, persisted=True))
        except Exception:
            pass
        return persisted + live

    def load(self, incident_id: str) -> Optional[dict]:
        """One incident's full payload: the in-memory copy, else the
        persisted blob (digest-verified; corruption deletes the blob and
        reads as a miss)."""
        with self._lock:
            for inc in reversed(self._payloads):
                if str(inc.get("id")) == str(incident_id):
                    return inc
        try:
            from elasticsearch_tpu_torch.index import ivf_cache

            key = incident_key(str(incident_id))
            blob = ivf_cache.load_blob(key, _EXT)
            if blob is None:
                return None
            payload = ivf_cache.unframe_blob(blob)
            if payload is None:
                ivf_cache.delete_blob(key, _EXT)
                return None
            return payload
        except Exception:
            return None

    def recent(self, n: int) -> List[dict]:
        """The last ``n`` full payloads held in memory (the diagnostics
        bundle ships these; older incidents stay fetchable by id)."""
        with self._lock:
            items = list(self._payloads)
        return items[-max(0, int(n)):]
