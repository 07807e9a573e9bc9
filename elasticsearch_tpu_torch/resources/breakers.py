"""Hierarchical circuit breakers for device memory (HBM).

Reference: org/elasticsearch/common/breaker/CircuitBreaker.java +
indices/breaker/HierarchyCircuitBreakerService.java — a parent breaker
caps the sum of its children (``fielddata``, ``request``,
``in_flight_requests``); each child has a dynamically-updatable
``limit`` and ``overhead`` (``indices.breaker.*`` settings), and
exceeding a limit fails the REQUEST with a typed
``CircuitBreakingException`` instead of OOMing the node.

TPU adaptation: the budgeted resource is device HBM, not JVM heap.
Percent limits resolve against ``ESTPU_HBM_BYTES`` (default 16 GiB —
deliberately static so the breaker works identically on CPU tier-1 runs
and real chips). One accelerator-extra child joins the ES trio:

  ``segments``  frozen-segment baseline structures (postings, live
                masks) charged at refresh/merge by the engine — the
                successor of the old ad-hoc ``SEGMENT_HBM_BUDGET``.

The ``fielddata`` child accounts every *lazily-loaded evictable* device
copy (doc-value columns, vector slabs, dense impact blocks) through
resources/residency.py, which evicts LRU copies under pressure before
letting the breaker trip.

A node over several devices keeps one service: every device's
residency registry charges it, so its totals count all of them, and
each registry bounds its own device with a budget of its own
(``resources/residency.py``).

Thread safety: one service-level RLock orders every child/parent check —
searches and refreshes charge concurrently under the threading REST
server.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException


def hbm_capacity() -> int:
    """The byte base percent limits resolve against. Env-pinned rather
    than read from the device so limits are deterministic across
    CPU/TPU and across restarts (the reference resolves against -Xmx,
    which is equally static)."""
    env = os.environ.get("ESTPU_HBM_BYTES")
    if env:
        return int(env)
    return 16 << 30


def parse_limit(v, capacity: Optional[int] = None) -> int:
    """ES byte-size grammar → bytes: int, "512mb", "2gb", "60%", -1
    (= unlimited, like the reference's -1 parent limit)."""
    if v is None:
        raise ValueError("limit must not be None")
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v)
    s = str(v).strip().lower()
    if s in ("-1", "none", "unbounded"):
        return -1
    if s.endswith("%"):
        pct = float(s[:-1])
        if not 0 <= pct <= 100:
            raise ValueError(f"percent limit out of range [{v}]")
        return int((capacity if capacity is not None else hbm_capacity())
                   * pct / 100.0)
    for suf, mul in (("pb", 1 << 50), ("tb", 1 << 40), ("gb", 1 << 30),
                     ("mb", 1 << 20), ("kb", 1 << 10), ("b", 1)):
        if s.endswith(suf):
            return int(float(s[: -len(suf)]) * mul)
    return int(float(s))


def human_bytes(n: int) -> str:
    """ES-style byte rendering ("512.0kb") — shared by breaker stats and
    the serving QoS layer's "Data too large" messages."""
    if n < 0:
        return "-1b"
    f = float(n)
    for suf in ("b", "kb", "mb", "gb", "tb"):
        if f < 1024 or suf == "tb":
            return f"{f:.1f}{suf}" if suf != "b" else f"{int(f)}b"
        f /= 1024
    return f"{int(n)}b"


_human = human_bytes  # module-internal call sites predate the public name


class CircuitBreaker:
    """One named byte budget. Usable standalone (the old ``HbmBudget``
    contract: reserve/force/release/used/total) or registered in a
    :class:`CircuitBreakerService`, where every reservation also checks
    the parent's combined limit."""

    def __init__(self, name: str, limit: int, overhead: float = 1.0,
                 service: Optional["CircuitBreakerService"] = None):
        self.name = name
        self.limit = int(limit)
        self.overhead = float(overhead)
        self.used = 0
        self.trip_count = 0
        self._service = service
        self._lock = service._lock if service is not None \
            else threading.RLock()

    # -- HbmBudget-compatible surface ---------------------------------------

    @property
    def total(self) -> int:
        return self.limit

    def remaining(self) -> int:
        with self._lock:
            if self.limit < 0:
                return 1 << 62
            return max(0, int(self.limit / max(self.overhead, 1e-9))
                       - self.used)

    def _would_trip(self, n: int) -> bool:
        return self.limit >= 0 and (self.used + n) * self.overhead > self.limit

    def reserve(self, n: int, count_trip: bool = True) -> bool:
        """Charge ``n`` bytes; False (and a ``tripped`` tick) when this
        breaker's or the parent's limit would be exceeded. A counted
        trip of a breaker in a service is recorded in the service's
        flight recorder (its node's; the reference records into every
        recorder of the process)."""
        parent = False
        with self._lock:
            if self._would_trip(n):
                if count_trip:
                    self.trip_count += 1
            elif self._service is not None \
                    and self._service._parent_would_trip(n):
                if count_trip:
                    self._service.parent_tripped += 1
                    self.trip_count += 1
                parent = True
            else:
                self.used += n
                return True
            used, limit = self.used, self.limit
        # outside the breaker lock: no new lock order
        rec = self._service.flight if self._service is not None else None
        if count_trip and rec is not None:
            rec.record("breaker_trips", breaker=self.name, parent=parent,
                       bytes_wanted=used + n, bytes_limit=limit)
        return False

    def break_or_reserve(self, n: int, label: str = "<unknown>") -> None:
        """reserve() or raise the ES-shaped CircuitBreakingException."""
        if self.reserve(n):
            return
        with self._lock:
            used, limit = self.used, self.limit
        raise CircuitBreakingException(
            f"[{self.name}] Data too large, data for [{label}] would be "
            f"[{used + n}/{_human(used + n)}] bytes, which is larger than "
            f"the limit of [{limit}/{_human(limit)}]",
            bytes_wanted=used + n, bytes_limit=limit)

    def force(self, n: int) -> None:
        """Unconditional charge — for paths that net-release memory and
        must never fail on transient accounting order (merges, tracked
        executor caches)."""
        with self._lock:
            self.used += n

    def release(self, n: int) -> None:
        with self._lock:
            self.used = max(0, self.used - n)

    def stats(self) -> dict:
        with self._lock:
            return {
                "limit_size_in_bytes": self.limit,
                "limit_size": _human(self.limit),
                "estimated_size_in_bytes": self.used,
                "estimated_size": _human(self.used),
                "overhead": self.overhead,
                "tripped": self.trip_count,
            }


class HbmBudget(CircuitBreaker):
    """Back-compat constructor for the pre-resources ad-hoc budget
    (tests and embedders build ``HbmBudget(total_bytes=...)``)."""

    def __init__(self, total_bytes: int = 2 << 30):
        super().__init__("adhoc", total_bytes)


#: (child name, default limit spec, default overhead, settings key prefix)
_DEFAULTS = (
    ("fielddata", "60%", 1.03, "indices.breaker.fielddata."),
    ("request", "40%", 1.0, "indices.breaker.request."),
    ("in_flight_requests", "100%", 1.0,
     "network.breaker.inflight_requests."),
    ("segments", None, 1.0, "indices.breaker.segments."),
)


def _segments_default() -> int:
    # honors the pre-resources env knob so existing deployments keep
    # their configured segment budget
    return int(os.environ.get("ESTPU_SEGMENT_BUDGET_BYTES", 8 << 30))


class CircuitBreakerService:
    """The breaker hierarchy: parent + named children, ES-shaped stats,
    dynamic ``indices.breaker.*`` / ``network.breaker.*`` settings."""

    PARENT_KEY = "indices.breaker.total.limit"

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.RLock()
        self.capacity = capacity if capacity is not None else hbm_capacity()
        self.parent_limit = parse_limit("70%", self.capacity)
        self.parent_tripped = 0
        # the owning node's flight recorder (monitor/flight.py), set by
        # the Node; trips record there
        self.flight = None
        self._children: Dict[str, CircuitBreaker] = {}
        for name, limit, overhead, _prefix in _DEFAULTS:
            lb = (_segments_default() if limit is None
                  else parse_limit(limit, self.capacity))
            self._children[name] = CircuitBreaker(name, lb, overhead,
                                                  service=self)

    def breaker(self, name: str) -> CircuitBreaker:
        return self._children[name]

    def _parent_would_trip(self, n: int) -> bool:
        # caller holds self._lock (children share it)
        if self.parent_limit < 0:
            return False
        return sum(c.used for c in self._children.values()) + n \
            > self.parent_limit

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        """Apply the MERGED persistent+transient cluster settings map:
        a present key sets, an absent key resets to the default —
        idempotent from the full map, so setting deletion (PUT with
        null) needs no special casing at the call site."""
        with self._lock:
            v = flat.get(self.PARENT_KEY)
            self.parent_limit = (parse_limit(v, self.capacity)
                                 if v is not None
                                 else parse_limit("70%", self.capacity))
            for name, limit, overhead, prefix in _DEFAULTS:
                br = self._children[name]
                lv = flat.get(prefix + "limit")
                if lv is not None:
                    br.limit = parse_limit(lv, self.capacity)
                else:
                    br.limit = (_segments_default() if limit is None
                                else parse_limit(limit, self.capacity))
                ov = flat.get(prefix + "overhead")
                br.overhead = float(ov) if ov is not None else overhead

    def hbm_usage(self) -> "tuple[int, int]":
        """``(used_bytes, capacity_bytes)`` snapshot for watermark
        reads: the parent's combined child bytes (which already include
        device-resident residency charges) over the capacity limits
        resolve against. One locked sum instead of the full ``stats()``
        render — the allocator probes this on every usage refresh and
        the disk-watermark deciders compare it against the
        ``cluster.routing.allocation.disk.watermark.*`` thresholds."""
        with self._lock:
            return (sum(c.used for c in self._children.values()),
                    self.capacity)

    def stats(self) -> dict:
        """``/_nodes/stats/breaker`` section (reference:
        AllCircuitBreakerStats.toXContent shape)."""
        with self._lock:
            out = {name: br.stats() for name, br in self._children.items()}
            est = sum(br.used for br in self._children.values())
            out["parent"] = {
                "limit_size_in_bytes": self.parent_limit,
                "limit_size": _human(self.parent_limit),
                "estimated_size_in_bytes": est,
                "estimated_size": _human(est),
                "overhead": 1.0,
                "tripped": self.parent_tripped,
            }
            return out
