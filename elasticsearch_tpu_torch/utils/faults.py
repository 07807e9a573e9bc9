"""Deterministic fault injection: named points, seed-driven firing.

Port of elasticsearch_tpu/utils/faults.py (ES's MockTransportService and
MockFSDirectoryService hooks): production code calls
``FAULTS.check("<point>", **ctx)`` at a failure-domain boundary, a no-op
until a test arms that point with ``FAULTS.inject``, or the
``ESTPU_FAULTS`` environment variable arms it in a subprocess member.

Every firing decision is a pure function of the fault's configuration and
the sequence of ``check`` calls: a probabilistic fault draws from a
``random.Random(seed)`` it owns, after its ``count`` and ``after`` gates,
so a chaos test that fails replays identically under the same seed.

The points the port passes through:

    transport.send        before a client transport connect
                          (cluster/transport.py)
    transport.recv        after the request frame is written, before
                          the response is read (a mid-request failure)
    translog.append       before a translog frame is written
                          (index/translog.py)
    translog.fsync        in place of the durability fsync
    segment.freeze        before a refresh freezes the RAM buffer
                          (index/engine.py)
    recovery.shard_sync   before a recovery source streams its shard
    recovery.ops_replay   before each op of a checkpoint-based recovery
                          replay lands on the target (index/recovery.py,
                          cluster/search_action.py::_on_recover)
    replication.fanout    before a primary fans an op out to one replica
                          copy (cluster/replication.py::_fanout)
    resources.reserve     before every breaker reservation of the
                          residency registry (resources/residency.py)
    discovery.vote        before a vote-request handler grants or denies
                          a ballot (cluster/bootstrap.py)
    publish.commit        between publish phase 1 (the quorum of acks)
                          and the commit fan-out
    discovery.partition   link-level drop, checked on every client
                          connect with the local node id in ctx, so a
                          test drops exactly the minority<->majority
                          links in both directions
    watchdog.program_stall
                          inside the watchdog's program-stall scan
                          (monitor/watchdog.py): an armed fault makes
                          every in-flight device dispatch count as
                          stalled, driving the trip, the incident and
                          its persistence without a real hang
    allocation.decide     inside the allocator's per-move decider pass
                          (cluster/allocator.py; ctx: index, shard,
                          source, target)
    relocation.stream     at the head of an allocator-driven relocation
                          stream (cluster/search_action.py::_on_recover):
                          an armed fault wedges the move, driving the
                          relocation watchdog's cancel and reschedule
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

#: the canonical point names — ``inject`` validates against this set so a
#: typo'd point fails the test loudly instead of silently never firing.
POINTS = frozenset({
    "transport.send",
    "transport.recv",
    "translog.append",
    "translog.fsync",
    "segment.freeze",
    "recovery.shard_sync",
    "recovery.ops_replay",
    "replication.fanout",
    "resources.reserve",
    "discovery.vote",
    "publish.commit",
    "discovery.partition",
    "watchdog.program_stall",
    "allocation.decide",
    "relocation.stream",
})


class _Fault:
    """One armed injection point. Firing is deterministic: the decision
    sequence depends only on (count, after, prob, seed, match) and the
    order of ``check`` calls."""

    def __init__(self, point: str, error: Any, count: int, after: int,
                 prob: Optional[float], seed: int,
                 match: Optional[Callable[[dict], bool]]):
        self.point = point
        self.error = error
        self.remaining = count        # -1 = unlimited
        self.after = after            # skip the first N matching checks
        self.prob = prob
        self.match = match
        self.seen = 0                 # matching checks observed
        self.fired = 0
        import random

        self._rng = random.Random(seed)

    def should_fire(self, ctx: dict) -> bool:
        if self.match is not None and not self.match(ctx):
            return False
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.remaining == 0:
            return False
        # the draw happens AFTER the count/after gates so the decision
        # stream stays aligned with eligible checks only
        if self.prob is not None and self._rng.random() >= self.prob:
            return False
        if self.remaining > 0:
            self.remaining -= 1
        self.fired += 1
        return True

    def make_error(self) -> BaseException:
        if isinstance(self.error, type) and issubclass(self.error,
                                                       BaseException):
            return self.error(f"injected fault at [{self.point}]")
        if isinstance(self.error, BaseException):
            return self.error
        raise TypeError(f"fault error must be an exception class or "
                        f"instance, got {self.error!r}")


class FaultRegistry:
    """Process-global registry of armed faults, keyed by point name.

    Tests arm points directly (``FAULTS.inject(...)``); subprocess cluster
    members arm via ``ESTPU_FAULTS`` (parsed once at import). ``check``
    is on hot paths (translog append, transport send), so the disarmed
    case is a single attribute read + truthiness test.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: Dict[str, List[_Fault]] = {}
        #: (point, ctx) tuples for every fired fault — chaos tests assert
        #: against this to prove the failure they observed was theirs
        self.history: List[tuple] = []

    def inject(self, point: str, error: Any = OSError, *, count: int = 1,
               after: int = 0, prob: Optional[float] = None, seed: int = 0,
               match: Optional[Callable[[dict], bool]] = None) -> None:
        """Arm ``point`` to raise ``error``.

        count: firings before the fault disarms itself (-1 = unlimited).
        after: matching checks to let through before becoming eligible.
        prob/seed: fire with probability ``prob`` per eligible check,
            drawn from ``random.Random(seed)`` — reproducible flake.
        match: ``match(ctx) -> bool`` narrows to specific call sites
            (e.g. only the query-phase transport action).
        """
        if point not in POINTS:
            raise ValueError(f"unknown fault point [{point}] — "
                             f"known: {sorted(POINTS)}")
        with self._lock:
            self._faults.setdefault(point, []).append(
                _Fault(point, error, count, after, prob, seed, match))

    def clear(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._faults.clear()
                self.history.clear()
            else:
                self._faults.pop(point, None)

    def active(self, point: str) -> bool:
        with self._lock:
            return bool(self._faults.get(point))

    def fired(self, point: str) -> int:
        with self._lock:
            return sum(1 for p, _ in self.history if p == point)

    def check(self, point: str, **ctx) -> None:
        """Raise the armed error if ``point`` should fire; no-op (and
        near-free) when nothing is armed."""
        if not self._faults:  # disarmed fast path — no lock taken
            return
        with self._lock:
            faults = self._faults.get(point)
            if not faults:
                return
            for f in faults:
                if f.should_fire(ctx):
                    if f.remaining == 0:
                        faults.remove(f)
                    self.history.append((point, ctx))
                    raise f.make_error()


def _parse_env_spec(spec: str, registry: "FaultRegistry") -> None:
    """``ESTPU_FAULTS`` grammar — arm faults in a fresh process:

        point[:key=value]* [;point...]
        e.g. "translog.fsync:count=1;transport.send:prob=0.5:seed=7"

    Recognised keys: count, after, prob, seed, error (oserror | timeout |
    connrefused | breaker). Used by subprocess cluster members where the
    test can't reach the registry object directly.
    """
    import socket

    from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException

    errors = {"oserror": OSError, "timeout": socket.timeout,
              "connrefused": ConnectionRefusedError,
              "breaker": CircuitBreakingException}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        point, kw = fields[0].strip(), {}
        for f in fields[1:]:
            k, _, v = f.partition("=")
            k = k.strip()
            if k == "error":
                kw["error"] = errors[v.strip().lower()]
            elif k == "prob":
                kw["prob"] = float(v)
            elif k in ("count", "after", "seed"):
                kw[k] = int(v)
            else:
                raise ValueError(f"unknown ESTPU_FAULTS key [{k}]")
        registry.inject(point, **kw)


#: the process-global registry every injection point consults
FAULTS = FaultRegistry()

_env_spec = os.environ.get("ESTPU_FAULTS")
if _env_spec:
    _parse_env_spec(_env_spec, FAULTS)
