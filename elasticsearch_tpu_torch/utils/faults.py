"""Deterministic fault injection at named points.

Port of the part of elasticsearch_tpu/utils/faults.py (ES's
MockTransportService and MockFSDirectoryService hooks) that the port's
code reaches: production code calls ``FAULTS.check("<point>", **ctx)`` at
a failure-domain boundary, a no-op until a test arms that point with
``FAULTS.inject``. Whether a check fires depends only on the fault's
``count`` and ``match`` and the order of ``check`` calls.

The points the port passes through:

    replication.fanout    before a primary fans an op out to one replica
                          copy (cluster/replication.py::_fanout)
    recovery.ops_replay   before each op of a checkpoint-based recovery
                          replay lands on the target (index/recovery.py)
    resources.reserve     before every breaker reservation of the
                          residency registry (resources/residency.py):
                          a handle's placement or rehydration, a
                          reserved pinned charge
    transport.send        before a client transport connect
                          (cluster/transport.py)
    transport.recv        after the request frame is written, before
                          the response is read (a mid-request failure)
    discovery.partition   link-level drop, checked on every client
                          connect with the local node id in ctx, so a
                          test drops exactly the minority<->majority
                          links in both directions
    discovery.vote        before a vote-request handler grants or denies
                          a ballot (cluster/bootstrap.py)
    publish.commit        between publish phase 1 (the quorum of acks)
                          and the commit fan-out
    allocation.decide     inside the allocator's per-move decider pass
                          (cluster/allocator.py; ctx: index, shard,
                          source, target)
    relocation.stream     at the head of an allocator-driven relocation
                          stream (cluster/search_action.py::_on_recover)
    recovery.shard_sync   before a recovery source streams its shard

The reference's translog and watchdog points, its probabilistic faults
(``prob``/``seed``/``after``) and its ``ESTPU_FAULTS`` environment spec
are not here: every scenario of the port's tests is held with ``count``
and ``match``, which are deterministic.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

#: the point names ``inject`` accepts, so a typo'd point fails the test
#: loudly instead of silently never firing
POINTS = frozenset({"recovery.ops_replay", "replication.fanout",
                    "resources.reserve", "transport.send", "transport.recv",
                    "discovery.partition", "discovery.vote",
                    "publish.commit", "allocation.decide",
                    "relocation.stream", "recovery.shard_sync"})


class _Fault:
    """One armed injection point."""

    def __init__(self, point: str, error: Any, count: int,
                 match: Optional[Callable[[dict], bool]]):
        self.point = point
        self.error = error
        self.remaining = count        # -1 = unlimited
        self.match = match

    def should_fire(self, ctx: dict) -> bool:
        if self.match is not None and not self.match(ctx):
            return False
        if self.remaining == 0:
            return False
        if self.remaining > 0:
            self.remaining -= 1
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
    ``check`` is on the write path, so the disarmed case is a single
    attribute read and truthiness test."""

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: Dict[str, List[_Fault]] = {}

    def inject(self, point: str, error: Any = OSError, *, count: int = 1,
               match: Optional[Callable[[dict], bool]] = None) -> None:
        """Arm ``point`` to raise ``error``.

        count: firings before the fault disarms itself (-1 = unlimited).
        match: ``match(ctx) -> bool`` narrows it to some checks (e.g. one
            shard's fan-out).
        """
        if point not in POINTS:
            raise ValueError(f"unknown fault point [{point}] — "
                             f"known: {sorted(POINTS)}")
        with self._lock:
            self._faults.setdefault(point, []).append(
                _Fault(point, error, count, match))

    def clear(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._faults.clear()
            else:
                self._faults.pop(point, None)

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
                    raise f.make_error()


#: the process-global registry every injection point consults
FAULTS = FaultRegistry()
