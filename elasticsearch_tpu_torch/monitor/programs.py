"""Device-program observatory: the in-flight half.

Port of the part of elasticsearch_tpu/monitor/programs.py that the stall
watchdog reads (monitor/watchdog.py): which device dispatches are in
flight and for how long, and each dispatch key's execute-time history,
from which the watchdog derives its adaptive stall bound.

A key is ``(program, shapes)``: ``program`` names a dispatch point
(``mesh_dsl``, ``mesh_bm25``, ``mesh_knn``, ``ivf_search``...) and
``shapes`` its static shape class (:func:`static_sig`). The port pads no
query to a power of two, so every size that can vary per request enters
the key as its power-of-two class (``utils/shapes.py::pow2_bucket``): the
table stays bounded however many query lengths the node sees.

On the card a launch returns before its kernel ends. :meth:`timed`
therefore brackets the dispatch up to the host's read of its result
(the copy back the search already makes): a kernel that never finishes
keeps its dispatch in flight, where the watchdog sees it age, and the
execute time that feeds ``execute_p99`` includes the device time.

The brackets stand for the reference's dispatch points: its
``parallel/executor.py`` ``mesh_bm25`` (:677) is ``_search_round``'s
``_score_chunks``; ``mesh_knn``/``mesh_maxsim`` (:787) each round of
``_search_vector_rounds``; ``mesh_dsl``'s memo and fresh runs (:868,
:984) the ``_run_round`` call of ``search_dsl``, both paths alike (the
scatter retry of :1006 has none: the port raises instead); its
``ops/ivf.py`` ``ivf_search``/``ivf_pq_search`` (:232, :278)
``ops/ivf.py::ivf_candidate_scores``. The host loop's B1 calls
(``search/queries.py::fused_bm25_topk`` and
``fused_bm25_topk_batch``) are bracketed too, as ``bm25_fused_topk`` and
``batch_bm25_fused``.

Left for the compile/warm layer (ROADMAP A11): compile attribution, the
per-index census, the program table (``snapshot``), ``_cat/programs``
and the ``programs`` section of ``_nodes/stats``.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Tuple

from elasticsearch_tpu_torch.monitor.flight import OpBoard
from elasticsearch_tpu_torch.monitor.metrics import (DEFAULT_LATENCY_BUCKETS,
                                                     OVERFLOW_LABEL,
                                                     Histogram)


def static_sig(**dims: Any) -> str:
    """``Q=8|D=1024|k=10``: the static shape-class dims of a dispatch
    point, sorted by name."""
    return "|".join(f"{k}={dims[k]}" for k in sorted(dims))


class ProgramEntry:
    """Execute counters of one (program, shapes) key."""

    __slots__ = ("program", "shapes", "calls", "execute_seconds", "hist")

    def __init__(self, program: str, shapes: str):
        self.program = program
        self.shapes = shapes
        self.calls = 0
        self.execute_seconds = 0.0
        self.hist = Histogram(DEFAULT_LATENCY_BUCKETS)

    def to_json(self) -> dict:
        return {
            "program": self.program,
            "shapes": self.shapes,
            "calls": self.calls,
            "execute_seconds": round(self.execute_seconds, 6),
            "execute_p50_seconds": round(self.hist.percentile(50), 6),
            "execute_p99_seconds": round(self.hist.percentile(99), 6),
        }


class ProgramRegistry:
    """Thread-safe (program, shapes) -> :class:`ProgramEntry` table and
    the board of dispatches in flight. One per process (:data:`REGISTRY`):
    the card is shared by every node in it."""

    _MAX_KEYS = 512  # past the cap new keys collapse into ``_other_``

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], ProgramEntry] = {}
        # a dispatch that never returns records nothing in the counters
        # above; the stall detector reads its age here
        self._inflight = OpBoard()

    def _entry(self, program: str, shapes: str) -> ProgramEntry:
        key = (program, shapes)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                if len(self._entries) >= self._MAX_KEYS:
                    key = (OVERFLOW_LABEL, OVERFLOW_LABEL)
                    e = self._entries.get(key)
                if e is None:
                    e = self._entries[key] = ProgramEntry(*key)
        return e

    def record_execute(self, program: str, shapes: str,
                       seconds: float) -> None:
        """One dispatch of ``seconds``, device time included."""
        e = self._entry(program, shapes)
        e.hist.observe(float(seconds))
        with self._lock:
            e.calls += 1
            e.execute_seconds += float(seconds)

    # -- in-flight dispatches (the watchdog's feed) ---------------------------

    def begin_dispatch(self, program: str, shapes: str) -> int:
        """Mark one dispatch in flight; returns the token
        :meth:`end_dispatch` retires."""
        return self._inflight.begin(program, shapes=shapes)

    def end_dispatch(self, token: int) -> None:
        self._inflight.end(token)

    def inflight_snapshot(self) -> List[dict]:
        """Every dispatch in flight, with its age."""
        return [{"program": r["kind"], "shapes": r.get("shapes", ""),
                 "age_seconds": r["age_seconds"]}
                for r in self._inflight.snapshot()]

    def execute_p99(self, program: str, shapes: str) -> Tuple[float, int]:
        """(execute p99 seconds, call count) of one key: the watchdog's
        adaptive bound comes from the key's own history."""
        with self._lock:
            e = self._entries.get((program, shapes))
            if e is None:
                return 0.0, 0
            calls = e.calls
        return e.hist.percentile(99), calls

    @contextmanager
    def timed(self, program: str, shapes: str):
        """Bracket one dispatch: in flight from entry to exit, and its
        wall time recorded as an execute when the block returns. The
        block must end with the host's read of the dispatch's result.
        Nothing records when the block raises."""
        tok = self.begin_dispatch(program, shapes)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.end_dispatch(tok)
        self.record_execute(program, shapes, time.perf_counter() - t0)

    # -- views ----------------------------------------------------------------

    def rows(self) -> List[dict]:
        """Per-key execute rows, sorted by (program, shapes)."""
        with self._lock:
            entries = sorted(self._entries.values(),
                             key=lambda e: (e.program, e.shapes))
        return [e.to_json() for e in entries]

    def stats(self) -> dict:
        """Totals over every key."""
        with self._lock:
            entries = list(self._entries.values())
        return {"keys": len(entries),
                "calls": sum(e.calls for e in entries),
                "execute_seconds": round(
                    sum(e.execute_seconds for e in entries), 6)}


#: the process singleton every dispatch point records into
REGISTRY = ProgramRegistry()
