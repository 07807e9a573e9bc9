"""Device-program observatory: per-key compile/execute attribution.

Port of elasticsearch_tpu/monitor/programs.py. One process-global table
of :class:`ProgramEntry` rows keyed by ``(program, shapes, backend)``:

- ``program`` names a dispatch point (``mesh_dsl``, ``mesh_bm25``,
  ``mesh_knn``, ``ivf_search``, ``bm25_fused_topk``...);
- ``shapes`` is its static shape class (:func:`static_sig`). The port
  pads no query to a power of two, so every size that can vary per
  request enters the key as its power-of-two class
  (``utils/shapes.py::pow2_bucket``): the table stays bounded however
  many query lengths the node sees;
- ``backend`` is :func:`backend_fingerprint`, which carries the device
  count, so a census taken on one card layout is never replayed on
  another (the reference's key lacks the count: ROADMAP C26).

:meth:`ProgramRegistry.timed` brackets each dispatch up to the host's
read of its result (the copy back the search already makes): a kernel
that never finishes keeps its dispatch in flight, where the watchdog
sees it age, and the execute time includes the device time. The call is
filed as a compile (``compiles``/``compile_seconds``) when the calling
thread's first-touch count (``tracing/retrace.py``) moved inside it: a
kernel library built or loaded, or the first dispatch of the key in the
process. Otherwise it is an execute (``calls``/``execute_seconds`` and
the p50/p99 histogram).

The brackets stand for the reference's dispatch points: its
``parallel/executor.py`` ``mesh_bm25`` (:677) is ``_search_round``'s
``_score_chunks``; ``mesh_knn``/``mesh_maxsim`` (:787) each round of
``_search_vector_rounds``; ``mesh_dsl``'s memo and fresh runs (:868,
:984) the ``_run_round`` call of ``search_dsl``; its ``ops/ivf.py``
``ivf_search``/``ivf_pq_search`` (:232, :278)
``ops/ivf.py::ivf_candidate_scores``. The host loop's B1 calls
(``search/queries.py::fused_bm25_topk`` and ``fused_bm25_topk_batch``)
are ``bm25_fused_topk`` and ``batch_bm25_fused``; the reference's batch
tiers' ``_tier_program`` keys are ``batch_bm25_hybrid``
(``hybrid_bm25_topk_batch``) and ``batch_knn_fused``
(``search/batch.py::knn_topk_fused_batch``).

Census: while an index's search runs inside :func:`index_scope`, every
recorded key also lands in that index's (program, shapes, field) census
set, and ``IndexService.search`` records the replayable body; both are
persisted by ``resources/census.py`` and replayed by
``serving/warmup.py``.

Cardinality: past ``_MAX_KEYS`` new keys collapse into ``_other_``.
"""
from __future__ import annotations

import contextvars
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from elasticsearch_tpu_torch.monitor.flight import OpBoard
from elasticsearch_tpu_torch.monitor.metrics import (DEFAULT_LATENCY_BUCKETS,
                                                     OVERFLOW_LABEL,
                                                     Histogram)

#: the index whose search runs on this flow: the census target
_ACTIVE_INDEX: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("estpu-program-index", default=None)

#: the (program, shapes) of the dispatch ``timed`` brackets on this
#: flow: a kernel library resolved inside it files its cache source on
#: that key (``record_cache_source``)
_ACTIVE_PROG_KEY: contextvars.ContextVar[Optional[Tuple[str, str]]] = \
    contextvars.ContextVar("estpu-program-key", default=None)


@contextmanager
def index_scope(index_name: Optional[str]):
    """Scope ``index_name`` as the census target for program records made
    below (None = record without census attribution)."""
    tok = _ACTIVE_INDEX.set(index_name)
    try:
        yield
    finally:
        _ACTIVE_INDEX.reset(tok)


# ---------------------------------------------------------------------------
# key components
# ---------------------------------------------------------------------------

_DTYPE_SHORT = {"float32": "f32", "float64": "f64", "bfloat16": "bf16",
                "float16": "f16", "int32": "i32", "int64": "i64",
                "int8": "i8", "uint8": "u8", "uint32": "u32", "bool": "b1"}


def _short_dtype(name: str) -> str:
    name = name.replace("torch.", "")
    return _DTYPE_SHORT.get(name, name)


def _one_sig(a: Any) -> str:
    """One argument's shape/dtype signature (numpy arrays and tensors);
    non-array leaves render as their type name or repr."""
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        dims = ",".join(str(int(d)) for d in shape)
        return f"{_short_dtype(str(dtype))}[{dims}]"
    if isinstance(a, (list, tuple)):
        return "(" + "+".join(_one_sig(x) for x in a) + ")"
    if isinstance(a, (bool, int, float, str)):
        return repr(a)
    return type(a).__name__


def shape_sig(args: Iterable[Any] = (), kwargs: Optional[dict] = None) -> str:
    """Canonical shape signature of a call's arguments:
    ``f32[8,1024]|i32[8,16]``, deterministic in shapes and dtypes only,
    so the same call gives the same key in every process."""
    parts = [_one_sig(a) for a in args]
    for k in sorted(kwargs or {}):
        parts.append(f"{k}={_one_sig(kwargs[k])}")
    return "|".join(parts)


def static_sig(**dims: Any) -> str:
    """``Q=8|D=1024|k=10``: the static shape-class dims of a dispatch
    point, sorted by name."""
    return "|".join(f"{k}={dims[k]}" for k in sorted(dims))


_FP_LOCK = threading.Lock()
_FP: Optional[str] = None


def backend_fingerprint() -> str:
    """``cuda/<device name>/sm_<major><minor>/n=<device count>``, or
    ``cpu/cpu/n=1`` without a card. The device count is part of it: a
    census or a library blob taken under one count is never served
    under another. Cached after first resolution."""
    global _FP
    if _FP is not None:
        return _FP
    with _FP_LOCK:
        if _FP is None:
            import torch

            if torch.cuda.is_available():
                major, minor = torch.cuda.get_device_capability(0)
                name = torch.cuda.get_device_name(0).replace(" ", "_")
                _FP = (f"cuda/{name}/sm_{major}{minor}"
                       f"/n={torch.cuda.device_count()}")
            else:
                _FP = "cpu/cpu/n=1"
        return _FP


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class ProgramEntry:
    """Counters for one (program, shapes, backend) key."""

    __slots__ = ("program", "shapes", "backend", "compiles",
                 "compile_seconds", "calls", "execute_seconds", "hist",
                 "fields", "last_used_at", "cache_sources")

    _FIELD_CAP = 8  # bounded per-entry field set (census attribution)

    def __init__(self, program: str, shapes: str, backend: str):
        self.program = program
        self.shapes = shapes
        self.backend = backend
        self.compiles = 0
        self.compile_seconds = 0.0
        self.calls = 0
        self.execute_seconds = 0.0
        self.hist = Histogram(DEFAULT_LATENCY_BUCKETS)
        self.fields: Set[str] = set()
        self.last_used_at = 0.0  # epoch, display only (no subtraction)
        # kernel-library resolutions inside this key's dispatches
        # (aot_hit / build_dir_hit / fresh: parallel/aot.py), the
        # ``cache`` column of _cat/programs
        self.cache_sources: Dict[str, int] = {}

    @property
    def cold(self) -> bool:
        """True until the key serves its first execute in this process."""
        return self.calls == 0

    def to_json(self) -> dict:
        return {
            "program": self.program,
            "shapes": self.shapes,
            "backend": self.backend,
            "compiles": self.compiles,
            "compile_seconds": round(self.compile_seconds, 6),
            "calls": self.calls,
            "execute_seconds": round(self.execute_seconds, 6),
            "execute_p50_seconds": round(self.hist.percentile(50), 6),
            "execute_p99_seconds": round(self.hist.percentile(99), 6),
            "cold": self.cold,
            "fields": sorted(self.fields),
            "last_used_at": self.last_used_at,
            "cache_sources": dict(sorted(self.cache_sources.items())),
        }


class ProgramRegistry:
    """Thread-safe (program, shapes, backend) -> :class:`ProgramEntry`
    table with per-index census sets and the board of dispatches in
    flight. One per process (:data:`REGISTRY`): the card is shared by
    every node in it."""

    _MAX_KEYS = 512          # key cap; overflow collapses, never grows
    _CENSUS_CAP = 1024       # per-index census key cap
    _BODY_CAP = 64           # per-index replayable-body cap

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str, str], ProgramEntry] = {}
        # per-index (program, shapes, field) -> hits: warmup runs
        # hottest first
        self._census: Dict[str, Dict[Tuple[str, str, str], int]] = {}
        # per-index canonical search bodies -> hits: the replayable half
        # (a dispatch key alone cannot rebuild a compiled DSL tree)
        self._bodies: Dict[str, Dict[str, int]] = {}
        # census/bodies mutation counters, per index: the watchdog's
        # flush writes only the indices that moved
        self._census_gen = 0
        self._census_gens: Dict[str, int] = {}
        # a dispatch that never returns records nothing in the counters
        # above; the stall detector reads its age here
        self._inflight = OpBoard()

    # -- entry resolution ----------------------------------------------------

    def _entry(self, program: str, shapes: str,
               field: Optional[str], census: bool = True) -> ProgramEntry:
        """Get-or-create under the lock; past the cap the overflow row
        absorbs new keys. ``census=False`` skips the per-index census
        row (cache-source accounting knows no field)."""
        backend = backend_fingerprint()
        key = (program, shapes, backend)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                if len(self._entries) >= self._MAX_KEYS:
                    key = (OVERFLOW_LABEL, OVERFLOW_LABEL, backend)
                    e = self._entries.get(key)
                if e is None:
                    e = ProgramEntry(*key)
                    self._entries[key] = e
            if field and len(e.fields) < ProgramEntry._FIELD_CAP:
                e.fields.add(field)
            index = _ACTIVE_INDEX.get()
            if census and index is not None and key[0] != OVERFLOW_LABEL:
                c = self._census.setdefault(index, {})
                ck = (program, shapes, field or "")
                if ck in c:
                    c[ck] += 1
                    self._bump_census_gen_locked(index)
                elif len(c) < self._CENSUS_CAP:
                    c[ck] = 1
                    self._bump_census_gen_locked(index)
        return e

    def _bump_census_gen_locked(self, index: str) -> None:
        self._census_gen += 1
        self._census_gens[index] = self._census_gens.get(index, 0) + 1

    # -- recording -----------------------------------------------------------

    def record_compile(self, program: str, shapes: str, n: int = 1,
                       seconds: float = 0.0,
                       field: Optional[str] = None) -> None:
        """A call of ``program`` at ``shapes`` that paid first-touch work."""
        e = self._entry(program, shapes, field)
        with self._lock:
            e.compiles += n
            e.compile_seconds += float(seconds)
            e.last_used_at = time.time()
        # each one is a latency cliff worth a black-box entry
        from elasticsearch_tpu_torch.monitor import flight

        flight.record("compiles", program=program, shapes=shapes,
                      seconds=round(float(seconds), 6))

    def record_execute(self, program: str, shapes: str, seconds: float,
                       field: Optional[str] = None) -> None:
        """One steady dispatch of ``seconds``, device time included."""
        e = self._entry(program, shapes, field)
        e.hist.observe(float(seconds))
        with self._lock:
            e.calls += 1
            e.execute_seconds += float(seconds)
            e.last_used_at = time.time()

    def record_call(self, program: str, shapes: str, seconds: float,
                    trace_delta: int, field: Optional[str] = None) -> None:
        """One dispatch of ``seconds``, classified by the caller's
        per-thread first-touch delta (``retrace.traces_since``); a
        negative delta (unknown) records nothing."""
        if trace_delta < 0:
            return
        if trace_delta > 0:
            self.record_compile(program, shapes, n=1, seconds=seconds,
                                field=field)
        else:
            self.record_execute(program, shapes, seconds, field=field)

    def record_cache_source(self, source: str,
                            fallback_program: str = "",
                            fallback_shapes: str = "") -> None:
        """One kernel-library resolution (parallel/aot.py) filed on the
        dispatch ``timed`` brackets on this flow, else on the fallback
        key (a library resolved outside any dispatch: ``build_all``)."""
        active = _ACTIVE_PROG_KEY.get()
        program, shapes = active if active is not None else (
            fallback_program, fallback_shapes)
        if not program:
            return
        e = self._entry(program, shapes, None, census=False)
        with self._lock:
            e.cache_sources[source] = e.cache_sources.get(source, 0) + 1

    def record_body(self, index: str, body_key: str, n: int = 1) -> None:
        """One eligible canonical search body observed for ``index``
        (``n`` > 1 when the caller samples). Bounded per index: at the
        cap the coldest entry decays by ``n`` and the newcomer takes its
        slot once it bottoms out, so a shifted workload displaces stale
        bodies."""
        n = max(1, int(n))
        with self._lock:
            b = self._bodies.setdefault(index, {})
            if body_key in b:
                b[body_key] += n
            elif len(b) < self._BODY_CAP:
                b[body_key] = n
            else:
                cold = min(b, key=b.get)
                if b[cold] <= n:
                    del b[cold]
                    b[body_key] = n
                else:
                    b[cold] -= n
            self._bump_census_gen_locked(index)

    # -- in-flight dispatches (the watchdog's feed) ---------------------------

    def begin_dispatch(self, program: str, shapes: str,
                       devices: Optional[str] = None) -> int:
        """Mark one dispatch in flight; returns the token
        :meth:`end_dispatch` retires. ``devices`` names the devices it
        runs on (a mesh round's), for the watchdog's stall reason."""
        if devices is None:
            return self._inflight.begin(program, shapes=shapes)
        return self._inflight.begin(program, shapes=shapes, devices=devices)

    def end_dispatch(self, token: int) -> None:
        self._inflight.end(token)

    def inflight_snapshot(self) -> List[dict]:
        """Every dispatch in flight, with its age."""
        return [dict({"program": r["kind"], "shapes": r.get("shapes", ""),
                      "age_seconds": r["age_seconds"]},
                     **({"devices": r["devices"]} if "devices" in r else {}))
                for r in self._inflight.snapshot()]

    def execute_p99(self, program: str, shapes: str) -> Tuple[float, int]:
        """(execute p99 seconds, call count) of one key: the watchdog's
        adaptive bound comes from the key's own history."""
        key = (program, shapes, backend_fingerprint())
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return 0.0, 0
            calls = e.calls
        return e.hist.percentile(99), calls

    @contextmanager
    def timed(self, program: str, shapes: str,
              field: Optional[str] = None, devices: Optional[str] = None):
        """Bracket one dispatch: in flight from entry to exit, filed as a
        compile when the thread's first-touch count moved inside it (the
        key's first dispatch in the process, a library built or loaded),
        else as an execute. The block must end with the host's read of
        the dispatch's result (a mesh round's one copy back, after every
        device's part). ``devices``: the devices it runs on, shown in
        flight. Nothing records when the block raises."""
        from elasticsearch_tpu_torch.tracing import retrace

        snap = retrace.snapshot()
        retrace.first_dispatch((program, shapes, backend_fingerprint()))
        tok = self.begin_dispatch(program, shapes, devices)
        ptok = _ACTIVE_PROG_KEY.set((program, shapes))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _ACTIVE_PROG_KEY.reset(ptok)
            self.end_dispatch(tok)
        self.record_call(program, shapes, time.perf_counter() - t0,
                         retrace.traces_since(snap), field=field)

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Per-key rows, sorted by (program, shapes, backend), rendered
        under the lock (``_entry`` adds fields under it)."""
        with self._lock:
            entries = sorted(self._entries.values(),
                             key=lambda e: (e.program, e.shapes, e.backend))
            return [e.to_json() for e in entries]

    def counters_snapshot(self) -> List[Tuple[str, str, str, int, float,
                                              float]]:
        """(program, shapes, backend, compiles, compile_seconds,
        execute_seconds) rows: the scrape-time view, no percentiles."""
        with self._lock:
            return sorted(
                (e.program, e.shapes, e.backend, e.compiles,
                 e.compile_seconds, e.execute_seconds)
                for e in self._entries.values())

    def stats(self) -> dict:
        """Totals for the ``programs`` section of ``/_nodes/stats``."""
        with self._lock:
            entries = list(self._entries.values())
        return {
            "keys": len(entries),
            "compiles": sum(e.compiles for e in entries),
            "compile_seconds": round(
                sum(e.compile_seconds for e in entries), 6),
            "calls": sum(e.calls for e in entries),
            "execute_seconds": round(
                sum(e.execute_seconds for e in entries), 6),
        }

    def census(self, index: str) -> List[dict]:
        """The observed (program, shapes, field) key set of ``index``
        with per-key hits, sorted."""
        with self._lock:
            keys = sorted(self._census.get(index, {}).items())
        return [{"program": p, "shapes": s, "field": f, "hits": n}
                for (p, s, f), n in keys]

    def bodies(self, index: str) -> List[dict]:
        """The observed replayable bodies of ``index``, hottest first."""
        with self._lock:
            items = sorted(self._bodies.get(index, {}).items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return [{"body": b, "hits": n} for b, n in items]

    def census_generation(self) -> int:
        with self._lock:
            return self._census_gen

    def census_generations(self) -> Dict[str, int]:
        """Per-index mutation counters: the flush writes only the
        indices that moved."""
        with self._lock:
            return dict(self._census_gens)

    def census_indices(self) -> List[str]:
        with self._lock:
            return sorted(set(self._census) | set(self._bodies))

    def counter_values(self) -> Dict[str, float]:
        """Flat per-key counter map for a bench's before/after delta
        (``programs.<program>|<shapes>.{compiles,...}``)."""
        out: Dict[str, float] = {}
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            base = f"programs.{e.program}|{e.shapes}"
            out[f"{base}.compiles"] = float(e.compiles)
            out[f"{base}.compile_seconds"] = float(e.compile_seconds)
            out[f"{base}.calls"] = float(e.calls)
            out[f"{base}.execute_seconds"] = float(e.execute_seconds)
        return out

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._entries.clear()
            self._census.clear()
            self._bodies.clear()
            self._census_gen = 0
            self._census_gens.clear()
        self._inflight.clear()


#: the process singleton every dispatch point records into
REGISTRY = ProgramRegistry()
