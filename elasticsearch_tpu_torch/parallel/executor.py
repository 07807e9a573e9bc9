"""Distributed query execution over the shard slots of the node's
devices.

Port of elasticsearch_tpu/parallel/executor.py. The reference scatters
the query phase over a ``('shard',)`` mesh as one ``shard_map`` program:
per-shard scoring and top-k, an ``all_gather`` merge and ``psum`` totals.
Here the mesh is S slots over the node's devices (``parallel/mesh.py``;
slot s on device s % n): a segment round — the r-th segment of every
shard — runs on each device as one sequence of PyTorch ops and kernel
launches over that device's slot-stacked ``[S_d, ...]`` tensors, and the
round's merged top-k comes back to the host in one copy of one packed
buffer.

Several devices: every device's part of a round is launched before any
result leaves its device; then each part's small per-slot results
(``[S_d, k]`` values and ids, hit counts, terms agg counts) go to the
first device by device-to-device copies (``copy_`` with
``non_blocking``: no NCCL, whose communicators cannot hold a list that
names one card twice, for a payload of k ids and scores a slot), merge
there in shard order by the same stable sort, and come back in one copy.
Counts are int64 sums, exact; the reference's ``all_gather`` and
``psum`` in one. A round's dispatch bracket (``monitor/programs.py``)
stays open to that copy back and names its devices. Each device has its
own word buffer, stacked copies and memo charges, on its own residency
registry. The slots and their candidates do not depend on the devices:
one device or several give the same hits, totals and counts.

Host work per round: compile the query (``parallel/compiler.py``), build
each prim's data, pack the per-request tables into one word buffer and
copy it to the card once. A repeated identical request skips the build
and the copy through the prepared-query memo. Segment data is never
re-uploaded: at S = 1 the round passes the segment's own tensors; at
S > 1 the stacked copies (live masks, postings, columns) live in an LRU
keyed by segment identity, each a pinned ``fielddata`` charge
(``Residency.track``) closed on eviction and on ``close``. A copy reads
a column's host mirror when its device copy was evicted
(``segment.stack_source``), so building a round rehydrates nothing. A
memo entry holds only the key of such a copy, never the copy, and looks
it up again each time it runs (rebuilding it, charged, after an
eviction); it reads the segment's own evictable tensors (columns, dense
impact blocks, vector slabs) again each run too, so it keeps none alive
past an eviction. Dense impact blocks and vector slabs are never
copied. A merge retires segments: after each
refresh and force merge the index service has ``drop_retired`` let go
of every entry that holds one, and of its charge.

The executor follows the index's replication groups, not a snapshot of
its shards: ``shards`` are the groups' current primaries (a promotion
shows at once), and the segments of every copy count as live for the
caches, since a search may read any copy.

Routes inside a round:
- a request that is a pure disjunctive term group on dense rows (the
  host loop's fused shape) runs kernel B1's rows form with its hit count
  on every slot whose part is pure-dense, on that slot's own block; at
  S = 1 that is the whole round: one copy in, B1's two kernels, one copy
  back. A round with no other non-empty slot builds and copies only B1's
  rows and weights; otherwise the other slots take the generic route,
  which gathers no dense row of a slot B1 serves;
- every other request runs the compiled emit tree over the stacked
  tensors, then one stable top-k per slot; a request with aggregations
  always does, and adds to the round each keyword terms agg's per-slot
  counts (in the same copy back) or keeps the round's [S, D] match mask
  on the card for the host-side collectors; a field-sorted request
  selects each slot's exact top k by its sort keys (``sort_topk``) and
  copies back every slot's candidates and match count, which the mesh
  service merges by value;
- ``search_knn`` / ``search_maxsim``: kernel B2 per slot at k' = 4k in
  bf16, then an f32 re-rank (``exact_rescore_topk``), MaxSim's per-doc
  max (``merge_candidate_topk``), and the merge across slots.

Slots merge in shard order, so the result does not depend on how shards
map to slots. A failure after a launch raises: only ``MeshCompileError``,
raised before anything runs, and a breaker's CircuitBreakingException (a
rehydration of a slot's own tensor denied) send a request to the host
loop.
"""
from __future__ import annotations

import functools
import itertools
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import stacking
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.monitor.programs import REGISTRY, static_sig
from elasticsearch_tpu_torch.ops.bm25_topk import unpack_topk
from elasticsearch_tpu_torch.ops.knn import (exact_rescore_topk, knn_topk,
                                             merge_candidate_topk)
from elasticsearch_tpu_torch.ops.scoring import (bm25_score_batch,
                                                sort_lanes, sort_topk,
                                                topk_stable)
from elasticsearch_tpu_torch.parallel.compiler import (HybridTGroupPrim,
                                                       LivePrim,
                                                       MeshQueryCompiler,
                                                       PostingsPrim,
                                                       TGroupPrim,
                                                       agg_term_counts)
from elasticsearch_tpu_torch.parallel.mesh import ShardMesh, mesh_size
from elasticsearch_tpu_torch.search import queries as Q
from elasticsearch_tpu_torch.search.context import SegmentContext, split_runs
from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

NEG_INF = float("-inf")

#: stacked segment-round data groups kept per executor and per copy of a
#: shard (``MeshSearchExecutor._data_cap``)
_DATA_CACHE_CAP = 32
#: prepared-query memo entries kept per executor
_PREP_CACHE_CAP = 64
#: score elements of one batched BM25 round's query chunk, [S, chunk, D]
#: (2^26 f32 = 256 MiB, with the sort behind it about 1.4 GiB)
_ROUND_ELEMS = 1 << 26


def _shard_order(lut_shard) -> List[int]:
    """The slots in the order of the shards they hold (empty slots last):
    candidates merge by (-score, shard, local) whatever the layout."""
    return sorted(range(len(lut_shard)),
                  key=lambda s: (lut_shard[s] < 0, lut_shard[s]))


def _pack_words(tables) -> np.ndarray:
    """One int32 word buffer of 4-byte numpy tables, in order."""
    if len(tables) == 1 and tables[0].dtype == np.int32:
        return tables[0].reshape(-1)
    return np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.int32)
                           for a in tables] or [np.zeros(0, np.int32)])


def _word_view(words: torch.Tensor, off: int, a: np.ndarray):
    """The view of the device word buffer that holds table ``a`` at word
    ``off``, in its dtype and shape."""
    t = words[off: off + a.size]
    if a.dtype == np.float32:
        t = t.view(torch.float32)
    return t.view(a.shape)


class _Env(dict):
    """prim index → its items, made when an emit first reads the prim:
    a table becomes its view of the word buffer, a deferred item (a
    callable) is called. A route that reads few prims makes few tensor
    ops, each of which costs host time on the card. One is made for each
    run of a round and dropped after it, so a memo entry pins no stacked
    copy."""

    def __init__(self, items):
        super().__init__()
        self._items = items

    def __missing__(self, i):
        its = tuple(a() if callable(a) else a for a in self._items[i])
        self[i] = its
        return its


def _own_view(per_slot, seg) -> torch.Tensor:
    """[1, length]: a one-slot round's view of the segment's own tensor."""
    return per_slot(seg).unsqueeze(0)


def _resolve(x):
    """A deferred item (a callable) read now; anything else as it is."""
    return x() if callable(x) else x


class _SlotData:
    """What ``DataPrim.build`` gets: slot-stacked views or cached copies
    of the round's segment data on mesh device ``d``."""

    def __init__(self, executor: "MeshSearchExecutor", seg_row, d: int = 0):
        self.executor = executor
        self.seg_row = seg_row
        self.d = d

    def _stack(self, per_slot, length, fill, dtype, fix):
        """The [S, length] copy. A reader may give a host mirror (an
        evicted column, ``segment.stack_source``): it is copied in from
        the host, so building a round rehydrates nothing."""
        dev = self.executor.devices[self.d]
        out = torch.full((len(self.seg_row), length), fill, dtype=dtype,
                         device=dev)
        for s, seg in enumerate(self.seg_row):
            with stacking():
                t = per_slot(seg) if seg is not None else None
            if t is None:
                continue
            if isinstance(t, np.ndarray):
                t = torch.from_numpy(t).to(dev)
            out[s, : t.shape[0]] = fix(seg, t) if fix is not None else t
        return out

    def stacked(self, key, per_slot, length: int, fill, dtype, fix=None):
        """A deferred [S, length] of ``per_slot(segment)`` (a 1-D tensor or
        None, padded with ``fill``; ``fix(segment, t)`` adjusts a row when
        it is copied), made when an emit reads it. At S = 1 a view of the
        segment's own tensor; at S > 1 a copy from the executor's data
        cache, looked up by ``key`` on every run."""
        stack = functools.partial(self._stack, per_slot, length, fill, dtype,
                                  fix)
        if len(self.seg_row) == 1:
            seg = self.seg_row[0]
            t = per_slot(seg) if seg is not None else None
            if t is not None and t.shape[0] == length:
                # read again each run: a memo entry holds no tensor of an
                # evictable field, so an eviction frees it
                return functools.partial(_own_view, per_slot, seg)
            return stack
        nbytes = len(self.seg_row) * length * torch.empty(
            (), dtype=dtype).element_size()
        return functools.partial(self.executor._cached_data, key, nbytes,
                                 stack, self.seg_row, self.d)


@dataclass
class _Round:
    """One prepared segment round: what the memo keeps."""

    compiled: Any
    # per prim: its items for an _Env (views of the word buffer and
    # segment tensors, deferred); None when no slot takes the generic
    # route
    items: Optional[List[list]]
    meta: Dict[int, tuple]
    kk: int  # each slot's candidates: min(k, D)
    kg: int  # the round's, over all its slots: min(k, S * kk)
    # per slot: (qw [1, R], rows [R], block, live, k) of B1's rows form,
    # or None for the generic route or an empty slot
    fused: List[Optional[tuple]]
    perm: Optional[torch.Tensor]  # the slots in shard order (S > 1)
    words: torch.Tensor  # the round's tables on the card
    refs: List[Any]  # the round's segments, pinned while the entry lives
    token: Any = None  # the memo entry's pinned charge (PinnedToken)

    @property
    def nbytes(self) -> int:
        """The word buffer's bytes: what a memo entry charges."""
        return int(self.words.numel()) * 4


@dataclass
class _Part:
    """One device's slots of a launched round, before the merge across
    slots, all on that device: each slot's top kk (``vals`` None for a
    sorted round), its exact hit count, each terms agg's counts [n,
    width] and the match mask when the request wants it."""

    vals: Optional[torch.Tensor]
    ids: torch.Tensor
    totals: torch.Tensor
    counts: List[torch.Tensor]
    mask: Optional[torch.Tensor]


@dataclass
class _MeshRound:
    """One prepared segment round over several devices: what the memo
    keeps. ``parts`` holds a ``_Round`` for each device with a non-empty
    slot (device d's slots d, d + n, ...); ``perm`` is the slots' shard
    order on the first device; ``widths`` each terms agg's count width
    (the widest part's; narrower parts pad with zeros)."""

    parts: List[Tuple[int, _Round]]
    compiled: Any
    kk: int
    kg: int
    S: int
    perm: torch.Tensor
    widths: Dict[int, int]
    refs: List[Any]
    token: Any = None

    @property
    def fused(self) -> list:
        """No round of several devices is a one-slot B1 round."""
        return [None] * self.S

    @property
    def meta(self) -> Dict[int, tuple]:
        """``_decode_round``'s view: each agg prim's widest vocabulary."""
        return {p: (w - 1,) for p, w in self.widths.items()}

    @property
    def nbytes(self) -> int:
        return sum(rd.nbytes for _d, rd in self.parts)


class _Charges:
    """A mesh round's memo charges, one on each device, closed as one."""

    def __init__(self, tokens):
        self.tokens = tokens

    def close(self) -> None:
        for t in self.tokens:
            t.close()


class MeshSearchExecutor:
    """Runs queries over N shards laid out on S slots over the mesh's
    devices (slot s on device s % n).

    Segments are searched in rounds (round r stacks the r-th segment of
    every shard; a shard with fewer segments leaves its slot empty), and
    rounds merge on the host. More shards than slots wrap round-robin
    (shard i → slot i % S, its segments joining that slot's rounds).
    ``residency`` is the node's registry set (or one registry): mesh
    device d charges its copies to ``residency.members[d]``."""

    def __init__(self, mesh: ShardMesh, groups, residency):
        self.mesh = mesh
        self.S = mesh_size(mesh)
        self.device = mesh.device
        self.devices = mesh.devices
        self.n_devices = mesh.n_devices
        self.residency = residency
        members = residency.members
        if len(members) < self.n_devices:
            raise ValueError(f"mesh has {self.n_devices} devices but the "
                             f"residency only {len(members)}")
        self.residencies = members[: self.n_devices]
        # what a dispatch bracket names (the watchdog's stall reason)
        self._devices_label = ",".join(str(d) for d in self.devices)
        # the index's live group list (``primary`` and ``copies`` of each)
        self.groups = groups
        if len(self.shards) < self.S:
            raise ValueError(
                f"mesh has {self.S} shard slots but got only "
                f"{len(self.shards)} shards; build the mesh with "
                f"shard_mesh(n_shards)")
        # prepared-query memo (LRU): (canonical body, round, segment
        # identity + tombstone counts, k) → _Round
        self._prep: "OrderedDict[Tuple, _Round]" = OrderedDict()
        self._prep_lock = threading.Lock()
        # stacked device data per segment round (S > 1), LRU-bounded per
        # device: key → (tensor, pinned segments, PinnedToken of its
        # bytes, mesh device)
        self._data: "OrderedDict[Tuple, tuple]" = OrderedDict()
        self._data_lock = threading.Lock()

    @property
    def shards(self) -> list:
        """Each group's current primary."""
        return [g.primary for g in self.groups]

    @property
    def _data_cap(self) -> int:
        """Stacked-data entries kept: _DATA_CACHE_CAP for each copy of a
        shard. A round stacks one copy of every shard, and round-robin
        reads turn every group at once, so each copy's rounds need
        entries of their own: at one cap for all, one replica made every
        lookup a miss."""
        return _DATA_CACHE_CAP * max(
            (len(g.copies) for g in self.groups), default=1)

    # -- caches ------------------------------------------------------------

    def _cached_data(self, key, nbytes: int, build, refs, d: int = 0):
        """A stacked copy on mesh device ``d`` keyed by segment ids.
        ``refs`` (the segments) are kept with it so a cached id() can
        never be recycled while the entry lives. The bytes are a pinned
        ``fielddata`` charge on the device's registry
        (``Residency.track``), forced as the reference's: the LRU's cap
        (each device's) is the ceiling, and a copy reads host mirrors, so
        it never trips. The token is closed on eviction or close."""
        with self._data_lock:
            if key in self._data:
                self._data.move_to_end(key)
                kernels.record("executor_data_hit")
                return self._data[key][0]
        kernels.record("executor_data_miss")
        tok = self.residencies[d].track(nbytes, label="executor.data")
        try:
            val = build()
        except BaseException:
            tok.close()
            raise
        evicted = []
        with self._data_lock:
            if key in self._data:  # a concurrent build won
                evicted.append(tok)
                val = self._data[key][0]
            else:
                self._data[key] = (val, list(refs), tok, d)
                mine = [k2 for k2, e in self._data.items() if e[3] == d]
                for old in mine[: max(0, len(mine) - self._data_cap)]:
                    evicted.append(self._data.pop(old)[2])
        for t in evicted:
            t.close()
        return val

    def data_bytes(self) -> int:
        """Bytes the stacked-data cache holds (and has charged)."""
        with self._data_lock:
            return sum(e[2].nbytes for e in self._data.values())

    def drop_retired(self) -> None:
        """Drop every memo entry and stacked copy that holds a segment no
        copy serves any more (a merge retired it), releasing their
        charges. Their keys can never match again, and they would pin the
        dead segments' tensors until the LRUs cycle."""
        live = {id(seg) for g in self.groups for sh in g.copies
                for seg in _segments_of(sh)}
        with self._data_lock:
            dead_data = [key for key, e in self._data.items()
                         if any(id(s) not in live for s in e[1])]
            data = [self._data.pop(key) for key in dead_data]
        with self._prep_lock:
            dead_prep = [key for key, rd in self._prep.items()
                         if any(id(s) not in live for s in rd.refs)]
            prep = [self._prep.pop(key) for key in dead_prep]
        for e in data:
            e[2].close()
        for rd in prep:
            rd.token.close()

    def cached_segments(self) -> set:
        """ids of the segments the memo and the stacked-data LRU hold."""
        with self._data_lock:
            ids = {id(s) for e in self._data.values() for s in e[1]}
        with self._prep_lock:
            ids |= {id(s) for rd in self._prep.values() for s in rd.refs}
        return ids

    def close(self) -> None:
        """Release every cached copy and memo entry and their charges."""
        with self._data_lock:
            data, self._data = list(self._data.values()), OrderedDict()
        with self._prep_lock:
            prep, self._prep = list(self._prep.values()), OrderedDict()
        for e in data:
            e[2].close()
        for rd in prep:
            rd.token.close()

    # -- rounds --------------------------------------------------------------

    def _rounds_for(self, shard_list):
        cols = [[] for _ in range(self.S)]
        for i, s in enumerate(shard_list):
            cols[i % self.S].extend(
                (i, ordinal, seg)
                for ordinal, seg in enumerate(_segments_of(s)))
        max_rounds = max((len(c) for c in cols), default=0) or 1
        return [[c[r] if r < len(c) else None for c in cols]
                for r in range(max_rounds)]

    def _compile(self, query, mappings, analysis, seg_row, agg_specs=None,
                 want_mask: bool = False, sort_spec=None):
        D = pow2_bucket(max((s.max_docs if s is not None else 1)
                            for s in seg_row))

        def has_dense(field):
            # builds the lazy dense block as the host loop's
            # ctx.hybrid_slices → inv.dense_block() does
            for s in seg_row:
                inv = s.inverted.get(field) if s is not None else None
                if inv is not None and inv.dense_block() is not None:
                    return True
            return False

        def col_everywhere(field):
            return all(s is None or field in s.numerics for s in seg_row)

        return MeshQueryCompiler(mappings, analysis, D=D,
                                 has_dense=has_dense,
                                 col_everywhere=col_everywhere).compile(
                                     query, agg_specs, want_mask, sort_spec)

    def _build_round(self, compiled, mappings, analysis, seg_row, lut_shard,
                     k: int, global_stats=None, d: int = 0,
                     part: bool = False) -> _Round:
        """Build the prims' data and copy the round's tables to mesh
        device ``d`` in one word buffer. A fused request builds its term
        group first: when no non-empty slot needs the generic route,
        nothing else is built or copied. With ``global_stats`` (dfs)
        every slot's term weights take the index-wide idf. ``part``: one
        device's slots of a round over several, which merges on the first
        device (no shard order of its own)."""
        D = compiled.D
        kk = min(k, D)
        ctxs = [SegmentContext(s, mappings, analysis, global_stats)
                if s is not None else None for s in seg_row]
        data = _SlotData(self, seg_row, d)
        items: List[list] = []
        meta: Dict[int, tuple] = {}
        f = compiled.fused
        on_b1 = [False] * len(seg_row)
        if f is not None:
            compiled.prims[f].scan(seg_row, ctxs)
            on_b1 = [seg is not None and compiled.prims[f].fused[s]
                     for s, seg in enumerate(seg_row)]
            compiled.prims[f].b1_slots = on_b1
        generic = any(seg is not None and not b
                      for seg, b in zip(seg_row, on_b1)) or f is None
        tables: List[np.ndarray] = []
        if generic:  # the term group reuses its scan
            for i, prim in enumerate(compiled.prims):
                its, meta[i] = prim.build(seg_row, ctxs, D, data)
                items.append(its)
            tables = [a for its in items for a in its
                      if isinstance(a, np.ndarray)]
        perm_t = len(tables)  # the slots in shard order (S > 1)
        ordered = len(seg_row) > 1 and not part
        if ordered:
            tables.append(np.asarray(_shard_order(lut_shard), np.int32))
        # B1's arguments of each pure-dense slot: its real rows' weights
        # then the rows, one table each (fused_bm25_topk's layout)
        fused: List[Optional[tuple]] = [None] * len(seg_row)
        for s, seg in enumerate(seg_row):
            if on_b1[s]:
                block, rows, w = compiled.prims[f].b1_args(s)
                fused[s] = (len(tables), rows.size, block, seg.live)
                tables.append(np.concatenate([w.view(np.int32), rows]))
        offs = list(itertools.accumulate([a.size for a in tables],
                                         initial=0))
        words = torch.from_numpy(_pack_words(tables)).to(self.devices[d])
        env_items = None
        if generic:
            at = {id(a): o for a, o in zip(tables, offs)}
            env_items = [[functools.partial(_word_view, words, at[id(a)], a)
                          if isinstance(a, np.ndarray) else a for a in its]
                         for its in items]
        perm = (_word_view(words, offs[perm_t], tables[perm_t])
                if ordered else None)
        for s, fs in enumerate(fused):
            if fs is not None:
                t, R, block, live = fs
                arg = words[offs[t]: offs[t] + 2 * R]
                fused[s] = (arg[:R].view(torch.float32).view(1, R), arg[R:],
                            block, live, min(kk, seg_row[s].max_docs))
        return _Round(compiled, env_items, meta, kk,
                      min(k, len(seg_row) * kk), fused, perm, words,
                      [s for s in seg_row if s is not None])

    def _slot_results(self, rd: _Round) -> _Part:
        """Launch a round's slots on their device: each slot's top kk,
        hit count, terms agg counts and mask, left on the device."""
        compiled, kk = rd.compiled, rd.kk
        fused = rd.fused
        n = len(fused)
        counts, mask = [], None
        ks = {f[4] for f in fused if f is not None}
        if all(f is not None for f in fused) and ks == {kk}:
            # every slot on B1 at the round's k: its packed results are
            # the stacked [S, 2k + 2] rows
            kernels.record("bm25_fused_topk", n)
            Q.FUSED_CALLS += n
            buf = torch.cat([Q.bm25_dense_topk(qw, _resolve(block), live,
                                               k=kk, rows=rows, count=True,
                                               packed=True)
                             for qw, rows, block, live, _ in fused])
            v, ids, totals = unpack_topk(buf, kk)
            # a fused non-match scores <= 0: out of the merge
            vals = torch.where(v > 0, v, NEG_INF)
            fused = ()
        elif rd.items is not None:
            _record_tgroup_kernels(compiled)
            env = _Env(rd.items)
            scores, mask = compiled.root.sm(env, rd.meta)
            mask = mask & env[compiled.live][0]
            counts = [agg_term_counts(mask, *env[p], rd.meta[p][0])
                      for _name, p in compiled.agg_prims]
            if compiled.sort:
                # each slot's top kk by its keys; every slot's count
                lanes = []
                for p, desc, first in compiled.sort:
                    key, exists = env[p]
                    lanes += sort_lanes(key, exists, desc, first,
                                        rd.meta[p][0])
                ids = sort_topk(lanes, mask, kk).to(torch.int32)
                return _Part(None, ids, mask.sum(1), counts,
                             mask if compiled.want_mask else None)
            masked = torch.where(mask, scores, NEG_INF)
            sv, si = torch.sort(masked, dim=1, descending=True, stable=True)
            vals, ids = sv[:, :kk], si[:, :kk].to(torch.int32)
            totals = mask.sum(1)
            if not compiled.want_mask:
                mask = None
        else:
            dev = rd.words.device
            vals = torch.full((n, kk), NEG_INF, dtype=torch.float32,
                              device=dev)
            ids = torch.zeros((n, kk), dtype=torch.int32, device=dev)
            totals = torch.zeros(n, dtype=torch.int64, device=dev)
        for s, f in enumerate(fused):
            if f is None:
                continue
            qw, rows, block, live, ks = f
            kernels.record("bm25_fused_topk")
            Q.FUSED_CALLS += 1
            v, i, t = Q.bm25_dense_topk(qw, _resolve(block), live, k=ks,
                                        rows=rows, count=True)
            if ks < kk:
                vals[s].fill_(NEG_INF)
            # a fused non-match scores <= 0: out of the merge
            vals[s, :ks] = torch.where(v[0] > 0, v[0], NEG_INF)
            ids[s, :ks] = i[0]
            totals[s] = t[0]
        return _Part(vals, ids, totals, counts, mask)

    def _run_round(self, rd: _Round):
        """Launch the round on one device: (its packed result, copied
        back once, the terms aggs' counts at its end; the [S, D] match
        mask when the request wants it, else None)."""
        fused = rd.fused
        n = len(fused)
        if n == 1 and fused[0] is not None:
            qw, rows, block, live, ks = fused[0]
            kernels.record("bm25_fused_topk")
            Q.FUSED_CALLS += 1
            return Q.bm25_dense_topk(qw, _resolve(block), live, k=ks,
                                     rows=rows,
                                     count=True, packed=True).cpu().numpy(), \
                None
        p = self._slot_results(rd)
        if n == 1 and not rd.compiled.sort:
            return torch.cat([p.vals[0].contiguous().view(torch.int32),
                              p.ids[0], p.totals.sum().reshape(1).view(
                                  torch.int32)]
                             + [c.reshape(-1).view(torch.int32)
                                for c in p.counts]).cpu().numpy(), p.mask
        perm = rd.perm.to(torch.int64) if n > 1 else None
        return _pack(rd.compiled.sort, p, perm, rd.kk, rd.kg).cpu().numpy(), \
            p.mask

    def _build_mesh_round(self, compiled, recompile, mappings, analysis,
                          seg_row, lut_shard, k: int,
                          global_stats=None) -> _MeshRound:
        """A round over several devices: each device with a non-empty
        slot builds its part (its own compiled program from ``recompile``,
        the same query over the same whole row, so every part has the
        round's D and prim forms) and gets its word buffer; the shard
        order goes to the first device."""
        parts: List[Tuple[int, _Round]] = []
        for d in range(self.n_devices):
            slots = self.mesh.slots_of(d)
            sub = [seg_row[s] for s in slots]
            if all(seg is None for seg in sub):
                continue
            c = compiled if not parts else recompile()
            parts.append((d, self._build_round(
                c, mappings, analysis, sub, [lut_shard[s] for s in slots],
                k, global_stats, d=d, part=True)))
        kk = min(k, compiled.D)
        widths = {p: max([rd.meta[p][0] + 1 for _d, rd in parts] or [1])
                  for _name, p in compiled.agg_prims}
        perm = torch.from_numpy(np.asarray(_shard_order(lut_shard),
                                           np.int64)).to(self.device)
        return _MeshRound(parts, compiled, kk, min(k, self.S * kk), self.S,
                          perm, widths, [s for s in seg_row if s is not None])

    def _run_mesh_round(self, mr: _MeshRound):
        """Launch every device's part, then gather the parts' per-slot
        results onto the first device, merge them there in shard order
        (``_pack``, as on one device) and copy the packed result back once:
        (the packed result, each slot's match mask on its own device or
        None)."""
        S, kk, nd, dev0 = mr.S, mr.kk, self.n_devices, self.device
        # every device's part is in flight before anything leaves one
        launched = [(d, self._slot_results(rd)) for d, rd in mr.parts]
        sort = bool(mr.compiled.sort)
        ids = torch.zeros((S, kk), dtype=torch.int32, device=dev0)
        totals = torch.zeros(S, dtype=torch.int64, device=dev0)
        vals = None if sort else torch.full((S, kk), NEG_INF,
                                            dtype=torch.float32, device=dev0)
        aggs = [p for _name, p in mr.compiled.agg_prims]
        counts = [torch.zeros((S, mr.widths[p]), dtype=torch.int64,
                              device=dev0) for p in aggs]
        masks = None
        for d, part in launched:
            sl = slice(d, S, nd)  # device d's slots
            ids[sl].copy_(part.ids, non_blocking=True)
            totals[sl].copy_(part.totals, non_blocking=True)
            if vals is not None:
                vals[sl].copy_(part.vals, non_blocking=True)
            for c, pc in zip(counts, part.counts):
                c[sl, : pc.shape[1]].copy_(pc, non_blocking=True)
            if part.mask is not None:
                masks = masks or [None] * S
                for j, s in enumerate(self.mesh.slots_of(d)):
                    masks[s] = part.mask[j]
        return _pack(sort, _Part(vals, ids, totals, counts, None), mr.perm,
                     kk, mr.kg).cpu().numpy(), masks

    @staticmethod
    def _decode_round(out: np.ndarray, rd: _Round, lut_shard, lut_ord,
                      merged: list, seg_row, agg_rounds: dict) -> int:
        """Candidates (score, shard, seg_ord, local) of one round into
        ``merged`` (a sorted round's: each slot's, in its key order, the
        score NaN), and each non-empty slot's count vector of every terms
        agg into ``agg_rounds`` (agg name → [(shard, seg_ord, segment,
        i64[vmax + 1])]); returns the round's exact hit count."""
        if len(rd.fused) == 1 and rd.fused[0] is not None:
            vals, ids, total = unpack_topk(out, rd.fused[0][4])
            # a fused non-match scores <= 0 or -inf
            ok = np.isfinite(vals[0]) & (vals[0] > 0)
            merged += [(v, lut_shard[0], lut_ord[0], i) for v, i in zip(
                vals[0][ok].tolist(), ids[0][ok].tolist())]
            return int(total[0])
        kk, kg, n = rd.kk, rd.kg, len(rd.fused)
        if rd.compiled.sort:
            ids = out[: n * kk].reshape(n, kk)
            end = n * kk + 2 * n
            counts = out[n * kk: end].view(np.int64)
            for si, seg in enumerate(seg_row):
                if seg is not None:
                    merged += [(NEG_INF, lut_shard[si], lut_ord[si], lc)
                               for lc in ids[si, : min(kk, int(counts[si]))]
                               .tolist()]
            total = int(counts.sum())
        else:
            gvals = out[:kg].view(np.float32)
            ok = np.isfinite(gvals)
            glocal = out[2 * kg: 3 * kg] if n > 1 else out[kg: 2 * kg]
            gslot = out[kg: 2 * kg][ok].tolist() if n > 1 \
                else [0] * int(ok.sum())
            merged += [(v, lut_shard[sl], lut_ord[sl], lc) for v, sl, lc
                       in zip(gvals[ok].tolist(), gslot, glocal[ok].tolist())]
            end = (3 if n > 1 else 2) * kg + 2
            total = int(out[end - 2: end].view(np.int64)[0])
        for name, p in rd.compiled.agg_prims:
            width = rd.meta[p][0] + 1
            c = out[end: end + 2 * n * width].view(np.int64).reshape(n, width)
            end += 2 * n * width
            agg_rounds.setdefault(name, []).extend(
                (lut_shard[si], lut_ord[si], seg, c[si])
                for si, seg in enumerate(seg_row) if seg is not None)
        return total

    # -- full DSL (compiled query trees) -------------------------------------

    def search_dsl(self, query, mappings, analysis, k: int, shards=None,
                   memo_key: Optional[Callable[[], Optional[bytes]]] = None,
                   agg_specs=None, want_mask: bool = False, sort_spec=None,
                   global_stats=None):
        """Execute a parsed query over the mesh: (cands, totals,
        agg_rounds, mask_rounds), cands a list of (score, shard, seg_ord,
        local) for the global top k in the host loop's order, totals the
        exact hit count. ``agg_specs`` lists (agg name, keyword field) of
        terms aggs the rounds count on the card: agg_rounds maps each
        name to [(shard, seg_ord, segment, i64 counts)], a vector per
        segment. With ``want_mask``, mask_rounds lists (shard, seg_ord,
        segment, bool[max_docs] on the card), each segment's match mask
        (live docs only) for the host-side collectors. With
        ``sort_spec`` (parsed sort keys), cands holds every segment's top
        k by its keys, each segment's in order, for the caller's merge by
        value. Raises
        MeshCompileError, before anything is launched, for a query the
        compiler does not take.

        ``shards`` is the caller's snapshot of per-shard segment lists
        (the reader the fetch phase will read); ``memo_key()`` gives the
        serialised request body that keys the prepared-query memo, or
        None. It is called once every round has compiled: a request the
        mesh declines never pays for it. ``global_stats`` (dfs) gives
        every slot the index-wide idf; such a request never reads or
        fills the memo, since its weights hold per-request statistics."""
        rows = self._rounds_for(self.shards if shards is None
                                else list(shards))
        # every round compiles before any round launches
        seg_rows = [[e[2] if e is not None else None for e in row]
                    for row in rows]

        def compile_row(seg_row):
            return self._compile(query, mappings, analysis, seg_row,
                                 agg_specs, want_mask, sort_spec)

        compiled = [compile_row(seg_row) for seg_row in seg_rows]
        key = memo_key() if memo_key is not None and global_stats is None \
            else None
        plans = []
        for rno, (row, seg_row) in enumerate(zip(rows, seg_rows)):
            prep_key = None
            if key is not None:
                prep_key = (key, rno,
                            tuple((id(s), s.deleted_count)
                                  if s is not None else None
                                  for s in seg_row), k)
            with self._prep_lock:
                rd = self._prep.get(prep_key) if prep_key is not None \
                    else None
                if rd is not None:
                    self._prep.move_to_end(prep_key)
            plans.append((row, seg_row, prep_key, rd, compiled[rno]))
        merged: List[tuple] = []
        totals = 0
        agg_rounds: Dict[str, list] = {}
        mask_rounds: List[tuple] = []
        for row, seg_row, prep_key, rd, compiled in plans:
            lut_shard = [e[0] if e is not None else -1 for e in row]
            lut_ord = [e[1] if e is not None else 0 for e in row]
            if rd is None and self.n_devices > 1:
                rd = self._build_mesh_round(
                    compiled, functools.partial(compile_row, seg_row),
                    mappings, analysis, seg_row, lut_shard, k, global_stats)
                if prep_key is not None:
                    kernels.record("executor_prep_miss")
                    self._remember(prep_key, rd)
            elif rd is None:
                rd = self._build_round(compiled, mappings, analysis, seg_row,
                                       lut_shard, k, global_stats)
                if prep_key is not None:
                    kernels.record("executor_prep_miss")
                    self._remember(prep_key, rd)
            else:
                kernels.record("executor_prep_hit")
            # in flight from the launch to the packed result's copy back
            # (the reference's memo and fresh dispatch points alike)
            with REGISTRY.timed("mesh_dsl", self._sig(
                    S=len(seg_row), D=_round_docs(seg_row), k=rd.kk),
                    devices=self._devices_label):
                out, mask = (self._run_round(rd) if self.n_devices == 1
                             else self._run_mesh_round(rd))
            totals += self._decode_round(out, rd, lut_shard, lut_ord, merged,
                                         seg_row, agg_rounds)
            if mask is not None:
                mask_rounds.extend(
                    (lut_shard[si], lut_ord[si], seg, mask[si][: seg.max_docs])
                    for si, seg in enumerate(seg_row) if seg is not None)
        if sort_spec:
            return merged, totals, agg_rounds, mask_rounds
        # the host loop's order: per shard (-score, seg, local) cut at k
        # (query_phase), then globally (-score, shard, local), stable
        # (search_shards)
        by_shard: Dict[int, list] = {}
        for t in merged:
            by_shard.setdefault(t[1], []).append(t)
        out: List[tuple] = []
        for sh in sorted(by_shard):
            lst = by_shard[sh]
            lst.sort(key=lambda t: (-t[0], t[2], t[3]))
            out.extend(lst[:k])
        out.sort(key=lambda t: (-t[0], t[1], t[3]))
        return out[:k], totals, agg_rounds, mask_rounds

    def _sig(self, **dims) -> str:
        """A round's dispatch key: its shape class, and the device count
        when the mesh spans several."""
        if self.n_devices > 1:
            dims["devices"] = self.n_devices
        return static_sig(**dims)

    def _remember(self, prep_key, rd) -> None:
        """Keep a prepared round (a ``_Round``, or a ``_MeshRound`` whose
        word buffers are charged on each of its devices), dropping the
        least recent past the cap."""
        if isinstance(rd, _MeshRound):
            rd.token = _Charges([
                self.residencies[d].track(part.nbytes, label="executor.prep")
                for d, part in rd.parts])
        else:
            rd.token = self.residency.track(rd.nbytes, label="executor.prep")
        dropped = []
        with self._prep_lock:
            old = self._prep.pop(prep_key, None)
            if old is not None:
                dropped.append(old)
            self._prep[prep_key] = rd
            while len(self._prep) > _PREP_CACHE_CAP:
                dropped.append(self._prep.popitem(last=False)[1])
        for ent in dropped:
            ent.token.close()

    # -- batched BM25 (msearch) ------------------------------------------------

    def search_terms(self, field: str,
                     query_terms: List[List[Tuple[str, float]]], k: int = 10,
                     shards=None):
        """The mesh's batched BM25 round: query_terms holds, per query, its
        (term, idf-free weight) list on ``field``. Returns (vals [Q, k],
        shard [Q, k], local [Q, k], seg_ord [Q, k], totals [Q]) merged
        over every segment round; (shard, seg_ord, local) addresses a doc
        as (shard, segment ordinal within it, local id).

        ``shards`` is the caller's snapshot of per-shard segment lists
        (the reader the fetch phase will read). Every term is scored from
        the postings by scatter, as the reference's batched program does
        (never kernel B1, whose bf16 products would change the scores)."""
        merged = None
        rows = self._rounds_for(self.shards if shards is None
                                else list(shards))
        for row in rows:
            out = self._search_round(field, query_terms, row, k)
            merged = out if merged is None else _merge_rounds(merged, out, k)
        return merged

    def _search_round(self, field, query_terms, row, k):
        """One segment round of ``search_terms``: per slot, each query's
        postings BM25 with that segment's own idf (``_chunk_table``), the
        live mask, the hit count and a stable top-k, each device's slots
        on that device (``_terms_part``); the slots merged in shard order
        on the first device, and the packed result back in one copy."""
        seg_row = [e[2] if e is not None else None for e in row]
        lut_shard = np.asarray([e[0] if e is not None else -1 for e in row],
                               np.int32)
        lut_ord = np.asarray([e[1] if e is not None else 0 for e in row],
                             np.int32)
        S, Qr = len(seg_row), len(query_terms)
        D = pow2_bucket(max((s.max_docs if s is not None else 1)
                            for s in seg_row))
        kk = min(k, D)
        kg = min(k, S * kk)  # the round keeps up to k over all its slots
        # per-slot chunk tables: the vocabulary and idf are the segment's
        tables = [[_chunk_table(seg, field, terms) for terms in query_terms]
                  for seg in seg_row]
        T = max([len(st) for per_q in tables for st, _, _ in per_q] + [1])
        starts = np.zeros((S, Qr, T), np.int32)
        lens = np.zeros((S, Qr, T), np.int32)
        ws = np.zeros((S, Qr, T), np.float32)
        for si, per_q in enumerate(tables):
            for qi, (st, ln, w) in enumerate(per_q):
                starts[si, qi, : len(st)] = st
                lens[si, qi, : len(ln)] = ln
                ws[si, qi, : len(w)] = w
        order = np.asarray(_shard_order(lut_shard), np.int64)
        nd, dev0 = self.n_devices, self.device
        perm = torch.from_numpy(order).to(dev0)
        # in flight from the first launch to the copy back
        with REGISTRY.timed("mesh_bm25", self._sig(
                S=S, Q=pow2_bucket(Qr, 1), T=pow2_bucket(T, 1), D=D, k=kk),
                devices=self._devices_label):
            # every device's part is in flight before anything leaves one
            parts = []
            for d in range(nd):
                slots = self.mesh.slots_of(d)
                sub = [seg_row[s] for s in slots]
                if nd > 1 and all(seg is None for seg in sub):
                    continue
                parts.append((d, self._terms_part(
                    field, sub, d, starts[slots], lens[slots], ws[slots], D,
                    kk)))
            if nd == 1:
                sv, si, total = parts[0][1]
            else:
                sv = torch.full((S, Qr, kk), NEG_INF, dtype=torch.float32,
                                device=dev0)
                si = torch.zeros((S, Qr, kk), dtype=torch.int64, device=dev0)
                total = torch.zeros(Qr, dtype=torch.int64, device=dev0)
                for d, (psv, psi, ptot) in parts:
                    sv[d::nd].copy_(psv, non_blocking=True)
                    si[d::nd].copy_(psi, non_blocking=True)
                    total += ptot.to(dev0, non_blocking=True)
            # each slot's top kk, the slots in shard order, then one
            # stable merge per query
            sv = sv.index_select(0, perm)
            si = si.index_select(0, perm)
            flat_v = sv.permute(1, 0, 2).reshape(Qr, S * kk)
            flat_i = si.permute(1, 0, 2).reshape(Qr, S * kk)
            gv, gpos = torch.sort(flat_v, dim=1, descending=True, stable=True)
            gv, gpos = gv[:, :kg], gpos[:, :kg]
            out = torch.cat([
                gv.contiguous().view(torch.int32),
                (gpos // kk).to(torch.int32),
                torch.gather(flat_i, 1, gpos).to(torch.int32),
                total.view(Qr, 1).view(torch.int32)],
                dim=1).cpu().numpy()  # one copy back
        kernels.record("bm25_scatter", Qr)
        slot = order[out[:, kg: 2 * kg]]
        return (out[:, :kg].view(np.float32), lut_shard[slot],
                out[:, 2 * kg: 3 * kg], lut_ord[slot],
                out[:, 3 * kg:].view(np.int64)[:, 0])

    def _terms_part(self, field, sub, d, starts, lens, ws, D, kk):
        """Mesh device ``d``'s slots of a ``search_terms`` round, on the
        device: each slot's top kk of every query ([S_d, Q, kk] values
        and ids) and the queries' hit counts over its slots. Queries run
        in chunks that bound the [S_d, chunk, D] score block."""
        Sd, Qr, T = starts.shape
        data = _SlotData(self, sub, d)
        post, _ = PostingsPrim(field).build(sub, None, D, data)
        doc_ids, tfnorm = post[0](), post[1]()
        live = LivePrim().build(sub, None, D, data)[0][0]()
        chunk = max(1, _ROUND_ELEMS // (Sd * D))
        svs, sis, tots = [], [], []
        for q0 in range(0, Qr, chunk):
            n = min(q0 + chunk, Qr) - q0
            G = Sd * n
            scores = bm25_score_batch(
                doc_ids, tfnorm, starts[:, q0: q0 + n].reshape(G, T),
                lens[:, q0: q0 + n].reshape(G, T),
                ws[:, q0: q0 + n].reshape(G, T), D=D,
                slot_of=np.repeat(np.arange(Sd, dtype=np.int32), n))
            masked = torch.where(live.unsqueeze(1), scores.view(Sd, n, D),
                                 NEG_INF)
            tots.append((masked > 0).sum((0, 2)))
            sv, si = topk_stable(masked.view(G, D), kk)
            svs.append(sv.reshape(Sd, n, kk))
            sis.append(si.reshape(Sd, n, kk))
        return torch.cat(svs, 1), torch.cat(sis, 1), torch.cat(tots)

    # -- kNN -------------------------------------------------------------------

    def search_knn(self, field: str, queries: np.ndarray, k: int = 10,
                   metric: str = "cosine"):
        """queries f32[Q, dims] → (vals, shard, local, seg_ord [Q, k],
        totals=None), merged over every segment round."""
        host = np.ascontiguousarray(queries, np.float32)

        def topk(q, vecs, live):
            kp = min(4 * k, vecs.shape[0])
            vals, idx = knn_topk(q, vecs, live, k=kp, metric=metric)
            vals, idx = exact_rescore_topk(q, vecs, vals, idx, metric=metric)
            return vals[:, :k], idx[:, :k]

        return self._search_vector_rounds(field, host, host.shape[0], k,
                                          topk, "mesh_knn")

    def search_maxsim(self, field: str, tokens: np.ndarray, k: int = 10,
                      metric: str = "cosine"):
        """Multi-vector MaxSim: tokens f32[Q, T, dims] → (vals, shard,
        local, seg_ord [Q, k], totals=None); a doc's score is the max
        over the request's tokens."""
        nq, T, dims = tokens.shape
        host = np.ascontiguousarray(tokens, np.float32).reshape(nq * T, dims)

        def topk(flat, vecs, live):
            kp = min(4 * k, vecs.shape[0])
            vals, idx = knn_topk(flat, vecs, live, k=kp, metric=metric)
            vals, idx = exact_rescore_topk(flat, vecs, vals, idx,
                                           metric=metric)
            vals, idx, _ = merge_candidate_topk(
                vals.reshape(nq, T * kp), idx.reshape(nq, T * kp),
                k=min(k, T * kp))
            return vals, idx

        return self._search_vector_rounds(field, host, nq, k, topk,
                                          "mesh_maxsim")

    def _search_vector_rounds(self, field: str, host: np.ndarray, nq: int,
                              k: int, topk, program: str):
        """Per round: ``topk(queries, vecs, live)`` on every slot's own
        slab (B2 and the re-rank), on the slot's device with the queries
        copied there once a call; every device's slots launched before
        any result leaves its device, then stacked on the first device in
        shard order, one sorted merge per request, one copy back; rounds
        merge on the host. Each round is in flight, as ``program``, up to
        its copy back."""
        nd, dev0 = self.n_devices, self.device
        qdev: Dict[int, torch.Tensor] = {}

        def queries_on(d):
            if d not in qdev:
                qdev[d] = torch.from_numpy(host).to(self.devices[d])
            return qdev[d]

        merged = None
        for row in self._rounds_for(self.shards):
            lut_shard = [e[0] if e is not None else -1 for e in row]
            lut_ord = [e[1] if e is not None else 0 for e in row]
            order = _shard_order(lut_shard)
            segs = [e[2] if e is not None else None for e in row]
            vcs = [s.vectors.get(field) for s in segs if s is not None]
            dims = next((vc.dims for vc in vcs if vc is not None), 0)
            with REGISTRY.timed(program, self._sig(
                    S=len(row), Q=pow2_bucket(nq, 1), D=_round_docs(segs),
                    dims=dims, k=k), devices=self._devices_label):
                # per device, its slots in shard order: (position, slot)
                staged = []
                for d in range(nd):
                    mine = [(pos, s) for pos, s in enumerate(order)
                            if s % nd == d]
                    dev = self.devices[d]
                    vals = torch.full((len(mine), nq, k), NEG_INF,
                                      dtype=torch.float32, device=dev)
                    ids = torch.zeros((len(mine), nq, k), dtype=torch.int32,
                                      device=dev)
                    for j, (_pos, s) in enumerate(mine):
                        seg = row[s][2] if row[s] is not None else None
                        vc = seg.vectors.get(field) if seg is not None \
                            else None
                        if vc is None:
                            continue
                        kernels.record("knn_fused_topk")
                        v, i = topk(queries_on(d), vc.vecs,
                                    seg.live & vc.exists)
                        vals[j, :, : v.shape[1]] = v
                        ids[j, :, : v.shape[1]] = i
                    staged.append((mine, vals, ids))
                if nd == 1:
                    vals, ids = staged[0][1], staged[0][2]
                else:
                    vals = torch.full((len(row), nq, k), NEG_INF,
                                      dtype=torch.float32, device=dev0)
                    ids = torch.zeros((len(row), nq, k), dtype=torch.int32,
                                      device=dev0)
                    for mine, dv, di in staged:
                        for j, (pos, _s) in enumerate(mine):
                            vals[pos].copy_(dv[j], non_blocking=True)
                            ids[pos].copy_(di[j], non_blocking=True)
                flat_v = vals.permute(1, 0, 2).reshape(nq, -1)
                flat_i = ids.permute(1, 0, 2).reshape(nq, -1)
                gv, gpos = torch.sort(flat_v, dim=1, descending=True,
                                      stable=True)
                gv, gpos = gv[:, :k], gpos[:, :k]
                out = torch.cat([gv.contiguous().view(torch.int32),
                                 (gpos // k).to(torch.int32),
                                 torch.gather(flat_i, 1, gpos)],
                                dim=1).cpu().numpy()
            slot = np.asarray(order, np.int32)[out[:, k: 2 * k]]
            res = (out[:, :k].view(np.float32),
                   np.asarray(lut_shard, np.int32)[slot], out[:, 2 * k:],
                   np.asarray(lut_ord, np.int32)[slot], None)
            merged = res if merged is None else _merge_rounds(merged, res, k)
        return merged

    # -- the cross-device sum of integer lanes -----------------------------

    def psum_partials(self, partials: np.ndarray) -> np.ndarray:
        """int64[S, L] per-slot lanes → their exact int64 sum [L]: each
        device sums its slots' rows on itself (rows d, d + n, ...), the
        sums go to the first device, add there, and come back in one
        copy (the reference's ``psum`` over its mesh). Raises on any
        failure."""
        parts = np.ascontiguousarray(partials, np.int64)
        S, L = parts.shape
        nd, dev0 = self.n_devices, self.device
        with REGISTRY.timed("mesh_psum", self._sig(S=S, L=pow2_bucket(L, 1)),
                            devices=self._devices_label):
            sums = [torch.from_numpy(parts[d::nd]).to(self.devices[d]).sum(0)
                    for d in range(nd)]
            acc = torch.zeros(L, dtype=torch.int64, device=dev0)
            for t in sums:
                acc += t.to(dev0, non_blocking=True)
            out = acc.cpu().numpy()
        kernels.record("mesh_psum")
        return out


def _pack(sort, p: _Part, perm, kk: int, kg: int) -> torch.Tensor:
    """A round's packed result from its slots' results: a sorted round's
    ids and counts as they are; else the round's top kg over all its
    slots (a round of S slots can hold up to S * kk of a deep page's
    candidates), merged in shard order (``perm``) by one stable sort,
    with each one's slot, then the total; the terms aggs' counts last."""
    counts = [c.reshape(-1).view(torch.int32) for c in p.counts]
    if sort:
        return torch.cat([p.ids.reshape(-1), p.totals.view(torch.int32)]
                         + counts)
    total = p.totals.sum().reshape(1).view(torch.int32)
    pv = p.vals.index_select(0, perm).reshape(-1)
    pi = p.ids.index_select(0, perm).reshape(-1)
    gv, gpos = torch.sort(pv, descending=True, stable=True)
    gv, gpos = gv[:kg], gpos[:kg]
    return torch.cat([gv.contiguous().view(torch.int32),
                      perm[gpos // kk].to(torch.int32), pi[gpos], total]
                     + counts)


def _record_tgroup_kernels(compiled) -> None:
    """Dispatch counters: which scoring form serves each term group of a
    round the generic route runs."""
    n_hybrid = sum(1 for p in compiled.prims
                   if isinstance(p, HybridTGroupPrim))
    n_scatter = sum(1 for p in compiled.prims if type(p) is TGroupPrim)
    if n_hybrid:
        kernels.record("bm25_hybrid", n_hybrid)
    if n_scatter:
        kernels.record("bm25_scatter", n_scatter)


def _round_docs(seg_row) -> int:
    """A round's doc-axis class: the pow2 class of its largest slot."""
    return pow2_bucket(max([s.max_docs for s in seg_row if s is not None]
                           + [1]))


def _segments_of(s) -> list:
    """A shard slot's segment list (live view where possible)."""
    if s is None:
        return []
    if isinstance(s, list):
        return s
    segs = getattr(s, "segments", None)
    if isinstance(segs, list):
        return segs
    return [s]  # a bare segment


def _chunk_table(seg, field: str, terms):
    """A slot's chunk table (starts, lens, weights) for a (term, weight)
    list: the segment's own postings runs, its idf folded into each
    weight, absent terms dropped."""
    runs = []
    inv = seg.inverted.get(field) if seg is not None else None
    if inv is not None:
        for term, w in terms:
            s, ln = inv.term_slice(term)
            if ln > 0:
                runs.append((s, ln, inv.idf(term) * w))
    starts, lens, ws, _ = split_runs(runs)
    return starts, lens, ws


def _merge_rounds(a, b, k):
    """Host merge of two (vals, shard, local, seg_ord, totals) sets."""
    av, ash, al, ar, at = a
    bv, bsh, bl, br, bt = b
    v = np.concatenate([av, bv], axis=1)
    sh = np.concatenate([ash, bsh], axis=1)
    lo = np.concatenate([al, bl], axis=1)
    rn = np.concatenate([ar, br], axis=1)
    order = np.argsort(-v, axis=1, kind="stable")[:, :k]

    def take(x):
        return np.take_along_axis(x, order, axis=1)

    totals = None if at is None else at + bt
    return take(v), take(sh), take(lo), take(rn), totals
