"""Distributed query execution over the shard slots of one card.

Port of elasticsearch_tpu/parallel/executor.py. The reference scatters
the query phase over a ``('shard',)`` mesh as one ``shard_map`` program:
per-shard scoring and top-k, an ``all_gather`` merge and ``psum`` totals.
On one H100 the mesh is S slots of one device (``parallel/mesh.py``): a
segment round — the r-th segment of every shard — runs as one sequence
of PyTorch ops and kernel launches over slot-stacked ``[S, ...]``
tensors, and the round's merged top-k comes back to the host in one
copy of one packed buffer.

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
    of the round's segment data."""

    def __init__(self, executor: "MeshSearchExecutor", seg_row):
        self.executor = executor
        self.seg_row = seg_row

    def _stack(self, per_slot, length, fill, dtype, fix):
        """The [S, length] copy. A reader may give a host mirror (an
        evicted column, ``segment.stack_source``): it is copied in from
        the host, so building a round rehydrates nothing."""
        out = torch.full((len(self.seg_row), length), fill, dtype=dtype,
                         device=self.executor.device)
        for s, seg in enumerate(self.seg_row):
            with stacking():
                t = per_slot(seg) if seg is not None else None
            if t is None:
                continue
            if isinstance(t, np.ndarray):
                t = torch.from_numpy(t).to(self.executor.device)
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
                                 stack, self.seg_row)


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


class MeshSearchExecutor:
    """Runs queries over N shards laid out on S slots of one card.

    Segments are searched in rounds (round r stacks the r-th segment of
    every shard; a shard with fewer segments leaves its slot empty), and
    rounds merge on the host. More shards than slots wrap round-robin
    (shard i → slot i % S, its segments joining that slot's rounds)."""

    def __init__(self, mesh: ShardMesh, groups, residency):
        self.mesh = mesh
        self.S = mesh_size(mesh)
        self.device = mesh.device
        self.residency = residency
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
        # stacked device data per segment round (S > 1), LRU-bounded:
        # key → (tensor, pinned segments, PinnedToken of its bytes)
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

    def _cached_data(self, key, nbytes: int, build, refs):
        """A stacked copy keyed by segment ids. ``refs`` (the segments)
        are kept with it so a cached id() can never be recycled while the
        entry lives. The bytes are a pinned ``fielddata`` charge
        (``Residency.track``), forced as the reference's: the LRU's cap is
        the ceiling, and a copy reads host mirrors, so it never trips.
        The token is closed on eviction or close."""
        with self._data_lock:
            if key in self._data:
                self._data.move_to_end(key)
                kernels.record("executor_data_hit")
                return self._data[key][0]
        kernels.record("executor_data_miss")
        tok = self.residency.track(nbytes, label="executor.data")
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
                self._data[key] = (val, list(refs), tok)
                while len(self._data) > self._data_cap:
                    evicted.append(self._data.popitem(last=False)[1][2])
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
                     k: int, global_stats=None) -> _Round:
        """Build the prims' data and copy the round's tables to the card
        in one word buffer. A fused request builds its term group first:
        when no non-empty slot needs the generic route, nothing else is
        built or copied. With ``global_stats`` (dfs) every slot's term
        weights take the index-wide idf."""
        D = compiled.D
        kk = min(k, D)
        ctxs = [SegmentContext(s, mappings, analysis, global_stats)
                if s is not None else None for s in seg_row]
        data = _SlotData(self, seg_row)
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
        if len(seg_row) > 1:
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
        words = torch.from_numpy(_pack_words(tables)).to(self.device)
        env_items = None
        if generic:
            at = {id(a): o for a, o in zip(tables, offs)}
            env_items = [[functools.partial(_word_view, words, at[id(a)], a)
                          if isinstance(a, np.ndarray) else a for a in its]
                         for its in items]
        perm = (_word_view(words, offs[perm_t], tables[perm_t])
                if len(seg_row) > 1 else None)
        for s, fs in enumerate(fused):
            if fs is not None:
                t, R, block, live = fs
                arg = words[offs[t]: offs[t] + 2 * R]
                fused[s] = (arg[:R].view(torch.float32).view(1, R), arg[R:],
                            block, live, min(kk, seg_row[s].max_docs))
        return _Round(compiled, env_items, meta, kk,
                      min(k, len(seg_row) * kk), fused, perm, words,
                      [s for s in seg_row if s is not None])

    def _run_round(self, rd: _Round):
        """Launch the round: (its packed result, copied back once, the
        terms aggs' counts at its end; the [S, D] match mask when the
        request wants it, else None)."""
        compiled, kk = rd.compiled, rd.kk
        fused = rd.fused
        n = len(fused)
        counts, mask = [], None
        if n == 1 and fused[0] is not None:
            qw, rows, block, live, ks = fused[0]
            kernels.record("bm25_fused_topk")
            Q.FUSED_CALLS += 1
            return Q.bm25_dense_topk(qw, _resolve(block), live, k=ks,
                                     rows=rows,
                                     count=True, packed=True).cpu().numpy(), \
                None
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
                      .reshape(-1).view(torch.int32)
                      for _name, p in compiled.agg_prims]
            if compiled.sort:
                # each slot's top kk by its keys; every slot's count
                lanes = []
                for p, desc, first in compiled.sort:
                    key, exists = env[p]
                    lanes += sort_lanes(key, exists, desc, first,
                                        rd.meta[p][0])
                ids = sort_topk(lanes, mask, kk).to(torch.int32)
                return torch.cat([ids.reshape(-1),
                                  mask.sum(1).view(torch.int32)] + counts
                                 ).cpu().numpy(), \
                    mask if compiled.want_mask else None
            masked = torch.where(mask, scores, NEG_INF)
            sv, si = torch.sort(masked, dim=1, descending=True, stable=True)
            vals, ids = sv[:, :kk], si[:, :kk].to(torch.int32)
            totals = mask.sum(1)
            if not compiled.want_mask:
                mask = None
        else:
            dev = self.device
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
        total = totals.sum().reshape(1).view(torch.int32)
        if n == 1:
            return torch.cat([vals[0].contiguous().view(torch.int32),
                              ids[0], total] + counts).cpu().numpy(), mask
        # the round's top kg over all its slots: a round of S slots can
        # hold up to S * kk of a deep page's candidates
        perm = rd.perm.to(torch.int64)
        pv = vals.index_select(0, perm).reshape(-1)
        pi = ids.index_select(0, perm).reshape(-1)
        gv, gpos = torch.sort(pv, descending=True, stable=True)
        gv, gpos = gv[:rd.kg], gpos[:rd.kg]
        return torch.cat([gv.contiguous().view(torch.int32),
                          perm[gpos // kk].to(torch.int32), pi[gpos],
                          total] + counts).cpu().numpy(), mask

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
        compiled = [self._compile(query, mappings, analysis, seg_row,
                                  agg_specs, want_mask, sort_spec)
                    for seg_row in seg_rows]
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
            if rd is None:
                rd = self._build_round(compiled, mappings, analysis, seg_row,
                                       lut_shard, k, global_stats)
                if prep_key is not None:
                    kernels.record("executor_prep_miss")
                    self._remember(prep_key, rd)
            else:
                kernels.record("executor_prep_hit")
            # in flight from the launch to the packed result's copy back
            # (the reference's memo and fresh dispatch points alike)
            with REGISTRY.timed("mesh_dsl", static_sig(
                    S=len(seg_row), D=_round_docs(seg_row), k=rd.kk)):
                out, mask = self._run_round(rd)
            totals += self._decode_round(out, rd, lut_shard, lut_ord, merged,
                                         seg_row, agg_rounds)
            if mask is not None:
                mask_rounds.extend(
                    (lut_shard[si], lut_ord[si], seg, mask[si, : seg.max_docs])
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

    def _remember(self, prep_key, rd: _Round) -> None:
        """Keep a prepared round, dropping the least recent past the
        cap."""
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
        live mask, the hit count and a stable top-k; the slots merged in
        shard order. Queries run in chunks that bound the [S, chunk, D]
        score block; the round's packed result comes back in one copy."""
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
        data = _SlotData(self, seg_row)
        post, _ = PostingsPrim(field).build(seg_row, None, D, data)
        doc_ids, tfnorm = post[0](), post[1]()
        live = LivePrim().build(seg_row, None, D, data)[0][0]()
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
        perm = torch.from_numpy(order).to(self.device)
        chunk = max(1, _ROUND_ELEMS // (S * D))
        # in flight from the first launch to the copy back
        with REGISTRY.timed("mesh_bm25", static_sig(
                S=S, Q=pow2_bucket(Qr, 1), T=pow2_bucket(T, 1), D=D, k=kk)):
            outs = []
            for q0 in range(0, Qr, chunk):
                n = min(q0 + chunk, Qr) - q0
                G = S * n
                scores = bm25_score_batch(
                    doc_ids, tfnorm, starts[:, q0: q0 + n].reshape(G, T),
                    lens[:, q0: q0 + n].reshape(G, T),
                    ws[:, q0: q0 + n].reshape(G, T), D=D,
                    slot_of=np.repeat(np.arange(S, dtype=np.int32), n))
                masked = torch.where(live.unsqueeze(1), scores.view(S, n, D),
                                     NEG_INF)
                total = (masked > 0).sum((0, 2))
                sv, si = topk_stable(masked.view(G, D), kk)
                # each slot's top kk, the slots in shard order, then one
                # stable merge per query
                sv = sv.reshape(S, n, kk).index_select(0, perm)
                si = si.reshape(S, n, kk).index_select(0, perm)
                flat_v = sv.permute(1, 0, 2).reshape(n, S * kk)
                flat_i = si.permute(1, 0, 2).reshape(n, S * kk)
                gv, gpos = torch.sort(flat_v, dim=1, descending=True,
                                      stable=True)
                gv, gpos = gv[:, :kg], gpos[:, :kg]
                outs.append(torch.cat([
                    gv.contiguous().view(torch.int32),
                    (gpos // kk).to(torch.int32),
                    torch.gather(flat_i, 1, gpos).to(torch.int32),
                    total.view(n, 1).view(torch.int32)], dim=1))
            out = torch.cat(outs).cpu().numpy()  # one copy back
        kernels.record("bm25_scatter", Qr)
        slot = order[out[:, kg: 2 * kg]]
        return (out[:, :kg].view(np.float32), lut_shard[slot],
                out[:, 2 * kg: 3 * kg], lut_ord[slot],
                out[:, 3 * kg:].view(np.int64)[:, 0])

    # -- kNN -------------------------------------------------------------------

    def search_knn(self, field: str, queries: np.ndarray, k: int = 10,
                   metric: str = "cosine"):
        """queries f32[Q, dims] → (vals, shard, local, seg_ord [Q, k],
        totals=None), merged over every segment round."""
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            self.device)

        def topk(vecs, live):
            kp = min(4 * k, vecs.shape[0])
            vals, idx = knn_topk(q, vecs, live, k=kp, metric=metric)
            vals, idx = exact_rescore_topk(q, vecs, vals, idx, metric=metric)
            return vals[:, :k], idx[:, :k]

        return self._search_vector_rounds(field, q.shape[0], k, topk,
                                          "mesh_knn")

    def search_maxsim(self, field: str, tokens: np.ndarray, k: int = 10,
                      metric: str = "cosine"):
        """Multi-vector MaxSim: tokens f32[Q, T, dims] → (vals, shard,
        local, seg_ord [Q, k], totals=None); a doc's score is the max
        over the request's tokens."""
        nq, T, dims = tokens.shape
        flat = torch.from_numpy(np.ascontiguousarray(
            tokens, np.float32).reshape(nq * T, dims)).to(self.device)

        def topk(vecs, live):
            kp = min(4 * k, vecs.shape[0])
            vals, idx = knn_topk(flat, vecs, live, k=kp, metric=metric)
            vals, idx = exact_rescore_topk(flat, vecs, vals, idx,
                                           metric=metric)
            vals, idx, _ = merge_candidate_topk(
                vals.reshape(nq, T * kp), idx.reshape(nq, T * kp),
                k=min(k, T * kp))
            return vals, idx

        return self._search_vector_rounds(field, nq, k, topk, "mesh_maxsim")

    def _search_vector_rounds(self, field: str, nq: int, k: int, topk,
                              program: str):
        """Per round: ``topk(vecs, live)`` on every slot's own slab (B2
        and the re-rank), the slots stacked in shard order, one sorted
        merge per request, one copy back; rounds merge on the host. Each
        round is in flight, as ``program``, up to its copy back."""
        merged = None
        for row in self._rounds_for(self.shards):
            lut_shard = [e[0] if e is not None else -1 for e in row]
            lut_ord = [e[1] if e is not None else 0 for e in row]
            order = _shard_order(lut_shard)
            segs = [e[2] if e is not None else None for e in row]
            vcs = [s.vectors.get(field) for s in segs if s is not None]
            dims = next((vc.dims for vc in vcs if vc is not None), 0)
            with REGISTRY.timed(program, static_sig(
                    S=len(row), Q=pow2_bucket(nq, 1), D=_round_docs(segs),
                    dims=dims, k=k)):
                vals = torch.full((len(row), nq, k), NEG_INF,
                                  dtype=torch.float32, device=self.device)
                ids = torch.zeros((len(row), nq, k), dtype=torch.int32,
                                  device=self.device)
                for pos, s in enumerate(order):
                    seg = row[s][2] if row[s] is not None else None
                    vc = seg.vectors.get(field) if seg is not None else None
                    if vc is None:
                        continue
                    kernels.record("knn_fused_topk")
                    v, i = topk(vc.vecs, seg.live & vc.exists)
                    vals[pos, :, : v.shape[1]] = v
                    ids[pos, :, : v.shape[1]] = i
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
