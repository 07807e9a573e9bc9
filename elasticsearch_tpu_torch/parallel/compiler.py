"""Mesh query compiler: a parsed query tree → one program over S slots.

Port of elasticsearch_tpu/parallel/compiler.py for the query types the
port's ``parse_query`` serves. The reference splits a query into a static
emit tree, traced once into a ``shard_map`` body, and per-shard data
tables stacked ``[S, ...]`` over the ``('shard',)`` mesh. On one card the
split stays, and there is no trace: an emit's ``ex`` runs its PyTorch ops
over slot-stacked ``[S, D]`` tensors, so one sequence of launches covers
every slot of a segment round.

Data a prim builds is one of three things:
- a numpy array of per-request tables (chunk tables, row lists, bounds,
  ids), packed with the round's other tables into one word buffer and
  copied to the card once (``executor._pack_words``);
- a slot-stacked tensor of segment data (live masks, postings, columns):
  at S = 1 a view of the segment's own tensor, at S > 1 a copy cached by
  the executor and charged to the breakers;
- a per-slot list of a segment's own big tensors (dense impact blocks,
  vector slabs), which are never stacked: the emits gather the rows they
  need, or launch kernel B2 once per slot.

Supported: match_all, match_none, term, terms, match (operator,
minimum_should_match), match_phrase (the positional program on each
slot's own CSR, ``PhrasePrim``/``EPhrase``), range (numeric i64-exact
and f32, date, keyword by term expansion), exists, ids, prefix,
wildcard, regexp and fuzzy (per-slot term-dict expansions, as data),
bool, constant_score, dis_max, boosting and brute-force knn. ``hybrid``
and knn through IVF, IVF-PQ or MaxSim decline by design
(``MeshCompileError`` with ``by_design``) and keep their host-loop
routes; any other tree raises ``MeshCompileError`` and the caller takes
the host loop, as the reference's mesh sends ``match`` with fuzziness,
multi_match, common, query_string, more_like_this and indices there.

Aggregations ride the round in one of two ways (``mesh_service``): a
request whose aggs are all keyword ``terms`` without sub-aggregations
adds one ``AggTermsPrim`` per agg, and the round counts each slot's
terms over its match mask on the card; any other agg tree asks for the
round's ``[S, D]`` match mask (``want_mask``), which the host-side
collectors read. Either way the round takes the generic route, never
kernel B1, which makes no mask.

A field-sorted request adds one sort prim a key (``SortColPrim`` for a
numeric or date column, ``SortOrdPrim`` for a keyword): each slot's
order-preserving int64 keys, the segment's own sort mirror
(``TpuSegment.sort_keys``), and the round selects each slot's exact top
k by the full key tuple (``ops/scoring.py::sort_topk``); a keyword's
keys rank its terms inside the slot's segment, and the slots' candidates
merge on the host by their values (``mesh_service``). ``_score`` as any
sort key declines (the host loop serves it). function_score comes with
ROADMAP A9b.
"""
from __future__ import annotations

import functools
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import split_i64
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.ops import scoring as S
from elasticsearch_tpu_torch.ops.positional import (build_phrase_inputs,
                                                    phrase_freq_program,
                                                    phrase_score)
from elasticsearch_tpu_torch.search import queries as Q
from elasticsearch_tpu_torch.search.context import SegmentContext, split_runs
from elasticsearch_tpu_torch.utils.errors import QueryParsingException
from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

NEG_INF = float("-inf")


class MeshCompileError(Exception):
    """The query can't ride the mesh program. ``by_design=True`` marks
    paths that are host-orchestrated on purpose (IVF probing, MaxSim,
    hybrid): the dispatch counters report them as ``mesh_host_by_design``,
    not ``mesh_fallback_total``."""

    def __init__(self, msg: str, by_design: bool = False):
        super().__init__(msg)
        self.by_design = by_design


# ---------------------------------------------------------------------------
# data primitives
# ---------------------------------------------------------------------------

class DataPrim:
    """One input group of the round. ``build(seg_row, ctxs, D, data)``
    returns (items, static): the items are numpy tables, slot-stacked
    tensors (``data.stacked``) or per-slot lists; ``static`` holds the
    parameters the emits read (postings a chunk position, row count R,
    range form)."""

    def build(self, seg_row, ctxs, D: int, data) -> Tuple[list, tuple]:
        raise NotImplementedError


def _ids(seg_row) -> tuple:
    return tuple(id(s) for s in seg_row)


class LivePrim(DataPrim):
    def build(self, seg_row, ctxs, D, data):
        # deletes invalidate through the deleted counts in the key
        key = ("live", _ids(seg_row),
               tuple(s.deleted_count if s is not None else 0
                     for s in seg_row), D)
        return [data.stacked(key, lambda s: s.live, D, False, torch.bool)], ()


class NumDocsPrim(DataPrim):
    def build(self, seg_row, ctxs, D, data):
        return [np.asarray([s.num_docs if s is not None else 0
                            for s in seg_row], np.int32)], ()


def _postings_nnz(field: str, seg_row) -> int:
    return max([s.inverted[field].nnz_pad for s in seg_row
                if s is not None and field in s.inverted] or [1])


def _inv_attr(field: str, attr: str):
    """per_slot reader of an inverted field's tensor (None without it)."""
    def get(seg):
        inv = seg.inverted.get(field)
        return None if inv is None else getattr(inv, attr)
    return get


def _stacked_doc_ids(field: str, seg_row, D: int, data):
    """The field's postings doc ids [S, NNZ], every pad (a segment pads
    with its own max_docs, an empty slot row with D) mapped to D."""
    def sentinel(seg, t):
        return torch.where(t >= seg.max_docs, torch.full_like(t, D), t)

    nnz = _postings_nnz(field, seg_row)
    return data.stacked(("postings", field, _ids(seg_row), nnz, D),
                        _inv_attr(field, "doc_ids"), nnz, D, torch.int32,
                        fix=sentinel)


class PostingsPrim(DataPrim):
    """Stacked postings of one field: doc_ids [S, NNZ] (pads and other
    slots' sentinels → D), tfnorm [S, NNZ]."""

    def __init__(self, field: str):
        self.field = field

    def build(self, seg_row, ctxs, D, data):
        f = self.field
        nnz = _postings_nnz(f, seg_row)
        return [_stacked_doc_ids(f, seg_row, D, data),
                data.stacked(("tfnorm", f, _ids(seg_row), nnz, D),
                             _inv_attr(f, "tfnorm"), nnz, 0.0,
                             torch.float32)], ()


class AggTermsPrim(DataPrim):
    """A keyword terms agg's inputs: the field's postings doc ids and
    term ids [S, NNZ] (the doc ids shared with the field's PostingsPrim,
    term-id pads ≥ a slot's vocabulary) and each slot's real vocabulary
    size; static: the widest vocabulary. Mirrors TermsAggregator's
    postings count, so multi-valued fields count correctly."""

    def __init__(self, field: str):
        self.field = field

    def build(self, seg_row, ctxs, D, data):
        f = self.field
        nnz = _postings_nnz(f, seg_row)
        vreal = np.asarray([len(s.inverted[f].terms)
                            if s is not None and f in s.inverted else 0
                            for s in seg_row], np.int32)
        vmax = int(vreal.max(initial=0))
        term_ids = data.stacked(("termids", f, _ids(seg_row), nnz, vmax),
                                _inv_attr(f, "term_ids"), nnz, vmax,
                                torch.int32)
        return [_stacked_doc_ids(f, seg_row, D, data), term_ids,
                vreal], (vmax,)


def agg_term_counts(mask, doc_ids, term_ids, vreal, vmax: int):
    """i64[S, vmax + 1]: per slot, how many matched docs (``mask`` [S,
    D]) carry each term, over the slot's postings; column vmax collects
    nothing real. One ``index_add_`` for every slot (exact)."""
    n = mask.shape[0]
    # the D sentinel of a pad reads a False column
    hit = torch.cat([mask, mask.new_zeros(n, 1)], 1).gather(
        1, doc_ids.to(torch.int64))
    w = hit & (term_ids < vreal[:, None])
    slot = torch.arange(n, device=mask.device)[:, None] * (vmax + 1)
    ids = term_ids.to(torch.int64).clamp(max=vmax) + slot
    return S.bucket_count(ids, w, num_buckets=n * (vmax + 1)).view(
        n, vmax + 1)


def _tables(per_slot, S: int):
    """starts/lens/ws [S, T] from per-slot chunk lists, T a pow2, and the
    postings of each chunk position over the slots (host i64[T]: the
    scatters' sizes)."""
    T = pow2_bucket(max([len(st) for st, _, _ in per_slot] or [1]),
                    minimum=1)
    h_starts = np.zeros((S, T), np.int32)
    h_lens = np.zeros((S, T), np.int32)
    h_ws = np.zeros((S, T), np.float32)
    for si, (st, ln, ws) in enumerate(per_slot):
        h_starts[si, : len(st)] = st
        h_lens[si, : len(ln)] = ln
        h_ws[si, : len(ws)] = ws
    return [h_starts, h_lens, h_ws], h_lens.astype(np.int64).sum(0)


class _SortPrim(DataPrim):
    """One sort key's inputs: each slot's i64 keys and exists [S, D]
    (its segment's sort mirror, stacked; zeros and False for a slot
    without it); static: whether every slot's keys clear the missing
    sentinels in this order (``scoring.lanes_safe``)."""

    label = "sort"

    def __init__(self, field: str, desc: bool):
        self.field = field
        self.desc = desc

    def build(self, seg_row, ctxs, D, data):
        f = self.field

        def mirror(attr):
            def get(seg):
                m = seg.sort_keys(f)
                return None if m is None else getattr(m, attr)
            return get

        key = (f, _ids(seg_row), D)
        safe = all(S.lanes_safe(m.lo, m.hi, self.desc)
                   for m in (s.sort_keys(f) for s in seg_row
                             if s is not None) if m is not None)
        return [data.stacked((self.label,) + key, mirror("key"), D, 0,
                             torch.int64),
                data.stacked((self.label + "exists",) + key,
                             mirror("exists"), D, False, torch.bool)], \
            (safe,)


class SortColPrim(_SortPrim):
    """A numeric, date or ip sort key: a column's exact values (integers)
    or f64 order keys."""

    label = "sortcol"


class SortOrdPrim(_SortPrim):
    """A keyword sort key: the rank of a doc's first value among its
    segment's sorted terms (slot-local; the merge compares strings)."""

    label = "sortord"


class TGroupPrim(DataPrim):
    """Chunk tables of one term group: starts/lens/ws [S, T].
    ``terms_fn(ctx)`` yields that slot's (terms, weights): per-shard idf
    and term-dict expansions resolve here, on the host, as data."""

    def __init__(self, field: str, terms_fn: Callable):
        self.field = field
        self.terms_fn = terms_fn

    def build(self, seg_row, ctxs, D, data):
        per_slot = []
        for seg, ctx in zip(seg_row, ctxs):
            inv = seg.inverted.get(self.field) if seg is not None else None
            runs = []
            if inv is not None:
                terms, weights = self.terms_fn(ctx)
                runs = [inv.term_slice(t) + (w,)
                        for t, w in zip(terms, weights)]
            per_slot.append(split_runs(runs)[:3])
        tables, sizes = _tables(per_slot, len(seg_row))
        return tables, (sizes,)


class HybridTGroupPrim(DataPrim):
    """A term group over the dense-impact path: the segment's frequent
    terms are rows of its impact[F, D] block, the rare tail stays as
    (start, len) chunks, the split the host loop's ``ctx.hybrid_slices``
    makes.

    ``scan`` resolves each slot's terms on the host: ``fused[s]`` says
    whether slot s's part is a pure-dense group (a block, a dense row, no
    tail postings), the shape the host loop sends to kernel B1, and
    ``b1_args(s)`` gives its block, real rows and weights. ``build`` (the
    generic route) adds the tables. Items: the per-slot blocks (a
    segment's own tensor or None; never stacked), qrows/qrw [S, R] (each
    slot's dense rows, sorted, -1/0 padded), starts/lens/ws [S, T] tail
    tables; static (the tail's postings a chunk position, the most real
    rows of a slot)."""

    def __init__(self, field: str, terms_fn: Callable):
        self.field = field
        self.terms_fn = terms_fn
        self.fused: List[bool] = []
        self.n_rows: List[int] = []
        self._slots: Optional[list] = None

    def scan(self, seg_row, ctxs) -> None:
        """Per slot: (block or None, {dense row: weight}, tail runs)."""
        self._slots, self.fused, self.n_rows = [], [], []
        for seg, ctx in zip(seg_row, ctxs):
            inv = seg.inverted.get(self.field) if seg is not None else None
            blk = inv.dense_block() if inv is not None else None
            runs = []
            row_w: Dict[int, float] = {}
            if inv is not None:
                terms, weights = self.terms_fn(ctx)
                for t, w in zip(terms, weights):
                    tid = inv.term_id(t)
                    if tid < 0:
                        continue
                    row = int(blk[0][tid]) if blk is not None else -1
                    if row >= 0:
                        row_w[row] = row_w.get(row, 0.0) + w
                    else:
                        s0 = int(inv.offsets[tid])
                        runs.append((s0, int(inv.offsets[tid + 1]) - s0, w))
            self._slots.append((None if blk is None else blk[1], row_w, runs))
            # a present term with an empty run (no postings in this
            # segment) leaves the group pure-dense, as in fused_bm25_topk
            self.fused.append(blk is not None and bool(row_w)
                              and sum(r[1] for r in runs) == 0)
            self.n_rows.append(len(row_w))

    def b1_args(self, s: int):
        """Slot s's block, its real dense rows, sorted, and their weights
        (the order ``pack_dense_rows`` gives the host loop)."""
        block, row_w, _runs = self._slots[s]
        rows = sorted(row_w)
        return (block, np.asarray(rows, np.int32),
                np.asarray([row_w[r] for r in rows], np.float32))

    def build(self, seg_row, ctxs, D, data):
        if self._slots is None:
            self.scan(seg_row, ctxs)
        blocks, per_slot = [], []
        for blk, _row_w, runs in self._slots:
            blocks.append(blk)
            per_slot.append(split_runs(runs)[:3])
        packed = [S.pack_dense_rows(sl[1]) for sl in self._slots]
        R = max(p[0].shape[0] for p in packed)
        h_qrows = np.full((len(seg_row), R), -1, np.int32)
        h_qrw = np.zeros((len(seg_row), R), np.float32)
        for si, (qr, qv) in enumerate(packed):
            h_qrows[si, : qr.shape[0]] = qr
            h_qrw[si, : qv.shape[0]] = qv
        tables, sizes = _tables(per_slot, len(seg_row))
        # past every slot's last real row the tables hold only pads
        return [blocks, h_qrows, h_qrw] + tables, (sizes, max(self.n_rows))


def _as_exact_int(v):
    """The host loop's test (``RangeQuery.execute``): v as an int when
    it is integral, else None."""
    if v is None:
        return None
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    i = int(f)
    return i if f == i else None


class RangePrim(DataPrim):
    """Numeric/date range: column slab + bounds. The exact-i64 pair form
    when the column carries (hi, lo) int32 pairs and the bounds are
    integral (the host loop's choice), else the f32 form with per-slot
    offset-adjusted bounds."""

    def __init__(self, field: str, lo, hi, use_int: bool):
        self.field = field
        self.lo = lo
        self.hi = hi
        self.use_int = use_int

    def _col(self, attr):
        f = self.field

        def get(seg):
            c = seg.numerics.get(f)
            return None if c is None else getattr(c, attr)
        return get

    def build(self, seg_row, ctxs, D, data):
        cols = [(s.numerics.get(self.field) if s is not None else None)
                for s in seg_row]
        key = (self.field, _ids(seg_row), D)
        exists = data.stacked(("colexists",) + key, self._col("exists"), D,
                              False, torch.bool)
        if self.use_int and any(c is not None and c.has_pair for c in cols):
            lo_v = _as_exact_int(self.lo)
            hi_v = _as_exact_int(self.hi)
            lo_v = lo_v if lo_v is not None else -(2 ** 63)
            hi_v = hi_v if hi_v is not None else 2 ** 63 - 1
            (lhi,), (llo,) = split_i64(np.array([lo_v]))
            (hhi,), (hlo,) = split_i64(np.array([hi_v]))
            bounds = np.broadcast_to(np.asarray([lhi, llo, hhi, hlo],
                                                np.int32),
                                     (len(seg_row), 4)).copy()
            return [data.stacked(("colhi",) + key, self._col("hi"), D, 0,
                                 torch.int32),
                    data.stacked(("collo",) + key, self._col("lo"), D, 0,
                                 torch.int32),
                    exists, bounds], ("pair",)
        bounds = np.zeros((len(seg_row), 2), np.float32)
        for si, c in enumerate(cols):
            off = c.offset if c is not None else 0.0
            bounds[si, 0] = (float(self.lo) - off) if self.lo is not None \
                else -np.inf
            bounds[si, 1] = (float(self.hi) - off) if self.hi is not None \
                else np.inf
        return [data.stacked(("colf32",) + key, self._col("values"), D, 0.0,
                             torch.float32),
                exists, bounds], ("f32",)


class ExistsPrim(DataPrim):
    def __init__(self, field: str):
        self.field = field

    def build(self, seg_row, ctxs, D, data):
        f = self.field

        def exists(seg):  # ExistsQuery.execute's resolution order
            for cols in (seg.numerics, seg.keywords, seg.vectors):
                if f in cols:
                    return cols[f].exists
            if f in seg.field_lengths:
                return seg.field_lengths[f] > 0
            return None

        key = ("exists", f, _ids(seg_row), D)
        return [data.stacked(key, exists, D, False, torch.bool)], ()


class IdsPrim(DataPrim):
    """The ids' positions s * D + local, a per-request table."""

    def __init__(self, values: List[str]):
        self.values = [str(v) for v in values]

    def build(self, seg_row, ctxs, D, data):
        pos = []
        for si, seg in enumerate(seg_row):
            if seg is None:
                continue
            for doc_id in self.values:
                loc = seg.id_map.get(doc_id)
                if loc is not None:
                    pos.append(si * D + loc)
        return [np.asarray(pos, np.int32)], ()


class PhrasePrim(DataPrim):
    """A phrase's inputs: a deferred per-slot list of the positional
    program's inputs on that slot's own CSR (``build_phrase_inputs``;
    views of the segment's tensors, nothing copied) with the slot's doc
    count, None where the phrase cannot match (positions missing, a term
    absent); the per-slot (avg_len, idf_sum) table [S, 2], idf through
    ``ctx.idf`` so dfs reaches it; the field lengths [S, D]."""

    def __init__(self, field: str, toks: List[Tuple[str, int]]):
        self.field = field
        self.toks = toks  # [(term, position)]: the query's analyzer output

    def build(self, seg_row, ctxs, D, data):
        f = self.field
        terms = list(dict.fromkeys(t for t, _ in self.toks))
        stats = np.zeros((len(seg_row), 2), np.float32)
        ok = []
        for si, (seg, ctx) in enumerate(zip(seg_row, ctxs)):
            inv = seg.inverted.get(f) if seg is not None else None
            ok.append(inv is not None and inv.positions is not None
                      and all(inv.term_slice(t)[1] > 0 for t in terms))
            if ok[-1]:
                stats[si] = (inv.avg_len,
                             sum(ctx.idf(f, t) for t in terms))

        def lengths(seg):
            return seg.field_lengths.get(f)

        return [functools.partial(_phrase_slots, seg_row, ok, f, self.toks),
                stats,
                data.stacked(("fieldlen", f, _ids(seg_row), D), lengths, D,
                             0.0, torch.float32)], ()


def _phrase_slots(seg_row, ok, field, toks):
    return [(build_phrase_inputs(seg.inverted[field], toks, seg.max_docs),
             seg.max_docs) if good else None
            for seg, good in zip(seg_row, ok)]


class VecsPrim(DataPrim):
    """dense_vector slabs for knn-as-query: the per-slot (vecs, exists)
    of each segment (its own tensors, never stacked), and the query
    vector f32 [dims] (a per-request table)."""

    def __init__(self, field: str, qvec):
        self.field = field
        self.qvec = np.asarray(qvec, np.float32)

    def build(self, seg_row, ctxs, D, data):
        slabs = []
        for seg in seg_row:
            vc = seg.vectors.get(self.field) if seg is not None else None
            slabs.append(None if vc is None else (vc.vecs, vc.exists))
        return [slabs, self.qvec], (int(self.qvec.shape[0]),)


# ---------------------------------------------------------------------------
# emit tree: static structure, run over slot-stacked [S, D] tensors
# ---------------------------------------------------------------------------

class Emit:
    boost: float = 1.0

    def ex(self, env, meta):
        """-> (scores f32[S, D] | None, mask bool[S, D]); mirrors
        Query.execute on every slot at once."""
        raise NotImplementedError

    def sm(self, env, meta):
        """Query.score_or_mask (filter-as-boost semantics)."""
        s, m = self.ex(env, meta)
        if s is None:
            s = m.to(torch.float32) * self.boost
        return s, m


def _doc_range(env, nd: int, D: int):
    n = env[nd][0]
    return torch.arange(D, device=n.device)[None, :] < n[:, None]


class EMatchAll(Emit):
    def __init__(self, boost: float, nd: int, D: int):
        self.boost = boost
        self.nd = nd
        self.D = D

    def ex(self, env, meta):
        mask = _doc_range(env, self.nd, self.D)
        return mask.to(torch.float32) * self.boost, mask


class ENone(Emit):
    def __init__(self, nd: int, D: int):
        self.nd = nd
        self.D = D

    def ex(self, env, meta):
        return None, torch.zeros_like(_doc_range(env, self.nd, self.D))


class ETermGroup(Emit):
    """mode 'scores': BM25 scores, mask = scores > 0 (all-positive weights).
    mode 'count_ge': conjunction — distinct matched terms >= n.
    mode 'mask': presence only (terms filter, keyword range)."""

    def __init__(self, prim: int, post: int, mode: str, n: int, boost: float,
                 D: int):
        self.prim = prim
        self.post = post
        self.mode = mode
        self.n = n
        self.boost = boost
        self.D = D

    def ex(self, env, meta):
        doc_ids, tfnorm = env[self.post]
        starts, lens, ws = env[self.prim]
        (sizes,) = meta[self.prim]
        base = _slot_base(doc_ids)
        if self.mode != "scores":
            counts = S.match_count_runs(doc_ids, starts, lens, sizes,
                                        D=self.D, base=base)
        if self.mode == "mask":
            return None, counts > 0
        scores = S.bm25_score_runs(doc_ids, tfnorm, starts, lens, ws, sizes,
                                   D=self.D, base=base)
        if self.mode == "count_ge":
            return scores, counts >= self.n
        return scores, scores > 0


def _slot_base(doc_ids):
    """i64[S]: where slot s's postings start in the flat [S, NNZ] stack
    (row s of a round's chunk tables reads slot s)."""
    S_, nnz = doc_ids.shape
    return torch.arange(0, S_ * nnz, nnz, dtype=torch.int64,
                        device=doc_ids.device)


def gather_rows(blocks, qrows, D: int):
    """f32[S, R, D]: each slot's query rows gathered out of its own block
    (pads clamp to row 0 and carry weight 0, as ``_rows`` does); zeros
    for a slot without a block."""
    S_, R = qrows.shape
    idx = torch.clamp(qrows, min=0).to(torch.int64)
    if S_ == 1 and blocks[0] is not None:
        return blocks[0].index_select(0, idx[0]).unsqueeze(0)
    out = torch.zeros(S_, R, D, dtype=torch.float32, device=qrows.device)
    for s, blk in enumerate(blocks):
        if blk is None:
            continue
        if blk.shape[1] == D:
            torch.index_select(blk, 0, idx[s], out=out[s])
        else:
            out[s, :, : blk.shape[1]] = blk.index_select(0, idx[s])
    return out


class ETermGroupHybrid(Emit):
    """ETermGroup over the dense-impact path: a gather of each slot's
    query rows plus the scatter tail (the host loop's
    ``bm25_score_hybrid_gather`` and friends, slot by slot in one
    sequence). Same three modes as ETermGroup."""

    def __init__(self, prim: int, post: int, mode: str, n: int, boost: float,
                 D: int):
        self.prim = prim
        self.post = post
        self.mode = mode
        self.n = n
        self.boost = boost
        self.D = D

    def ex(self, env, meta):
        doc_ids, tfnorm = env[self.post]
        blocks, qrows, qrw, starts, lens, ws = env[self.prim]
        (sizes, R) = meta[self.prim]
        base = _slot_base(doc_ids)
        # the first R rows hold every slot's real rows; the rest are pads,
        # whose weight-0 terms leave the sum as it is
        qrows, qrw = qrows[:, :R], qrw[:, :R]
        rows = gather_rows(blocks, qrows, self.D)
        if self.mode != "scores":
            present = (rows != 0) & (qrows >= 0)[:, :, None]
        if self.mode == "mask":
            return None, present.any(1) | (S.match_count_runs(
                doc_ids, starts, lens, sizes, D=self.D, base=base) > 0)
        # the dense rows summed in row order, then the tail, as
        # bm25_score_hybrid_gather does
        dense = torch.zeros(rows.shape[0], self.D, dtype=torch.float32,
                            device=rows.device)
        for w, x in zip(qrw.t().unsqueeze(2).unbind(0), rows.unbind(1)):
            dense = dense + w * x
        scores = dense + S.bm25_score_runs(doc_ids, tfnorm, starts, lens,
                                           ws, sizes, D=self.D, base=base)
        if self.mode == "scores":
            return scores, scores > 0
        counts = present.sum(1, dtype=torch.int32) + S.match_count_runs(
            doc_ids, starts, lens, sizes, D=self.D, base=base)
        return scores, counts >= self.n


class ERange(Emit):
    def __init__(self, prim: int, ilo: bool, ihi: bool):
        self.prim = prim
        self.ilo = ilo
        self.ihi = ihi

    def ex(self, env, meta):
        (form,) = meta[self.prim]
        if form == "pair":
            hi_col, lo_col, exists, b = env[self.prim]
            return None, S.range_mask_i64pair(
                hi_col, lo_col, exists, b[:, 0:1], b[:, 1:2], b[:, 2:3],
                b[:, 3:4], self.ilo, self.ihi)
        values, exists, b = env[self.prim]
        lo, hi = b[:, 0:1], b[:, 1:2]
        ge = values >= lo if self.ilo else values > lo
        le = values <= hi if self.ihi else values < hi
        return None, ge & le & exists


class EMaskData(Emit):
    """A mask handed over as data (exists)."""

    def __init__(self, prim: int):
        self.prim = prim

    def ex(self, env, meta):
        return None, env[self.prim][0]


class EIds(Emit):
    """The ids mask, set from the positions table."""

    def __init__(self, prim: int, nd: int, D: int):
        self.prim = prim
        self.nd = nd
        self.D = D

    def ex(self, env, meta):
        mask = torch.zeros_like(_doc_range(env, self.nd, self.D))
        mask.view(-1)[env[self.prim][0].to(torch.int64)] = True
        return None, mask


class EOr(Emit):
    """OR of child masks (numeric terms query)."""

    def __init__(self, children: List[Emit], nd: int, D: int):
        self.children = children
        self.nd = nd
        self.D = D

    def ex(self, env, meta):
        mask = torch.zeros_like(_doc_range(env, self.nd, self.D))
        for c in self.children:
            mask = mask | c.ex(env, meta)[1]
        return None, mask


class EConstScore(Emit):
    def __init__(self, child: Emit, boost: float):
        self.child = child
        self.boost = boost

    def ex(self, env, meta):
        _, mask = self.child.ex(env, meta)
        return mask.to(torch.float32) * self.boost, mask


class EBool(Emit):
    def __init__(self, must, should, must_not, filter_, need: int,
                 boost: float, nd: int, D: int):
        self.must = must
        self.should = should
        self.must_not = must_not
        self.filter = filter_
        self.need = need
        self.boost = boost
        self.nd = nd
        self.D = D

    def ex(self, env, meta):
        mask = _doc_range(env, self.nd, self.D)
        if not (self.must or self.should or self.filter or self.must_not):
            return None, torch.zeros_like(mask)
        scores = torch.zeros(mask.shape, dtype=torch.float32,
                             device=mask.device)
        for c in self.must:
            s, m = c.sm(env, meta)
            scores = scores + s
            mask = mask & m
        for c in self.filter:
            mask = mask & c.ex(env, meta)[1]
        for c in self.must_not:
            mask = mask & ~c.ex(env, meta)[1]
        if self.should:
            should_count = torch.zeros(mask.shape, dtype=torch.int32,
                                       device=mask.device)
            for c in self.should:
                s, m = c.sm(env, meta)
                scores = scores + torch.where(m, s, torch.zeros_like(s))
                should_count = should_count + m.to(torch.int32)
            if self.need > 0:
                mask = mask & (should_count >= self.need)
        if self.boost != 1.0:
            scores = scores * self.boost
        return scores * mask, mask


class EPhrase(Emit):
    """match_phrase: the positional program on each slot's inputs, then
    the BM25 phrase score over the slot-stacked frequencies, the host
    loop's MatchPhraseQuery math."""

    def __init__(self, prim: int, slop: int, boost: float):
        self.prim = prim
        self.slop = slop
        self.boost = boost

    def ex(self, env, meta):
        slots, stats, lengths = env[self.prim]
        freq = torch.zeros(lengths.shape, dtype=torch.float32,
                           device=lengths.device)
        for s, slot in enumerate(slots):
            if slot is None or slot[0] is None:
                continue
            kernels.record("phrase_program")
            freq[s, : slot[1]] = phrase_freq_program(
                *slot[0], slop=self.slop, D=slot[1])
        scores = phrase_score(freq, lengths, stats[:, 0:1],
                              stats[:, 1:2]) * self.boost
        return scores, freq > 0


class EDisMax(Emit):
    def __init__(self, children: List[Emit], tie: float, boost: float):
        self.children = children
        self.tie = tie
        self.boost = boost

    def ex(self, env, meta):
        return Q.dis_max_scores([c.sm(env, meta) for c in self.children],
                                self.tie, self.boost)


class EBoosting(Emit):
    def __init__(self, positive: Emit, negative: Emit, neg_boost: float,
                 boost: float):
        self.positive = positive
        self.negative = negative
        self.neg_boost = neg_boost
        self.boost = boost

    def ex(self, env, meta):
        s, mask = self.positive.sm(env, meta)
        return Q.boosting_scores(s, mask, self.negative.ex(env, meta)[1],
                                 self.neg_boost, self.boost)


class EKnn(Emit):
    """knn-as-query, brute force: kernel B2 per slot over that segment's
    own slab at k = num_candidates in f32, then one scatter-max of every
    slot's valid (score, id) pairs into the (scores, mask) contract, as
    ``KnnQuery._select`` does. Invalid (-inf) pairs go to a dump slot
    past the last row instead of to their (meaningless) ids."""

    def __init__(self, prim: int, filt: Optional[Emit], live: int, kc: int,
                 metric: str, boost: float, D: int):
        self.prim = prim
        self.filter = filt
        self.live = live
        self.kc = kc
        self.metric = metric
        self.boost = boost
        self.D = D

    def ex(self, env, meta):
        slabs, q = env[self.prim]
        live = env[self.live][0]
        fm = self.filter.ex(env, meta)[1] if self.filter is not None \
            else None
        Sn, D = live.shape
        flat, vals = [], []
        for s, slab in enumerate(slabs):
            if slab is None:
                continue
            vecs, exists = slab
            Ds = vecs.shape[0]
            lv = exists & live[s, :Ds]
            if fm is not None:
                lv = lv & fm[s, :Ds]
            # the host loop's B2 entry point, KnnQuery._select's
            v, i = Q.knn_topk(q.unsqueeze(0), vecs, lv, k=min(self.kc, Ds),
                              metric=self.metric, precise=True)
            v, i = v[0], i[0]
            ok = v > NEG_INF
            flat.append(torch.where(ok, i.to(torch.int64) + s * D, Sn * D))
            vals.append(torch.where(ok, v * self.boost, 0.0))
        scores = torch.zeros(Sn * D + 1, dtype=torch.float32,
                             device=live.device)
        hit = torch.zeros(Sn * D + 1, dtype=torch.bool, device=live.device)
        if flat:
            kernels.record("knn_fused_topk")
            idx = torch.cat(flat) if len(flat) > 1 else flat[0]
            scores.scatter_reduce_(0, idx, torch.cat(vals) if len(vals) > 1
                                   else vals[0], reduce="amax")
            hit.index_fill_(0, idx, True)
        return scores[: Sn * D].view(Sn, D), hit[: Sn * D].view(Sn, D)


# ---------------------------------------------------------------------------
# compiler
# ---------------------------------------------------------------------------

class CompiledMeshQuery:
    """Result of ``MeshQueryCompiler.compile``: emit tree + data prims,
    one per request and round. ``fused`` is the index of the term-group
    prim when the request is a pure disjunctive term group on dense rows
    (the host loop's ``_fused_eligible_terms`` shape) and nothing reads
    the mask, else None. ``agg_prims`` lists (agg name, AggTermsPrim
    index) of the keyword terms aggs the round counts; ``want_mask``
    asks the round for its [S, D] match mask (host-side collectors);
    ``sort`` lists (sort prim index, descending, missing first) of a
    field-sorted request's keys, in order."""

    def __init__(self, root: Emit, prims: List[DataPrim], live: int, D: int,
                 fused: Optional[int] = None,
                 agg_prims: Optional[List[Tuple[str, int]]] = None,
                 want_mask: bool = False,
                 sort: Optional[List[Tuple[int, bool, bool]]] = None):
        self.root = root
        self.prims = prims
        self.live = live
        self.D = D
        self.fused = fused
        self.agg_prims = agg_prims or []
        self.want_mask = want_mask
        self.sort = sort or []


class MeshQueryCompiler:
    def __init__(self, mappings, analysis, D: int = 0,
                 has_dense: Optional[Callable[[str], bool]] = None):
        self.mappings = mappings
        self.analysis = analysis
        self.D = D
        # has_dense(field): True when a segment of the round has a dense
        # impact block for the field; term groups then take the hybrid
        # form (the host loop's ctx.hybrid_slices dispatch)
        self.has_dense = has_dense or (lambda field: False)
        # a segment-free context: analysis and mappings only
        self._qctx = SegmentContext(None, mappings, analysis)
        self.prims: List[DataPrim] = []
        self._postings: Dict[str, int] = {}

    def _add(self, prim: DataPrim) -> int:
        self.prims.append(prim)
        return len(self.prims) - 1

    def _postings_for(self, field: str) -> int:
        if field not in self._postings:
            self._postings[field] = self._add(PostingsPrim(field))
        return self._postings[field]

    def compile(self, query, agg_specs: Optional[list] = None,
                want_mask: bool = False,
                sort_spec: Optional[list] = None) -> CompiledMeshQuery:
        self._live = self._add(LivePrim())
        self._nd = self._add(NumDocsPrim())
        root = self._c(query)
        agg_prims = [(name, self._add(AggTermsPrim(field)))
                     for name, field in (agg_specs or [])]
        sort = [self._sort_key(s) for s in (sort_spec or [])]
        # the host loop's _fused_eligible_terms shape: a match (operator
        # or, no minimum_should_match) or a term on a text field with a
        # positive boost, a scores-mode hybrid root (a fuzzy query or a
        # one-term phrase scores in f32 there, so it does here)
        fused = root.prim if isinstance(root, ETermGroupHybrid) \
            and root.mode == "scores" \
            and isinstance(query, (Q.MatchQuery, Q.TermQuery)) \
            and not agg_prims and not want_mask and not sort else None
        return CompiledMeshQuery(root, self.prims, self._live, self.D, fused,
                                 agg_prims, want_mask, sort)

    def _sort_key(self, s: dict) -> Tuple[int, bool, bool]:
        """A sort key's prim, or MeshCompileError: ``_score`` as any key
        (a sorted round carries no scores), ``_geo_distance``, and a
        field the mapping gives no numeric (ip included) or keyword doc
        values (the reference declines an ip primary too)."""
        field = s["field"]
        if field in ("_score", "_geo_distance"):
            raise MeshCompileError(f"{field} sort key")
        fm = self.mappings.get(field)
        column = fm is not None and (fm.is_numeric or fm.type == "ip")
        if not (column or fm is not None and fm.is_keyword):
            raise MeshCompileError(f"unsortable sort field [{field}]")
        desc = s["order"] == "desc"
        prim = (SortColPrim if column else SortOrdPrim)(field, desc)
        return (self._add(prim), desc,
                str(s.get("missing", "_last")) == "_first")

    # -- tree walk (mirrors search/queries.py execute semantics) -------------

    def _c(self, q) -> Emit:
        D = self.D
        if q is None or isinstance(q, Q.MatchAllQuery):
            return EMatchAll(getattr(q, "boost", 1.0), self._nd, D)
        if isinstance(q, Q.MatchNoneQuery):
            return ENone(self._nd, D)
        if isinstance(q, Q.TermQuery):
            fm = self.mappings.get(q.field)
            if fm is not None and fm.is_numeric:
                return self._range(Q.RangeQuery(q.field, gte=q.value,
                                                lte=q.value, boost=q.boost))
            return self._tgroup_scores(
                q.field, q.boost, lambda ctx, q=q: [q._term_str(ctx)])
        if isinstance(q, Q.TermsQuery):
            fm = self.mappings.get(q.field)
            if fm is not None and fm.is_numeric:
                node = EOr([self._range(Q.RangeQuery(q.field, gte=v, lte=v))
                            for v in q.values], self._nd, D)
                node.boost = q.boost
                return node
            terms = list(dict.fromkeys(str(v) for v in q.values))
            return self._tgroup_mask(q.field, q.boost, lambda ctx: terms)
        if isinstance(q, Q.MatchQuery):
            if q.fuzziness is not None:
                # per-term expansion groups: the host loop, as in the
                # reference's mesh
                raise MeshCompileError("fuzzy match")
            return self._match(q)
        if isinstance(q, Q.MatchPhraseQuery):
            return self._phrase(q)
        if isinstance(q, (Q.PrefixQuery, Q.WildcardQuery, Q.RegexpQuery)):
            def expand(ctx, q=q):
                inv = ctx.inv(q.field)
                return [] if inv is None else q.expand(inv)

            return self._tgroup_mask(q.field, q.boost, expand)
        if isinstance(q, Q.FuzzyQuery):
            return self._tgroup_scores(
                q.field, q.boost, lambda ctx, q=q: Q.fuzzy_terms(
                    ctx.inv(q.field), str(q.value), q.fuzziness,
                    q.max_expansions))
        if isinstance(q, Q.DisMaxQuery):
            if not q.queries:
                return ENone(self._nd, D)
            return EDisMax([self._c(c) for c in q.queries], q.tie_breaker,
                           q.boost)
        if isinstance(q, Q.BoostingQuery):
            return EBoosting(self._c(q.positive), self._c(q.negative),
                             q.negative_boost, q.boost)
        if isinstance(q, Q.RangeQuery):
            return self._range(q)
        if isinstance(q, Q.ExistsQuery):
            node = EMaskData(self._add(ExistsPrim(q.field)))
            node.boost = q.boost
            return node
        if isinstance(q, Q.IdsQuery):
            node = EIds(self._add(IdsPrim(q.values)), self._nd, D)
            node.boost = q.boost
            return node
        if isinstance(q, Q.BoolQuery):
            default_msm = 0 if (q.must or q.filter) else 1
            need = ((Q._min_should_match(q.msm, len(q.should))
                     if q.msm is not None else default_msm)
                    if q.should else 0)
            return EBool([self._c(c) for c in q.must],
                         [self._c(c) for c in q.should],
                         [self._c(c) for c in q.must_not],
                         [self._c(c) for c in q.filter], need, q.boost,
                         self._nd, D)
        if isinstance(q, Q.ConstantScoreQuery):
            return EConstScore(self._c(q.inner), q.boost)
        if isinstance(q, Q.KnnQuery):
            return self._knn(q)
        from elasticsearch_tpu_torch.search.hybrid import HybridQuery

        if isinstance(q, HybridQuery):
            # two engines, a fusion and a re-rank, orchestrated per
            # searcher: the intended route, not a capability gap
            raise MeshCompileError("hybrid runs its own engines",
                                   by_design=True)
        raise MeshCompileError(f"unsupported query type {type(q).__name__}")

    def _phrase(self, q) -> Emit:
        fm = self.mappings.get(q.field)
        if fm is None or not fm.is_text:
            raise MeshCompileError("match_phrase on a non-text field")
        an = self._qctx.search_analyzer(q.field)
        toks = an.analyze(str(q.text)) if an else [(str(q.text), 0)]
        if not toks:
            return ENone(self._nd, self.D)
        if len(toks) == 1:
            t0 = toks[0][0]
            return self._tgroup_scores(q.field, q.boost, lambda ctx: [t0])
        return EPhrase(self._add(PhrasePrim(q.field, list(toks))),
                       int(q.slop), q.boost)

    def _knn(self, q) -> Emit:
        fm = self.mappings.get(q.field)
        if q._use_ann(self._qctx):
            # the IVF probe (and PQ coarse-to-fine) is a host-orchestrated
            # pipeline by design
            raise MeshCompileError("knn via IVF", by_design=True)
        if q.maxsim:
            # B2 per token + a scatter-max merge, routed by design
            raise MeshCompileError("knn multi-vector MaxSim", by_design=True)
        dims = getattr(fm, "dims", None) if fm is not None else None
        if fm is None or not dims:
            return ENone(self._nd, self.D)  # unmapped vector field
        if q.tokens.shape[1] != int(dims):
            raise QueryParsingException(
                f"knn query vector has {q.tokens.shape[1]} dims but field "
                f"[{q.field}] is mapped with {dims}")
        filt = self._c(q.filter) if q.filter is not None else None
        prim = self._add(VecsPrim(q.field, q.tokens[0]))
        kc = int(min(max(q.num_candidates, q.k), self.D))
        return EKnn(prim, filt, self._live, kc, fm.similarity or "cosine",
                    q.boost, self.D)

    def _tgroup_prim(self, field: str, terms_fn) -> Tuple[int, int, type]:
        """The term-group prim for a field: the dense-impact form when a
        segment of the round carries a dense block, else the scatter
        form."""
        hybrid = bool(self.has_dense(field))
        prim = (HybridTGroupPrim if hybrid else TGroupPrim)(field, terms_fn)
        post = self._postings_for(field)
        return (self._add(prim), post,
                ETermGroupHybrid if hybrid else ETermGroup)

    def _tgroup_scores(self, field: str, boost: float, terms_of) -> Emit:
        """Scoring term group (mask = scores > 0): weights idf * boost,
        duplicate terms summed (``_dedupe_terms``)."""
        if boost <= 0:
            # the host loop switches to an explicit term mask there
            raise MeshCompileError("non-positive boost on scoring term group")

        def terms_fn(ctx):
            terms = terms_of(ctx)
            if not terms:
                return [], []
            return Q._dedupe_terms(terms, boost, lambda t: ctx.idf(field, t))

        idx, post, cls = self._tgroup_prim(field, terms_fn)
        return cls(idx, post, "scores", 0, boost, self.D)

    def _tgroup_mask(self, field: str, boost: float, expand_fn) -> Emit:
        def terms_fn(ctx):
            terms = list(dict.fromkeys(expand_fn(ctx)))
            return terms, [1.0] * len(terms)

        idx, post, cls = self._tgroup_prim(field, terms_fn)
        return cls(idx, post, "mask", 0, boost, self.D)

    def _match(self, q) -> Emit:
        if q.boost <= 0:
            raise MeshCompileError("non-positive boost on match query")
        field, boost = q.field, q.boost

        def terms_fn(ctx):
            return Q._dedupe_terms(q._analyze(ctx), boost,
                                   lambda t: ctx.idf(field, t))

        idx, post, cls = self._tgroup_prim(field, terms_fn)
        if q.operator != "and" and q.msm is None:
            return cls(idx, post, "scores", 0, boost, self.D)
        # the analyzer output is query-side, the same on every shard, so
        # the and/msm thresholds are static
        n_terms = len(set(q._analyze(self._qctx)))
        need = max(n_terms, 1) if q.operator == "and" \
            else max(Q._min_should_match(q.msm, n_terms), 1)
        return cls(idx, post, "count_ge", need, boost, self.D)

    def _range(self, q) -> Emit:
        fm = self.mappings.get(q.field)
        if fm is not None and (fm.is_text or fm.is_keyword):
            # keyword range: per-shard sorted-term-dict expansion
            def expand(ctx, q=q):
                inv = ctx.inv(q.field)
                if inv is None:
                    return []
                lo, ilo, hi, ihi = q._bounds(ctx)
                terms = sorted(inv.terms)
                i0 = bisect_left(terms, str(lo)) if lo is not None else 0
                if lo is not None and not ilo and i0 < len(terms) \
                        and terms[i0] == str(lo):
                    i0 += 1
                i1 = bisect_left(terms, str(hi)) if hi is not None \
                    else len(terms)
                if hi is not None and ihi and i1 < len(terms) \
                        and terms[i1] == str(hi):
                    i1 += 1
                return terms[i0:i1]

            return self._tgroup_mask(q.field, q.boost, expand)
        if fm is None:
            raise MeshCompileError(f"range on unmapped field [{q.field}]")
        # numeric/date: the bounds are query-side constants
        lo, ilo, hi, ihi = q._bounds(self._qctx)
        use_int = ((lo is None or _as_exact_int(lo) is not None)
                   and (hi is None or _as_exact_int(hi) is not None))
        node = ERange(self._add(RangePrim(q.field, lo, hi, use_int)),
                      ilo if lo is not None else True,
                      ihi if hi is not None else True)
        node.boost = q.boost
        return node
