"""BM25, mask, top-k and aggregation primitives of the slice, on tensors.

Port of the parts of elasticsearch_tpu/ops/scoring.py the single-query
host path and the aggregations call. The reference's forms that exist
only to suit XLA:TPU (the scatter-free ``*_lookup`` tails,
``bm25_hybrid_candidates_topk``, blocked ``exact_topk``, the packed
single-pull result, ``bucket_count``'s sort-and-search branch) are not
ported: on the card a scatter is an ``index_add_``.

Postings scatters: a query term's run is a ``(start, len)`` chunk of the
segment's CSR, and a query is a chunk table (starts, lens, weights over
chunk positions t). ``bm25_score_runs`` and ``match_count_runs`` scatter
the postings of the real runs of G such tables at once (G queries of one
segment, or the S slots of the mesh over slot-stacked postings ``[S,
NNZ]``), one ``index_add_`` per chunk position into a ``[G, D]`` buffer:
a doc occurs at most once in a chunk, so a doc's sum runs in chunk
order, deterministic on the card as on the CPU, and every caller's sums
agree bit for bit. The host's run lengths size each scatter, so nothing
waits on the card. The ``*_segment`` forms are one table (the host loop),
``bm25_score_batch`` many host tables in one copy (batched ``_msearch``),
and ``bm25_hybrid_topk_batch`` adds the f32 product ``qw[Q, F] @
impact`` and takes each query's top k and hit count.

Field sort: every sort key of a segment becomes one or two int64 lanes
in an order-preserving key space (``sort_lanes``), and ``sort_topk``
takes the exact top k of a mask by the lanes' lexicographic order, then
the doc id; ``after_mask`` is ``search_after``'s strict "after" in the
same space (``lane_cursor`` places the cursor).
"""
from __future__ import annotations

import math
from bisect import bisect_left

import numpy as np
import torch

from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

NEG_INF = float("-inf")

DENSE_ROW_PAD = 8  # kernel sublane multiple; pack_dense_rows pads R to it


def _t_major(x):
    """A [G, T] table flattened chunk position major: [t * G + g]."""
    return x.reshape(-1) if x.shape[0] == 1 else x.t().reshape(-1)


def _run_postings(starts, lens, base, sizes):
    """(pair i32[n], pos i64[n]): every posting of the chunk tables
    starts/lens [G, T] (on the card), chunk position major: for each t,
    row g's run of lens[g, t] postings from base[g] + starts[g, t] in the
    flat postings. ``pair`` is t * G + g. ``sizes`` (host, [T]) holds each
    position's posting count, so the host sizes every op and nothing
    waits on the card."""
    n = int(sizes.sum())
    ln = _t_major(lens)
    pair = torch.repeat_interleave(ln, output_size=n)
    off = _t_major(starts) - (torch.cumsum(ln, 0, dtype=torch.int64) - ln)
    if base is not None:
        off = off + base.repeat(lens.shape[1])
    return pair, off[pair] + torch.arange(n, device=lens.device)


def _doc_index(doc_ids, pair, pos, G: int, D: int):
    """Flat [G * D] index of each posting: its row's base plus its doc."""
    docs = doc_ids.reshape(-1)[pos]
    return docs if G == 1 else (pair % G).to(torch.int64) * D + docs


def _scatter_runs(idx, contrib, sizes, G: int, D: int):
    """[G, D] sums of ``contrib`` at flat ``idx`` (g * D + doc), one
    ``index_add_`` per chunk position in increasing t: a doc occurs at
    most once in a chunk, so each add is free of collisions and a doc's
    sum runs in chunk order, deterministic on the card as on the CPU."""
    out = torch.zeros(G * D, dtype=contrib.dtype, device=contrib.device)
    off = 0
    for size in sizes.tolist():
        if size:
            out.index_add_(0, idx[off: off + size],
                           contrib[off: off + size])
        off += size
    return out.view(G, D)


def bm25_score_runs(doc_ids, tfnorm, starts, lens, weights, sizes, *,
                    D: int, base=None):
    """f32[G, D]: for each row g of the chunk tables starts/lens/weights
    [G, T] (on the card), the sum over its chunks of tfnorm * weight at
    each posting (0 for docs it does not match). ``doc_ids``/``tfnorm``
    are one segment's [NNZ], or slot-stacked [S, NNZ] with ``base`` (i64
    [G] on the card) the flat offset of each row's slot; ``sizes`` as in
    ``_run_postings``."""
    G = lens.shape[0]
    if not sizes.any():
        return torch.zeros(G, D, dtype=torch.float32, device=tfnorm.device)
    pair, pos = _run_postings(starts, lens, base, sizes)
    contrib = tfnorm.reshape(-1)[pos] * _t_major(weights)[pair]
    return _scatter_runs(_doc_index(doc_ids, pair, pos, G, D), contrib,
                         sizes, G, D)


def match_count_runs(doc_ids, starts, lens, sizes, *, D: int, base=None):
    """i32[G, D]: how many of row g's chunks hold each doc (a doc occurs
    at most once in a term's run, so a split run still counts it once);
    arguments as ``bm25_score_runs``'s."""
    G = lens.shape[0]
    if not sizes.any():
        return torch.zeros(G, D, dtype=torch.int32, device=doc_ids.device)
    pair, pos = _run_postings(starts, lens, base, sizes)
    ones = torch.ones(pos.shape[0], dtype=torch.int32, device=pos.device)
    return _scatter_runs(_doc_index(doc_ids, pair, pos, G, D), ones, sizes,
                         G, D)


def _upload_tables(doc_ids, starts, lens, weights, slot_of=None):
    """Host chunk tables (numpy [G, T]) on the card in one copy: (starts,
    lens, weights, base or None) and the host's per-position sizes."""
    G, T = np.shape(lens)
    parts = [(starts, np.int32), (lens, np.int32), (weights, np.float32)]
    if slot_of is not None:
        parts.append((slot_of, np.int32))
    words = torch.from_numpy(np.concatenate([
        np.ascontiguousarray(a, dtype=dt).reshape(-1).view(np.int32)
        for a, dt in parts])).to(doc_ids.device)
    n = G * T
    base = None
    if slot_of is not None:
        base = words[3 * n:].to(torch.int64) * doc_ids.shape[-1]
    return (words[:n].view(G, T), words[n: 2 * n].view(G, T),
            words[2 * n: 3 * n].view(torch.float32).view(G, T), base,
            np.asarray(lens, np.int64).sum(0))


def bm25_score_batch(doc_ids, tfnorm, starts, lens, weights, *, D: int,
                     slot_of=None):
    """``bm25_score_runs`` of host chunk tables (numpy [G, T]), with
    ``slot_of`` (numpy [G]) naming each row's slot of slot-stacked
    postings. The tables go to the card in one copy."""
    st, ln, ws, base, sizes = _upload_tables(doc_ids, starts, lens, weights,
                                             slot_of)
    return bm25_score_runs(doc_ids, tfnorm, st, ln, ws, sizes, D=D,
                           base=base)


def bm25_score_segment(doc_ids, tfnorm, starts, lens, weights, *, D: int):
    """f32[D] BM25 scores of one segment's chunk table (numpy [T]): sum
    over chunks of tfnorm * weight at each posting (0 for non-matching
    docs)."""
    return bm25_score_batch(doc_ids, tfnorm, np.asarray(starts)[None],
                            np.asarray(lens)[None],
                            np.asarray(weights)[None], D=D)[0]


def match_count_segment(doc_ids, starts, lens, *, D: int):
    """i32[D] count of matching query terms per doc (a doc occurs at most
    once in a term's run, so split chunks still count it once)."""
    lens = np.asarray(lens)[None]
    st, ln, _ws, _base, sizes = _upload_tables(
        doc_ids, np.asarray(starts)[None], lens, np.zeros(lens.shape))
    return match_count_runs(doc_ids, st, ln, sizes, D=D)[0]


def term_mask(doc_ids, starts, lens, *, D: int):
    """bool[D]: docs containing ANY of the chunks."""
    return match_count_segment(doc_ids, starts, lens, D=D) > 0


def pack_dense_rows(row_w: dict):
    """(qrows i32[R], qrw f32[R]) from {dense_row: weight}: sorted rows,
    -1/0 padding, R = pow2(len) >= DENSE_ROW_PAD (host numpy)."""
    R = pow2_bucket(max(len(row_w), 1), minimum=DENSE_ROW_PAD)
    qrows = np.full(R, -1, np.int32)
    qrw = np.zeros(R, np.float32)
    for i, (row, w) in enumerate(sorted(row_w.items())):
        qrows[i] = row
        qrw[i] = w
    return qrows, qrw


def _rows(dense_impact, qrows):
    idx = torch.clamp(torch.as_tensor(qrows, dtype=torch.int64,
                                      device=dense_impact.device), min=0)
    return dense_impact.index_select(0, idx)


def gather_impact_rows(dense_impact, qrows):
    """(impact[qrows] [R, D], valid f32[R]): padding rows (-1) clamp to
    row 0 and carry validity 0."""
    q = torch.as_tensor(qrows, dtype=torch.int64, device=dense_impact.device)
    return _rows(dense_impact, q), (q >= 0).to(torch.float32)


def bm25_score_hybrid_gather(dense_impact, qrows, qrw, doc_ids, tfnorm,
                             starts, lens, weights, *, D: int):
    """f32[D] hybrid BM25 reading only the query's dense rows: an f32
    sum over the R gathered rows (in row order) plus the CSR tail."""
    rows = _rows(dense_impact, qrows)
    w = torch.as_tensor(qrw, dtype=torch.float32, device=rows.device)
    dense = torch.zeros(D, dtype=torch.float32, device=rows.device)
    for r in range(rows.shape[0]):
        dense = dense + w[r] * rows[r]
    return dense + bm25_score_segment(doc_ids, tfnorm, starts, lens, weights,
                                      D=D)


def _dense_present(dense_impact, qrows):
    q = torch.as_tensor(qrows, dtype=torch.int64, device=dense_impact.device)
    return (_rows(dense_impact, q) != 0) & (q >= 0)[:, None]  # [R, D]


def match_count_hybrid_gather(dense_impact, qrows, doc_ids, starts, lens,
                              *, D: int):
    """i32[D] matched-term counts: gathered dense presence + CSR tail."""
    dcount = _dense_present(dense_impact, qrows).sum(0, dtype=torch.int32)
    return dcount + match_count_segment(doc_ids, starts, lens, D=D)


def term_mask_hybrid_gather(dense_impact, qrows, doc_ids, starts, lens, *,
                            D: int):
    """bool[D] any-term mask: gathered dense presence | CSR tail."""
    return (_dense_present(dense_impact, qrows).any(0)
            | term_mask(doc_ids, starts, lens, D=D))


def dense_presence_count(impact, qind, live) -> int:
    """Exact hit count of a pure-dense term group: docs where ANY row with
    indicator qind[0, r] > 0 has a non-zero impact, ANDed with live."""
    sel = qind[0] > 0
    present = ((impact != 0) & sel[:, None]).any(0) & live
    return int(present.sum())


def f32_matmul_exact(device) -> bool:
    """Whether an f32 ``torch.matmul`` on ``device`` multiplies in f32:
    on the card only while TF32 is off (``torch.backends.cuda.matmul.
    allow_tf32``, which ``torch.set_float32_matmul_precision`` also
    sets). The batched products need f32, the reference's ``HIGHEST``;
    this reads the caller's setting and never changes it."""
    return torch.device(device).type != "cuda" \
        or not torch.backends.cuda.matmul.allow_tf32


def bm25_score_hybrid_batch(dense_impact, qw, doc_ids, tfnorm, starts, lens,
                            weights, *, D: int):
    """f32[Q, D] batched hybrid BM25: the f32 product qw[Q, F] @
    impact[F, D] for the dense rows plus the scatter tail of the [Q, T]
    chunk tables. The caller holds the product to f32
    (``f32_matmul_exact``)."""
    dense = torch.matmul(qw, dense_impact)
    return dense + bm25_score_batch(doc_ids, tfnorm, starts, lens, weights,
                                    D=D)


def topk_stable(scores, k: int):
    """(vals f32[R, k], ids i32[R, k]): each row's top k by (-value,
    index), the first k of a stable descending sort (``torch.topk`` alone
    leaves the order of ties open), as one ``torch.topk`` over unique
    int64 keys: the value's order-preserving bits over the inverted
    index. No row is sorted whole. -0.0 ranks as 0.0."""
    s = scores + 0.0  # -0.0 -> 0.0, as a sort compares them
    b = s.view(torch.int32).to(torch.int64)
    u = b & 0xFFFFFFFF
    u = torch.where(b < 0, 0xFFFFFFFF - u, u | 0x80000000)
    ids = torch.arange(s.shape[-1], dtype=torch.int64, device=s.device)
    key = (u - (1 << 31)) * (1 << 32) + (0xFFFFFFFF - ids)
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(s, -1, idx), idx.to(torch.int32)


def bm25_hybrid_topk_batch(dense_impact, qw, doc_ids, tfnorm, starts, lens,
                           weights, live, *, D: int, k: int):
    """(vals f32[Q, k], ids i32[Q, k], totals i64[Q]): the scores of
    ``bm25_score_hybrid_batch``, matched where > 0 (every weight of a
    disjunctive term group is positive) and live, then each row's top k
    by (-score, doc id), ``topk_with_mask``'s order."""
    scores = bm25_score_hybrid_batch(dense_impact, qw, doc_ids, tfnorm,
                                     starts, lens, weights, D=D)
    m = (scores > 0) & live[None, :]
    vals, idx = topk_stable(torch.where(m, scores, NEG_INF), k)
    return vals, idx, m.sum(1)


def range_mask_f32(values, exists, lo: float, hi: float, include_lo: bool,
                   include_hi: bool):
    """Range filter over an f32 column (lo/hi +-inf when open)."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=values.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=values.device)
    ge = values >= lo_t if include_lo else values > lo_t
    le = values <= hi_t if include_hi else values < hi_t
    return ge & le & exists


def range_mask_i64pair(hi_col, lo_col, exists, lo_hi: int, lo_lo: int,
                       hi_hi: int, hi_lo: int, include_lo: bool,
                       include_hi: bool):
    """Exact 64-bit range over (hi, lo) int32 pair columns."""
    def ge(ah, al, bh, bl):
        return (ah > bh) | ((ah == bh) & (al >= bl))

    def gt(ah, al, bh, bl):
        return (ah > bh) | ((ah == bh) & (al > bl))

    lower = (ge if include_lo else gt)(hi_col, lo_col, lo_hi, lo_lo)
    upper = (ge if include_hi else gt)(hi_hi, hi_lo, hi_col, lo_col)
    return lower & upper & exists


def topk_with_mask(scores, mask, *, k: int):
    """(values f32[k], indices i32[k]) of the top-k masked scores, ordered
    by (-value, index) like ``lax.top_k``; masked-out docs get -inf."""
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    vals, idx = torch.sort(masked, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)


def count_mask(mask) -> int:
    return int(mask.sum())


#: most int64 counters ``bucket_count`` spreads its adds over
_COUNT_SLOTS = 1 << 16


def bucket_count(bucket_ids, mask, *, num_buckets: int):
    """i64[num_buckets]: how many selected entries carry each id, an
    ``index_add_`` of the 0/1 ``mask`` at ``bucket_ids`` (each in
    ``[0, num_buckets)``). Each bucket has ``lanes`` private counters (an
    entry adds to the one its position mod lanes picks) summed at the
    end: a handful of buckets over 2^20 entries (a keyword's few values)
    would otherwise queue every add of the card on a few addresses.
    Integer adds, so the counts are exact in any order."""
    ids = bucket_ids.reshape(-1).to(torch.int64)
    lanes = max(1, min(256, _COUNT_SLOTS // max(num_buckets, 1)))
    if lanes > 1:
        ids = ids * lanes + torch.arange(ids.numel(), device=ids.device) \
            % lanes
    out = torch.zeros(num_buckets * lanes, dtype=torch.int64,
                      device=ids.device)
    out.index_add_(0, ids, mask.reshape(-1).to(torch.int64))
    return out.view(num_buckets, lanes).sum(1)


# ---------------------------------------------------------------------------
# exact field sort
# ---------------------------------------------------------------------------

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1
#: the sentinels of a single-lane key: a missing value sorts first or
#: last, and in the first lane a doc outside the selection after both.
#: A lane holds them only when every present value lies strictly between
#: MISSING_FIRST and MISSING_LAST (``lanes_safe``)
MISSING_FIRST = I64_MIN
MISSING_LAST = I64_MAX - 1
UNMATCHED = I64_MAX


def f64_order_keys(x) -> np.ndarray:
    """i64 keys in the order of the f64 values ``x`` (-0.0 as 0.0): the
    bits, with a negative value's other 63 bits flipped."""
    b = (np.asarray(x, np.float64) + 0.0).view(np.int64)
    return np.where(b < 0, b ^ np.int64(I64_MAX), b)


def f64_order_keys_dev(x):
    """``f64_order_keys`` of an f64 tensor, on its device."""
    b = (x + 0.0).view(torch.int64)
    return torch.where(b < 0, b ^ I64_MAX, b)


def f32_order_keys(x):
    """i64 keys in the order of the f32 tensor ``x`` (-0.0 as 0.0)."""
    b = (x + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def lanes_safe(lo: int, hi: int, desc: bool) -> bool:
    """Whether keys in [lo, hi] stay clear of the sentinels in the order
    ``desc`` asks for (a descending lane holds ~key)."""
    if desc:
        lo, hi = ~hi, ~lo
    return lo > MISSING_FIRST and hi < MISSING_LAST


def sort_lanes(key, exists, desc: bool, missing_first: bool,
               safe: bool) -> list:
    """The i64 lanes of one sort key: ``key`` (ascending key space) where
    ``exists``, ~key for a descending order, and the missing docs first
    or last whatever the order. One lane with sentinels when ``safe``,
    else a rank lane (0 missing first, 1 present, 2 missing last) and
    the value lane."""
    v = torch.bitwise_not(key) if desc else key
    if safe:
        return [torch.where(exists, v, MISSING_FIRST if missing_first
                            else MISSING_LAST)]
    rank = torch.where(exists, 1, 0 if missing_first else 2)
    return [rank.to(torch.int64), torch.where(exists, v, 0)]


def _as_float(c) -> float:
    try:
        return float(c)
    except OverflowError:  # an int past the f64 range
        return math.inf if c > 0 else -math.inf


def value_bounds(c, kind: str, terms=None):
    """(lo, exact, hi) for a search_after value ``c`` in a key space: the
    greatest key at or below c, whether it equals c, and the least key
    at or above it. ``kind``: "int" (the value itself, unbounded),
    "f64"/"f32" (``f*_order_keys``), "rank" (c's place among the sorted
    ``terms``)."""
    if kind == "rank":
        i = bisect_left(terms, c)
        present = i < len(terms) and terms[i] == c
        return (i if present else i - 1), present, i
    if kind == "int":
        if isinstance(c, float) and math.isinf(c):
            far = I64_MAX + 1 if c > 0 else I64_MIN - 1
            return far, False, far
        lo, hi = math.floor(c), math.ceil(c)
        return lo, lo == c, hi
    f = _as_float(c)
    ft = np.float64 if kind == "f64" else np.float32
    with np.errstate(over="ignore"):
        v = ft(f)
    lo = v if float(v) <= c else np.nextafter(v, ft(-np.inf))
    hi = v if float(v) >= c else np.nextafter(v, ft(np.inf))
    if kind == "f64":
        keys = f64_order_keys(np.asarray([lo, hi], np.float64))
    else:
        keys = f32_order_keys(torch.tensor([lo, hi], dtype=torch.float32))
    return int(keys[0]), float(lo) == c, int(keys[1])


def lane_cursor(c, kind: str, desc: bool, missing_first: bool, safe: bool,
                terms=None) -> list:
    """The cursor of one sort key over its ``sort_lanes``: a (position,
    exact) pair a lane, where a doc comes after the cursor on the lane
    when its key is greater than the position and ties with it when
    exact and equal. ``c`` None is a missing cursor value."""
    if c is None:
        if safe:
            return [(MISSING_FIRST if missing_first else MISSING_LAST, True)]
        return [(0 if missing_first else 2, True), (0, True)]
    lo, exact, hi = value_bounds(c, kind, terms)
    p = ~hi if desc else lo
    if safe:
        # no present value reaches a sentinel: a cursor beyond every
        # value sits just inside them, ranking the missing docs right
        if p <= MISSING_FIRST:
            return [(MISSING_FIRST, False)]
        if p >= MISSING_LAST - 1:
            return [(MISSING_LAST - 1, exact and p == MISSING_LAST - 1)]
        return [(p, exact)]
    if p < I64_MIN:
        return [(0, False), (0, False)]
    if p > I64_MAX:
        return [(1, False), (0, False)]
    return [(1, True), (p, exact)]


def after_mask(lanes, cursor):
    """bool: the docs whose lane tuple comes strictly after ``cursor``
    (a (position, exact) pair a lane, ``lane_cursor``'s)."""
    after = torch.zeros(lanes[0].shape, dtype=torch.bool,
                        device=lanes[0].device)
    tie = None
    for lane, (pos, exact) in zip(lanes, cursor):
        gt = lane > pos
        after = after | (gt if tie is None else tie & gt)
        if not exact:
            break
        eq = lane == pos
        tie = eq if tie is None else tie & eq
    return after


def sort_topk(lanes, mask, k: int):
    """i64[..., k]: along the last dim, the docs of ``mask`` in the
    lexicographic order of the i64 ``lanes``, then doc id, the first k
    (then the unmatched docs, when fewer match). Stable sorts from the
    last lane to the first; the first lane moves the unmatched docs past
    every key (``UNMATCHED``)."""
    keys = [torch.where(mask, lanes[0], UNMATCHED)] + list(lanes[1:])
    perm = None
    for lane in reversed(keys):
        x = lane if perm is None else lane.gather(-1, perm)
        p = torch.sort(x, dim=-1, stable=True).indices
        perm = p if perm is None else perm.gather(-1, p)
    return perm[..., :k]
