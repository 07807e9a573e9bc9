"""Positional programs: phrase and span frequency vectors on tensors.

Port of elasticsearch_tpu/ops/positional.py (Lucene's ExactPhraseScorer
and SloppyPhraseScorer semantics, as MatchQueryBuilder type=phrase and
SpanNearQueryBuilder use them). The execution model is the reference's:

* the positional CSR (``positions`` aligned with the postings order,
  ``pos_offsets`` per posting) lives on the card with its doc-per-position
  expansion ``doc_per_pos``, placed once per field (``positional_device``);
* the first query term's positional entries are the anchors, sliced
  straight out of those arrays;
* for every other term j each anchor looks for the position it needs
  (anchor position + delta_j for a phrase) inside the term's entry for
  the anchor's doc, and a phrase matches where every term has it (slop
  0) or where the greedy nearest window fits the slop (weight
  1/(1 + matchLength), the reference's documented deviation from
  Lucene's search over alternative windows);
* the per-anchor weights roll up into a frequency per doc, which
  ``phrase_score`` turns into BM25 over the phrase pseudo-term.

What differs on the card is the search. The reference runs two
per-element binary searches of fixed step counts (the doc in the term's
postings run, then the position inside the entry's bounds). Here a term's
positional entries are one contiguous slice of the CSR, sorted by (doc,
position), so each of them becomes one packed int64 key ``doc << 32 |
position`` (``term_keys``), and one ``torch.searchsorted`` over the
query's keys ``[M, L]`` answers every anchor of every term at once: the
found key holds both the doc test and the position. The ordered span
chain, where each term starts after the previous match, searches one
term at a time.

The frequency rollup never adds floats with atomics, whose order would
make sloppy frequencies vary from run to run: ``_freq_segmented`` sorts
the anchors by doc (stable) and sums each doc's run of weights as int64
fixed point (2^-40 steps), so the sums are exact integers in any order;
whole-number frequencies (exact phrase, span_not) come out exact.

The reference's ``scatter_free`` switch is a TPU workaround and is not
ported; ``anchor_valid`` stays for padded anchor sets (None: all valid).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: key of a padded slot of ``term_keys``: above every real key
KEY_PAD = torch.iinfo(torch.int64).max
#: weight scale of the fixed-point rollup
_FIX = float(1 << 40)


def _pack(doc, pos):
    """int64 key ``doc << 32 | pos`` (pos may be negative or past 2^31:
    the key stays between doc's neighbours' keys, so it finds nothing of
    theirs)."""
    return doc.to(torch.int64) * (1 << 32) + pos.to(torch.int64)


def _doc_of(key):
    return torch.div(key, 1 << 32, rounding_mode="floor")


def _pos_of(key):
    return key - _doc_of(key) * (1 << 32)


def _lower_bound(keys, query):
    """Index of the first key >= ``query`` in each sorted row of ``keys``
    ([M, L] with query [M, A], or [L] with query [A]): the reference's
    bounded per-element binary search, as one batched search over packed
    (doc, position) keys, whose doc half plays the per-entry bounds."""
    return torch.searchsorted(keys, query)


def term_keys(positions, doc_per_pos, spans: Sequence[Tuple[int, int]]):
    """int64 [M, L]: row j holds the packed (doc, position) keys of the
    positional slice ``spans[j] = (lo, hi)`` of the CSR (one term's
    entries, sorted), padded with ``KEY_PAD``; L is the longest slice."""
    L = max([hi - lo for lo, hi in spans] + [1])
    if len(spans) == 1 and spans[0][1] - spans[0][0] == L:
        lo, hi = spans[0]
        return _pack(doc_per_pos[lo:hi], positions[lo:hi]).unsqueeze(0)
    keys = torch.full((len(spans), L), KEY_PAD, dtype=torch.int64,
                      device=positions.device)
    for j, (lo, hi) in enumerate(spans):
        if hi > lo:
            keys[j, : hi - lo] = _pack(doc_per_pos[lo:hi], positions[lo:hi])
    return keys


def _freq_segmented(anchor_doc, match, w, *, D: int):
    """f32[D]: per doc, the sum of the matched anchors' weights. A stable
    sort by doc, then each doc's run summed from an int64 prefix sum of
    the weights in 2^-40 fixed point (exact, so deterministic on the card
    in any order), read at the run bounds."""
    dkey = torch.where(match, anchor_doc.to(torch.int64), D)
    ds, order = torch.sort(dkey, stable=True)
    fixed = torch.round(torch.where(match, w.to(torch.float64), 0.0)
                        * _FIX).to(torch.int64)[order]
    csum = torch.cat([fixed.new_zeros(1), torch.cumsum(fixed, 0)])
    bounds = torch.searchsorted(
        ds, torch.arange(D + 1, dtype=torch.int64, device=ds.device))
    return ((csum[bounds[1:]] - csum[bounds[:-1]]).to(torch.float64)
            / _FIX).to(torch.float32)


def _nearest(keys, doc, target):
    """Per anchor and term, the term's position nearest ``target`` inside
    the anchor's doc (the lower bound or the one before it; a tie takes
    the lower bound), and whether the doc holds the term at all."""
    L = keys.shape[-1]
    q = _pack(doc, target)
    idx = _lower_bound(keys, q)
    k1 = keys.gather(-1, idx.clamp(max=L - 1))
    k0 = keys.gather(-1, (idx - 1).clamp(min=0))
    d64 = doc.to(torch.int64)
    c1_ok = (idx < L) & (_doc_of(k1) == d64)
    c0_ok = (idx >= 1) & (_doc_of(k0) == d64)
    c1, c0 = _pos_of(k1), _pos_of(k0)
    far = 1 << 30
    d1 = torch.where(c1_ok, (c1 - target).abs(), far)
    d0 = torch.where(c0_ok, (c0 - target).abs(), far)
    return torch.where(d0 < d1, c0, c1), c0_ok | c1_ok


def phrase_freq_program(anchor_doc, anchor_pos, anchor_valid, keys, deltas,
                        *, slop: int, D: int, ordered: bool = False,
                        unordered: bool = False):
    """Phrase / ordered-near / unordered-near frequency vector f32[D].

    anchor_doc/pos: [A] the anchor term's positional entries (docs < D;
    padded anchors carry ``anchor_valid`` False, or doc D).
    keys:   int64 [M, L] the other terms' ``term_keys``.
    deltas: [M] each term's expected position offset from the anchor
            (phrase mode; ignored by the near modes).
    ``ordered`` is span_near in order: clause j's first position after
    clause j-1's match, width - (M + 1) within the slop. ``unordered`` is
    span_near out of order over unit-width clauses: each clause's
    position nearest the anchor, the window minus the clause count within
    the slop."""
    apos = anchor_pos.to(torch.int64)
    match = anchor_doc < D
    if anchor_valid is not None:
        match = match & anchor_valid
    M = keys.shape[0]
    if ordered:
        prev = apos
        for j in range(M):
            q = _pack(anchor_doc, prev + 1)
            idx = _lower_bound(keys[j].contiguous(), q)
            k = keys[j].gather(0, idx.clamp(max=keys.shape[1] - 1))
            ok = (idx < keys.shape[1]) & (_doc_of(k) ==
                                          anchor_doc.to(torch.int64))
            match = match & ok
            prev = torch.where(ok, _pos_of(k), prev)
        mlen = (prev - apos + 1) - (M + 1)
        match = match & (mlen <= slop)
        w = 1.0 / (1.0 + mlen.clamp(min=0).to(torch.float32))
        return _freq_segmented(anchor_doc, match, w, D=D)
    d = torch.as_tensor(deltas, dtype=torch.int64,
                        device=apos.device).reshape(M, 1)
    doc = anchor_doc.unsqueeze(0).expand(M, -1)
    if slop == 0 and not unordered:
        target = apos.unsqueeze(0) + d
        q = _pack(doc, target)
        idx = _lower_bound(keys, q)
        hit = keys.gather(1, idx.clamp(max=keys.shape[1] - 1)) == q
        match = match & hit.all(0)
        return _freq_segmented(anchor_doc, match,
                               match.to(torch.float32), D=D)
    if unordered:
        target = apos.unsqueeze(0).expand(M, -1)
        q, found = _nearest(keys, doc, target)
        adj = q
    else:
        target = apos.unsqueeze(0) + d
        q, found = _nearest(keys, doc, target)
        adj = q - d
    lo = torch.minimum(torch.where(found, adj, apos).amin(0), apos)
    hi = torch.maximum(torch.where(found, adj, apos).amax(0), apos)
    mlen = hi - lo
    if unordered:
        mlen = mlen - M
    match = match & found.all(0) & (mlen <= slop)
    w = 1.0 / (1.0 + mlen.clamp(min=0).to(torch.float32))
    return _freq_segmented(anchor_doc, match, w, D=D)


def phrase_score(freq, lengths, avg_len, idf_sum, *, k1: float = 1.2,
                 b: float = 0.75):
    """BM25 over the phrase pseudo-term: idf_sum * tfNorm(phraseFreq), in
    f32 and the reference's order of operations. ``avg_len`` and
    ``idf_sum`` are floats or tensors broadcasting against ``freq``."""
    avg = torch.clamp(torch.as_tensor(avg_len, dtype=torch.float32,
                                      device=freq.device), min=1e-9)
    idf = torch.as_tensor(idf_sum, dtype=torch.float32, device=freq.device)
    norm = k1 * ((1.0 - b) + (b * lengths) / avg)
    tfn = freq * (k1 + 1.0) / (freq + norm)
    return torch.where(freq > 0, idf * tfn, 0.0)


def span_not_program(anchor_doc, anchor_pos, anchor_valid, keys, pre: int,
                     post: int, *, D: int):
    """Surviving-include-anchor count f32[D] for span_not: an include span
    at position p survives when no exclude-term position lies inside
    [p - pre, p + post] (SpanNotQuery over unit-width spans); ``keys``
    are the exclude terms' ``term_keys``."""
    apos = anchor_pos.to(torch.int64)
    alive = anchor_doc < D
    if anchor_valid is not None:
        alive = alive & anchor_valid
    M, L = keys.shape
    doc = anchor_doc.unsqueeze(0).expand(M, -1)
    idx = _lower_bound(keys, _pack(doc, apos.unsqueeze(0) - pre))
    k = keys.gather(1, idx.clamp(max=L - 1))
    has = ((idx < L) & (_doc_of(k) == doc.to(torch.int64))
           & (_pos_of(k) <= apos.unsqueeze(0) + post))
    alive = alive & ~has.any(0)
    return _freq_segmented(anchor_doc, alive, alive.to(torch.float32), D=D)


# ---------------------------------------------------------------------------
# host-side prep
# ---------------------------------------------------------------------------

def positional_device(inv):
    """The field's positional CSR on the card, (positions, pos_offsets,
    doc_per_pos) int32, placed once and kept as long as the field: each
    charged to the ``fielddata`` breaker under the reference's labels
    (``TpuSegment.fielddata_bytes`` counts them, so a merge that retires
    the segment and the index's close release them). The host
    ``doc_per_pos`` is kept beside it (``inv._pos_host_dpp``). None
    without positions."""
    cached = inv._pos_dev
    if cached is not None:
        return cached
    if inv.positions is None or inv.pos_offsets is None:
        return None
    with inv._dense_lock:
        if inv._pos_dev is None:
            put = inv.residency.put_array
            counts = np.diff(inv.pos_offsets).astype(np.int64)
            dpp = np.repeat(inv.doc_ids_host[: counts.shape[0]],
                            counts).astype(np.int32)
            pos = put(np.asarray(inv.positions, np.int32), label="positions")
            try:
                offs = put(np.asarray(inv.pos_offsets, np.int32),
                           label="pos_offsets")
                try:
                    dev = put(dpp, label="doc_per_pos")
                except BaseException:
                    inv.residency.release(offs.numel() * 4)
                    raise
            except BaseException:
                inv.residency.release(pos.numel() * 4)
                raise
            inv._pos_host_dpp = dpp
            inv._pos_dev = (pos, offs, dev)
    return inv._pos_dev


def positional_bytes(inv) -> int:
    """Bytes of the field's placed positional CSR (0 before a phrase)."""
    dev = inv._pos_dev
    return 0 if dev is None else sum(int(t.numel()) * 4 for t in dev)


def _entry_span(inv, term) -> Tuple[int, int]:
    """The term's positional slice (lo, hi) in the CSR; (0, 0) absent."""
    s, ln = inv.term_slice(term)
    if ln == 0:
        return 0, 0
    return int(inv.pos_offsets[s]), int(inv.pos_offsets[s + ln])


def build_union_anchor_inputs(inv, anchor_terms, other_terms, D: int):
    """(anchor_doc, anchor_pos, anchor_valid, keys): anchors are the
    union of ``anchor_terms``' positional entries (span trees whose first
    clause is a term disjunction; not doc-sorted, which the rollup's sort
    handles), keys the ``term_keys`` of ``other_terms`` (an absent term's
    row finds nothing). None when positions are missing or no anchor
    term occurs."""
    dev = positional_device(inv)
    if dev is None:
        return None
    positions, _offs, dpp = dev
    spans = [sp for sp in (_entry_span(inv, t) for t in anchor_terms)
             if sp[1] > sp[0]]
    if not spans:
        return None
    adoc = torch.cat([dpp[lo:hi] for lo, hi in spans])
    apos = torch.cat([positions[lo:hi] for lo, hi in spans])
    keys = term_keys(positions, dpp,
                     [_entry_span(inv, t) for t in other_terms] or [(0, 0)])
    return adoc, apos, None, keys


def build_phrase_inputs(inv, terms, D: int):
    """(anchor_doc, anchor_pos, anchor_valid, keys, deltas) for
    ``phrase_freq_program``, or None when a positional prerequisite is
    missing (no positions, a term absent, a one-term phrase). ``terms``
    are (term, position) pairs; the first is the anchor and the deltas
    are the others' offsets from it. The anchors are views of the CSR on
    the card, doc-ascending; nothing is copied to the card."""
    dev = positional_device(inv)
    if dev is None:
        return None
    positions, _offs, dpp = dev
    (t0, d0), rest = terms[0], terms[1:]
    lo, hi = _entry_span(inv, t0)
    if hi == lo or not rest:
        return None
    spans: List[Tuple[int, int]] = []
    for t, _d in rest:
        sp = _entry_span(inv, t)
        if sp[1] == sp[0]:
            return None  # an absent term: the phrase cannot match
        spans.append(sp)
    deltas = np.asarray([d - d0 for _t, d in rest], np.int64)
    return (dpp[lo:hi], positions[lo:hi], None,
            term_keys(positions, dpp, spans), deltas)


def phrase_freq(inv, terms, D: int, slop: int) -> Optional[torch.Tensor]:
    """f32[D] phrase frequencies of ``terms`` on the field, or None when
    the phrase cannot match (``build_phrase_inputs``)."""
    inputs = build_phrase_inputs(inv, terms, D)
    if inputs is None:
        return None
    return phrase_freq_program(*inputs, slop=int(slop), D=D)
