"""Scoring primitives of the PyTorch port against the JAX package's jitted
functions on the CPU, on the same postings (carried across by convert):
f32 scores at rtol 1e-5 (scatter sums may run in another order), masks,
counts and top-k ids exact, ties included."""
import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis.registry import AnalysisRegistry as RefAnalysis
from elasticsearch_tpu.index.doc_parser import DocumentParser as RefParser
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.ops import scoring as ref
from elasticsearch_tpu.search.context import SegmentContext as RefContext
from elasticsearch_tpu_torch.index.convert import segment_from_arrays
from elasticsearch_tpu_torch.index.segment import split_i64
from elasticsearch_tpu_torch.ops import scoring as port
from elasticsearch_tpu_torch.resources.residency import Residency

from _torch_parity import MAPPING, corpus, reference_arrays


@pytest.fixture(scope="module")
def segs():
    an, mp = RefAnalysis({}), RefMappings(MAPPING)
    b, p = RefBuilder(mp), RefParser(mp, an)
    for doc_id, src in corpus(700, seed=2):
        b.add(p.parse(doc_id, src))
    rseg = b.freeze()
    for local in (3, 17, 40, 41, 500):
        rseg.delete_local(local)
    pseg = segment_from_arrays(reference_arrays(rseg),
                               Residency(torch.device("cpu")))
    return rseg, pseg, RefContext(rseg, mp, an)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _groups(rseg):
    inv = rseg.inverted["body"]
    by_df = [inv.terms[i] for i in np.argsort(-inv.df, kind="stable")]
    dense, tail = by_df[:3], by_df[-4:]
    return {"tail": tail, "dense": dense, "mixed": dense[:2] + tail[:2],
            "absent": ["zzzz", tail[0]]}


@pytest.mark.parametrize("group", ["tail", "dense", "mixed", "absent"])
def test_scatter_scores_counts_masks(segs, group):
    rseg, pseg, rctx = segs
    terms = _groups(rseg)[group]
    inv = rseg.inverted["body"]
    weights = [inv.idf(t) if t in inv.vocab else 0.0 for t in terms]
    starts, lens, ws, P, _ = rctx.chunked_slices(inv, terms, weights)
    D = rseg.max_docs
    pinv = pseg.inverted["body"]
    want = np.asarray(ref.bm25_score_segment(inv.doc_ids, inv.tfnorm, starts,
                                             lens, ws, P=P, D=D))
    got = port.bm25_score_segment(pinv.doc_ids, pinv.tfnorm, starts, lens,
                                  ws, D=D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(
        port.match_count_segment(pinv.doc_ids, starts, lens, D=D).numpy(),
        np.asarray(ref.match_count_segment(inv.doc_ids, starts, lens, P=P,
                                           D=D)))
    np.testing.assert_array_equal(
        port.term_mask(pinv.doc_ids, starts, lens, D=D).numpy(),
        np.asarray(ref.term_mask(inv.doc_ids, starts, lens, P=P, D=D)))


@pytest.mark.parametrize("group", ["dense", "mixed"])
def test_hybrid_gather_primitives(segs, group):
    rseg, pseg, rctx = segs
    terms = _groups(rseg)[group]
    inv, pinv = rseg.inverted["body"], pseg.inverted["body"]
    weights = [inv.idf(t) for t in terms]
    hyb = rctx.hybrid_slices(inv, terms, weights, need_qw=False)
    assert hyb is not None
    rimp, _, _, starts, lens, ws, P, _, qrows, qrw = hyb
    pimp = pinv.dense_block()[1]
    D = rseg.max_docs
    want = np.asarray(ref.bm25_score_hybrid_gather(
        rimp, qrows, qrw, inv.doc_ids, inv.tfnorm, starts, lens, ws, P=P,
        D=D))
    got = port.bm25_score_hybrid_gather(pimp, qrows, qrw, pinv.doc_ids,
                                        pinv.tfnorm, starts, lens, ws, D=D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(
        port.match_count_hybrid_gather(pimp, qrows, pinv.doc_ids, starts,
                                       lens, D=D).numpy(),
        np.asarray(ref.match_count_hybrid_gather(rimp, qrows, inv.doc_ids,
                                                 starts, lens, P=P, D=D)))
    np.testing.assert_array_equal(
        port.term_mask_hybrid_gather(pimp, qrows, pinv.doc_ids, starts, lens,
                                     D=D).numpy(),
        np.asarray(ref.term_mask_hybrid_gather(rimp, qrows, inv.doc_ids,
                                               starts, lens, P=P, D=D)))
    rsub, rvalid = ref.gather_impact_rows(rimp, qrows)
    psub, pvalid = port.gather_impact_rows(pimp, qrows)
    np.testing.assert_array_equal(psub.numpy(), np.asarray(rsub))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(rvalid))
    assert port.dense_presence_count(psub, pvalid[None, :], pseg.live) == \
        int(ref.dense_presence_count(rsub, rvalid[None, :], rseg.live))


def test_pack_dense_rows():
    row_w = {7: 0.5, 2: 1.25, 30: 3.0}
    for a, b in zip(port.pack_dense_rows(row_w), ref.pack_dense_rows(row_w)):
        np.testing.assert_array_equal(a, b)
    assert port.pack_dense_rows({})[0].shape == (8,)


@pytest.mark.parametrize("lo,hi,ilo,ihi", [
    (10.0, 50.0, True, False), (-np.inf, 20.5, True, True),
    (99.99, np.inf, False, True), (30.0, 30.0, True, True)])
def test_range_mask_f32(segs, lo, hi, ilo, ihi):
    rseg, pseg, _ = segs
    r, p = rseg.numerics["price"], pseg.numerics["price"]
    want = ref.range_mask_f32(r.values, r.exists, np.float32(lo),
                              np.float32(hi), ilo, ihi)
    got = port.range_mask_f32(p.values, p.exists, lo, hi, ilo, ihi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lo,hi,ilo,ihi", [
    (-50_000_150, 200_000_600, True, False), (0, 2**40, False, True),
    (-(2**63), 5_000_015, True, True), (7_000_021, 7_000_021, True, True)])
def test_range_mask_i64pair(segs, lo, hi, ilo, ihi):
    rseg, pseg, _ = segs
    r, p = rseg.numerics["n"], pseg.numerics["n"]
    (lh,), (ll,) = split_i64(np.array([lo]))
    (hh,), (hl,) = split_i64(np.array([hi]))
    want = ref.range_mask_i64pair(r.hi, r.lo, r.exists, lh, ll, hh, hl, ilo,
                                  ihi)
    got = port.range_mask_i64pair(p.hi, p.lo, p.exists, int(lh), int(ll),
                                  int(hh), int(hl), ilo, ihi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port.count_mask(got) == int(ref.count_mask(want))


@pytest.mark.parametrize("k", [1, 10, 300, 1024])
def test_topk_with_mask_tie_order(k):
    rng = np.random.default_rng(k)
    D = 1024
    scores = (rng.integers(0, 6, D) * 0.25).astype(np.float32)  # heavy ties
    mask = rng.random(D) > 0.25
    wv, wi = ref.topk_with_mask(scores, mask, k=k)
    gv, gi = port.topk_with_mask(_t(scores), _t(mask), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
