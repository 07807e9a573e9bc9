"""The vector modules of the PyTorch port against the JAX package:
packed bit-vectors, kernel B3's plain twin (PQ table-sum), the ADC lookup
table, the PQ layout rules, the port's own IVF/PQ builds (recall floors,
determinism) and the IVF candidate pipeline on state carried across from
the reference through ``index/convert.py``.

On the CPU the B3 wrapper runs its plain twin; ``chip_smoke.py`` holds
the CUDA kernel against the same twin on the card.
"""
import numpy as np
import pytest
import torch

from elasticsearch_tpu import resources as ref_resources
from elasticsearch_tpu.ops import bitvec as ref_bitvec
from elasticsearch_tpu.ops import pq as ref_pq
from elasticsearch_tpu.ops.ivf import build_ivf as ref_build_ivf
from elasticsearch_tpu.ops.ivf import \
    ivf_candidate_scores as ref_candidate_scores
from elasticsearch_tpu.ops.pallas_kernels import adc_scores_pallas
from elasticsearch_tpu.resources.breakers import \
    CircuitBreakerService as RefBreakers
from elasticsearch_tpu.resources.residency import ResidencyRegistry
from elasticsearch_tpu_torch.index.convert import segment_from_arrays
from elasticsearch_tpu_torch.ops import bitvec
from elasticsearch_tpu_torch.ops.adc import adc_scores
from elasticsearch_tpu_torch.ops.ivf import build_ivf, ivf_candidate_scores
from elasticsearch_tpu_torch.ops.pq import (adc_lut, adc_sum, build_pq,
                                            place_pq, pq_codebook_size,
                                            pq_layout)
from elasticsearch_tpu_torch.resources.residency import Residency

from _torch_parity import clustered

CPU = Residency(torch.device("cpu"))


def _iso(mp):
    """Isolated breakers and residency for the reference's placements."""
    svc = RefBreakers(capacity=1 << 30)
    mp.setattr(ref_resources, "BREAKERS", svc)
    mp.setattr(ref_resources, "RESIDENCY", ResidencyRegistry(svc))


def _slab(n, dims, n_clusters, seed):
    x = clustered(n, dims, n_clusters, seed=seed)
    D = 1 << int(np.ceil(np.log2(n)))
    vecs = np.zeros((D, dims), np.float32)
    vecs[:n] = x
    exists = np.zeros(D, bool)
    exists[:n] = True
    return x, vecs, exists, D


# -- packed bit-vectors ------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
def test_bitvec_round_trips_match_reference(density):
    import jax.numpy as jnp

    rng = np.random.default_rng(int(density * 100))
    mask = rng.random(4096) < density
    mask[[31, 63, 4095]] = density > 0  # top bits: the sign of an i32 word
    words = bitvec.pack_mask(torch.from_numpy(mask))
    ref_words = np.asarray(ref_bitvec.pack_mask(jnp.asarray(mask)))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), ref_words)
    # every doc's bit reads back (the round trip)
    np.testing.assert_array_equal(
        bitvec.test_bits(words, torch.arange(4096)).numpy(), mask)
    ids = rng.integers(0, 4096, 500).astype(np.int32)
    np.testing.assert_array_equal(
        bitvec.test_bits(words, torch.from_numpy(ids)).numpy(),
        np.asarray(ref_bitvec.test_bits(jnp.asarray(ref_words),
                                        jnp.asarray(ids))))
    assert bitvec.popcount(words) == int(ref_bitvec.popcount(
        jnp.asarray(ref_words))) == int(mask.sum())


# -- kernel B3 (ADC table-sum) -----------------------------------------------

@pytest.mark.parametrize("W,M,K", [(2048, 8, 16), (2048, 32, 256),
                                   (6144, 16, 64)])
def test_adc_plain_matches_pallas_bit_for_bit(W, M, K):
    import jax.numpy as jnp

    rng = np.random.default_rng(W + M + K)
    codes = rng.integers(0, K, size=(W, M)).astype(np.uint8)
    lut = rng.standard_normal((M, K)).astype(np.float32)
    got = adc_scores(torch.from_numpy(codes), torch.from_numpy(lut)).numpy()
    want = np.asarray(adc_scores_pallas(jnp.asarray(codes.astype(np.int32)),
                                        jnp.asarray(lut), tile=2048,
                                        interpret=True))
    np.testing.assert_array_equal(got, want)
    # the XLA form sums in its own order: within 1e-6 of the scale of the
    # terms (sum of |lut[m, c]|), which is what reordering an f32 sum
    # moves; the sum itself may cancel towards 0
    xla = np.asarray(ref_pq.adc_sum(jnp, jnp.asarray(codes),
                                    jnp.asarray(lut)))
    scale = np.abs(lut[np.arange(M)[None, :], codes]).sum(1)
    assert np.all(np.abs(got - xla) <= 1e-6 * scale)
    port_xla = adc_sum(torch.from_numpy(codes), torch.from_numpy(lut)).numpy()
    assert np.all(np.abs(port_xla - xla) <= 1e-6 * scale)


def test_adc_wrapper_takes_any_shape_and_rejects_bad_ones():
    codes = torch.zeros(3, 5, dtype=torch.uint8)
    lut = torch.arange(5 * 7, dtype=torch.float32).reshape(5, 7)
    assert adc_scores(codes, lut).tolist() == [float(sum(range(0, 35, 7)))] * 3
    with pytest.raises(ValueError, match="shape mismatch"):
        adc_scores(codes, lut[:4])
    with pytest.raises(ValueError, match="K <= 256"):
        adc_scores(codes, torch.zeros(5, 257))


@pytest.mark.parametrize("metric", ["cosine", "dot_product", "l2_norm"])
def test_adc_lut_matches_reference(metric):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    books = rng.standard_normal((8, 32, 4)).astype(np.float32)
    q = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(ref_pq.adc_lut(jnp, jnp.asarray(q), jnp.asarray(books),
                                     metric))
    got = adc_lut(torch.from_numpy(q), torch.from_numpy(books), metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_pq_layout_and_codebook_size_match_reference():
    for dims in list(range(1, 200)) + [256, 384, 768, 1024, 1536]:
        assert pq_layout(dims) == ref_pq.pq_layout(dims), dims
    for n in (0, 1, 7, 8, 100, 200, 1000, 2047, 2048, 10 ** 6):
        assert pq_codebook_size(n) == ref_pq.pq_codebook_size(n), n


# -- the port's own builds -----------------------------------------------------

def _recall(x, search, trials=20, seed=2):
    n, dims = x.shape
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    rng = np.random.default_rng(seed)
    hits = 0
    for _ in range(trials):
        q = x[rng.integers(n)] + 0.1 * rng.standard_normal(dims).astype(
            np.float32)
        qn = q / max(np.linalg.norm(q), 1e-12)
        exact = np.argsort(-(xn @ qn), kind="stable")[:10]
        s, m = search(q)
        s = s.numpy().copy()
        s[~m.numpy()] = -np.inf
        approx = np.argsort(-s, kind="stable")[:10]
        hits += len(set(exact.tolist()) & set(approx.tolist()))
    return hits / (10 * trials)


def test_port_ivf_build_holds_reference_recall_floor():
    """tests/unit/test_ivf.py::test_ivf_recall_vs_exact's slab and bar,
    built by the port's own k-means."""
    x, vecs, exists, D = _slab(20_000, 32, 64, seed=1)
    idx = build_ivf(torch.from_numpy(vecs), torch.from_numpy(exists), D)
    tv = torch.from_numpy(vecs)
    recall = _recall(x, lambda q: ivf_candidate_scores(
        idx, tv, q, 2000, "cosine", D))
    assert recall >= 0.95, recall
    assert idx.nprobe_for(2000) * idx.Lmax < 20_000


def test_port_pq_build_holds_reference_recall_floor():
    """tests/unit/test_pq.py::test_pq_coarse_fine_recall_vs_exact's slab
    and bar: ADC coarse rank (B3's twin) + exact fine re-rank."""
    x, vecs, exists, D = _slab(8000, 32, 256, seed=1)
    tv, te = torch.from_numpy(vecs), torch.from_numpy(exists)
    ivf = build_ivf(tv, te, D)
    pq = place_pq(build_pq(tv, te, "cosine"), CPU, label="t")
    assert pq is not None and (pq.M, pq.K, pq.dsub) == (8, 256, 4)
    recall = _recall(x, lambda q: ivf_candidate_scores(
        ivf, tv, q, 2000, "cosine", D, pq=pq, fine_k=128))
    assert recall >= 0.95, recall


def test_builds_are_deterministic():
    _x, vecs, exists, D = _slab(3000, 16, 24, seed=5)
    tv, te = torch.from_numpy(vecs), torch.from_numpy(exists)
    a, b = build_ivf(tv, te, D), build_ivf(tv, te, D)
    for name in ("centroids", "lists", "list_lens"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.C, a.Lmax, a.avg_len) == (b.C, b.Lmax, b.avg_len)
    pa, pb = build_pq(tv, te, "l2_norm"), build_pq(tv, te, "l2_norm")
    assert torch.equal(pa.codes, pb.codes)
    assert torch.equal(pa.codebooks, pb.codebooks)
    # every live doc sits in exactly one list, in ascending id order
    lists = a.lists.numpy()
    real = lists[lists < D]
    assert sorted(real.tolist()) == list(range(3000))
    for row, n in zip(lists, a.list_lens.numpy()):
        assert np.all(np.diff(row[:n]) > 0) and np.all(row[n:] == D)


def test_small_slabs_decline():
    """Below 64 live vectors no IVF, below 128 no PQ (the reference's
    floors, where brute force is better)."""
    v = torch.zeros(64, 8)
    assert build_ivf(v[:63], torch.ones(63, dtype=torch.bool), 64) is None
    assert build_pq(v, torch.ones(64, dtype=torch.bool), "cosine") is None


_FUSED = {  # name: (N, W, M, K, live share, filter share or None)
    "pads": (8192, 6144, 32, 256, 0.12, None),
    "filter_10pct": (8192, 6144, 32, 256, 0.12, 0.1),
    "filter_0pct": (8192, 6144, 32, 256, 0.12, 0.0),
    "all_padded": (8192, 2048, 32, 256, 0.0, None),
    "w1": (8192, 1, 32, 256, 1.0, None),
    "m8_k16": (4096, 2048, 8, 16, 0.5, 0.5),
    "m64_k256": (4096, 2048, 64, 256, 0.5, None),
    "m32_k16": (4096, 4096, 32, 16, 0.3, 0.3),
}


@pytest.mark.parametrize("name", sorted(_FUSED))
def test_adc_fused_matches_pallas_bit_for_bit(name):
    """The fused form reads each slot's code row out of the whole table
    and gives pads (ids outside [0, N)) and filtered slots -inf; the
    reference gathers the rows first and runs the Pallas kernel in
    interpret mode on the copy, the mask applied after in numpy."""
    import jax.numpy as jnp

    N, W, M, K, live, filt = _FUSED[name]
    rng = np.random.default_rng(len(name) * 1000 + W)
    codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
    lut = rng.standard_normal((M, K)).astype(np.float32)
    cand = np.where(rng.random(W) < live, rng.integers(0, N, W), N)
    cand = cand.astype(np.int32)
    ok = cand < N
    words = None
    if filt is not None:
        fmask = rng.random(N) < filt
        ok &= fmask[np.where(ok, cand, 0)]
        words = bitvec.pack_mask(torch.from_numpy(fmask))
    got = adc_scores(torch.from_numpy(codes), torch.from_numpy(lut),
                     cand=torch.from_numpy(cand), filter_words=words).numpy()
    tile = 2048
    Wp = -(-W // tile) * tile  # the Pallas kernel takes whole tiles
    rows = np.zeros((Wp, M), np.int32)
    rows[:W] = codes[np.where(cand < N, cand, 0)]
    want = np.asarray(adc_scores_pallas(jnp.asarray(rows), jnp.asarray(lut),
                                        tile=tile, interpret=True))[:W]
    want = np.where(ok, want, np.float32(-np.inf))
    assert got.dtype == np.float32 and got.shape == (W,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isneginf(got).sum() == W - ok.sum()


def test_adc_fused_filter_without_candidates_and_negative_ids():
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 16, (256, 8)).astype(np.uint8))
    lut = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    fmask = torch.from_numpy(rng.random(256) < 0.5)
    words = bitvec.pack_mask(fmask)
    full = adc_scores(codes, lut)
    got = adc_scores(codes, lut, filter_words=words)
    assert torch.equal(got, torch.where(fmask, full, -torch.inf))
    cand = torch.tensor([-1, 5, 256, 255, -7, 0], dtype=torch.int32)
    got = adc_scores(codes, lut, cand=cand)
    want = torch.tensor([-np.inf, full[5], -np.inf, full[255], -np.inf,
                         full[0]], dtype=torch.float32)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="filter words"):
        adc_scores(codes, lut, filter_words=words[:4])
    with pytest.raises(ValueError, match="cand"):
        adc_scores(codes, lut, cand=cand[None, :])


# -- the IVF pipeline on carried-across state ------------------------------------

@pytest.fixture(scope="module")
def carried():
    """A reference slab with its built IVF quantizer and PQ tier, and a
    port segment carrying the same state through segment_from_arrays."""
    from _torch_parity import reference_vectors
    from elasticsearch_tpu.index.segment import VectorColumn as RefColumn

    with pytest.MonkeyPatch.context() as mp:
        _iso(mp)
        x, vecs, exists, D = _slab(6000, 32, 128, seed=7)
        rc = RefColumn(name="v", vecs=vecs, exists=exists, dims=32,
                       vecs_host=vecs, exists_host=exists,
                       similarity="cosine")
        rc._ivf = ref_build_ivf(vecs, exists, D)
        rc._pq = ref_pq.place_pq(ref_pq.build_pq(vecs, exists, "cosine"),
                                 label="t")
        seg = segment_from_arrays(
            {"num_docs": D, "max_docs": D,
             "vectors": {"v": reference_vectors(rc)}}, CPU)
        yield x, vecs, D, rc, seg.vectors["v"]


@pytest.mark.parametrize("mode", ["flat", "pq", "pq_filter", "filter_only"])
def test_candidate_scores_match_reference_on_carried_state(carried, mode):
    """Same quantizer, same PQ codes: the port's pipeline admits the same
    candidates as the reference's and scores them at rtol 1e-5. (The
    reference on the CPU ranks coarse scores with adc_sum, which sums in
    another order than B3; this seed has no near-tie at the fine_k cut.)"""
    import jax
    import jax.numpy as jnp

    x, vecs, D, rc, vc = carried
    rng = np.random.default_rng(11)
    filt = rng.random(D) < 0.3
    words_ref = ref_bitvec.pack_mask(jnp.asarray(filt))
    words = bitvec.pack_mask(torch.from_numpy(filt))
    assert vc.get_ivf(D) is not None and vc.get_pq(D) is not None
    dv = jax.device_put(vecs)
    for t in range(6):
        q = x[rng.integers(len(x))] + 0.1 * rng.standard_normal(32).astype(
            np.float32)
        kw, pkw = {}, {}
        if mode in ("pq", "pq_filter"):
            kw.update(pq=rc._pq, fine_k=128)
            pkw.update(pq=vc.get_pq(D), fine_k=128)
        if mode in ("pq_filter", "filter_only"):
            kw["filter_words"] = words_ref
            pkw["filter_words"] = words
        rs, rm = ref_candidate_scores(rc._ivf, dv, q, 1500, "cosine", D, **kw)
        ps, pm = ivf_candidate_scores(vc.get_ivf(D), vc.vecs, q, 1500,
                                      "cosine", D, **pkw)
        rm = np.asarray(rm)
        np.testing.assert_array_equal(pm.numpy(), rm)
        assert rm.sum() > 0
        np.testing.assert_allclose(ps.numpy()[rm], np.asarray(rs)[rm],
                                   rtol=1e-5)
        if mode in ("pq_filter", "filter_only"):
            assert not (pm.numpy() & ~filt).any()


def test_convert_carries_vector_state(carried):
    _x, vecs, D, rc, vc = carried
    np.testing.assert_array_equal(vc.vecs.numpy(), vecs)
    ivf = vc.get_ivf(D)
    np.testing.assert_array_equal(ivf.lists.numpy(), np.asarray(rc._ivf.lists))
    np.testing.assert_array_equal(ivf.centroids.numpy(),
                                  np.asarray(rc._ivf.centroids))
    assert (ivf.C, ivf.Lmax, ivf.sentinel) == (rc._ivf.C, rc._ivf.Lmax, D)
    pq = vc.get_pq(D)
    np.testing.assert_array_equal(pq.codes_dev().numpy(), rc._pq.codes_host)
    assert (pq.M, pq.K, pq.dsub, pq.metric) == (rc._pq.M, rc._pq.K,
                                                rc._pq.dsub, rc._pq.metric)
