"""Kernel B2 of the PyTorch port (fused kNN scores + top-k) against the
JAX package's Pallas kernel in interpret mode and a numpy oracle.

On the CPU the port's wrapper runs its plain twin; the CUDA kernel itself
is held against the same twin on the card by ``chip_smoke.py``.

Bars. Against ``knn_topk_pallas(interpret=True)`` on the same inputs:
scores at rtol 1e-5 (both round the same operands and sum exact or f32
products, in different orders), ids equal wherever the score is more
than that away from its neighbours. Against the exact f64 oracle: the
reference test's own bar, rtol/atol 5e-3 and recall@k >= 0.95
(tests/unit/test_pallas_kernels.py::test_pallas_knn_matches_oracle).
"""
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops.pallas_kernels import knn_topk_pallas
from elasticsearch_tpu_torch.ops import knn_topk as b2
from elasticsearch_tpu_torch.ops.knn import knn_scores, knn_topk

METRICS = ("cosine", "dot_product", "l2_norm")


def _inputs(seed, Q, D, dims, live=0.9):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Q, dims)).astype(np.float32)
    v = rng.normal(size=(D, dims)).astype(np.float32)
    mask = rng.random(D) < live
    return q, v, mask


def _port(q, v, mask, k, metric, precise):
    vals, ids = knn_topk(torch.from_numpy(q), torch.from_numpy(v),
                         torch.from_numpy(mask), k=k, metric=metric,
                         precise=precise)
    return vals.numpy(), ids.numpy()


def _pallas(q, v, mask, k, metric, precise, tile=2048):
    import jax.numpy as jnp

    vals, ids = knn_topk_pallas(jnp.asarray(q), jnp.asarray(v),
                                jnp.asarray(mask), k=k, metric=metric,
                                tile=tile, interpret=True, precise=precise)
    return np.asarray(vals), np.asarray(ids)


def _assert_same_ranking(v, i, rv, ri, rtol):
    """(v, i) [Q, k] against a reference (rv, ri) [Q, k+1]: values at
    rtol, ids equal outside groups of values within rtol."""
    k = v.shape[1]
    np.testing.assert_allclose(v, rv[:, :k], rtol=rtol, atol=0)
    for q in range(v.shape[0]):
        row = rv[q]
        for j in range(k):
            near = lambda a, b: abs(a - b) <= rtol * abs(b)  # noqa: E731
            tied = (j > 0 and near(row[j - 1], row[j])) or (
                j + 1 < row.shape[0] and near(row[j], row[j + 1]))
            if not tied:
                assert i[q, j] == ri[q, j], (q, j)


def _exact_topk(q, v, mask, k, metric):
    q, v = q.astype(np.float64), v.astype(np.float64)
    if metric == "cosine":
        qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        vn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        s = (1 + qn @ vn.T) / 2
    elif metric == "dot_product":
        s = (1 + q @ v.T) / 2
    else:
        s = 1.0 / (1.0 + ((q[:, None, :] - v[None, :, :]) ** 2).sum(-1))
    s = np.where(mask[None, :], s, -np.inf)
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


@pytest.mark.parametrize("D", [4096, 8192])
@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_matches_pallas_interpret(metric, precise, D):
    q, v, mask = _inputs(3, 4, D, 64)
    k = 10
    rv, ri = _pallas(q, v, mask, k + 1, metric, precise)
    pv, pi = _port(q, v, mask, k, metric, precise)
    _assert_same_ranking(pv, pi, rv, ri, rtol=1e-5)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_holds_the_reference_bar(metric, precise):
    q, v, mask = _inputs(3, 4, 8192, 64)
    k = 10
    pv, pi = _port(q, v, mask, k, metric, precise)
    ev, ei = _exact_topk(q, v, mask, k, metric)
    np.testing.assert_allclose(pv, ev, rtol=5e-3, atol=5e-3)
    recall = np.mean([len(set(pi[r]) & set(ei[r])) / k for r in range(4)])
    assert recall >= 0.95
    assert not np.isin(pi, np.nonzero(~mask)[0]).any()
    assert (np.diff(pv, axis=1) <= 0).all()
    if precise:  # f32 throughout: within a few ulps of f64
        np.testing.assert_allclose(pv, ev, rtol=1e-5)


def _quantized(seed, Q, D, dims):
    """Half-integer vectors: every product and sum is exact in f32, so
    every implementation computes the same values and ties are many."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-2, 3, size=(Q, dims)).astype(np.float32) / 2
    v = rng.integers(-2, 3, size=(D, dims)).astype(np.float32) / 2
    mask = rng.random(D) < 0.8
    return q, v, mask


def test_tie_rule_matches_pallas_exactly():
    """Tie-heavy rows: the port and the Pallas kernel (whose extract-max
    takes the first maximum, previous best first) return the same ids
    in the same order, lower doc id first among equal scores."""
    q, v, mask = _quantized(11, 3, 4096, 8)
    pv, pi = _port(q, v, mask, 40, "dot_product", True)
    rv, ri = _pallas(q, v, mask, 40, "dot_product", True)
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(pi, ri)
    ties = np.sum(pv[:, 1:] == pv[:, :-1])
    assert ties > 30  # the case really is tie-heavy
    for r in range(pv.shape[0]):
        for j in range(1, pv.shape[1]):
            if pv[r, j] == pv[r, j - 1]:
                assert pi[r, j] > pi[r, j - 1]


def test_k_larger_than_a_tile():
    """k = 2500 > the 2048-doc tile (and the kernel's 2048-doc chunk):
    exact values, so the order must be the oracle's exactly."""
    q, v, mask = _quantized(12, 2, 4096, 8)
    k = 2500
    pv, pi = _port(q, v, mask, k, "dot_product", True)
    s = np.where(mask[None, :], (1 + q.astype(np.float64) @ v.T.astype(
        np.float64)) / 2, -np.inf)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(pi, order)
    np.testing.assert_array_equal(pv, np.take_along_axis(s, order, axis=1))


def test_fewer_live_docs_than_k_leave_neg_inf_slots():
    q, v, _ = _inputs(5, 2, 4096, 16)
    mask = np.zeros(4096, bool)
    live = np.array([7, 300, 1999, 2048, 4095])
    mask[live] = True
    pv, pi = _port(q, v, mask, 10, "cosine", True)
    assert np.isfinite(pv[:, :5]).all() and np.isneginf(pv[:, 5:]).all()
    for r in range(2):
        assert set(pi[r, :5]) == set(live)
    ev, ei = _exact_topk(q, v, mask, 5, "cosine")
    np.testing.assert_array_equal(pi[:, :5], ei)


@pytest.mark.parametrize("Q", [1, 3])
def test_unpadded_query_counts(Q):
    """Q = 1 (a REST knn query) and Q = 3 run as they are, no padding to
    the TPU's sublane multiple; the rows match the Pallas kernel's."""
    q, v, mask = _inputs(7, Q, 4096, 128)
    pv, pi = _port(q, v, mask, 5, "cosine", False)
    assert pv.shape == (Q, 5) and pi.shape == (Q, 5)
    assert pi.dtype == np.int32
    rv, ri = _pallas(q, v, mask, 6, "cosine", False)
    _assert_same_ranking(pv, pi, rv, ri, rtol=1e-5)


def test_kernel_arithmetic_on_one_row():
    """The twin's arithmetic, spelled out in numpy for one doc: per-row
    normalisation, bf16 rounding, f32 sums in increasing dims."""
    def bf16(x):
        u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.astype(np.uint32).view(np.float32)

    q, v, mask = _inputs(9, 1, 64, 32, live=1.0)
    qh, _ = b2.prepare_queries(torch.from_numpy(q), "cosine", False)
    row = v[17]
    v2 = np.float32(0)
    for x in row:
        v2 = np.float32(v2 + np.float32(x * x))
    den = np.maximum(np.sqrt(v2), np.float32(1e-12))
    xb = bf16((row / den).astype(np.float32))
    s = np.float32(0)
    for a, b in zip(qh.numpy()[0], xb):
        s = np.float32(s + np.float32(a * b))
    want = np.float32(np.float32(1 + s) * np.float32(0.5))
    got = b2.knn_scores_plain(qh, torch.zeros(1), torch.from_numpy(v),
                              "cosine", False)[0, 17].item()
    assert got == want


def test_knn_scores_matches_reference():
    import jax.numpy as jnp

    from elasticsearch_tpu.ops.knn import knn_scores as ref_scores

    q, v, _ = _inputs(4, 3, 300, 24)
    for metric in METRICS:
        want = np.asarray(ref_scores(jnp.asarray(q), jnp.asarray(v),
                                     metric=metric, use_bf16=False))
        got = knn_scores(torch.from_numpy(q), torch.from_numpy(v),
                         metric=metric).numpy()
        # f32 sums in another order; (1 + dot) / 2 cancels near dot = -1,
        # so the bar is absolute there (dot magnitudes reach ~10)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_wrapper_rejects_bad_arguments():
    q, v, mask = (torch.from_numpy(a) for a in _inputs(1, 1, 64, 8))
    with pytest.raises(ValueError, match="k must be"):
        knn_topk(q, v, mask, k=0)
    with pytest.raises(ValueError, match="k must be"):
        knn_topk(q, v, mask, k=65)
    with pytest.raises(ValueError, match="unknown knn metric"):
        knn_topk(q, v, mask, k=3, metric="hamming")
    with pytest.raises(ValueError, match="shape mismatch"):
        knn_topk(q[:, :4], v, mask, k=3)


@pytest.mark.parametrize("queries", [1, 8])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dims", [1, 3, 37, 100, 128, 252, 256, 1024, 4096,
                                  20_000, 40_000])
def test_stage_plan(dims, aligned, queries):
    """The kernel's ring: whole-stage tensor copies only for rows of a
    multiple of 4 floats on an aligned slab that fit a copy's box once
    padded; strides of an odd count of 16-byte pieces (or floats), so a
    warp's reads of 32 rows miss no bank; rows per stage dividing the
    256 scorers, as many as four stages allow; 2-16 slots inside the
    ring (the smaller one-query ring leaves room for two blocks per SM);
    no staging only where two stages of one row do not fit."""
    ring = b2.RING_BYTES if queries >= 8 else b2.RING_BYTES_ONE
    mode, rows, slots, stride = b2.stage_plan(dims, aligned, queries)
    if mode == b2.DIRECT:
        assert 8 * (dims + 1) > ring
        return
    assert dims <= stride < dims + 8
    if aligned and dims % 4 == 0 and dims <= 252:
        assert mode == b2.TENSOR
        assert stride % 4 == 0 and (stride // 4) % 2 == 1
        assert stride <= b2.MAX_BOX
    else:
        assert mode == b2.ASYNC4 and stride % 2 == 1
    assert 256 % rows == 0 and 1 <= rows <= b2.MAX_ROWS
    assert 2 <= slots <= b2.MAX_SLOTS
    assert slots * rows * stride * 4 <= ring
    if rows < b2.MAX_ROWS:
        assert 4 * 2 * rows * stride * 4 > ring
    if dims == 128 and aligned:  # the slice's shape
        assert (mode, rows, slots, stride) == (
            (b2.TENSOR, 64, 4, 132) if queries >= 8 else (b2.TENSOR, 32, 5, 132))
    # the block's shared memory: keys, running lists, counters, eight
    # queries' scores and the ring
    best = (8 if queries >= 8 else 1) * 128 * 8
    scores = 65_536 if queries >= 8 else 0
    smem = 16_384 + best + 512 + scores + slots * rows * stride * 4
    assert smem <= 232_448 and (queries >= 8 or 2 * (smem + 1024) <= 233_472)


def _ring_completes(rows, slots, warp_wide, items=16):
    """A model of one block of the kernel's ring (csrc/knn_topk.cu),
    over two chunks (16 items per scorer): group g (rows threads) scores
    stages j * groups + g in increasing j, each once the copy warp (which
    fills stages in order, a slot once its previous stage is scored) has
    filled it and the slot's previous stage is scored; a stage counts as
    scored once its group has left the warp sync that follows. With
    ``warp_wide`` that sync waits for every lane of the warp (at any
    stage), else for the group's own lanes. True when every stage gets
    scored, False on a deadlock."""
    groups = 256 // rows
    mates = max(1, 32 // rows)  # groups sharing a warp
    nxt = [0] * groups          # next item of each group
    in_sync = [False] * groups  # scored its stage, not yet out of the sync
    scored = set()
    filled = -1
    total = items * groups

    def ready(n):
        return n < 0 or n in scored

    progress = True
    while progress:
        progress = False
        while filled + 1 < total and ready(filled + 1 - slots):
            filled += 1
            progress = True
        for g in range(groups):
            n = nxt[g] * groups + g
            if nxt[g] < items and not in_sync[g] and n <= filled \
                    and ready(n - slots):
                in_sync[g] = True
                progress = True
        for w in range(0, groups, mates):
            warp = range(w, w + mates)
            leave = [g for g in warp if in_sync[g]]
            if warp_wide and len(leave) < mates:
                continue
            for g in leave:
                scored.add(nxt[g] * groups + g)
                nxt[g] += 1
                in_sync[g] = False
                progress = True
    return len(scored) == total


@pytest.mark.parametrize("queries", [1, 8])
@pytest.mark.parametrize("dims", [37, 128, 768, 1024, 1536, 2048, 3072, 4096])
def test_ring_groups_progress(dims, queries):
    """Every ring the stage plan makes scores all its stages when a group
    syncs only its own lanes, rings of fewer than 32 rows included (where
    groups share a warp and wait on each other's stages)."""
    mode, rows, slots, _ = b2.stage_plan(dims, True, queries)
    assert mode != b2.DIRECT
    assert _ring_completes(rows, slots, warp_wide=False)


def test_ring_warp_wide_sync_deadlocks():
    """Why the kernel's sync names the group's lanes: with a warp-wide
    sync, a 768-dim ring for one query (4 rows, 7 slots) deadlocks, as
    group 7 waits on group 0's stage while group 0 waits in the sync for
    group 7's lanes; wide enough rings do not."""
    assert b2.stage_plan(768, True, 1)[1:3] == (4, 7)
    assert not _ring_completes(4, 7, warp_wide=True)
    assert _ring_completes(32, 5, warp_wide=True)
    assert _ring_completes(64, 4, warp_wide=True)


# -- the mesh's vector-round stages: exact_rescore_topk and
# merge_candidate_topk against the reference's functions on seeded
# inputs, with ties and -inf padding. Bar: the same ids in the same
# order, scores at rtol 1e-5 (f32 sums in other orders) for the re-rank;
# the merge reorders the given values only, so it is exact.

def _ref_knn():
    from elasticsearch_tpu.ops import knn as ref_knn

    return ref_knn


@pytest.mark.parametrize("metric", METRICS)
def test_exact_rescore_topk_matches_reference(metric):
    from elasticsearch_tpu_torch.ops.knn import exact_rescore_topk

    rng = np.random.default_rng(31)
    Q, D, dims, k = 3, 300, 16, 24
    q = rng.normal(size=(Q, dims)).astype(np.float32)
    v = rng.normal(size=(D, dims)).astype(np.float32)
    v[7] = v[5]  # a duplicate row: tied candidates keep position order
    idx = np.stack([rng.permutation(D)[:k] for _ in range(Q)]).astype(
        np.int32)
    idx[:, :2] = [5, 7]
    vals = rng.random((Q, k)).astype(np.float32)
    vals[:, -5:] = -np.inf  # padding: stays -inf, sorts last
    idx[0, -1] = D - 1
    got_v, got_i = exact_rescore_topk(
        torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(vals),
        torch.from_numpy(idx), metric=metric)
    ref_v, ref_i = _ref_knn().exact_rescore_topk(q, v, vals, idx,
                                                 metric=metric)
    ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    np.testing.assert_allclose(got_v.numpy(), ref_v, rtol=1e-5, atol=0)
    assert np.isneginf(got_v.numpy()[:, -5:]).all()


@pytest.mark.parametrize("k", [1, 8, 30])
def test_merge_candidate_topk_matches_reference(k):
    from elasticsearch_tpu_torch.ops.knn import merge_candidate_topk

    rng = np.random.default_rng(41 + k)
    Q, N = 4, 48
    ids = rng.integers(0, 20, size=(Q, N)).astype(np.int32)  # repeats
    vals = np.round(rng.random((Q, N)), 1).astype(np.float32)  # ties
    vals[:, ::7] = -np.inf  # invalid slots, some sharing valid ids
    vals[3] = -np.inf  # a row with no valid candidate
    got = merge_candidate_topk(torch.from_numpy(vals), torch.from_numpy(ids),
                               k=k)
    ref = _ref_knn().merge_candidate_topk(vals, ids, k=k)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="exceeds"):
        merge_candidate_topk(torch.from_numpy(vals), torch.from_numpy(ids),
                             k=N + 1)


@pytest.mark.parametrize("limit", ["rows", "scratch"])
def test_batches_past_one_launch_run_in_slices(monkeypatch, limit):
    """More query rows than one launch takes (the grid's 65,535 rows, or
    the scratch budget for the key lists) run as several launches whose
    rows stack: the same bits as one call over all rows."""
    from elasticsearch_tpu_torch.utils import shapes

    q, v, mask = (torch.from_numpy(a) for a in _inputs(11, 13, 4096, 32))
    whole = b2.knn_topk(q, v, mask, k=20, precise=True)
    if limit == "rows":
        monkeypatch.setattr(shapes, "MAX_QUERY_ROWS", 5)
        want = [(0, 5), (5, 10), (10, 13)]
    else:  # two chunks of 2048 docs, 20 keys, two buffers: 640 B a row
        monkeypatch.setattr(shapes, "TOPK_SCRATCH_BYTES", 4 * 640 + 639)
        want = [(0, 4), (4, 8), (8, 12), (12, 13)]
    assert shapes.query_slices(13, 4096, 20) == want
    got = b2.knn_topk(q, v, mask, k=20, precise=True)
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
