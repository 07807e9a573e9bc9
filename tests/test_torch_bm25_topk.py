"""Kernel B1 of the PyTorch port (fused dense-impact BM25 top-k) against
the JAX package's Pallas kernel in interpret mode and a numpy oracle.

On the CPU the port's wrapper runs its plain twin; the CUDA kernel itself
is held against the same twin on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops.pallas_kernels import bm25_dense_topk_pallas
from elasticsearch_tpu_torch.ops import bm25_topk
from elasticsearch_tpu_torch.ops.bm25_topk import (bm25_dense_topk,
                                                   bm25_dense_topk_plain)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest, ties to even) and back, in numpy."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _oracle(qw, impact, mask, k):
    """bf16 operands, f32 sum in increasing f, -inf where masked, then
    (-value, doc id) order."""
    qb, ib = _bf16(qw), _bf16(impact)
    s = np.zeros((qw.shape[0], impact.shape[1]), np.float32)
    for f in range(qw.shape[1]):
        s = (s + qb[:, f:f + 1] * ib[f]).astype(np.float32)
    s = np.where(mask[None, :], s, np.float32(-np.inf))
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


def _port(qw, impact, mask, k):
    v, i = bm25_dense_topk(torch.from_numpy(qw), torch.from_numpy(impact),
                           torch.from_numpy(mask), k=k)
    return v.numpy(), i.numpy()


_QUANTS = (0.05, 1.0, 0.5)  # 1.0 -> near-total tie rows


def _tie_case(rng, quant):
    Q, F, D = 16, 16, 4096
    qw = (rng.random((Q, F)) * 2).astype(np.float32)
    impact = rng.random((F, D)).astype(np.float32)
    impact = ((impact / quant).round() * quant).astype(np.float32)
    mask = rng.random(D) > 0.3
    mask[:600] = False
    return qw, impact, mask


@pytest.mark.parametrize("case", range(len(_QUANTS)))
def test_plain_matches_pallas_tie_parity(case):
    """The reference's own tie-heavy cases (quantized impacts, a masked
    prefix), drawn in the reference test's order: ids equal, values at
    rtol 1e-6 against the Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for quant in _QUANTS[:case + 1]:
        qw, impact, mask = _tie_case(rng, quant)
    pv, pi = bm25_dense_topk_pallas(jnp.asarray(qw), jnp.asarray(impact),
                                    jnp.asarray(mask), k=10, tile=512,
                                    q_tile=8, interpret=True)
    tv, ti = _port(qw, impact, mask, 10)
    np.testing.assert_array_equal(ti, np.asarray(pi))
    np.testing.assert_allclose(tv, np.asarray(pv), rtol=1e-6)


@pytest.mark.parametrize("quant", _QUANTS)
def test_plain_matches_lax_top_k_tie_rule(quant):
    """Fresh tie-heavy draws against the rule the Pallas kernel states:
    lax.top_k over the bf16 score row. On the quant=1.0 draw the Pallas
    kernel itself drops a tied lower doc id (a reference fault, listed in
    ROADMAP section C); the port follows the rule."""
    import jax.numpy as jnp
    from jax import lax

    qw, impact, mask = _tie_case(np.random.default_rng(3), quant)
    sc = jnp.dot(jnp.asarray(qw).astype(jnp.bfloat16),
                 jnp.asarray(impact).astype(jnp.bfloat16),
                 preferred_element_type=jnp.float32)
    wv, wi = lax.top_k(jnp.where(jnp.asarray(mask)[None, :], sc, -jnp.inf),
                       10)
    tv, ti = _port(qw, impact, mask, 10)
    np.testing.assert_array_equal(ti, np.asarray(wi))
    np.testing.assert_allclose(tv, np.asarray(wv), rtol=1e-6)


def test_plain_matches_pallas_sparse_impacts():
    """tfnorm-like sparse impacts and idf-like sparse query weights."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    Q, F, D, k = 8, 64, 4096, 10
    impact = ((rng.random((F, D)) < 0.05) * rng.random((F, D)) * 2.5
              ).astype(np.float32)
    qw = np.zeros((Q, F), np.float32)
    for i in range(Q):
        qw[i, rng.choice(F, size=4, replace=False)] = rng.random(4) * 3.0
    mask = rng.random(D) > 0.05
    pv, pi = bm25_dense_topk_pallas(jnp.asarray(qw), jnp.asarray(impact),
                                    jnp.asarray(mask), k=k, tile=1024,
                                    q_tile=8, interpret=True)
    tv, ti = _port(qw, impact, mask, k)
    np.testing.assert_array_equal(ti, np.asarray(pi))
    np.testing.assert_allclose(tv, np.asarray(pv), rtol=1e-6)


@pytest.mark.parametrize("Q,F,D,k", [
    (1, 8, 5000, 10),     # the single-query shape, ragged D
    (1, 8, 4096, 1000),   # k far past the TPU kernel's 64
    (3, 16, 2048, 200),
    (1, 8, 64, 64),       # k == D
])
def test_plain_matches_oracle(Q, F, D, k):
    rng = np.random.default_rng(Q * 7 + F + D + k)
    qw = (rng.random((Q, F)) * 3).astype(np.float32)
    impact = ((rng.random((F, D)) < 0.2) * rng.random((F, D)) * 2.2
              ).astype(np.float32)
    impact = (impact * 8).round().astype(np.float32) / 8  # many exact ties
    mask = rng.random(D) > 0.2
    ev, ei = _oracle(qw, impact, mask, k)
    tv, ti = _port(qw, impact, mask, k)
    assert tv.shape == (Q, k) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ei)
    np.testing.assert_array_equal(tv, ev)


def test_plain_is_stable_on_full_ties():
    """All scores equal: the lowest doc ids win, in order; masked docs
    rank last at -inf, again by doc id."""
    D, k = 300, 12
    qw = np.ones((1, 8), np.float32)
    impact = np.full((8, D), 0.5, np.float32)
    mask = np.ones(D, bool)
    mask[[0, 3, 5]] = False
    v, i = _port(qw, impact, mask, k)
    assert list(i[0]) == [d for d in range(D) if mask[d]][:k]
    assert (v == 4.0).all()
    v, i = _port(qw, impact, np.zeros(D, bool), 4)
    assert list(i[0]) == [0, 1, 2, 3] and np.isneginf(v).all()


def test_wrapper_cpu_takes_plain_without_counting():
    rng = np.random.default_rng(0)
    qw = torch.from_numpy(rng.random((2, 8)).astype(np.float32))
    imp = torch.from_numpy(rng.random((8, 128)).astype(np.float32))
    mask = torch.ones(128, dtype=torch.bool)
    before = bm25_topk.LAUNCHES
    v, i = bm25_dense_topk(qw, imp, mask, k=5)
    pv, pi = bm25_dense_topk_plain(qw, imp, mask, k=5)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert bm25_topk.LAUNCHES == before


@pytest.mark.parametrize("bad", ["shape", "k0", "k_past_d", "mask_len"])
def test_wrapper_rejects_bad_input(bad):
    qw = torch.zeros(1, 8)
    imp = torch.zeros(8, 64)
    mask = torch.ones(64, dtype=torch.bool)
    k = 5
    if bad == "shape":
        imp = torch.zeros(4, 64)
    elif bad == "k0":
        k = 0
    elif bad == "k_past_d":
        k = 65
    else:
        mask = torch.ones(63, dtype=torch.bool)
    with pytest.raises(ValueError):
        bm25_dense_topk(qw, imp, mask, k=k)


# -- the rows form: rows of a whole dense block, pads skipped ----------------

_ROWS_CASES = [  # (R, pads, repeated rows, quantized impacts)
    (1, 0, False, None), (2, 1, False, None), (3, 0, False, None),
    (4, 2, False, None), (8, 3, False, None), (8, 0, True, None),
    (12, 4, True, None), (16, 0, False, None), (16, 5, False, 0.5),
    (5, 2, True, 1.0),
]


def _rows_case(n, R, pads, repeat, quant):
    """A 64-row block, its live mask, rows i32[R] (pads at -1 and outside
    the block, anywhere in the list), and weights qw f32[8, R] whose pad
    columns hold garbage for the port and zeros for the reference."""
    rng = np.random.default_rng(40 + n)
    F, D = 64, 4096
    impact = ((rng.random((F, D)) < 0.3) * rng.random((F, D)) * 2.2
              ).astype(np.float32)
    if quant is not None:
        impact = ((impact / quant).round() * quant).astype(np.float32)
    mask = rng.random(D) > 0.2
    rows = rng.permutation(F)[:R].astype(np.int32)
    if repeat:
        rows[R // 2:] = rows[:R - R // 2]
    pad = rng.permutation(R)[:pads]
    rows[pad] = [(-1, 64, -1, 1000)[i % 4] for i in range(pads)]
    qw = (rng.random((8, R)) * 3).astype(np.float32)
    qw_ref = np.where((rows >= 0) & (rows < F), qw, 0).astype(np.float32)
    return qw, qw_ref, impact, mask, rows


@pytest.mark.parametrize("n", range(len(_ROWS_CASES)))
def test_rows_form_matches_pallas_on_gathered_rows(n):
    """The rows form reads the query's rows out of the whole block and
    skips pads; the reference gathers them first (pads clamp to row 0 at
    weight 0) and runs the Pallas kernel in interpret mode on the copy.
    Same ids in the same order, bit-equal values; where the Pallas
    kernel's own tie fault shows (ROADMAP C), the rule it states
    (lax.top_k over the bf16 score row) decides, at the tie-parity
    test's tolerance."""
    import jax.numpy as jnp
    from jax import lax

    from elasticsearch_tpu.ops.scoring import gather_impact_rows

    qw, qw_ref, impact, mask, rows = _rows_case(n, *_ROWS_CASES[n])
    sub, _valid = gather_impact_rows(jnp.asarray(impact), jnp.asarray(
        np.where(rows < impact.shape[0], rows, -1)))
    pv, pi = bm25_dense_topk_pallas(jnp.asarray(qw_ref), sub,
                                    jnp.asarray(mask), k=10, tile=512,
                                    q_tile=8, interpret=True)
    tv, ti = bm25_dense_topk(torch.from_numpy(qw), torch.from_numpy(impact),
                             torch.from_numpy(mask), k=10,
                             rows=torch.from_numpy(rows))
    tv, ti = tv.numpy(), ti.numpy()
    sc = jnp.dot(jnp.asarray(qw_ref).astype(jnp.bfloat16),
                 sub.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    wv, wi = lax.top_k(jnp.where(jnp.asarray(mask)[None, :], sc, -jnp.inf),
                       10)
    if np.array_equal(np.asarray(pi), np.asarray(wi)):
        np.testing.assert_array_equal(ti, np.asarray(pi))
        np.testing.assert_array_equal(tv.view(np.uint32),
                                      np.asarray(pv).view(np.uint32))
    else:  # the reference's tie fault: the stated rule decides
        np.testing.assert_array_equal(ti, np.asarray(wi))
        np.testing.assert_allclose(tv, np.asarray(wv), rtol=1e-6)


@pytest.mark.parametrize("n", range(len(_ROWS_CASES)))
def test_rows_form_count_matches_reference_presence_count(n):
    """count=True: docs where a valid row's f32 impact is non-zero, live
    ones only; exactly the reference's dense_presence_count over the
    gathered rows."""
    import jax.numpy as jnp

    from elasticsearch_tpu.ops.scoring import (dense_presence_count,
                                               gather_impact_rows)

    qw, _qw_ref, impact, mask, rows = _rows_case(n, *_ROWS_CASES[n])
    sub, valid = gather_impact_rows(jnp.asarray(impact), jnp.asarray(
        np.where(rows < impact.shape[0], rows, -1)))
    want = int(dense_presence_count(sub, valid[None, :], jnp.asarray(mask)))
    v, i, total = bm25_dense_topk(torch.from_numpy(qw),
                                  torch.from_numpy(impact),
                                  torch.from_numpy(mask), k=10,
                                  rows=torch.from_numpy(rows), count=True)
    assert total.dtype == torch.int64 and total.shape == (8,)
    assert total.tolist() == [want] * 8
    pv, pi = bm25_dense_topk(torch.from_numpy(qw), torch.from_numpy(impact),
                             torch.from_numpy(mask), k=10,
                             rows=torch.from_numpy(rows))
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_count_includes_f32_subnormals():
    """An f32 subnormal impact rounds to bf16 zero, so it adds nothing to
    a score, but its doc holds the term and counts as a hit. The
    reference's XLA:CPU compare flushes subnormals to zero and misses
    exactly those docs (ROADMAP C); on normal impacts the two agree."""
    import jax.numpy as jnp

    from elasticsearch_tpu.ops.scoring import (dense_presence_count,
                                               gather_impact_rows)

    F, D = 4, 1024
    impact = np.zeros((F, D), np.float32)
    impact[1, ::7] = np.float32(2.0 ** -140)  # subnormal, bf16 rounds to 0
    impact[2, ::5] = 1.5
    mask = np.ones(D, bool)
    mask[3::10] = False
    rows = np.array([1, -1, 2], np.int32)
    qw = np.ones((1, 3), np.float32)
    v, i, total = bm25_dense_topk(torch.from_numpy(qw),
                                  torch.from_numpy(impact),
                                  torch.from_numpy(mask), k=10,
                                  rows=torch.from_numpy(rows), count=True)
    sub7 = np.zeros(D, bool)
    sub7[::7] = True
    five = np.zeros(D, bool)
    five[::5] = True
    assert int(total[0]) == int(((sub7 | five) & mask).sum())
    sub, valid = gather_impact_rows(jnp.asarray(impact), jnp.asarray(rows))
    ref = int(dense_presence_count(sub, valid[None, :], jnp.asarray(mask)))
    assert ref == int((five & mask).sum())  # XLA:CPU flushes subnormals
    assert int(total[0]) - ref == int((sub7 & ~five & mask).sum())
    # the subnormal rows add nothing to a score: the top docs are row 2's
    assert (v[0] == 1.5).all() and all(d % 5 == 0 for d in i[0].tolist())


def test_packed_result_is_the_parts():
    rng = np.random.default_rng(9)
    qw = torch.from_numpy(rng.random((3, 4)).astype(np.float32))
    imp = torch.from_numpy(((rng.random((16, 300)) < 0.4)
                            * rng.random((16, 300))).astype(np.float32))
    mask = torch.from_numpy(rng.random(300) > 0.1)
    rows = torch.tensor([5, -1, 0, 9], dtype=torch.int32)
    parts = bm25_dense_topk(qw, imp, mask, k=7, rows=rows, count=True)
    buf = bm25_dense_topk(qw, imp, mask, k=7, rows=rows, count=True,
                          packed=True)
    assert buf.dtype == torch.int32 and buf.shape == (3, 16)
    for got in (bm25_topk.unpack_topk(buf, 7),
                bm25_topk.unpack_topk(buf.numpy(), 7)):
        for a, b in zip(got, parts):
            assert np.array_equal(np.asarray(a), b.numpy())
    # without count the total slot is 0
    empty = bm25_dense_topk(qw, imp, mask, k=7, rows=rows, packed=True)
    assert bm25_topk.unpack_topk(empty, 7)[2].tolist() == [0, 0, 0]


def test_rows_form_equals_all_rows_form_on_the_gathered_block():
    """rows=None is the form over all F rows: the rows form over an
    identity row list gives the same bits, and over a row subset the same
    as the all-rows form on a copy of those rows."""
    rng = np.random.default_rng(12)
    imp = torch.from_numpy(((rng.random((10, 700)) < 0.3)
                            * rng.random((10, 700))).astype(np.float32))
    mask = torch.from_numpy(rng.random(700) > 0.2)
    qw = torch.from_numpy(rng.random((2, 10)).astype(np.float32))
    a = bm25_dense_topk(qw, imp, mask, k=20, count=True)
    b = bm25_dense_topk(qw, imp, mask, k=20, count=True,
                        rows=torch.arange(10, dtype=torch.int32))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rows = torch.tensor([7, 2, 2, 9], dtype=torch.int32)
    c = bm25_dense_topk(qw[:, :4].contiguous(), imp, mask, k=20, rows=rows)
    d = bm25_dense_topk(qw[:, :4].contiguous(), imp[rows.long()], mask, k=20)
    assert all(torch.equal(x, y) for x, y in zip(c, d))


@pytest.mark.parametrize("bad", ["rows_len", "rows_dim"])
def test_wrapper_rejects_bad_rows(bad):
    qw = torch.zeros(1, 3)
    imp = torch.zeros(8, 64)
    mask = torch.ones(64, dtype=torch.bool)
    rows = (torch.zeros(4, dtype=torch.int32) if bad == "rows_len"
            else torch.zeros(1, 3, dtype=torch.int32))
    with pytest.raises(ValueError):
        bm25_dense_topk(qw, imp, mask, k=5, rows=rows)


@pytest.mark.parametrize("seed", [0, 1])
def test_all_rows_form_count_matches_reference_batch_count(seed):
    """The batched form of ``_msearch`` tier 1 (rows=None, count=True,
    Q=9): weights built as ``fused_bm25_topk_batch`` builds them (a few
    dense rows a query, each idf * boost > 0, the rest 0). The count is
    the reference's ``dense_presence_count_batch`` over the 1.0
    indicators of those rows; values and ids are the Pallas kernel's in
    interpret mode over the whole block, at rtol 1e-6."""
    import jax.numpy as jnp
    from jax import lax

    from elasticsearch_tpu.ops.scoring import dense_presence_count_batch

    rng = np.random.default_rng(60 + seed)
    Q, F, D = 9, 64, 4096
    impact = ((rng.random((F, D)) < 0.05) * rng.random((F, D)) * 2.2
              ).astype(np.float32)
    mask = rng.random(D) > 0.2
    qw = np.zeros((Q, F), np.float32)
    for q in range(Q):
        rows = rng.permutation(F)[: int(rng.integers(1, 5))]
        qw[q, rows] = rng.random(rows.size) * 3 + 0.1
    qind = (qw > 0).astype(np.float32)
    want = np.asarray(dense_presence_count_batch(
        jnp.asarray(impact), jnp.asarray(qind), jnp.asarray(mask),
        chunk=1024))
    v, i, total = bm25_dense_topk(torch.from_numpy(qw),
                                  torch.from_numpy(impact),
                                  torch.from_numpy(mask), k=10, count=True)
    assert total.dtype == torch.int64 and total.shape == (Q,)
    np.testing.assert_array_equal(total.numpy(), want)
    # Q pads to the kernel's q_tile with zero rows, as its dispatcher
    # (bm25_dense_topk_auto) pads it
    qp = np.concatenate([qw, np.zeros((16 - Q, F), np.float32)])
    pv, pi = bm25_dense_topk_pallas(jnp.asarray(qp), jnp.asarray(impact),
                                    jnp.asarray(mask), k=10, tile=512,
                                    q_tile=8, interpret=True)
    sc = jnp.dot(jnp.asarray(qw).astype(jnp.bfloat16),
                 jnp.asarray(impact).astype(jnp.bfloat16),
                 preferred_element_type=jnp.float32)
    wv, wi = lax.top_k(jnp.where(jnp.asarray(mask)[None, :], sc, -jnp.inf),
                       10)
    for q in range(Q):
        # bf16 impacts tie often; where the Pallas kernel's own tie fault
        # shows (ROADMAP C), the rule it states (lax.top_k over the bf16
        # score row) decides
        ref_v, ref_i = ((pv[q], pi[q]) if np.array_equal(pi[q], wi[q])
                        else (wv[q], wi[q]))
        np.testing.assert_array_equal(i[q].numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(v[q].numpy(), np.asarray(ref_v),
                                   rtol=1e-6)


@pytest.mark.parametrize("form", ["all_rows", "rows"])
def test_batches_past_one_launch_run_in_slices(monkeypatch, form):
    """A batch of more query rows than one launch takes (the grid's
    65,535 rows) runs as several launches whose rows stack: the same
    values, ids, counts and packed buffer as one call."""
    from elasticsearch_tpu_torch.utils import shapes

    rng = np.random.default_rng(70)
    Q, F, D = 11, 16, 2500
    qw = torch.from_numpy((rng.random((Q, F)) * 3).astype(np.float32))
    imp = torch.from_numpy(((rng.random((F, D)) < 0.2)
                            * rng.random((F, D))).astype(np.float32))
    mask = torch.from_numpy(rng.random(D) > 0.1)
    rows = (None if form == "all_rows"
            else torch.tensor([3, -1, 0, 7, 7, 15, 2, 9, 1, 4, 11, 12, 13,
                               5, 6, 8], dtype=torch.int32))
    whole = bm25_dense_topk(qw, imp, mask, k=9, rows=rows, count=True)
    buf = bm25_dense_topk(qw, imp, mask, k=9, rows=rows, count=True,
                          packed=True)
    monkeypatch.setattr(shapes, "MAX_QUERY_ROWS", 4)
    assert len(shapes.query_slices(Q, D, 9)) == 3
    got = bm25_dense_topk(qw, imp, mask, k=9, rows=rows, count=True)
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    assert torch.equal(bm25_dense_topk(qw, imp, mask, k=9, rows=rows,
                                       count=True, packed=True), buf)


# --- the tensor-core pass of the batched form (csrc/bm25_tc.cuh) -----------
# Its tensor-core sums only pick candidates; exact sums decide. On the CPU
# the margin that makes this safe and the selection rule are checked
# against emulations; the kernel itself, and its plan, are held against
# the twin on the card by chip_smoke.py's phase 3.


def _margin_inputs(kind, seed, Q=8, F=256, n=256):
    rng = np.random.default_rng(seed)
    qw = (rng.random((Q, F)) * 3).astype(np.float32)
    if kind == "ties":
        imp = np.round(rng.random((F, n)) * 4).astype(np.float32)
        qw[:] = qw[:, :1]
    elif kind == "mixed":
        mag = np.where(rng.random((F, n)) < 0.5, 2.0 ** 10, 2.0 ** -10)
        imp = (mag * (1 + rng.random((F, n)))).astype(np.float32)
        qw = (2.0 ** (rng.random((Q, F)) * 16 - 8)).astype(np.float32)
    elif kind == "subnormal":
        imp = ((rng.random((F, n)) < 0.3) * rng.random((F, n))).astype(
            np.float32)
        tiny = rng.random((F, n)) < 0.3
        imp[tiny] = (rng.random(int(tiny.sum())) * 2.0 ** -127).astype(
            np.float32)
        qw[:, ::3] = (rng.random((Q, len(range(0, F, 3)))) * 2.0 ** -100
                      ).astype(np.float32)
    elif kind == "subnormal weights":
        # weights below the normal range (bf16 keeps a few bits of them)
        # against impacts near 2^24: a flushed weight loses 2^-102 or so
        imp = ((rng.random((F, n)) < 0.5)
               * (2.0 ** 24 * (1 + rng.random((F, n))))).astype(np.float32)
        qw = ((rng.random((Q, F)) < 0.75)
              * 2.0 ** (-133 + rng.random((Q, F)) * 7)).astype(np.float32)
    else:  # "zero weights": BM25-shaped, most weights of a query 0
        imp = ((rng.random((F, n)) < 0.2) * rng.random((F, n)) * 2.2
               ).astype(np.float32)
        qw *= rng.random((Q, F)) < 4 / F
    return qw, imp


def _products(qw, imp):
    """f32 [Q, F, n]: the bf16 products (exact in f32 unless they fall
    below the normal range)."""
    return (_bf16(qw)[:, :, None] * _bf16(imp)[None]).astype(np.float32)


def _seq(p, order):
    s = np.zeros((p.shape[0], p.shape[2]), np.float32)
    for r in order:
        s = (s + p[:, r]).astype(np.float32)
    return s


def _pairwise(p):
    while p.shape[1] > 1:
        if p.shape[1] % 2:
            p = np.concatenate([p, np.zeros_like(p[:, :1])], axis=1)
        p = (p[:, 0::2] + p[:, 1::2]).astype(np.float32)
    return p[:, 0]


def _wide16(p):
    acc = np.stack([_seq(p[:, j::16], range(p[:, j::16].shape[1]))
                    for j in range(16)], axis=1)
    return _seq(acc, range(16))


def _toward_zero_f32(x):
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _truncating(p, ftz):
    """A tensor-core-like accumulator: per k16 step the running sum and
    the 16 products are aligned to the largest exponent, each truncated
    to 24 bits below it, summed, and the sum truncated to f32; with
    ``ftz`` products below the normal range are flushed to zero first."""
    p = p.astype(np.float64)
    if ftz:
        p = np.where(np.abs(p) < 2.0 ** -126, 0.0, p)
    acc = np.zeros((p.shape[0], p.shape[2]))
    for g in range(0, p.shape[1], 16):
        terms = np.concatenate([acc[:, None], p[:, g:g + 16]], axis=1)
        e = np.frexp(np.abs(terms).max(axis=1))[1]
        quantum = np.ldexp(1.0, e - 24)[:, None]
        acc = _toward_zero_f32(
            (np.trunc(terms / quantum) * quantum).sum(axis=1)
        ).astype(np.float64)
    return acc.astype(np.float32)


def _flush(x):
    """bf16 operands with those below the normal range set to zero."""
    b = _bf16(x)
    return np.where(np.abs(b) < 2.0 ** -126, np.float32(0), b)


@pytest.mark.parametrize("kind", ["ties", "mixed", "subnormal",
                                  "subnormal weights", "zero weights"])
def test_rescore_margin_bounds_other_summation_orders(kind):
    """``rescore_margin`` (the kernel's m_q, its constant mirrored) bounds
    |s_other - s_twin| per tile of 64 docs for f32 sums in other orders:
    reversed, pairwise, 16 partial sums then added, and a truncating
    aligned accumulator with and without flushing subnormal products, and
    with subnormal operands flushed too. The twin's own sum is taken from
    ``bm25_dense_topk_plain``'s arithmetic."""
    qw, imp = _margin_inputs(kind, 80 + len(kind))
    Q, F = qw.shape
    n = imp.shape[1]
    qb = torch.from_numpy(qw).to(torch.bfloat16).float()
    twin = torch.zeros(Q, n)
    for r in range(F):
        twin = twin + qb[:, r:r + 1] * torch.from_numpy(imp[r]).to(
            torch.bfloat16).float()
    twin = twin.numpy()
    p = _products(qw, imp)
    others = {"reversed": _seq(p, range(F - 1, -1, -1)),
              "pairwise": _pairwise(p), "16 partial sums": _wide16(p),
              "truncating": _truncating(p, False),
              "truncating, ftz": _truncating(p, True),
              "truncating, operands flushed": _truncating(
                  _products(_flush(qw), _flush(imp)), True)}
    if kind == "mixed":  # the point of the case: the last bits differ
        assert not any(np.array_equal(o, twin) for o in others.values())
    if kind == "subnormal weights":  # and here a flushed weight matters
        assert not np.array_equal(others["truncating, operands flushed"],
                                  twin)
    T = bm25_topk.TC_DOCS
    for t0 in range(0, n, T):
        m = bm25_topk.rescore_margin(
            torch.from_numpy(qw), torch.from_numpy(imp[:, t0:t0 + T])
        ).numpy().astype(np.float64)
        for name, o in others.items():
            err = np.abs(o[:, t0:t0 + T].astype(np.float64)
                         - twin[:, t0:t0 + T])
            assert (err <= m[:, None]).all(), (
                f"{kind}, {name}: error {err.max()} over margin "
                f"{m[np.argmax(err.max(1))]}")


def _f32_round(x, up):
    y = x.astype(np.float32)
    bad = (y.astype(np.float64) < x) if up else (y.astype(np.float64) > x)
    y[bad] = np.nextafter(y[bad], np.float32(np.inf if up else -np.inf))
    return y


def _emulate_tc(qw, imp, mask, k, G, mode, rng, seed_docs=bm25_topk.TC_SEED_DOCS):
    """The tensor-core pass's selection on the CPU: G blocks walk tiles of
    ``TC_DOCS`` docs (block x takes tiles x, x + G, ...), interleaved tile
    by tile; per query a block keeps the k best exact keys. Its
    tensor-core score is the twin's perturbed anywhere within +-m
    (``mode``: all up, all down, or random). The threshold is the list's
    k-th value, or, before the list is full, the tile's k-th largest ŝ
    less m (rounded down) when the tile has k live docs and no bound is
    shared yet; a block publishes it when finite, and every block takes
    the largest published one too, and the k-th largest of the blocks'
    best exact values (their docs are disjoint).
    A live doc is a candidate when ŝ + m (rounded up) reaches the
    threshold; a masked doc when there is none at all (the list not full,
    fewer than k live docs in the tile, nothing published). A candidate's
    key is exact: -inf if masked, +0 if no row hits, else the twin's sum.
    The blocks' lists merge by key. Before the first tile the shared
    threshold holds the k-th best live exact score of docs 0 ..
    ``seed_docs`` - 1, when there are k."""
    Q, F = qw.shape
    D = imp.shape[1]
    T = bm25_topk.TC_DOCS
    qb = torch.from_numpy(qw).to(torch.bfloat16).float()
    s = torch.zeros(Q, D)
    for r in range(F):
        s = s + qb[:, r:r + 1] * torch.from_numpy(imp[r]).to(
            torch.bfloat16).float()
    s = s.numpy()
    hit = ((qw != 0).astype(np.float64) @ (imp != 0).astype(np.float64)) > 0
    tiles = -(-D // T)
    lists = [[[] for _ in range(Q)] for _ in range(G)]
    published = np.full(Q, -np.inf)
    seed = min(D, seed_docs)  # the seed: the k-th best live of docs 0 ..
    for q in range(Q):
        vals = np.sort(s[q, :seed][mask[:seed]])[::-1]
        if vals.size >= k and vals[k - 1] > -np.inf:
            published[q] = vals[k - 1]
    for step in range(-(-tiles // G)):
        for x in range(G):
            tile = x + step * G
            if tile >= tiles:
                continue
            d0, d1 = tile * T, min(D, tile * T + T)
            m = bm25_topk.rescore_margin(torch.from_numpy(qw),
                                         torch.from_numpy(imp[:, d0:d1]))
            m = m.numpy().astype(np.float64)
            live = mask[d0:d1]
            for q in range(Q):
                u = {"up": np.ones(d1 - d0), "down": -np.ones(d1 - d0),
                     "random": rng.uniform(-1, 1, d1 - d0)}[mode]
                hat = s[q, d0:d1].astype(np.float64) + m[q] * u
                hat = np.where(u > 0, _f32_round(hat, False),
                               _f32_round(hat, True)).astype(np.float64)
                lst = lists[x][q]
                heads = sorted((-lists[b][q][0][0] for b in range(G)
                                if lists[b][q] and lists[b][q][0][0] < np.inf),
                               reverse=True)
                board = heads[k - 1] if len(heads) >= k else -np.inf
                shared = max(published[q], board)
                theta = -np.inf
                if len(lst) == k:
                    theta = -lst[-1][0]
                elif live.sum() >= k and shared == -np.inf:
                    kth = np.sort(hat[live])[::-1][k - 1]
                    theta = float(_f32_round(np.array([kth - m[q]]),
                                             False)[0])
                if theta > -np.inf:
                    published[q] = max(published[q], theta)
                masked_too = (len(lst) < k and live.sum() < k
                              and shared == -np.inf)
                theta = max(theta, shared)
                up = _f32_round(hat + m[q], True).astype(np.float64)
                cand = np.where(live, up >= theta, masked_too)
                for j in np.flatnonzero(cand):
                    d = d0 + j
                    v = (-np.inf if not live[j] else
                         0.0 if not hit[q, d] else float(s[q, d]))
                    key = (-v, d)
                    if len(lst) < k or key < lst[-1]:
                        lst.append(key)
                        lst.sort()
                        del lst[k:]
    vals = np.empty((Q, k), np.float32)
    ids = np.empty((Q, k), np.int32)
    for q in range(Q):
        best = sorted(sum((lists[x][q] for x in range(G)), []))[:k]
        vals[q] = [np.float32(-v) for v, _ in best]
        ids[q] = [d for _, d in best]
    return vals, ids


def _selection_case(kind, rng):
    Q, F, D = 6, 32, 1000
    if kind == "all tie":
        qw = np.full((Q, F), 1.5, np.float32)
        imp = np.ones((F, D), np.float32)
        mask = rng.random(D) > 0.3
    elif kind == "ties":
        qw = np.repeat((rng.random((Q, 1)) * 3), F, axis=1).astype(np.float32)
        imp = np.round(rng.random((F, D)) * 2).astype(np.float32)
        mask = rng.random(D) > 0.3
    elif kind == "fewer live than k":
        qw = (rng.random((Q, F)) * 3).astype(np.float32)
        imp = ((rng.random((F, D)) < 0.2) * rng.random((F, D))).astype(
            np.float32)
        mask = np.zeros(D, bool)
        mask[rng.choice(D, 7, replace=False)] = True
    elif kind in ("mixed", "subnormal weights"):
        qw, imp = _margin_inputs(kind, 7, Q=Q, F=F, n=D)
        mask = rng.random(D) > 0.1
    else:  # "sparse": BM25-shaped, zero weights, docs with no hit
        qw, imp = _margin_inputs("zero weights", 8, Q=Q, F=F, n=D)
        mask = rng.random(D) > 0.2
    return qw, imp, mask


@pytest.mark.parametrize("mode", ["up", "down", "random"])
@pytest.mark.parametrize("kind", ["all tie", "ties", "fewer live than k",
                                  "mixed", "subnormal weights", "sparse"])
def test_tensor_core_selection_rule_is_exact(kind, mode):
    """The selection rule, emulated with tensor-core scores anywhere
    within the margin of the twin's, returns the twin's values (bit for
    bit) and ids, for k below, at and above a tile's live docs."""
    rng = np.random.default_rng(90)
    qw, imp, mask = _selection_case(kind, rng)
    for k, G, seed in ((1, 1, 512), (10, 3, 512), (40, 2, 512), (2, 5, 512),
                       (10, 3, 0), (10, 3, 64)):
        got_v, got_i = _emulate_tc(qw, imp, mask, k, G, mode, rng, seed)
        want_v, want_i = bm25_dense_topk_plain(
            torch.from_numpy(qw), torch.from_numpy(imp),
            torch.from_numpy(mask), k=k)
        np.testing.assert_array_equal(got_v.view(np.int32),
                                      want_v.numpy().view(np.int32))
        np.testing.assert_array_equal(got_i, want_i.numpy())
