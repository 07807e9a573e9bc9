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
