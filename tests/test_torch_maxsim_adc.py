"""Kernel B4 (MaxSim over PQ codes) of the PyTorch port against the JAX
package: the plain twin against ``maxsim_adc_pallas`` run in interpret
mode (bit for bit), against the reference's XLA form on shapes the TPU
gate refused, ``adc_luts`` against the reference's per-token
``adc_lut``, and the wrapper's refusals.

On the CPU the B4 wrapper runs its plain twin; ``chip_smoke.py`` holds
the CUDA kernel against the same twin on the card.
"""
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import pq as ref_pq
from elasticsearch_tpu.ops.pallas_kernels import (_maxsim_adc_xla,
                                                  maxsim_adc_pallas)
from elasticsearch_tpu_torch.ops.maxsim_adc import (maxsim_adc,
                                                    maxsim_adc_plain, plan)
from elasticsearch_tpu_torch.ops.pq import adc_lut, adc_luts


def _case(seed, W, M, K, T):
    """Seeded u8-valued codes [W, M] and negative-leaning LUTs [T, M, K]
    (the l2 form 2 q.c - |c|^2 is mostly negative)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, K, size=(W, M)).astype(np.uint8)
    luts = (rng.standard_normal((T, M, K)) - 1.5).astype(np.float32)
    return codes, luts


def _pallas(codes, luts, tile, pad):
    """The reference kernel on the dispatcher's layout: token columns
    [M, K, Tp], Tp a multiple of 8; ``pad`` "neg" fills pad columns with
    -1e30 at t_real = Tp (maxsim_adc_auto's form), "zero" fills them
    with zeros at t_real = T."""
    import jax.numpy as jnp

    T, M, K = luts.shape
    Tp = -(-T // 8) * 8
    cols = np.full((M, K, Tp), -1e30 if pad == "neg" else 0.0, np.float32)
    cols[:, :, :T] = luts.transpose(1, 2, 0)
    out = maxsim_adc_pallas(jnp.asarray(codes.astype(np.int32)),
                            jnp.asarray(cols),
                            t_real=Tp if pad == "neg" else T, tile=tile,
                            interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("pad", ["neg", "zero"])
@pytest.mark.parametrize("shape", [(128, 4, 128, 5, 64),
                                   (256, 32, 256, 32, 128)])
def test_plain_matches_pallas_bit_for_bit(shape, pad):
    W, M, K, T, tile = shape
    codes, luts = _case(W + T, W, M, K, T)
    got = maxsim_adc(torch.from_numpy(codes), torch.from_numpy(luts)).numpy()
    want = _pallas(codes, luts, tile, pad)
    assert got.dtype == np.float32 and got.shape == (W,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", [(97, 8, 64, 65), (97, 3, 64, 1),
                                   (1, 32, 256, 7)])
def test_plain_matches_xla_form_off_the_tpu_gate(shape):
    """W 97 fits no tile, K 64 is no lane multiple, T 65 pads past the
    gate's Tp <= 64: the reference always took its XLA form here."""
    import jax.numpy as jnp

    W, M, K, T = shape
    codes, luts = _case(7 * W + M, W, M, K, T)
    got = maxsim_adc(torch.from_numpy(codes), torch.from_numpy(luts)).numpy()
    want = np.asarray(_maxsim_adc_xla(jnp.asarray(codes.astype(np.int32)),
                                      jnp.asarray(luts)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_plain_is_a_per_token_sum_then_max():
    """The twin's rule written out in numpy: per token a left-to-right
    f32 sum over m, then the max; a NaN in any token's sum wins."""
    codes, luts = _case(3, 50, 6, 32, 4)
    luts[2, 1, codes[7, 1]] = np.nan
    per = np.zeros((4, 50), np.float32)
    for t in range(4):
        for m in range(6):
            per[t] = per[t] + luts[t, m, codes[:, m]]
    got = maxsim_adc_plain(torch.from_numpy(codes),
                           torch.from_numpy(luts)).numpy()
    assert np.isnan(got[7]) and np.isnan(per[:, 7]).any()
    ok = ~np.isnan(per).any(axis=0)
    np.testing.assert_array_equal(got[ok], per.max(axis=0)[ok])
    assert np.isnan(got).sum() == (~ok).sum()


@pytest.mark.parametrize("group", [1, 2, 5])
def test_group_maxima_fold_to_the_full_max(group):
    """The kernel's split of the token axis: the twin over each group of
    tokens, the groups' maxima folded with torch.maximum in forward and
    in reverse group order, equals the twin over all tokens bit for bit,
    with a NaN in a token past the first group."""
    W, M, K, T = 200, 8, 64, 13
    codes, luts = _case(41 + group, W, M, K, T)
    luts[T - 2, 3, codes[5, 3]] = np.nan
    c, lt = torch.from_numpy(codes), torch.from_numpy(luts)
    full = maxsim_adc_plain(c, lt)
    parts = [maxsim_adc_plain(c, lt[t:t + group]) for t in range(0, T, group)]
    assert len(parts) == -(-T // group)
    nan = torch.isnan(full)
    assert nan[5]
    for order in (parts, parts[::-1]):
        got = order[0]
        for p in order[1:]:
            got = torch.maximum(got, p)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           full[~nan].view(torch.int32))


def test_plan_groups_tokens_by_table_bytes():
    """Tokens per group: as many as fit in 32 KiB of tables, at least
    one; the scratch holds one row of W maxima per group, and none for
    a single group or rows of more than 32 codes (one launch)."""
    assert plan(100, 32, 256, 32) == (1, 32, 3200)
    assert plan(100, 32, 256, 33) == (1, 33, 3300)
    assert plan(100, 16, 256, 32) == (2, 16, 1600)
    assert plan(300, 3, 255, 7) == (7, 1, 0)
    assert plan(1, 1, 64, 100) == (100, 1, 0)
    assert plan(4097, 64, 256, 8) == (8, 1, 0)
    for W, M, K, T in [(100, 32, 256, 32), (7, 5, 200, 40), (10, 32, 255, 3),
                       (1, 1, 1, 1)]:
        gt, groups, n = plan(W, M, K, T)
        assert gt == 1 or gt * M * K * 4 <= 32 * 1024
        assert (groups - 1) * gt < T <= groups * gt
        assert n == (groups * W if groups > 1 else 0)


@pytest.mark.parametrize("metric", ["cosine", "dot_product", "l2_norm"])
def test_adc_luts_match_reference_per_token(metric):
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    M, K, dsub, T = 8, 32, 4, 6
    books = rng.standard_normal((M, K, dsub)).astype(np.float32)
    toks = rng.standard_normal((T, M * dsub)).astype(np.float32)
    got = adc_luts(torch.from_numpy(toks), torch.from_numpy(books),
                   metric).numpy()
    assert got.shape == (T, M, K)
    for t in range(T):
        want = np.asarray(ref_pq.adc_lut(jnp, jnp.asarray(toks[t]),
                                         jnp.asarray(books), metric))
        # f32 sums of dsub products in other orders: within a few ulps
        # of the terms' scale (~1), so an entry that cancels near 0 is
        # held absolutely
        np.testing.assert_allclose(got[t], want, rtol=1e-5, atol=1e-6)
        # and the port's single-token table, which B3 reads
        np.testing.assert_allclose(
            got[t], adc_lut(torch.from_numpy(toks[t]),
                            torch.from_numpy(books), metric).numpy(),
            rtol=1e-5, atol=1e-6)


def test_wrapper_refuses_other_devices_and_shapes():
    codes = torch.zeros(4, 2, dtype=torch.uint8)
    luts = torch.zeros(3, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        maxsim_adc(codes.to("meta"), luts.to("meta"))
    with pytest.raises(ValueError, match="mismatch"):
        maxsim_adc(codes, torch.zeros(3, 5, 16))
    with pytest.raises(ValueError, match="expected"):
        maxsim_adc(codes, torch.zeros(2, 16))
    with pytest.raises(ValueError, match="K <= 256"):
        maxsim_adc(codes, torch.zeros(3, 2, 300))
    assert maxsim_adc(codes[:0], luts).shape == (0,)
