"""The port's ring-attention encode against the reference's
(models/ring_encoder.py on its 8-device ('sp',) CPU mesh) and against the
port's dense encode.

Weights are the reference's seeded ``init_params`` carried across by
``params_from_flax``. Bars: at f32 within atol 1e-5 of the reference's
ring; at bf16 cosine > 0.999 and atol 3e-2 (the reference's own
ring-vs-dense bar), against both the reference and the dense encode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from elasticsearch_tpu.models import dual_encoder as R
from elasticsearch_tpu.models import ring_encoder as RR
from elasticsearch_tpu_torch.models import dual_encoder as P
from elasticsearch_tpu_torch.models import ring_encoder as PR

MID = dict(vocab_size=512, max_len=64, d_model=64, n_heads=4, n_layers=2,
           d_ff=128, embed_dim=32)


def _pair(dt="bf16", seed=3, **kw):
    args = dict(MID, **kw)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rc = R.DualEncoderConfig(dtype=jd, **args)
    pc = P.DualEncoderConfig(dtype=td, **args)
    params = R.init_params(rc, seed=seed)
    model = P.build_model(pc)
    model.load_state_dict(P.params_from_flax(params, pc))
    return rc, params, pc, model


def _batch(rng, B, L, vocab=512, ragged=True):
    ids = rng.integers(1, vocab, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    if ragged:
        for i in range(B):
            n = int(rng.integers(L // 3, L + 1))
            ids[i, n:] = 0
            mask[i, n:] = 0.0
    return ids, mask


def _bf16_close(got, want):
    cos = np.sum(got * want, axis=-1)
    assert np.all(cos > 0.999), cos
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def _port_ring(pc, model, ids, mask, S=8):
    return PR.ring_encode(pc, model, ids, mask,
                          PR.build_sp_mesh(S, device="cpu")).numpy()


def test_ring_encode_matches_the_references_ring_f32(eight_devices):
    """f32: the same online softmax, block order and pool, within atol
    1e-5 of the reference's ring on its 8 devices."""
    rc, params, pc, model = _pair("f32")
    rng = np.random.default_rng(0)
    ids, mask = _batch(rng, 4, 64)
    ref = np.asarray(RR.ring_encode(rc, params, ids, mask,
                                    RR.build_sp_mesh(8)))
    np.testing.assert_allclose(_port_ring(pc, model, ids, mask), ref,
                               rtol=0, atol=1e-5)


def test_ring_encode_matches_the_references_ring_bf16(eight_devices):
    rc, params, pc, model = _pair("bf16")
    rng = np.random.default_rng(1)
    ids, mask = _batch(rng, 4, 64)
    ref = np.asarray(RR.ring_encode(rc, params, ids, mask,
                                    RR.build_sp_mesh(8)))
    _bf16_close(_port_ring(pc, model, ids, mask), ref)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_ring_encode_matches_dense(S):
    """The port's ring against its own dense encode (the reference's
    test, at every slot count that divides 64)."""
    _rc, _params, pc, model = _pair("bf16")
    rng = np.random.default_rng(2)
    ids, mask = _batch(rng, 4, 64)
    dense = P.encode(model, ids, mask).numpy()
    ring = _port_ring(pc, model, ids, mask, S)
    assert ring.shape == dense.shape
    _bf16_close(ring, dense)


def test_ring_encode_pads_ragged_length(eight_devices):
    """L = 30 is no multiple of 8: right-padded with mask 0, the padding
    changes nothing; against the port's dense encode and the reference's
    ring."""
    rc, params, pc, model = _pair("bf16")
    rng = np.random.default_rng(3)
    ids, mask = _batch(rng, 2, 30, ragged=False)
    ring = _port_ring(pc, model, ids, mask)
    _bf16_close(ring, P.encode(model, ids, mask).numpy())
    _bf16_close(ring, np.asarray(RR.ring_encode(rc, params, ids, mask,
                                                RR.build_sp_mesh(8))))


def test_ring_encode_padding_may_cross_max_len(eight_devices):
    """L == max_len = 60, no multiple of 8: the ring pads past max_len
    with mask-0 positions and clipped position ids; valid input is not
    refused and matches dense and the reference."""
    rc, params, pc, model = _pair("bf16", seed=9, vocab_size=256,
                                  max_len=60, d_model=32, n_heads=2,
                                  n_layers=1, d_ff=64, embed_dim=16)
    rng = np.random.default_rng(4)
    ids, mask = _batch(rng, 2, 60, vocab=256, ragged=False)
    ring = _port_ring(pc, model, ids, mask)
    _bf16_close(ring, P.encode(model, ids, mask).numpy())
    _bf16_close(ring, np.asarray(RR.ring_encode(rc, params, ids, mask,
                                                RR.build_sp_mesh(8))))


def test_ring_encode_rejects_overlong():
    _rc, _params, pc, model = _pair("bf16")
    ids = np.zeros((1, pc.max_len + 8), np.int32)
    mask = np.ones((1, pc.max_len + 8), np.float32)
    with pytest.raises(ValueError, match="exceeds cfg.max_len"):
        _port_ring(pc, model, ids, mask)


def test_ring_attention_holds_one_block_of_scores(monkeypatch):
    """No [L, L] score matrix: every product of the ring is one slot's
    [B, H, L/S, L/S] scores or its [B, H, L/S, Dh] values, and there are
    S * S of each a layer."""
    _rc, _params, pc, model = _pair("bf16")
    shapes = []
    real = torch.einsum

    def spy(eq, *ops):
        out = real(eq, *ops)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "einsum", spy)
    rng = np.random.default_rng(5)
    ids, mask = _batch(rng, 2, 64)
    _port_ring(pc, model, ids, mask)
    B, H, n, Dh = 2, 4, 64 // 8, 16
    assert sorted(set(shapes)) == sorted({(B, H, n, n), (B, H, n, Dh)})
    assert len(shapes) == 2 * 8 * 8 * pc.n_layers


def test_ring_encode_long_context(eight_devices):
    """max_len 1024 through 8 slots: per-slot peak [B, H, 128, 128],
    64x smaller than dense; finite, unit-norm and equal to the
    reference's ring (bf16 bar)."""
    rc, params, pc, model = _pair("bf16", seed=5, max_len=1024,
                                  n_layers=1)
    ids, mask = P.SimpleTokenizer(pc)(["long document " * 300],
                                      max_len=1024)
    out = _port_ring(pc, model, ids, mask)
    assert out.shape == (1, 32) and np.all(np.isfinite(out))
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-3)
    _bf16_close(out, np.asarray(RR.ring_encode(rc, params, ids, mask,
                                               RR.build_sp_mesh(8))))


def test_build_sp_mesh():
    mesh = PR.build_sp_mesh(8, device="cpu")
    assert mesh.slots == 8 and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError):
        PR.build_sp_mesh(0, device="cpu")
