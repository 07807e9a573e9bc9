"""Sequence-parallel (ring attention) encode for the dual encoder.

Port of elasticsearch_tpu/models/ring_encoder.py. Long passages blow up
attention memory quadratically: at L tokens the dense encode holds
``[B, H, L, L]`` scores. This module runs the same dual encoder (same
parameters, same numerics up to the order of the bf16 products) with
the sequence cut into S slots of ``L/S`` positions:

- LayerNorm, the MLP and the projections are position-wise and run on
  every slot at once;
- attention is a ring: each slot keeps its query block and takes the
  key/value/mask blocks in ring order, the block of slot ``(i - t) % S``
  at step t (the reference's ``ppermute`` to the next device becomes the
  next block index), accumulating the exact softmax with the online
  max/sum rescaling in f32. One slot's block step holds
  ``[B, H, L/S, L/S]`` scores, and the slots run one after another, so
  that is the peak;
- the masked mean pool is a per-slot partial sum, summed over the slots
  in place of the reference's ``psum``.

The reference's slots are devices of an ``('sp',)`` mesh; here they are
slots of one card (a ``parallel/mesh.py::ShardMesh``), so there is no
collective and no per-mesh compiled function to cache (its
``_jitted_fwd``): eager PyTorch runs the loop as written.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from elasticsearch_tpu_torch.models.dual_encoder import (
    DualEncoder, DualEncoderConfig, _as_inputs, _first_touch)
from elasticsearch_tpu_torch.parallel.mesh import ShardMesh, shard_mesh
from elasticsearch_tpu_torch.utils.device import resolve_device

_NEG = -1e30  # the ring's mask value, in f32


def build_sp_mesh(n_devices: int, device=None) -> ShardMesh:
    """S sequence slots of one device (the card unless the caller passes
    ``device="cpu"``)."""
    return shard_mesh(n_devices, resolve_device(device))


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """The reference ring path's LayerNorm: f32 statistics with the
    two-pass variance, eps 1e-6, back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) / torch.sqrt(var + 1e-6)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, S: int) -> torch.Tensor:
    """Exact softmax attention over the full L, one query slot at a time.

    q/k/v: [B, H, L, Dh] with L = S * Lloc; mask: f32[B, L]. Returns
    [B, H, L, Dh] in q's dtype: for slot i, S block steps over key blocks
    (i - t) % S with online max/sum rescaling in f32.
    """
    B, H, L, Dh = q.shape
    n = L // S
    out = torch.empty_like(q)
    for i in range(S):
        qf = q[:, :, i * n:(i + 1) * n].float() / math.sqrt(Dh)
        m_acc = torch.full((B, H, n), _NEG, dtype=torch.float32,
                           device=q.device)
        l_acc = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
        o_acc = torch.zeros((B, H, n, Dh), dtype=torch.float32,
                            device=q.device)
        for t in range(S):
            j = (i - t) % S
            blk = slice(j * n, (j + 1) * n)
            s = torch.einsum("bhqd,bhkd->bhqk", qf, k[:, :, blk].float())
            s = torch.where(mask[:, None, None, blk] > 0, s, _NEG)
            m_new = torch.maximum(m_acc, s.amax(-1))
            alpha = torch.exp(m_acc - m_new)
            p = torch.exp(s - m_new[..., None])
            l_acc = l_acc * alpha + p.sum(-1)
            o_acc = (o_acc * alpha[..., None]
                     + torch.einsum("bhqk,bhkd->bhqd", p,
                                    v[:, :, blk].float()))
            m_acc = m_new
        out[:, :, i * n:(i + 1) * n] = (
            o_acc / torch.clamp(l_acc[..., None], min=1e-30)).to(q.dtype)
    return out


def _forward(cfg: DualEncoderConfig, model: DualEncoder, ids: torch.Tensor,
             mask: torch.Tensor, S: int) -> torch.Tensor:
    """The encoder forward over S slots of a padded [B, Lp] batch,
    mirroring the reference's ``_forward_local`` layer by layer."""
    dtype = cfg.dtype
    B, Lp = ids.shape
    H, D = cfg.n_heads, cfg.d_model
    Dh = D // H

    x = F.embedding(ids, model.tok_emb.weight).to(dtype)
    # the clip covers ring padding past max_len: those positions are
    # mask 0, and their embedding never reaches the pool
    pos_ids = torch.clamp(torch.arange(Lp, device=ids.device), 0,
                          cfg.max_len - 1)
    x = x + model.pos_emb.weight.to(dtype)[pos_ids][None]
    m = mask.float()

    for blk in model.blocks:
        h = _layer_norm(x, blk.ln1.scale, blk.ln1.bias)
        a = blk.attn

        def heads(lin):
            y = torch.matmul(h, lin.weight.to(dtype).t())
            return (y.view(B, Lp, H, Dh).permute(0, 2, 1, 3)
                    + lin.bias.to(dtype).view(H, Dh)[None, :, None, :])

        o = _ring_attention(heads(a.query), heads(a.key), heads(a.value), m,
                            S)
        o = o.permute(0, 2, 1, 3).reshape(B, Lp, D)
        x = x + (torch.matmul(o, a.out.weight.to(dtype).t())
                 + a.out.bias.to(dtype))
        h = _layer_norm(x, blk.ln2.scale, blk.ln2.bias)
        h = torch.matmul(h, blk.wi.weight.to(dtype).t()) \
            + blk.wi.bias.to(dtype)
        h = F.gelu(h, approximate="tanh")
        h = torch.matmul(h, blk.wo.weight.to(dtype).t()) \
            + blk.wo.bias.to(dtype)
        x = x + h

    x = _layer_norm(x, model.ln_f.scale, model.ln_f.bias)
    # masked mean pool: per-slot partials, then their sum over the slots
    part = (x * m[:, :, None].to(x.dtype)).view(B, S, Lp // S, D).sum(2)
    num = part.sum(1)
    den = m.view(B, S, Lp // S).sum(2).sum(1)
    pooled = num / torch.clamp(den, min=1.0)[:, None].to(x.dtype)
    z = (torch.matmul(pooled, model.proj.weight.to(dtype).t())
         + model.proj.bias.to(dtype)).float()
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                           min=1e-6)


def ring_encode(cfg: DualEncoderConfig, model: DualEncoder, token_ids,
                attn_mask, mesh: ShardMesh) -> torch.Tensor:
    """Sequence-parallel encode: f32[B, embed_dim], unit-norm, equal to
    ``encode(model, ...)`` up to bf16 tolerance, on the model's device.

    token_ids/attn_mask are [B, L] arrays or tensors with L <=
    ``cfg.max_len``; L is right-padded (mask 0, clipped position ids) to
    a multiple of the mesh's slots.
    """
    S = mesh.slots
    ids, msk = _as_inputs(model, token_ids, attn_mask)
    B, L = ids.shape
    if L > cfg.max_len:
        raise ValueError(f"sequence {L} exceeds cfg.max_len {cfg.max_len}")
    Lp = ((L + S - 1) // S) * S
    if Lp != L:
        ids = F.pad(ids, (0, Lp - L))
        msk = F.pad(msk, (0, Lp - L))
    _first_touch("ring_encoder.ring_encode", f"{B}x{Lp}/sp={S}/{cfg.dtype}")
    with torch.no_grad():
        return _forward(cfg, model, ids, msk, S)

