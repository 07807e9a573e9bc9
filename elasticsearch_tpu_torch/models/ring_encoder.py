"""Sequence-parallel (ring attention) encode for the dual encoder.

Port of elasticsearch_tpu/models/ring_encoder.py. Long passages blow up
attention memory quadratically: at L tokens the dense encode holds
``[B, H, L, L]`` scores. This module runs the same dual encoder (same
parameters, same numerics up to the order of the bf16 products) with
the sequence cut into S slots of ``L/S`` positions:

- the slots lie over the mesh's devices (``build_sp_mesh``; slot ``i``
  on mesh device ``i % n_devices``, a ``parallel/mesh.py::ShardMesh``):
  each device holds its slots' ids, mask and activations, and a copy of
  the parameters made once a call. LayerNorm, the MLP and the
  projections are position-wise and run on each device over all of its
  slots at once;
- attention is a ring: each slot keeps its query block and takes the
  key/value/mask blocks in ring order, the block of slot ``(i - t) % S``
  at step t, copied from that block's device without blocking (the
  reference's ``ppermute``), accumulating the exact softmax with the
  online max/sum rescaling in f32. The outer loop is the ring step and
  the inner one the slot, so every device has step t queued before any
  starts step t + 1. A slot's block step holds ``[B, H, L/S, L/S]``
  scores: a device's peak is one such block per slot it holds;
- the masked mean pool's per-slot partial sums and mask counts are
  gathered on the first device and summed there in place of the
  reference's ``psum``; the projection runs there.

The reference's mesh shrinks to the devices there are; this one keeps
its S slots and wraps them over the devices, and a list may name one
device several times (``utils/device.py::resolve_devices``). On one
device every slot shares it, the position-wise ops run over the whole
sequence, and the copies are no-ops. There is no per-mesh compiled
function to cache (the reference's ``_jitted_fwd``): eager PyTorch runs
the loop as written.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from elasticsearch_tpu_torch.models.dual_encoder import (
    DualEncoder, DualEncoderConfig, _as_inputs, _first_touch)
from elasticsearch_tpu_torch.parallel.mesh import ShardMesh, shard_mesh
from elasticsearch_tpu_torch.utils.device import resolve_devices

_NEG = -1e30  # the ring's mask value, in f32


def build_sp_mesh(n_devices: int, device=None) -> ShardMesh:
    """S sequence slots over the devices of ``device`` (every visible
    card by default, ``"cpu"`` only when asked, or a list): slot i on
    device ``i % min(S, len(devices))``."""
    return shard_mesh(n_devices, resolve_devices(device))


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """The reference ring path's LayerNorm: f32 statistics with the
    two-pass variance, eps 1e-6, back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) / torch.sqrt(var + 1e-6)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _ring_attention(mesh: ShardMesh, q, k, v, m, n: int):
    """Exact softmax attention over the full L, the ring turned step by
    step across the devices.

    q/k/v: per mesh device ``[B, H, n * S_d, Dh]`` over its slots (slot
    i at local block ``i // n_devices``); m: per device f32[B, n * S_d].
    Returns per device the attention output in q's dtype.
    """
    S, nd = mesh.slots, mesh.n_devices
    B, H, _, Dh = q[0].shape
    blk = [slice(li * n, (li + 1) * n) for li in range((S + nd - 1) // nd)]
    acc = []
    for i in range(S):
        d = mesh.device_of(i)
        dev = q[d].device
        qf = q[d][:, :, blk[i // nd]].float() / math.sqrt(Dh)
        acc.append([qf, torch.full((B, H, n), _NEG, dtype=torch.float32,
                                   device=dev),
                    torch.zeros((B, H, n), dtype=torch.float32, device=dev),
                    torch.zeros((B, H, n, Dh), dtype=torch.float32,
                                device=dev)])
    for t in range(S):
        for i in range(S):
            qf, m_acc, l_acc, o_acc = acc[i]
            j = (i - t) % S
            dj, bj = mesh.device_of(j), blk[j // nd]
            dev = qf.device
            kb = k[dj][:, :, bj].to(dev, non_blocking=True)
            vb = v[dj][:, :, bj].to(dev, non_blocking=True)
            mb = m[dj][:, bj].to(dev, non_blocking=True)
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float())
            s = torch.where(mb[:, None, None, :] > 0, s, _NEG)
            m_new = torch.maximum(m_acc, s.amax(-1))
            alpha = torch.exp(m_acc - m_new)
            p = torch.exp(s - m_new[..., None])
            acc[i][1] = m_new
            acc[i][2] = l_acc * alpha + p.sum(-1)
            acc[i][3] = (o_acc * alpha[..., None]
                         + torch.einsum("bhqk,bhkd->bhqd", p, vb.float()))
    out = [torch.empty_like(x) for x in q]
    for i in range(S):
        _qf, _m, l_acc, o_acc = acc[i]
        d = mesh.device_of(i)
        out[d][:, :, blk[i // nd]] = (
            o_acc / torch.clamp(l_acc[..., None], min=1e-30)).to(q[d].dtype)
    return out


def _slot_positions(mesh: ShardMesh, d: int, n: int) -> torch.Tensor:
    """The sequence positions of mesh device d's slots, in slot order."""
    return torch.cat([torch.arange(i * n, (i + 1) * n)
                      for i in mesh.slots_of(d)])


def _on_device(x: torch.Tensor, pos: torch.Tensor, dev) -> torch.Tensor:
    """``x[:, pos]`` on ``dev``; the whole of x when pos covers it in
    order (one device)."""
    if pos.numel() != x.shape[1]:
        x = x[:, pos.to(x.device)]
    return x.to(dev, non_blocking=True)


def _forward(cfg: DualEncoderConfig, model: DualEncoder, ids: torch.Tensor,
             mask: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """The encoder forward over the mesh's slots of a padded [B, Lp]
    batch, mirroring the reference's ``_forward_local`` layer by layer;
    f32[B, E] on the first device."""
    dtype = cfg.dtype
    S, nd = mesh.slots, mesh.n_devices
    B, Lp = ids.shape
    n = Lp // S
    H, D = cfg.n_heads, cfg.d_model
    Dh = D // H
    params = {}  # one copy of the parameters a device, made once a call
    W = []
    for dev in mesh.devices:
        if dev not in params:
            params[dev] = {k: t.detach().to(dev, non_blocking=True)
                           for k, t in model.state_dict().items()}
        W.append(params[dev])

    x, m = [], []
    for d, dev in enumerate(mesh.devices):
        pos = _slot_positions(mesh, d, n)
        ids_d = _on_device(ids, pos, dev)
        # the clip covers ring padding past max_len: those positions are
        # mask 0, and their embedding never reaches the pool
        pos_ids = torch.clamp(pos, 0, cfg.max_len - 1).to(dev)
        xd = F.embedding(ids_d, W[d]["tok_emb.weight"]).to(dtype)
        x.append(xd + W[d]["pos_emb.weight"].to(dtype)[pos_ids][None])
        m.append(_on_device(mask, pos, dev).float())

    for li in range(cfg.n_layers):
        pre = f"blocks.{li}."
        hs = [_layer_norm(x[d], W[d][pre + "ln1.scale"],
                          W[d][pre + "ln1.bias"]) for d in range(nd)]

        def heads(d, name):
            h = hs[d]
            y = torch.matmul(h, W[d][pre + name + ".weight"].to(dtype).t())
            return (y.view(B, h.shape[1], H, Dh).permute(0, 2, 1, 3)
                    + W[d][pre + name + ".bias"].to(dtype)
                    .view(H, Dh)[None, :, None, :])

        o = _ring_attention(mesh, [heads(d, "attn.query") for d in range(nd)],
                            [heads(d, "attn.key") for d in range(nd)],
                            [heads(d, "attn.value") for d in range(nd)], m, n)
        for d in range(nd):
            w = W[d]
            od = o[d].permute(0, 2, 1, 3).reshape(B, -1, D)
            xd = x[d] + (torch.matmul(od, w[pre + "attn.out.weight"]
                                      .to(dtype).t())
                         + w[pre + "attn.out.bias"].to(dtype))
            h = _layer_norm(xd, w[pre + "ln2.scale"], w[pre + "ln2.bias"])
            h = torch.matmul(h, w[pre + "wi.weight"].to(dtype).t()) \
                + w[pre + "wi.bias"].to(dtype)
            h = F.gelu(h, approximate="tanh")
            h = torch.matmul(h, w[pre + "wo.weight"].to(dtype).t()) \
                + w[pre + "wo.bias"].to(dtype)
            x[d] = xd + h

    # masked mean pool: per-slot partials on each device, gathered on the
    # first in slot order and summed there
    first = mesh.device
    parts, dens = [], []
    for d in range(nd):
        xd = _layer_norm(x[d], W[d]["ln_f.scale"], W[d]["ln_f.bias"])
        Sd = xd.shape[1] // n
        parts.append((xd * m[d][:, :, None].to(xd.dtype))
                     .view(B, Sd, n, D).sum(2))
        dens.append(m[d].view(B, Sd, n).sum(2))
    if nd == 1:
        part, den = parts[0], dens[0]
    else:
        part = torch.stack([parts[mesh.device_of(i)][:, i // nd]
                            .to(first, non_blocking=True)
                            for i in range(S)], 1)
        den = torch.stack([dens[mesh.device_of(i)][:, i // nd]
                           .to(first, non_blocking=True)
                           for i in range(S)], 1)
    num = part.sum(1)
    den = den.sum(1)
    pooled = num / torch.clamp(den, min=1.0)[:, None].to(num.dtype)
    w = W[0]
    z = (torch.matmul(pooled, w["proj.weight"].to(dtype).t())
         + w["proj.bias"].to(dtype)).float()
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                           min=1e-6)


def ring_encode(cfg: DualEncoderConfig, model: DualEncoder, token_ids,
                attn_mask, mesh: ShardMesh) -> torch.Tensor:
    """Sequence-parallel encode: f32[B, embed_dim], unit-norm, equal to
    ``encode(model, ...)`` up to bf16 tolerance, on the mesh's first
    device.

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
        return _forward(cfg, model, ids, msk, mesh)

