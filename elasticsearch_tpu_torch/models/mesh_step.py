"""The contrastive train step over a ``('dp', 'tp')`` training mesh.

Port of what the reference's jitted step does under ``training_mesh(n)``
with ``param_shardings`` and ``batch_sharding`` (GSPMD's tensor-parallel
all-reduces and the data-parallel gradient psum), written out as one
autograd graph across the mesh's devices (``parallel/mesh.py``):

- Position ``(g, r)`` (data-parallel group g, tensor-parallel rank r)
  owns its own parameter leaves on ``mesh.device_of(g, r)``: the rank's
  slice of each tensor-parallel parameter and a whole copy of the rest.
  The slices are the reference's rules (``dual_encoder._RULES``):
  q/k/v and ``wi`` hold their rows of the ``nn.Linear`` weight and bias
  (whole heads), ``out`` and ``wo`` their input columns, the embeddings
  their ``d_model`` columns; LayerNorms and ``proj`` are whole. A dim
  the axis does not divide stays whole (the reference's per-dim
  fallback), and that layer runs whole on every rank.
- The forward is the Megatron pattern: the embedding slices gathered
  into ``[b, L, d_model]`` on rank 0 and copied to every rank; column-
  parallel outputs stay local; the row-parallel partial products,
  computed in f32 from the compute dtype's operands, are summed in rank
  order on rank 0, cast once, and copied to every rank before the bias
  and the residual. Rank 0 pools and projects.
- The batch splits over 'dp' in contiguous rows; each group encodes its
  rows, and every group's query and passage embeddings are gathered in
  dp order on the first device, so the loss is the reference's global
  in-batch InfoNCE over the whole batch.
- The collectives are ``torch.autograd.Function``s (:class:`_Broadcast`,
  :class:`_SumTo`, :class:`_Gather`) whose backward passes sum in rank
  order, so no gradient depends on which device's thread ran first.
  After ``backward`` every parameter slice's gradient is summed over the
  positions that hold it (the dp replicas, and the tp ranks for a whole
  one), in position order on the first holder's device, and copied back
  to each; then AdamW, elementwise, updates every leaf as the one-device
  step updates the whole tensor.

The exchange is ``.to(device)`` copies and sums, not NCCL: a device list
may name one device several times (``utils/device.py``), and the
payloads are one model's activations and gradients.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from elasticsearch_tpu_torch.models import dual_encoder as de


class _Broadcast(torch.autograd.Function):
    """``x`` copied to each of ``devices``; the backward pass sums the
    copies' gradients in rank order on ``x``'s device."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.set_materialize_grads(False)
        ctx.src = x.device
        return tuple(x.view_as(x) if d == x.device
                     else x.to(d, non_blocking=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        acc = None
        for g in grads:
            if g is None:
                continue
            g = g.to(ctx.src, non_blocking=True)
            acc = g if acc is None else acc + g
        return acc, None


class _SumTo(torch.autograd.Function):
    """The sum of ``xs``, each moved to ``device``, in rank order; the
    backward pass copies the gradient to each input's device."""

    @staticmethod
    def forward(ctx, device, *xs):
        ctx.devices = [x.device for x in xs]
        acc = xs[0].to(device, non_blocking=True)
        for x in xs[1:]:
            acc = acc + x.to(device, non_blocking=True)
        return acc

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g.to(d, non_blocking=True)
                               for d in ctx.devices)


class _Gather(torch.autograd.Function):
    """``xs`` concatenated along ``dim`` on ``device``, in rank order; the
    backward pass sends each part's slice of the gradient to its
    device."""

    @staticmethod
    def forward(ctx, device, dim, *xs):
        ctx.dim = dim
        ctx.devices = [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        return torch.cat([x.to(device, non_blocking=True) for x in xs], dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.split(g, ctx.sizes, ctx.dim)
        return (None, None) + tuple(p.to(d, non_blocking=True)
                                    for p, d in zip(parts, ctx.devices))


def split_dims(cfg: de.DualEncoderConfig, tp: int
               ) -> Dict[str, Optional[int]]:
    """Per state-dict name, the dim of the ``nn.Linear``/embedding tensor
    split over 'tp' (None: whole on every rank). The reference's rules:
    the embeddings when tp divides d_model, attention when it divides the
    heads, the MLP when it divides d_ff."""
    emb = tp > 1 and cfg.d_model % tp == 0
    attn = tp > 1 and cfg.n_heads % tp == 0
    mlp = tp > 1 and cfg.d_ff % tp == 0
    out: Dict[str, Optional[int]] = {}
    for _path, name, _kind in de._layout(cfg):
        dim = None
        if name in ("tok_emb.weight", "pos_emb.weight"):
            dim = 1 if emb else None
        elif ".attn." in name:
            if name.endswith("out.weight"):
                dim = 1 if attn else None
            elif not name.endswith("out.bias"):
                dim = 0 if attn else None  # q/k/v weight and bias
        elif ".wi." in name:
            dim = 0 if mlp else None
        elif name.endswith("wo.weight"):
            dim = 1 if mlp else None
        out[name] = dim
    return out


class MeshTrainStep:
    """``step(q_ids, q_mask, d_ids, d_mask)`` -> the global loss (a 0-d
    tensor on ``mesh.device``): one symmetric InfoNCE update of the
    sharded model. ``shards[g][r]`` is position (g, r)'s ``{name: leaf}``
    on its device; ``model`` gathers the shards into a whole
    ``DualEncoder`` on the first device, on demand (for ``encode``,
    ``params_to_flax`` and ``save_checkpoint``)."""

    def __init__(self, cfg: de.DualEncoderConfig, model: de.DualEncoder,
                 mesh, lr: float):
        self.cfg = cfg
        self.mesh = mesh
        self.dims = split_dims(cfg, mesh.tp)
        full = {k: v.detach() for k, v in model.state_dict().items()}
        self.shards: List[List[Dict[str, torch.Tensor]]] = []
        for g in range(mesh.dp):
            row = []
            for r in range(mesh.tp):
                dev = mesh.device_of(g, r)
                leaves = {}
                for name, t in full.items():
                    d = self.dims[name]
                    if d is not None:
                        t = torch.chunk(t, mesh.tp, d)[r]
                    leaf = t.to(dev, copy=True).contiguous()
                    leaf.requires_grad_(True)
                    leaf.grad = torch.zeros_like(leaf)
                    leaves[name] = leaf
                row.append(leaves)
            self.shards.append(row)
        # the slices' holders, in position order: a split tensor's rank-r
        # slice is held by every group's rank r, a whole one by all
        self._holders: List[List[torch.Tensor]] = []
        for name, d in self.dims.items():
            if d is None:
                self._holders.append([self.shards[g][r][name]
                                      for g in range(mesh.dp)
                                      for r in range(mesh.tp)])
            else:
                self._holders += [[self.shards[g][r][name]
                                   for g in range(mesh.dp)]
                                  for r in range(mesh.tp)]
        self.opt = de.make_optimizer(
            [p for row in self.shards for sh in row for p in sh.values()],
            lr)

    # -- the sharded forward ------------------------------------------------

    def _row_parallel(self, g: int, parts: Sequence[torch.Tensor]
                      ) -> tuple:
        """f32 partial products summed in rank order on rank 0, cast once
        to the compute dtype, copied to every rank of group g."""
        devs = self.mesh.grid[g]
        y = _SumTo.apply(devs[0], *parts).to(self.cfg.dtype)
        return _Broadcast.apply(y, devs)

    def _encode(self, g: int, ids: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        """Group g's embeddings f32[b, E] of its rows, on its rank 0: the
        model's layer loop (``dual_encoder._encode_ranks``) over the
        group's ranks, the embedding columns gathered and the row-parallel
        partials summed across them."""
        devs = self.mesh.grid[g]
        return de._encode_ranks(
            self.cfg, self.shards[g],
            [ids.to(d, non_blocking=True) for d in devs],
            [mask.to(d, non_blocking=True) for d in devs], self.dims,
            gather=lambda xs: _Broadcast.apply(
                _Gather.apply(devs[0], -1, *xs), devs),
            row_sum=lambda parts: self._row_parallel(g, parts))

    def _embeddings(self, ids: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
        """Every group's rows encoded, gathered in dp order: f32[B, E] on
        the first device."""
        b = ids.shape[0] // self.mesh.dp
        parts = [self._encode(g, ids[g * b:(g + 1) * b],
                              mask[g * b:(g + 1) * b])
                 for g in range(self.mesh.dp)]
        return _Gather.apply(self.mesh.device, 0, *parts)

    # -- the step -----------------------------------------------------------

    def __call__(self, q_ids, q_mask, d_ids, d_mask) -> torch.Tensor:
        dev = self.mesh.device
        q_ids = de._as_tensor(q_ids, dev, torch.long)
        q_mask = de._as_tensor(q_mask, dev, torch.float32)
        d_ids = de._as_tensor(d_ids, dev, torch.long)
        d_mask = de._as_tensor(d_mask, dev, torch.float32)
        B = q_ids.shape[0]
        if B % self.mesh.dp:
            raise ValueError(f"batch {B} does not divide dp={self.mesh.dp}")
        de._check_len(self.cfg, q_ids.shape[1])
        de._check_len(self.cfg, d_ids.shape[1])
        de._first_touch(
            "dual_encoder.train_step",
            f"{B}x{q_ids.shape[1]}x{d_ids.shape[1]}/{self.cfg.dtype}/"
            f"dp={self.mesh.dp},tp={self.mesh.tp}")
        self.opt.zero_grad(set_to_none=False)
        loss = de.contrastive_loss(self._embeddings(q_ids, q_mask),
                                   self._embeddings(d_ids, d_mask))
        loss.backward()
        self._sum_gradients()
        self.opt.step()
        return loss.detach()

    @torch.no_grad()
    def _sum_gradients(self) -> None:
        """Each slice's gradient summed over its holders in position
        order on the first holder's device, then copied to every
        holder: the fixed-order all-reduce."""
        for holders in self._holders:
            if len(holders) < 2:
                continue
            first = holders[0].grad
            acc = first.clone()
            for p in holders[1:]:
                acc += p.grad.to(first.device, non_blocking=True)
            for p in holders:
                p.grad.copy_(acc, non_blocking=True)

    # -- the whole model ----------------------------------------------------

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The gathered parameters on the first device: group 0's slices
        concatenated in rank order."""
        dev = self.mesh.device
        out = {}
        for name, d in self.dims.items():
            row = self.shards[0]
            if d is None:
                out[name] = row[0][name].detach().to(dev, copy=True)
            else:
                out[name] = torch.cat([sh[name].detach().to(dev)
                                       for sh in row], d)
        return out

    @property
    def model(self) -> de.DualEncoder:
        """A whole ``DualEncoder`` of the current parameters on the first
        device, gathered on each access."""
        model = de.DualEncoder(self.cfg).to(self.mesh.device)
        model.load_state_dict(self.state_dict())
        return model
