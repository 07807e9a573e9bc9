"""SBERT-style dual encoder for dense retrieval.

Port of elasticsearch_tpu/models/dual_encoder.py. The model generates
`dense_vector` embeddings for hybrid BM25 + kNN search: passages are
encoded at index time into a segment's vector slab, queries at search
time, and B2 (``ops/knn_topk.py``) scores them.

- One shared transformer tower: f32 parameters, activations in the
  config's dtype (bf16 by default), a masked mean pool and an
  L2-normalised projection, so cosine similarity is a plain product.
- In-batch contrastive training (symmetric InfoNCE): every (query,
  positive) pair uses the rest of the batch as negatives.

The forward mirrors flax's numerics, not PyTorch's defaults: LayerNorm
takes f32 statistics with the fast variance ``E[x^2] - E[x]^2`` and eps
1e-6; gelu is the tanh form; attention masks with the dtype's most
negative finite value and softmaxes in the compute dtype, so a padded
query row attends uniformly and the pool drops it (``-inf`` would make
it NaN and poison the pool); Dense and Embed cast their f32 parameters
to the compute dtype before the product; the pool divides in the
compute dtype and the projection is cast to f32 before the normalise.

The parameters carry across from the reference in process
(``params_from_flax``/``params_to_flax``); checkpoints are torch's format
(``save_checkpoint``), not orbax's.
"""
from __future__ import annotations

import math
import os
import re
import zlib
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticsearch_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6  # flax LayerNorm's epsilon


@dataclass
class DualEncoderConfig:
    vocab_size: int = 8192
    max_len: int = 128
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024
    embed_dim: int = 128
    dtype: torch.dtype = torch.bfloat16  # the compute dtype; params are f32


def config_to_dict(cfg: DualEncoderConfig) -> Dict[str, Any]:
    """The config with its dtype as a name (``"bfloat16"``)."""
    out = {f.name: getattr(cfg, f.name) for f in fields(cfg)}
    out["dtype"] = str(cfg.dtype).replace("torch.", "")
    return out


def config_from_dict(d: Dict[str, Any]) -> DualEncoderConfig:
    d = dict(d)
    d["dtype"] = getattr(torch, d.get("dtype") or "bfloat16")
    return DualEncoderConfig(**d)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            dtype) -> torch.Tensor:
    """flax Dense: the f32 kernel and bias cast to ``dtype``, the product
    rounded, then the bias added."""
    return torch.matmul(x, weight.to(dtype).t()) + bias.to(dtype)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """flax LayerNorm: f32 statistics, fast variance clipped at 0, eps
    1e-6, the scale folded into the reciprocal, the output in the input's
    dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    mu2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * scale
    return ((xf - mu) * mul + bias).to(x.dtype)


def _embed(ids: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
           dtype) -> torch.Tensor:
    """Token plus position embeddings in the compute dtype (of whichever
    ``d_model`` columns the tables hold)."""
    x = F.embedding(ids, tok).to(dtype)
    return x + pos[:ids.shape[1]].to(dtype)[None]


def _self_mask(m: torch.Tensor) -> torch.Tensor:
    """bool[B, 1, L, L]: a query and a key both unmasked."""
    return (m[:, None, None, :] * m[:, None, :, None]) > 0


def _attend(h: torch.Tensor, q_w, q_b, k_w, k_b, v_w, v_b, heads: int,
            mask: torch.Tensor, dtype) -> torch.Tensor:
    """Softmax attention of ``heads`` heads whose q/k/v rows the weights
    hold: ``[B, L, heads * Dh]`` before the out projection."""
    B, L, _ = h.shape
    Dh = q_w.shape[0] // heads
    q = _linear(h, q_w, q_b, dtype).view(B, L, heads, Dh)
    k = _linear(h, k_w, k_b, dtype).view(B, L, heads, Dh)
    v = _linear(h, v_w, v_b, dtype).view(B, L, heads, Dh)
    # flax divides by sqrt(depth) rounded to the compute dtype
    q = q / torch.tensor(math.sqrt(Dh), dtype=dtype).item()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s = torch.where(mask, s, torch.finfo(dtype).min)
    # jax.nn.softmax: the max is held out of the gradient
    e = torch.exp(s - s.amax(-1, keepdim=True).detach())
    w = e / e.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, heads * Dh)


def _pool_project(x: torch.Tensor, m: torch.Tensor, ln_scale, ln_bias,
                  proj_w, proj_b, dtype) -> torch.Tensor:
    """The final LayerNorm, the masked mean pool (dividing in the compute
    dtype) and the L2-normalised projection, f32[B, E]."""
    x = _layer_norm(x, ln_scale, ln_bias)
    denom = torch.clamp(m.sum(1, keepdim=True), min=1.0)
    pooled = (x * m[:, :, None].to(x.dtype)).sum(1) / denom.to(x.dtype)
    z = _linear(pooled, proj_w, proj_b, dtype).float()
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                           min=1e-6)


def _encode_ranks(cfg: "DualEncoderConfig", P: Sequence[Dict[str, Any]],
                  ids: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                  dims: Dict[str, Optional[int]], gather=None,
                  row_sum=None) -> torch.Tensor:
    """The encoder forward over the tensor-parallel ranks of one group,
    f32[B, E] on rank 0's device. ``P[r]`` maps the state dict's names to
    rank r's tensors and ``ids[r]``/``masks[r]`` are its inputs on its
    device; ``dims`` gives a name's split dim (absent or None: whole on
    every rank). ``gather(xs)`` turns the ranks' embedding columns into
    every rank's whole ``[B, L, d_model]``; ``row_sum(parts)`` sums the
    row-parallel f32 partials and gives every rank the sum in the
    compute dtype. One rank with nothing split is the one-device model
    (:meth:`DualEncoder.forward`); ``models/mesh_step.py`` passes the
    rest."""
    dtype, tp = cfg.dtype, len(P)
    ms = [m.float() for m in masks]
    sa = [_self_mask(m) for m in ms]
    xs = [_embed(ids[r], P[r]["tok_emb.weight"], P[r]["pos_emb.weight"],
                 dtype) for r in range(tp)]
    if dims.get("tok_emb.weight") is not None:
        xs = gather(xs)
    heads = cfg.n_heads // tp if dims.get(
        "blocks.0.attn.query.weight") is not None else cfg.n_heads

    def residual(xs, hs, pre, name):
        """x + the (row-parallel) projection ``name`` of hs."""
        wn, bn = pre + name + ".weight", pre + name + ".bias"
        if dims.get(wn) is None:
            return [xs[r] + _linear(hs[r], P[r][wn], P[r][bn], dtype)
                    for r in range(tp)]
        ys = row_sum([torch.matmul(hs[r].float(),
                                   P[r][wn].to(dtype).float().t())
                      for r in range(tp)])
        return [xs[r] + (ys[r] + P[r][bn].to(dtype)) for r in range(tp)]

    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        os_ = []
        for r in range(tp):
            w = P[r]
            h = _layer_norm(xs[r], w[pre + "ln1.scale"], w[pre + "ln1.bias"])
            os_.append(_attend(
                h, w[pre + "attn.query.weight"], w[pre + "attn.query.bias"],
                w[pre + "attn.key.weight"], w[pre + "attn.key.bias"],
                w[pre + "attn.value.weight"], w[pre + "attn.value.bias"],
                heads, sa[r], dtype))
        xs = residual(xs, os_, pre, "attn.out")
        hs = [F.gelu(_linear(
            _layer_norm(xs[r], P[r][pre + "ln2.scale"],
                        P[r][pre + "ln2.bias"]),
            P[r][pre + "wi.weight"], P[r][pre + "wi.bias"], dtype),
            approximate="tanh") for r in range(tp)]
        xs = residual(xs, hs, pre, "wo")
    w = P[0]
    return _pool_project(xs[0], ms[0], w["ln_f.scale"], w["ln_f.bias"],
                         w["proj.weight"], w["proj.bias"], dtype)


class LayerNorm(nn.Module):
    """flax LayerNorm's parameters (:func:`_layer_norm`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Attention(nn.Module):
    """flax MultiHeadDotProductAttention's parameters (:func:`_attend`).
    The q/k/v kernels ``[D, H, Dh]`` are ``nn.Linear(D, H*Dh)`` and the
    out kernel ``[H, Dh, D]`` is ``nn.Linear(H*Dh, D)``."""

    def __init__(self, d_model: int):
        super().__init__()
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)


class Block(nn.Module):
    """Pre-LN attention and MLP, each with its residual: the parameters
    (the order is :func:`_encode_ranks`')."""

    def __init__(self, cfg: DualEncoderConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model)
        self.attn = Attention(cfg.d_model)
        self.ln2 = LayerNorm(cfg.d_model)
        self.wi = nn.Linear(cfg.d_model, cfg.d_ff)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model)


class DualEncoder(nn.Module):
    """``forward(token_ids int[B, L], attn_mask [B, L]) -> f32[B, E]``,
    unit-norm; L <= ``cfg.max_len``."""

    def __init__(self, cfg: DualEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model)
        self.proj = nn.Linear(cfg.d_model, cfg.embed_dim)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.weight.device

    def forward(self, token_ids: torch.Tensor, attn_mask: torch.Tensor
                ) -> torch.Tensor:
        _check_len(self.cfg, token_ids.shape[1])
        return _encode_ranks(self.cfg, [dict(self.named_parameters())],
                             [token_ids], [attn_mask], {})


def _check_len(cfg: DualEncoderConfig, L: int) -> None:
    if L > cfg.max_len:
        raise ValueError(f"sequence {L} exceeds cfg.max_len {cfg.max_len}")


def build_model(cfg: DualEncoderConfig) -> DualEncoder:
    return DualEncoder(cfg)


def init_params(cfg: DualEncoderConfig, seed: int = 0,
                device=None) -> DualEncoder:
    """A model with flax's initialisers, drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and moved to ``device`` (the
    card unless the caller passes ``"cpu"``): lecun-normal kernels (a
    normal truncated at two deviations, scaled to variance 1/fan_in),
    zero biases, unit LayerNorm scales, normal embeddings of variance
    1/d_model. The same seed gives the same weights on any device; they
    are not flax's random stream."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    model = DualEncoder(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                # flax's variance_scaling(1, fan_in, truncated_normal):
                # 0.8796... is the std of a normal truncated at +-2
                std = math.sqrt(1.0 / mod.in_features) / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, math.sqrt(1.0 / cfg.d_model),
                                   generator=gen)
    return model.to(dev)


def _first_touch(program: str, shapes: str) -> None:
    """The model's first dispatch of a key counts as a first touch, as a
    search program's does (``monitor/programs.py::timed``)."""
    from elasticsearch_tpu_torch.monitor.programs import backend_fingerprint
    from elasticsearch_tpu_torch.tracing import retrace

    retrace.first_dispatch((program, shapes, backend_fingerprint()))


def _as_tensor(x, dev, dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(dev, dtype)


def _as_inputs(model: DualEncoder, token_ids, attn_mask
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (_as_tensor(token_ids, model.device, torch.long),
            _as_tensor(attn_mask, model.device, torch.float32))


def encode(model: DualEncoder, token_ids, attn_mask) -> torch.Tensor:
    """f32[B, embed_dim], unit-norm, on the model's device; the inputs may
    be numpy arrays or tensors."""
    ids, mask = _as_inputs(model, token_ids, attn_mask)
    _first_touch("dual_encoder.encode",
                 f"{ids.shape[0]}x{ids.shape[1]}/{model.cfg.dtype}")
    with torch.no_grad():
        return model(ids, mask)


class SimpleTokenizer:
    """Hash-vocabulary tokenizer (no vocabulary files). Bucket ids come
    from crc32, stable across processes (Python's ``hash()`` is salted
    per process), so passages indexed by one server encode identically
    after a restart and in the reference."""

    def __init__(self, cfg: DualEncoderConfig):
        self.cfg = cfg

    def bucket(self, token: str) -> int:
        return (zlib.crc32(token.encode("utf-8"))
                % (self.cfg.vocab_size - 1)) + 1

    def __call__(self, texts, max_len: Optional[int] = None):
        L = max_len or self.cfg.max_len
        ids = np.zeros((len(texts), L), np.int32)
        mask = np.zeros((len(texts), L), np.float32)
        for i, t in enumerate(texts):
            toks = t.lower().split()[:L]
            for j, tok in enumerate(toks):
                ids[i, j] = self.bucket(tok)
            mask[i, : len(toks)] = 1.0
        return ids, mask


# ---------------------------------------------------------------------------
# the reference's parameter tree
# ---------------------------------------------------------------------------

def _layout(cfg: DualEncoderConfig):
    """(flax path, port name, kind) of every parameter. Kinds: ``copy``;
    ``dense`` (a ``[in, out]`` kernel, transposed for ``nn.Linear``);
    ``qkv`` (``[D, H, Dh]``), ``qkv_bias`` (``[H, Dh]``) and ``out``
    (``[H, Dh, D]``), flattened over the heads."""
    rows = [("tok_emb/embedding", "tok_emb.weight", "copy"),
            ("pos_emb/embedding", "pos_emb.weight", "copy")]
    for i in range(cfg.n_layers):
        f, p = f"block_{i}", f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            rows += [(f"{f}/{ln}/scale", f"{p}.{ln}.scale", "copy"),
                     (f"{f}/{ln}/bias", f"{p}.{ln}.bias", "copy")]
        for name in ("query", "key", "value"):
            rows += [(f"{f}/attn/{name}/kernel", f"{p}.attn.{name}.weight",
                      "qkv"),
                     (f"{f}/attn/{name}/bias", f"{p}.attn.{name}.bias",
                      "qkv_bias")]
        rows += [(f"{f}/attn/out/kernel", f"{p}.attn.out.weight", "out"),
                 (f"{f}/attn/out/bias", f"{p}.attn.out.bias", "copy")]
        for name in ("wi", "wo"):
            rows += [(f"{f}/{name}/kernel", f"{p}.{name}.weight", "dense"),
                     (f"{f}/{name}/bias", f"{p}.{name}.bias", "copy")]
    rows += [("ln_f/scale", "ln_f.scale", "copy"),
             ("ln_f/bias", "ln_f.bias", "copy"),
             ("proj/kernel", "proj.weight", "dense"),
             ("proj/bias", "proj.bias", "copy")]
    return rows


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def params_from_flax(tree, cfg: DualEncoderConfig) -> Dict[str, torch.Tensor]:
    """The reference's param tree (nested dicts of arrays, with or without
    the ``"params"`` level) as this module's f32 state dict, for
    ``model.load_state_dict``."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for path, name, kind in _layout(cfg):
        a = np.asarray(_get(p, path), np.float32)
        if kind == "dense":
            a = a.T
        elif kind == "qkv":
            a = a.reshape(a.shape[0], -1).T
        elif kind == "qkv_bias":
            a = a.reshape(-1)
        elif kind == "out":
            a = a.reshape(-1, a.shape[-1]).T
        out[name] = torch.from_numpy(np.array(a, np.float32))
    return out


def params_to_flax(model: DualEncoder) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: ``{"params": tree}`` of
    numpy f32 arrays in the reference's layout."""
    cfg = model.cfg
    H, D = cfg.n_heads, cfg.d_model
    sd = model.state_dict()
    root: Dict[str, Any] = {}
    for path, name, kind in _layout(cfg):
        a = sd[name].detach().float().cpu().numpy()
        if kind == "dense":
            a = a.T
        elif kind == "qkv":
            a = a.T.reshape(D, H, D // H)
        elif kind == "qkv_bias":
            a = a.reshape(H, D // H)
        elif kind == "out":
            a = a.T.reshape(H, D // H, a.shape[0])
        node = root
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": root}


# ---------------------------------------------------------------------------
# sharding rules (dp x tp) as data
# ---------------------------------------------------------------------------

# flax path regex -> the kernel's axes. Column-parallel (output dim on
# 'tp'): q/k/v, mlp wi, the embeddings' model dim. Row-parallel (input dim
# on 'tp'): attention out, mlp wo. models/mesh_step.py::split_dims slices
# the port's tensors by the same rules.
_RULES = [
    (r"tok_emb.*embedding$", (None, "tp")),
    (r"pos_emb.*embedding$", (None, "tp")),
    (r"attn/(query|key|value).*kernel$", (None, "tp")),
    (r"attn/out.*kernel$", ("tp", None)),
    (r"wi/kernel$", (None, "tp")),
    (r"wo/kernel$", ("tp", None)),
    (r"proj/kernel$", (None, None)),
]


def _spec_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, axes in _RULES:
        if re.search(pat, path):
            if len(axes) == ndim:
                return axes
            if ndim > len(axes):
                # attn kernels are [d_model, heads, head_dim]: 'tp' goes on
                # the heads dim (column-parallel) or the leading dim
                # (row-parallel out projection), the rest replicated
                if axes == (None, "tp"):
                    return tuple([None] * (ndim - 2) + ["tp", None])
                if axes == ("tp", None):
                    return tuple(["tp"] + [None] * (ndim - 1))
            return (None,) * ndim
    return (None,) * ndim


def param_shardings(mesh, model: DualEncoder
                    ) -> Dict[str, Tuple[Optional[str], ...]]:
    """flax path -> the axis of each dim of the reference's kernel
    (``'tp'`` or None) under ``mesh``; a dim the axis does not divide
    falls back to replication."""
    out = {}
    for path, a in _flat(params_to_flax(model)["params"]):
        spec = _spec_for(path, a.ndim)
        out[path] = tuple(
            ax if ax is None or a.shape[d] % mesh.shape[ax] == 0 else None
            for d, ax in enumerate(spec))
    return out


def batch_sharding(mesh) -> Tuple[str]:
    """A batch splits its leading dim over 'dp'."""
    return ("dp",)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def contrastive_loss(q_emb: torch.Tensor, d_emb: torch.Tensor,
                     scale: float = 20.0) -> torch.Tensor:
    """Symmetric in-batch InfoNCE over L2-normalised embeddings."""
    logits = q_emb @ d_emb.T * scale  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (_xent(logits, labels) + _xent(logits.T, labels))


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    mx = logits.max(-1, keepdim=True).values
    logz = torch.log(torch.sum(torch.exp(logits - mx), dim=-1)) + mx[:, 0]
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def make_optimizer(params, lr: float = 1e-3) -> torch.optim.AdamW:
    """optax ``adamw(lr, weight_decay=0.01)``: betas 0.9/0.999, eps 1e-8,
    the decay on every parameter (no mask: LayerNorm and biases too)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def make_train_step(cfg: DualEncoderConfig, lr: float = 1e-3,
                    model: Optional[DualEncoder] = None, mesh=None,
                    device=None):
    """``(step, opt)``: ``step(q_ids, q_mask, d_ids, d_mask)`` runs one
    symmetric InfoNCE update with autograd and returns the loss (a 0-d
    tensor). Without ``model`` one is drawn by :func:`init_params` (seed
    0) on ``device``, or on the mesh's first device.

    Under a ``training_mesh`` of more than one position the step is
    ``models/mesh_step.py::MeshTrainStep``: ``model``'s parameters are
    sliced onto the positions' devices, the batch splits over 'dp' (it
    must divide dp, as the reference's sharded batch must), the loss is
    the global in-batch InfoNCE, and ``step.model`` gathers the shards
    into a whole model on demand. Without a mesh, or under
    ``training_mesh(1)``, the step updates ``step.model`` (``model``
    itself) on its device. A mesh brings its own devices: ``device``
    with a mesh is refused."""
    if mesh is not None and device is not None:
        raise ValueError("make_train_step: the mesh places the step; "
                         "pass no device with it")
    if mesh is not None and mesh.dp * mesh.tp > 1:
        from elasticsearch_tpu_torch.models.mesh_step import MeshTrainStep

        if model is None:
            model = init_params(cfg, device=mesh.device)
        step = MeshTrainStep(cfg, model, mesh, lr)
        return step, step.opt
    if model is None:
        model = init_params(cfg, device=mesh.device if mesh is not None
                            else device)
    opt = make_optimizer(model.parameters(), lr)

    def step(q_ids, q_mask, d_ids, d_mask) -> torch.Tensor:
        q_ids, q_mask = _as_inputs(model, q_ids, q_mask)
        d_ids, d_mask = _as_inputs(model, d_ids, d_mask)
        B = q_ids.shape[0]
        _first_touch("dual_encoder.train_step",
                     f"{B}x{q_ids.shape[1]}x{d_ids.shape[1]}/{cfg.dtype}")
        opt.zero_grad(set_to_none=True)
        loss = contrastive_loss(model(q_ids, q_mask), model(d_ids, d_mask))
        loss.backward()
        opt.step()
        return loss.detach()

    step.model = model
    return step, opt


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, model: DualEncoder, opt=None, step: int = 0,
                    cfg: Optional[DualEncoderConfig] = None) -> None:
    """Params, step, optimizer state and config in one ``torch.save``
    file (the reference writes an orbax directory)."""
    payload: Dict[str, Any] = {
        "params": {k: v.detach().cpu() for k, v in
                   model.state_dict().items()},
        "step": int(step)}
    if opt is not None:
        payload["opt_state"] = opt.state_dict()
    if cfg is not None:
        payload["config"] = config_to_dict(cfg)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """-> {"params", "step", "opt_state"?, "config"?}; tensors only, no
    pickled code (``weights_only=True``)."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
