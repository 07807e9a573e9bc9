"""Fused dense-impact BM25 top-k: kernel B1 and its plain twin.

Port of ``bm25_dense_topk_pallas`` (elasticsearch_tpu/ops/pallas_kernels.py
:150, dispatched by ``bm25_dense_topk_auto`` :316). The CUDA kernel lives
in ``csrc/bm25_dense_topk.cu``; its note gives the design and the bound.

The function, for qw f32[Q, F], impact f32[F, D], mask bool[D]:

    s[q, d] = sum_f bf16(qw[q, f]) * bf16(impact[f, d])   (f32 accumulate)
    s[q, d] = -inf where not mask[d]
    returns the top k of each row as (f32[Q, k], i32[Q, k]), ordered by
    (-value, doc id): among equal scores the lowest doc id wins, which is
    ``lax.top_k``'s tie rule.
"""
from __future__ import annotations

import ctypes

import torch

#: kernel launches (one per wrapper call that reaches the card)
LAUNCHES = 0

_U64_AS_I64 = torch.int64  # scratch holds 64-bit keys; only the bits matter


def bm25_dense_topk_plain(qw: torch.Tensor, impact: torch.Tensor,
                          mask: torch.Tensor, *, k: int):
    """Plain PyTorch twin of the kernel: the bf16-rounded product summed
    in f32 in increasing f (the kernel's order, so the two agree bit for
    bit: bf16 x bf16 products are exact in f32), then a STABLE descending
    sort cut to k. ``torch.topk`` leaves tie order unspecified, so it
    cannot stand in for the sort."""
    qb = qw.to(torch.bfloat16).to(torch.float32)
    ib = impact.to(torch.bfloat16).to(torch.float32)
    s = torch.zeros(qw.shape[0], impact.shape[1], dtype=torch.float32,
                    device=impact.device)
    for f in range(qw.shape[1]):
        s = s + qb[:, f:f + 1] * ib[f]
    s = torch.where(mask[None, :], s, torch.full_like(s, float("-inf")))
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def _lib():
    from elasticsearch_tpu_torch.ops.build import library

    lib = library("bm25_dense_topk")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bm25_dense_topk_scratch.argtypes = [i32, i64, i32]
        lib.bm25_dense_topk_scratch.restype = i64
        lib.bm25_dense_topk.argtypes = [vp, i32, i32, vp, i64, vp, i32, vp,
                                        vp, vp, vp, vp]
        lib.bm25_dense_topk.restype = i32
        lib._typed = True
    return lib


def bm25_dense_topk(qw: torch.Tensor, impact: torch.Tensor,
                    mask: torch.Tensor, *, k: int, plain: bool = False):
    """Top-k of the masked bf16 dense-impact product (see module doc).

    CPU tensors take the plain twin. CUDA tensors launch the kernel, or
    raise; ``plain=True`` runs the twin on the card instead, for checks
    that compare the two."""
    if qw.dim() != 2 or impact.dim() != 2 or mask.dim() != 1:
        raise ValueError("expected qw [Q, F], impact [F, D], mask [D]")
    Q, F = qw.shape
    D = impact.shape[1]
    if impact.shape[0] != F or mask.shape[0] != D:
        raise ValueError(f"shape mismatch: qw {tuple(qw.shape)}, impact "
                         f"{tuple(impact.shape)}, mask {tuple(mask.shape)}")
    if not 1 <= k <= D:
        raise ValueError(f"k must be in [1, {D}], got {k}")
    if qw.device.type == "cpu" or plain:
        return bm25_dense_topk_plain(qw, impact, mask, k=k)
    if qw.device.type != "cuda" or impact.device != qw.device \
            or mask.device != qw.device:
        raise ValueError("qw, impact and mask must lie on one CUDA device")
    if qw.dtype != torch.float32 or impact.dtype != torch.float32 \
            or mask.dtype != torch.bool:
        raise TypeError("expected qw f32, impact f32, mask bool")
    if not (qw.is_contiguous() and impact.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("qw, impact and mask must be contiguous")
    if Q < 1 or Q > 65535 or D >= 2 ** 31:
        raise ValueError(f"kernel takes 1 <= Q <= 65535 and D < 2^31, got "
                         f"Q={Q}, D={D}")
    lib = _lib()
    n = int(lib.bm25_dense_topk_scratch(Q, D, k))
    dev = qw.device
    scratch_a = torch.empty(n, dtype=_U64_AS_I64, device=dev)
    scratch_b = torch.empty(n, dtype=_U64_AS_I64, device=dev)
    vals = torch.empty(Q, k, dtype=torch.float32, device=dev)
    ids = torch.empty(Q, k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bm25_dense_topk(qw.data_ptr(), Q, F, impact.data_ptr(), D,
                                  mask.data_ptr(), k, scratch_a.data_ptr(),
                                  scratch_b.data_ptr(), vals.data_ptr(),
                                  ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bm25_dense_topk kernel launch failed: CUDA "
                           f"error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return vals, ids
