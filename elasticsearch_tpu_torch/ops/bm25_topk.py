"""Fused dense-impact BM25 top-k: kernel B1 and its plain twin.

Port of ``bm25_dense_topk_pallas`` (elasticsearch_tpu/ops/pallas_kernels.py
:150, dispatched by ``bm25_dense_topk_auto`` :316), fused with the work its
single-query caller did around it: the gather of the query's rows out of
the dense block and the hit count. The CUDA kernel lives in
``csrc/bm25_dense_topk.cu`` (the batched form's tensor-core pass in
``csrc/bm25_tc.cuh``); its note gives the design and the bound.

The function, for qw f32[Q, R], rows i32[R] (rows of the whole block
impact f32[F, D]; a row outside [0, F), -1 by convention, is a pad and is
never read; without rows, all F rows) and mask bool[D]:

    s[q, d] = sum over valid r, in increasing r, of
              bf16(qw[q, r]) * bf16(impact[rows[r], d])   (f32 accumulate)
    s[q, d] = -inf where not mask[d]
    returns the top k of each row as (f32[Q, k], i32[Q, k]), ordered by
    (-value, doc id): among equal scores the lowest doc id wins, which is
    ``lax.top_k``'s tie rule;
    with count=True also total i64[Q]: the docs d with mask[d] where some
    valid row r with qw[q, r] != 0 has impact[rows[r], d] != 0 in f32
    (``ops/scoring.py::dense_presence_count`` over the gathered rows).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from elasticsearch_tpu_torch.utils.shapes import query_slices

#: kernel launches (one per wrapper call that reaches the card)
LAUNCHES = 0


def _row_list(rows, F: int, R: int):
    """The rows as host ints, None for a pad (outside [0, F))."""
    idx = range(R) if rows is None else rows.tolist()
    return [r if 0 <= r < F else None for r in idx]


def bm25_dense_topk_plain(qw: torch.Tensor, impact: torch.Tensor,
                          mask: torch.Tensor, *, k: int, rows=None,
                          count: bool = False):
    """Plain PyTorch twin of the kernel: the bf16-rounded products summed
    in f32 in increasing r over the valid rows (the kernel's order, so the
    two agree bit for bit: bf16 x bf16 products are exact in f32), then a
    STABLE descending sort cut to k; with ``count``, the hit count of the
    f32 rows. ``torch.topk`` leaves tie order unspecified, so it cannot
    stand in for the sort."""
    Q, R = qw.shape
    D = impact.shape[1]
    qb = qw.to(torch.bfloat16).to(torch.float32)
    s = torch.zeros(Q, D, dtype=torch.float32, device=impact.device)
    hit = torch.zeros(Q, D, dtype=torch.bool, device=impact.device)
    for r, row in enumerate(_row_list(rows, impact.shape[0], R)):
        if row is None:
            continue
        x = impact[row]
        s = s + qb[:, r:r + 1] * x.to(torch.bfloat16).to(torch.float32)
        if count:
            hit |= (qw[:, r:r + 1] != 0) & (x != 0)[None, :]
    s = torch.where(mask[None, :], s, torch.full_like(s, float("-inf")))
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    out = (vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous())
    if count:
        return out + ((hit & mask[None, :]).sum(1, dtype=torch.int64),)
    return out


def pack_topk(vals: torch.Tensor, ids: torch.Tensor, total=None):
    """The kernel's packed result i32[Q, 2k + 2] from its parts: per query
    the values' f32 bits, the doc ids, and the total as an int64 (0 when
    None)."""
    Q = vals.shape[0]
    if total is None:
        total = torch.zeros(Q, dtype=torch.int64, device=vals.device)
    return torch.cat([vals.contiguous().view(torch.int32), ids,
                      total.reshape(Q, 1).view(torch.int32)], dim=1)


def unpack_topk(buf, k: int):
    """(vals f32[Q, k], ids i32[Q, k], total i64[Q]) as views of a packed
    result, a tensor or a numpy array."""
    if isinstance(buf, np.ndarray):
        return (buf[:, :k].view(np.float32), buf[:, k:2 * k],
                buf[:, 2 * k:].view(np.int64)[:, 0])
    return (buf[:, :k].view(torch.float32), buf[:, k:2 * k],
            buf[:, 2 * k:].view(torch.int64)[:, 0])


#: the tensor-core pass of the batched form (csrc/bm25_tc.cuh): it takes
#: the all-rows form from TC_MIN_Q queries, for F <= TC_MAX_F rows and
#: k <= TC_MAX_K; other shapes run on the CUDA cores
TC_MIN_Q, TC_MAX_F, TC_MAX_K = 8, 256, 128
#: docs 0 .. TC_SEED_DOCS - 1, scored exactly per query before the pass,
#: seed its shared threshold
TC_SEED_DOCS = 512
#: its tiles of docs
TC_DOCS = 64
#: a block's dynamic shared memory on an H100
SMEM_LIMIT = 232448


def _f32_up(x: np.ndarray) -> np.ndarray:
    """float64 -> the least float32 at or above it."""
    y = x.astype(np.float32)
    low = y.astype(np.float64) < x
    y[low] = np.nextafter(y[low], np.float32(np.inf))
    return y


def rescore_margin(qw: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """f32[Q]: the margin m_q the tensor-core pass allows between its sum
    of a doc in ``tile`` (impact f32[F, n], one tile's columns) and the
    twin's: F * 2^-20 * a_q * M + (a_q + F + F * M * 2^-6) * 2^-120,
    where a_q is the sum of |bf16(qw[q])| and M the largest |bf16 impact|
    of the tile (the note of csrc/bm25_dense_topk.cu derives it). Computed in float64 and
    rounded up; the kernel rounds each of its steps up, so its margin is
    at least this one."""
    F = qw.shape[1]
    a = qw.to(torch.bfloat16).double().abs().sum(1).numpy()
    M = float(tile.to(torch.bfloat16).double().abs().max()) \
        if tile.numel() else 0.0
    m = F * 2.0 ** -20 * a * M + (a + F + F * M * 2.0 ** -6) * 2.0 ** -120
    return torch.from_numpy(_f32_up(m))


def _lib():
    from elasticsearch_tpu_torch.ops.build import library

    lib = library("bm25_dense_topk")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bm25_dense_topk_scratch.argtypes = [i32, i32, i64, i32, i32]
        lib.bm25_dense_topk_scratch.restype = i64
        lib.bm25_dense_topk_plan.argtypes = [i32, i32, i64, i32, i32, vp]
        lib.bm25_dense_topk_plan.restype = None
        lib.bm25_dense_topk.argtypes = [vp, i32, i32, vp, i32, vp, i64, vp,
                                        i32, i32, vp, vp, vp, vp]
        lib.bm25_dense_topk.restype = i32
        lib._typed = True
    return lib


def kernel_plan(Q: int, F: int, D: int, k: int, all_rows: bool = True):
    """The built kernel's plan for one launch (``bm25_dense_topk_plan``)
    on the current card, or None where the CUDA-core pass runs: query rows
    a block (QT), query tiles, blocks a query tile (the grid's x), 64-row
    stages a tile, doc tiles, dynamic shared memory and scratch bytes,
    whether the running lists fit in shared memory, and the ring's slots
    of bf16 values."""
    out = (ctypes.c_longlong * 10)()
    _lib().bm25_dense_topk_plan(Q, F, D, k, int(all_rows), out)
    if not out[0]:
        return None
    return {"QT": out[1], "query_tiles": out[2], "G": out[3],
            "stages": out[4], "tiles": out[5], "smem": out[6],
            "scratch_bytes": 8 * out[7], "lists_in_smem": bool(out[8]),
            "values_stages": out[9]}


def _check_cuda(qw, impact, mask, rows):
    Q, R = qw.shape
    F, D = impact.shape
    tensors = (qw, impact, mask) + (() if rows is None else (rows,))
    if qw.device.type != "cuda" or any(t.device != qw.device
                                       for t in tensors):
        raise ValueError("qw, impact, mask and rows must lie on one CUDA "
                         "device")
    if qw.dtype != torch.float32 or impact.dtype != torch.float32 \
            or mask.dtype != torch.bool \
            or (rows is not None and rows.dtype != torch.int32):
        raise TypeError("expected qw f32, impact f32, mask bool, rows i32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qw, impact, mask and rows must be contiguous")
    if Q < 1 or D >= 2 ** 31 or F >= 2 ** 31:
        raise ValueError(f"kernel takes Q >= 1 and D, F < 2^31, got Q={Q}, "
                         f"D={D}, F={F}")


def _launch(qw, impact, mask, k, rows, count, rescored=None):
    """One launch on the card: the packed i32[Q, 2k + 2] result."""
    global LAUNCHES
    Q, R = qw.shape
    F, D = impact.shape
    lib = _lib()
    dev = qw.device
    with torch.cuda.device(dev):
        n = int(lib.bm25_dense_topk_scratch(Q, F, D, k, int(rows is None)))
        scratch = torch.empty(n, dtype=torch.int64, device=dev)
        buf = torch.empty(Q, 2 * k + 2, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bm25_dense_topk(
            qw.data_ptr(), Q, R, None if rows is None else rows.data_ptr(),
            F, impact.data_ptr(), D, mask.data_ptr(), k, int(count),
            scratch.data_ptr(), buf.data_ptr(),
            None if rescored is None else rescored.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bm25_dense_topk kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return buf


def bm25_dense_topk_rescored(qw: torch.Tensor, impact: torch.Tensor,
                             mask: torch.Tensor, *, k: int,
                             count: bool = True):
    """The all-rows form on the card, once, with the docs each query
    rescored exactly: (packed i32[Q, 2k + 2], rescored i64[Q]; zeros
    where the CUDA-core pass runs). For checks and timings of the
    tensor-core pass's filter; one launch, so at most one slice of
    ``query_slices``."""
    Q, F = qw.shape
    if impact.dim() != 2 or impact.shape[0] != F or mask.dim() != 1 \
            or mask.shape[0] != impact.shape[1]:
        raise ValueError(f"shape mismatch: qw {tuple(qw.shape)}, impact "
                         f"{tuple(impact.shape)}, mask {tuple(mask.shape)}")
    if not 1 <= k <= impact.shape[1] or len(
            query_slices(Q, impact.shape[1], k)) > 1:
        raise ValueError("one launch's rows and 1 <= k <= D expected")
    _check_cuda(qw, impact, mask, None)
    rescored = torch.zeros(Q, dtype=torch.int64, device=qw.device)
    return _launch(qw, impact, mask, k, None, count, rescored), rescored


def bm25_dense_topk(qw: torch.Tensor, impact: torch.Tensor,
                    mask: torch.Tensor, *, k: int, rows=None,
                    count: bool = False, packed: bool = False,
                    plain: bool = False):
    """Top-k of the masked bf16 dense-impact product (see module doc).

    Returns (vals, ids), with ``count`` (vals, ids, total); with
    ``packed`` the one i32[Q, 2k + 2] buffer those are views of instead
    (``unpack_topk`` splits it), so that a caller moves all of it to the
    host in one copy. CPU tensors take the plain twin. CUDA tensors launch
    the kernel, or raise; ``plain=True`` runs the twin on the card
    instead, for checks that compare the two. More query rows than one
    launch takes run as one launch per slice of ``query_slices``."""
    if qw.dim() != 2 or impact.dim() != 2 or mask.dim() != 1:
        raise ValueError("expected qw [Q, R], impact [F, D], mask [D]")
    Q, R = qw.shape
    F, D = impact.shape
    if rows is None and R != F:
        raise ValueError(f"shape mismatch: qw {tuple(qw.shape)}, impact "
                         f"{tuple(impact.shape)}, mask {tuple(mask.shape)}")
    if rows is not None and (rows.dim() != 1 or rows.shape[0] != R):
        raise ValueError(f"expected rows [{R}], got {tuple(rows.shape)}")
    if mask.shape[0] != D:
        raise ValueError(f"shape mismatch: qw {tuple(qw.shape)}, impact "
                         f"{tuple(impact.shape)}, mask {tuple(mask.shape)}")
    if not 1 <= k <= D:
        raise ValueError(f"k must be in [1, {D}], got {k}")
    parts = query_slices(Q, D, k)
    if len(parts) > 1:
        outs = [bm25_dense_topk(qw[a:b], impact, mask, k=k, rows=rows,
                                count=count, packed=packed, plain=plain)
                for a, b in parts]
        if packed:
            return torch.cat(outs)
        return tuple(torch.cat(x) for x in zip(*outs))
    if qw.device.type == "cpu" or plain:
        res = bm25_dense_topk_plain(qw, impact, mask, k=k, rows=rows,
                                    count=count)
        return pack_topk(*res) if packed else res
    _check_cuda(qw, impact, mask, rows)
    buf = _launch(qw, impact, mask, k, rows, count)
    if packed:
        return buf
    vals, ids, total = unpack_topk(buf, k)
    return (vals, ids, total) if count else (vals, ids)
