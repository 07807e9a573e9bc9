"""Fused dense-vector kNN top-k: kernel B2 and its plain twin.

Port of ``knn_topk_pallas`` (elasticsearch_tpu/ops/pallas_kernels.py:39,
dispatched by ``knn_topk_auto`` :537). The CUDA kernel lives in
``csrc/knn_topk.cu``; its note gives the design and the bound.

The function, for queries f32[Q, dims], vecs f32[D, dims], mask bool[D]:

    cosine: queries and each corpus row normalised (x / max(|x|, 1e-12))
    q . v in f32, with both operands rounded to bf16 unless ``precise``
    cosine, dot_product: (1 + s) / 2
    l2_norm: 1 / (1 + max(|q|^2 - 2 s + |v|^2, 0)), |q|^2 of the
             (rounded) query, |v|^2 of the f32 row
    -inf where not mask; the top k of each row as (f32[Q, k], i32[Q, k])
    ordered by (-value, doc id): ``lax.top_k``'s tie rule.

Slots past the live docs hold -inf; their ids are masked docs and mean
nothing. There is no shape gate: the kernel takes any dims and 1 <= k <=
D (the TPU dispatcher sent k > 64 or dims % 128 != 0 to XLA), and any Q:
the wrapper launches it once per slice of query rows that its grid and
scratch hold (``utils/shapes.py::query_slices``).
"""
from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.utils.shapes import query_slices

#: kernel launches (one per wrapper call that reaches the card)
LAUNCHES = 0

METRICS = {"cosine": 0, "dot_product": 1, "dot": 1, "l2_norm": 2, "l2": 2}

_U64_AS_I64 = torch.int64  # scratch holds 64-bit keys; only the bits matter

#: the kernel's staging modes (csrc/knn_topk.cu)
TENSOR, ASYNC4, DIRECT = 0, 1, 2
#: shared-memory bytes of the kernel's ring of row stages. Eight queries
#: at a time (Q >= 8): one block per SM, whose 227 KiB less the chunk's
#: 2048 sort keys (16 KiB), eight running lists of 128 keys (8 KiB), the
#: slots' mbarriers and counters (512 B) and the chunk's eight scores per
#: thread (64 KiB) hold the ring. One query: two blocks per SM (each 228
#: KiB / 2 less the 1 KiB the card reserves per block, its keys, one
#: running list and the counters), which the card times faster at Q = 1.
RING_BYTES = 232_448 - 16_384 - 8_192 - 512 - 65_536
RING_BYTES_ONE = 233_472 // 2 - 1_024 - 16_384 - 1_024 - 512
MAX_ROWS, MAX_SLOTS = 64, 16
#: widest box row of a tensor copy, in floats
MAX_BOX = 256


def stage_plan(dims: int, aligned: bool, queries: int = 8):
    """(mode, rows per stage, slots, row stride in floats) of the kernel's
    ring for ``queries`` queries (its budget: ``RING_BYTES``, or
    ``RING_BYTES_ONE`` below eight). Rows of a multiple of 4 floats on a 16-byte aligned slab, padded
    to an odd count of 16-byte pieces that fits a tensor copy's box, are
    staged by one tensor copy per stage (TENSOR); other slabs by 4-byte
    copies (ASYNC4), padded to an odd count of floats. Odd strides keep a
    warp's reads of its 32 rows on distinct banks. Rows per stage: the
    largest power of two up to 64 of which four stages fit in the
    budget (wide rows take fewer); slots: as many stages as fit, at most
    16. Rows so wide that two stages of one row do not fit are
    not staged (DIRECT)."""
    ring = RING_BYTES if queries >= 8 else RING_BYTES_ONE
    tensor = dims % 4 == 0 and aligned and ((dims // 4) | 1) * 4 <= MAX_BOX
    stride = ((dims // 4) | 1) * 4 if tensor else dims | 1
    rows = MAX_ROWS
    while rows > 1 and 4 * rows * stride * 4 > ring:
        rows //= 2
    slots = min(MAX_SLOTS, ring // (rows * stride * 4))
    if slots < 2:
        return DIRECT, 0, 0, 0
    return (TENSOR if tensor else ASYNC4), rows, slots, stride


def _metric_code(metric: str) -> int:
    try:
        return METRICS[metric]
    except KeyError:
        raise ValueError(f"unknown knn metric [{metric}]") from None


def prepare_queries(queries: torch.Tensor, metric: str, precise: bool):
    """(qh f32[Q, dims], q2 f32[Q]) as the kernel takes them: the query
    normalised for cosine, rounded to bf16 unless ``precise``, and the
    sum of its squares (the l2 term, of the rounded query as on the TPU).
    Shared by the kernel and its twin, so both see the same bits."""
    q = queries.to(torch.float32)
    if _metric_code(metric) == 0:
        n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        q = q / torch.clamp(n, min=1e-12)
    if not precise:
        q = q.to(torch.bfloat16).to(torch.float32)
    q = q.contiguous()
    return q, torch.sum(q * q, dim=-1).contiguous()


def knn_scores_plain(qh: torch.Tensor, q2: torch.Tensor, vecs: torch.Tensor,
                     metric: str, precise: bool) -> torch.Tensor:
    """f32[Q, D] scores of prepared queries against the slab, each sum in
    increasing dims with one rounding per product and per add (the
    kernel's arithmetic, so the two agree bit for bit)."""
    code = _metric_code(metric)
    vt = vecs.to(torch.float32).t().contiguous()  # [dims, D]
    D = vt.shape[1]
    den = None
    if code == 0:
        v2 = torch.zeros(D, dtype=torch.float32, device=vt.device)
        for j in range(vt.shape[0]):
            v2 = v2 + vt[j] * vt[j]
        den = torch.clamp(torch.sqrt(v2), min=1e-12)
    s = torch.zeros(qh.shape[0], D, dtype=torch.float32, device=vt.device)
    v2 = torch.zeros(D, dtype=torch.float32, device=vt.device)
    for j in range(vt.shape[0]):
        x = vt[j]
        if code == 2:
            v2 = v2 + x * x
        if den is not None:
            x = x / den
        if not precise:
            x = x.to(torch.bfloat16).to(torch.float32)
        s = s + qh[:, j:j + 1] * x[None, :]
    if code == 2:
        d2 = torch.clamp((q2[:, None] - 2.0 * s) + v2[None, :], min=0.0)
        return torch.ones_like(d2) / (d2 + 1.0)
    return (s + 1.0) * 0.5


def knn_topk_plain(queries: torch.Tensor, vecs: torch.Tensor,
                   mask: torch.Tensor, *, k: int, metric: str = "cosine",
                   precise: bool = False):
    """Plain PyTorch twin of the kernel: the kernel's scores, then a
    STABLE descending sort cut to k (``torch.topk`` leaves tie order
    unspecified)."""
    qh, q2 = prepare_queries(queries, metric, precise)
    s = knn_scores_plain(qh, q2, vecs, metric, precise)
    s = torch.where(mask[None, :], s, torch.full_like(s, float("-inf")))
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def _lib():
    from elasticsearch_tpu_torch.ops.build import library

    lib = library("knn_topk")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.knn_topk_scratch.argtypes = [i32, i64, i32]
        lib.knn_topk_scratch.restype = i64
        lib.knn_topk.argtypes = [vp, vp, i32, i32, vp, i64, vp, i32, i32,
                                 i32, i32, i32, i32, i32, vp, vp, vp, vp, vp]
        lib.knn_topk.restype = i32
        lib._typed = True
    return lib


def knn_topk(queries: torch.Tensor, vecs: torch.Tensor, mask: torch.Tensor,
             *, k: int, metric: str = "cosine", precise: bool = False,
             plain: bool = False):
    """Top-k of the masked similarity row of each query (see module doc).

    CPU tensors take the plain twin. CUDA tensors launch the kernel, or
    raise; ``plain=True`` runs the twin on the card instead, for checks
    that compare the two. More query rows than one launch takes run as
    one launch per slice of ``query_slices``."""
    if queries.dim() != 2 or vecs.dim() != 2 or mask.dim() != 1:
        raise ValueError("expected queries [Q, dims], vecs [D, dims], "
                         "mask [D]")
    Q, dims = queries.shape
    D = vecs.shape[0]
    if vecs.shape[1] != dims or mask.shape[0] != D:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"vecs {tuple(vecs.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if not 1 <= k <= D:
        raise ValueError(f"k must be in [1, {D}], got {k}")
    code = _metric_code(metric)
    parts = query_slices(Q, D, k)
    if len(parts) > 1:
        outs = [knn_topk(queries[a:b], vecs, mask, k=k, metric=metric,
                         precise=precise, plain=plain) for a, b in parts]
        return tuple(torch.cat(x) for x in zip(*outs))
    if queries.device.type == "cpu" or plain:
        return knn_topk_plain(queries, vecs, mask, k=k, metric=metric,
                              precise=precise)
    if queries.device.type != "cuda" or vecs.device != queries.device \
            or mask.device != queries.device:
        raise ValueError("queries, vecs and mask must lie on one CUDA device")
    if vecs.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("expected vecs f32 and mask bool")
    if not (vecs.is_contiguous() and mask.is_contiguous()):
        raise ValueError("vecs and mask must be contiguous")
    if Q < 1 or D >= 2 ** 31 or dims < 1:
        raise ValueError(f"kernel takes Q >= 1, dims >= 1 and D < 2^31, "
                         f"got Q={Q}, dims={dims}, D={D}")
    qh, q2 = prepare_queries(queries, metric, precise)
    if qh.data_ptr() % 16:  # the kernel reads query rows as float4s
        qh = qh.clone()
    mode, rows, slots, stride = stage_plan(dims, vecs.data_ptr() % 16 == 0,
                                           Q)
    lib = _lib()
    n = int(lib.knn_topk_scratch(Q, D, k))
    dev = queries.device
    scratch_a = torch.empty(n, dtype=_U64_AS_I64, device=dev)
    scratch_b = torch.empty(n, dtype=_U64_AS_I64, device=dev)
    vals = torch.empty(Q, k, dtype=torch.float32, device=dev)
    ids = torch.empty(Q, k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn_topk(qh.data_ptr(), q2.data_ptr(), Q, dims,
                           vecs.data_ptr(), D, mask.data_ptr(), code,
                           int(bool(precise)), k, mode, rows, slots, stride,
                           scratch_a.data_ptr(),
                           scratch_b.data_ptr(), vals.data_ptr(),
                           ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_topk kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return vals, ids
