"""PQ asymmetric-distance table-sum (ADC): kernel B3 and its plain twin.

Port of ``adc_scores_pallas`` (elasticsearch_tpu/ops/pallas_kernels.py
:415, gate ``adc_pallas_tile`` :469), fused with the gather and mask its
caller (``ops/ivf.py::ivf_pq_search``) did around it. The CUDA kernel
lives in ``csrc/adc_scores.cu``; its note gives the design and the bound.

The function, for codes u8[N, M] (a segment's whole code table), an
optional candidate list cand i32[W] (doc ids; one outside [0, N) is a
pad), optional packed filter words i32[N / 32] (``ops/bitvec.py``'s
layout) and a lookup table lut f32[M, K]:

    id     = cand[w], or w without cand
    out[w] = sum over m, in increasing m, of lut[m, codes[id, m]]   (f32)
    out[w] = -inf where id is a pad or its filter bit is clear

Without cand and filter it is the table-sum the TPU kernel computes. The
TPU kernel adds one one-hot product per m, which is the same sum, so
kernel, twin and ``adc_scores_pallas`` agree bit for bit. The reference's
XLA form ``adc_sum`` may sum in another order. There is no gate (any W, N,
M and K <= 256) and no failure latch: on the card the kernel launches or
the wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.ops.bitvec import test_bits

#: kernel launches (one per wrapper call that reaches the card)
LAUNCHES = 0


def adc_scores_plain(codes: torch.Tensor, lut: torch.Tensor, cand=None,
                     filter_words=None) -> torch.Tensor:
    """Plain PyTorch twin: the candidates' code rows gathered, their table
    entries added in increasing m, one f32 rounding per add (the kernel's
    order), then -inf at pads and filtered slots."""
    N = codes.shape[0]
    ok = None
    if cand is not None or filter_words is not None:
        ids = (torch.arange(N, device=codes.device) if cand is None
               else cand.to(torch.int64))
        ok = (ids >= 0) & (ids < N)
        safe = torch.where(ok, ids, torch.zeros_like(ids))
        if filter_words is not None:
            ok = ok & test_bits(filter_words, safe)
        codes = codes[safe]
    idx = codes.to(torch.int64)
    acc = torch.zeros(codes.shape[0], dtype=torch.float32, device=lut.device)
    for m in range(codes.shape[1]):
        acc = acc + lut[m][idx[:, m]]
    if ok is not None:
        acc = torch.where(ok, acc, torch.full_like(acc, float("-inf")))
    return acc


def _lib():
    from elasticsearch_tpu_torch.ops.build import library

    lib = library("adc_scores")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.adc_scores.argtypes = [vp, i64, i32, i32, vp, vp, i64, vp, vp,
                                   vp]
        lib.adc_scores.restype = i32
        lib._typed = True
    return lib


def adc_scores(codes: torch.Tensor, lut: torch.Tensor, *, cand=None,
               filter_words=None, plain: bool = False) -> torch.Tensor:
    """Coarse ADC scores f32[W] (see module doc).

    CPU tensors take the plain twin. CUDA tensors launch the kernel, or
    raise; ``plain=True`` runs the twin on the card instead, for checks
    that compare the two. The kernel reads uint8 codes."""
    if codes.dim() != 2 or lut.dim() != 2:
        raise ValueError("expected codes [N, M] and lut [M, K]")
    N, M = codes.shape
    K = lut.shape[1]
    if lut.shape[0] != M:
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, lut "
                         f"{tuple(lut.shape)}")
    if M < 1 or not 1 <= K <= 256:
        raise ValueError(f"expected M >= 1 and 1 <= K <= 256, got M={M}, "
                         f"K={K}")
    if cand is not None and cand.dim() != 1:
        raise ValueError(f"expected cand [W], got {tuple(cand.shape)}")
    if filter_words is not None and (filter_words.dim() != 1
                                     or filter_words.shape[0] * 32 < N):
        raise ValueError(f"expected filter words [{-(-N // 32)}], got "
                         f"{tuple(filter_words.shape)}")
    if codes.device.type == "cpu" or plain:
        return adc_scores_plain(codes, lut, cand, filter_words)
    extra = tuple(t for t in (cand, filter_words) if t is not None)
    if codes.device.type != "cuda" or any(
            t.device != codes.device for t in (lut,) + extra):
        raise ValueError("codes, lut, cand and filter words must lie on one "
                         "CUDA device")
    if codes.dtype != torch.uint8 or lut.dtype != torch.float32 \
            or any(t.dtype != torch.int32 for t in extra):
        raise TypeError("expected codes u8, lut f32, cand and filter words "
                        "i32")
    if not all(t.is_contiguous() for t in (codes, lut) + extra):
        raise ValueError("codes, lut, cand and filter words must be "
                         "contiguous")
    dev = codes.device
    W = N if cand is None else cand.shape[0]
    out = torch.empty(W, dtype=torch.float32, device=dev)
    if W == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adc_scores(
            codes.data_ptr(), N, M, K,
            None if cand is None else cand.data_ptr(),
            None if filter_words is None else filter_words.data_ptr(),
            W, lut.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"adc_scores kernel launch failed: CUDA error "
                           f"{err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
