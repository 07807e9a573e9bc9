"""PQ asymmetric-distance table-sum (ADC): kernel B3 and its plain twin.

Port of ``adc_scores_pallas`` (elasticsearch_tpu/ops/pallas_kernels.py
:415, gate ``adc_pallas_tile`` :469). The CUDA kernel lives in
``csrc/adc_scores.cu``; its note gives the design and the bound.

The function, for codes u8[W, M] and a lookup table lut f32[M, K]:

    out[w] = sum over m, in increasing m, of lut[m, codes[w, m]]   (f32)

The TPU kernel adds one one-hot product per m, which is the same sum, so
kernel, twin and ``adc_scores_pallas`` agree bit for bit. The reference's
XLA form ``adc_sum`` may sum in another order. There is no gate (any W,
M and K <= 256) and no failure latch: on the card the kernel launches or
the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

#: kernel launches (one per wrapper call that reaches the card)
LAUNCHES = 0


def adc_scores_plain(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: the gathered table entries added in increasing
    m, one f32 rounding per add (the kernel's order)."""
    idx = codes.to(torch.int64)
    acc = torch.zeros(codes.shape[0], dtype=torch.float32, device=lut.device)
    for m in range(codes.shape[1]):
        acc = acc + lut[m][idx[:, m]]
    return acc


def _lib():
    from elasticsearch_tpu_torch.ops.build import library

    lib = library("adc_scores")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.adc_scores.argtypes = [vp, i64, i32, i32, vp, vp, i32, vp]
        lib.adc_scores.restype = i32
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def adc_scores(codes: torch.Tensor, lut: torch.Tensor, *,
               plain: bool = False) -> torch.Tensor:
    """Coarse ADC scores f32[W] (see module doc).

    CPU tensors take the plain twin. CUDA tensors launch the kernel, or
    raise; ``plain=True`` runs the twin on the card instead, for checks
    that compare the two. The kernel reads uint8 codes."""
    if codes.dim() != 2 or lut.dim() != 2:
        raise ValueError("expected codes [W, M] and lut [M, K]")
    W, M = codes.shape
    K = lut.shape[1]
    if lut.shape[0] != M:
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, lut "
                         f"{tuple(lut.shape)}")
    if M < 1 or not 1 <= K <= 256:
        raise ValueError(f"expected M >= 1 and 1 <= K <= 256, got M={M}, "
                         f"K={K}")
    if codes.device.type == "cpu" or plain:
        return adc_scores_plain(codes, lut)
    if codes.device.type != "cuda" or lut.device != codes.device:
        raise ValueError("codes and lut must lie on one CUDA device")
    if codes.dtype != torch.uint8 or lut.dtype != torch.float32:
        raise TypeError("expected codes u8 and lut f32")
    if not (codes.is_contiguous() and lut.is_contiguous()):
        raise ValueError("codes and lut must be contiguous")
    dev = codes.device
    out = torch.empty(W, dtype=torch.float32, device=dev)
    if W == 0:
        return out
    lib = _lib()
    n_sms = _sm_count(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adc_scores(codes.data_ptr(), W, M, K, lut.data_ptr(),
                             out.data_ptr(), n_sms, stream)
    if err != 0:
        raise RuntimeError(f"adc_scores kernel launch failed: CUDA error "
                           f"{err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
