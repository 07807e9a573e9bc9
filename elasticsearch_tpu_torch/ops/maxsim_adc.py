"""MaxSim over PQ codes: kernel B4 and its plain twin.

Port of ``maxsim_adc_pallas`` (elasticsearch_tpu/ops/pallas_kernels.py
:585, dispatcher ``maxsim_adc_auto`` :701). The CUDA kernel lives in
``csrc/maxsim_adc.cu``; its note gives the design and the bound.

The function, for the window's codes u8[W, M] and one ADC lookup table
per query token, luts f32[T, M, K] (``ops/pq.py::adc_luts``):

    acc[t, w] = sum over m, in increasing m, of luts[t, m, codes[w, m]]
    out[w]    = max over t of acc[t, w]                            (f32)

The TPU kernel adds one one-hot product per m, which is the same sum, so
kernel, twin and ``maxsim_adc_pallas`` agree bit for bit. Its token
padding (-1e30 columns, ``t_real``) existed for Mosaic's sublane tiling
and is gone: T is any count. A NaN sum wins the max, as
``torch.maximum`` has it. There is no gate (any W, M and K <= 256) and no
failure latch: on the card the kernel launches or the wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

#: kernel launches (one per wrapper call that reaches the card; the
#: fold of the token groups' maxima is part of that one call)
LAUNCHES = 0

#: shared-memory bytes of token tables one block of the kernel stages
GROUP_BYTES = 32 * 1024
#: widest code row the grouped kernel keeps in registers
REG_CODES = 32


def plan(W: int, M: int, K: int, T: int):
    """(tokens per group, groups, scratch floats) of the kernel's launch:
    as many tokens per group as fit in ``GROUP_BYTES`` of tables (at
    least one), and an f32[groups, W] scratch for the groups' maxima
    when there is more than one group. Rows wider than ``REG_CODES``
    take the one-launch wide kernel: one group, no scratch."""
    if M > REG_CODES:
        return T, 1, 0
    gt = max(1, min(T, GROUP_BYTES // (M * K * 4)))
    groups = -(-T // gt)
    return gt, groups, groups * W if groups > 1 else 0


def maxsim_adc_plain(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: each token's gathered table entries added in
    increasing m with one f32 rounding per add, then the token sums
    folded in increasing t with ``torch.maximum`` (the kernel's order)."""
    idx = codes.to(torch.int64)
    T, M = luts.shape[0], luts.shape[1]
    acc = torch.zeros(T, codes.shape[0], dtype=torch.float32,
                      device=luts.device)
    for m in range(M):
        acc = acc + luts[:, m][:, idx[:, m]]
    best = acc[0]
    for t in range(1, T):
        best = torch.maximum(best, acc[t])
    return best


def _lib():
    from elasticsearch_tpu_torch.ops.build import library

    lib = library("maxsim_adc")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.maxsim_adc.argtypes = [vp, i64, i32, i32, i32, vp, i32, vp, vp,
                                   vp]
        lib.maxsim_adc.restype = i32
        lib._typed = True
    return lib


def maxsim_adc(codes: torch.Tensor, luts: torch.Tensor, *,
               plain: bool = False) -> torch.Tensor:
    """MaxSim ADC scores f32[W] (see module doc).

    CPU tensors take the plain twin. CUDA tensors launch the kernel, or
    raise; ``plain=True`` runs the twin on the card instead, for checks
    that compare the two. The kernel reads uint8 codes."""
    if codes.dim() != 2 or luts.dim() != 3:
        raise ValueError("expected codes [W, M] and luts [T, M, K]")
    W, M = codes.shape
    T, K = luts.shape[0], luts.shape[2]
    if luts.shape[1] != M:
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, luts "
                         f"{tuple(luts.shape)}")
    if M < 1 or T < 1 or not 1 <= K <= 256:
        raise ValueError(f"expected M >= 1, T >= 1 and 1 <= K <= 256, got "
                         f"M={M}, T={T}, K={K}")
    if codes.device.type == "cpu" or plain:
        return maxsim_adc_plain(codes, luts)
    if codes.device.type != "cuda" or luts.device != codes.device:
        raise ValueError("codes and luts must lie on one CUDA device")
    if codes.dtype != torch.uint8 or luts.dtype != torch.float32:
        raise TypeError("expected codes u8 and luts f32")
    if not (codes.is_contiguous() and luts.is_contiguous()):
        raise ValueError("codes and luts must be contiguous")
    dev = codes.device
    out = torch.empty(W, dtype=torch.float32, device=dev)
    if W == 0:
        return out
    gt, _groups, n_scratch = plan(W, M, K, T)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.maxsim_adc(codes.data_ptr(), W, M, K, T, luts.data_ptr(),
                             gt, scratch.data_ptr() if n_scratch else None,
                             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"maxsim_adc kernel launch failed: CUDA error "
                           f"{err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
