"""Product quantization: PQ-coded vector slabs and asymmetric distance.

Port of elasticsearch_tpu/ops/pq.py. The build splits ``dims`` into M
subspaces of ``dsub`` dims, trains K centroids per subspace (squared-l2
k-means, ``ops/ivf.kmeans``) and encodes every slab row into M uint8
codes. A query builds one M x K lookup table of partial similarities
(``adc_lut``; ``adc_luts`` for every token of a MaxSim re-rank, which
kernel B4 reads); a candidate's coarse score is the sum of its M table
entries (kernel B3, ``ops/adc.py``; the reference's XLA form is
``adc_sum``). Coarse scores only rank: the IVF fine stage re-scores the
survivors exactly.

Metric mapping: cosine encodes the l2-normalised rows and normalises the
query in the LUT; dot_product uses the raw query; l2_norm's LUT is
``2 q_m . c - |c|^2``, monotone in ``-|q_m - c|^2``.

The build runs on the slab's device and is deterministic (as
``kmeans``). ``place_pq`` registers the code array as a best-effort,
evictable ``fielddata`` handle with its host mirror
(``resources/residency.py``); readers take ``PqIndex.codes_dev()``, which
rehydrates it after an eviction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

#: encode-time chunk: bounds the [chunk, M, K] affinity
_ENCODE_CHUNK = 16384
#: fewest live vectors worth a codebook (below, exact scoring wins)
_MIN_TRAIN = 128
#: k-means iterations per subspace
_ITERS = 6


def pq_layout(dims: int) -> Tuple[int, int]:
    """(M subspaces, dsub dims each) for a vector field: dsub >= 4 with M
    at most 32, tiny dims down to dsub 2, then a single subspace."""
    for M in (32, 16, 8, 4, 2):
        if dims % M == 0 and dims // M >= 4:
            return M, dims // M
    for M in (16, 8, 4, 2):
        if dims % M == 0 and dims // M >= 2:
            return M, dims // M
    return 1, dims


def pq_codebook_size(n_train: int) -> int:
    """K for n_train live vectors: 256 when the slab affords it, else the
    largest power of two keeping >= 8 training vectors per codeword."""
    if n_train >= 2048:
        return 256
    k = 1 << max(int(np.floor(np.log2(max(n_train // 8, 1)))), 0)
    return max(min(k, 256), 1)


@dataclass
class PqHostParts:
    """Build output before placement: codebooks and codes as tensors on
    the build's device (or carried across by ``index/convert.py``).
    Placement, and its breaker charge, stays with the caller, so a
    denial can retry later without training again."""

    codebooks: Any  # f32[M, K, dsub]
    codes: Any  # u8[max_docs, M]
    M: int
    K: int
    dsub: int
    dims: int
    metric: str


@dataclass
class PqIndex:
    """The PQ tier of one immutable vector slab on the device."""

    codebooks: Any  # f32[M, K, dsub], always resident
    codes: Any  # ResidentArray of u8[max_docs, M] (evictable fielddata)
    M: int
    K: int
    dsub: int
    dims: int
    metric: str

    @property
    def codes_host(self) -> np.ndarray:
        return self.codes.host

    def codes_dev(self) -> torch.Tensor:
        """The device code array, rehydrating an evicted handle."""
        return self.codes.get()


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-12)


def train_pq(train: torch.Tensor, M: int, K: int) -> torch.Tensor:
    """Per-subspace k-means codebooks f32[M, K, dsub] over the live
    training rows (already normalised for cosine). Subspace clustering is
    always squared-l2; the similarity shapes the LUT instead."""
    from elasticsearch_tpu_torch.ops.ivf import kmeans

    dims = train.shape[1]
    dsub = dims // M
    books = torch.empty(M, K, dsub, dtype=torch.float32, device=train.device)
    for m in range(M):
        sub = train[:, m * dsub:(m + 1) * dsub].contiguous()
        cents, _ = kmeans(sub, K, iters=_ITERS, metric="l2")
        if cents.shape[0] < K:  # tiny training set: repeat-pad codewords
            reps = -(-K // cents.shape[0])
            cents = cents.repeat(reps, 1)[:K]
        books[m] = cents
    return books


def pq_encode(vecs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """u8[N, M] codes for every slab row: the nearest codeword of each
    subspace by the norm expansion (argmax x.c - |c|^2 / 2, first among
    equals), over chunks of rows."""
    M, _K, dsub = codebooks.shape
    N = vecs.shape[0]
    half_sq = 0.5 * torch.sum(codebooks * codebooks, dim=-1)  # [M, K]
    out = torch.empty(N, M, dtype=torch.uint8, device=vecs.device)
    for s in range(0, N, _ENCODE_CHUNK):
        x = vecs[s:s + _ENCODE_CHUNK].reshape(-1, M, dsub)
        aff = torch.einsum("nmd,mkd->nmk", x, codebooks) - half_sq[None]
        out[s:s + _ENCODE_CHUNK] = torch.argmax(aff, dim=2).to(torch.uint8)
    return out


def build_pq(vecs: torch.Tensor, exists: torch.Tensor,
             metric: str) -> Optional[PqHostParts]:
    """Train and encode the PQ tier for one frozen slab on its device,
    with ``pq_layout`` subspaces and ``pq_codebook_size`` codewords. None
    (declined) below 128 live vectors."""
    ids = torch.nonzero(exists).flatten()
    n = int(ids.numel())
    if n < _MIN_TRAIN:
        return None
    dims = vecs.shape[1]
    M, dsub = pq_layout(dims)
    K = pq_codebook_size(n)
    slab = vecs.to(torch.float32)
    if metric == "cosine":
        # encode the directions: the table-sum then approximates cos(q, v)
        slab = _normalize_rows(slab)
    books = train_pq(slab[ids], M, K)
    return PqHostParts(codebooks=books, codes=pq_encode(slab, books), M=M,
                       K=K, dsub=dsub, dims=dims, metric=metric)


def place_pq(parts: PqHostParts, residency,
             label: str = "pq") -> Optional[PqIndex]:
    """Place a built PQ tier on ``residency``'s device: the code array an
    evictable ``fielddata`` handle, best-effort (a denial returns None:
    PQ only accelerates, the caller keeps the exact path and a later
    query retries), the small codebooks always resident. Codes built on
    the device are adopted as the first copy; the handle keeps a host
    mirror for rehydration. A failure to place the codebooks closes the
    codes handle before it propagates, so no charge is stranded."""
    codes = parts.codes
    placed = codes if isinstance(codes, torch.Tensor) else None
    handle = residency.put_array(codes, label=f"{label}.codes",
                                 best_effort=True, placed=placed)
    if handle is None:
        return None
    try:
        books = residency.device_put(parts.codebooks)
    except BaseException:
        handle.close()
        raise
    return PqIndex(codebooks=books, codes=handle, M=parts.M, K=parts.K,
                   dsub=parts.dsub, dims=parts.dims, metric=parts.metric)


def adc_lut(query: torch.Tensor, codebooks: torch.Tensor,
            metric: str) -> torch.Tensor:
    """f32[M, K] partial-similarity lookup table for one query; higher is
    better for every metric (ranking proxies, not ES scores)."""
    q = query.to(torch.float32)
    if metric == "cosine":
        q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    M, _K, dsub = codebooks.shape
    lut = torch.einsum("md,mkd->mk", q.reshape(M, dsub), codebooks)
    if metric in ("l2_norm", "l2"):
        lut = 2.0 * lut - torch.sum(codebooks * codebooks, dim=-1)
    return lut.contiguous()


def adc_luts(tokens: torch.Tensor, codebooks: torch.Tensor,
             metric: str) -> torch.Tensor:
    """f32[T, M, K]: ``adc_lut`` of every query token at once, one einsum
    over the tokens (the reference vmaps ``adc_lut``). The layout kernel
    B4 (``ops/maxsim_adc.py``) reads."""
    q = tokens.to(torch.float32)
    if metric == "cosine":
        n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        q = q / torch.clamp(n, min=1e-12)
    M, _K, dsub = codebooks.shape
    luts = torch.einsum("tmd,mkd->tmk", q.reshape(q.shape[0], M, dsub),
                        codebooks)
    if metric in ("l2_norm", "l2"):
        luts = 2.0 * luts - torch.sum(codebooks * codebooks, dim=-1)[None]
    return luts.contiguous()


def adc_sum(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The reference's XLA form of the table-sum: one [W, M] gather and a
    row sum, in the reduction's own order. The IVF-PQ path runs kernel B3
    (``ops/adc.py``) instead."""
    M = lut.shape[0]
    idx = codes.to(torch.int64)
    return torch.sum(lut[torch.arange(M, device=lut.device)[None, :], idx],
                     dim=1)
