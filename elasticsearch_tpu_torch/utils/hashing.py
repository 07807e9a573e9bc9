"""Shared hashing utilities.

- ``murmur3_32``: murmur3 x86 32-bit over utf-8 (Lucene/ES Murmur3 parity;
  the murmur3 field mapper, routing and keyword cardinality).
- ``hash32_device``: the 32-bit integer mix of numeric HyperLogLog values,
  on tensors.
- ``hll_update_host``: fold 32-bit hashes into HyperLogLog registers on
  the host.
"""
from __future__ import annotations

import numpy as np
import torch

HLL_BITS = 12
HLL_M = 1 << HLL_BITS

_MASK32 = 0xFFFFFFFF


def routing_hash(s: str) -> int:
    """Reference Murmur3HashFunction.hash(String): murmurhash3_x86_32 over
    the UTF-16LE bytes of the routing key, seed 0, as a SIGNED 32-bit int
    (OperationRouting then takes MathUtils.mod == Python's %). Distinct
    from ``murmur3_32``: the murmur3 FIELD MAPPER hashes UTF-8 bytes."""
    h = murmur3_32(s, encoding="utf-16-le")
    return h - (1 << 32) if h >= (1 << 31) else h


def murmur3_32(s: str, seed: int = 0, encoding: str = "utf-8") -> int:
    data = s.encode(encoding)
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data) // 4 * 4
    for i in range(0, n, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[n:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 tensors h in [0, 2^32): the product is
    split at h's 16th bit, so no partial product reaches 2^63."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * (c & 0xFFFF)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def hash32_device(x):
    """32-bit integer mix on a tensor of any integer dtype: the value's
    low 32 bits (two's complement, as a uint32 cast takes them), then
    multiply, xor-shift, multiply, xor-shift, each mod 2^32. Returns the
    hashes as int64 in [0, 2^32): PyTorch's uint32 has few ops, so the mix
    runs in int64 and masks to 32 bits after each step."""
    h = x.to(torch.int64) & _MASK32
    h = _mul32(h, 2654435761)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x45D9F3B)
    return h ^ (h >> 16)


def hll_update_host(registers: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    """Fold uint32 hashes into HLL registers (numpy, vectorized)."""
    if hashes.size == 0:
        return registers
    h = hashes.astype(np.uint32)
    reg = (h >> (32 - HLL_BITS)).astype(np.int64)
    rest = (h << HLL_BITS).astype(np.uint32)
    with np.errstate(divide="ignore"):
        lz = np.where(rest > 0, 31 - np.floor(np.log2(rest.astype(np.float64))).astype(np.int64), 32)
    rank = np.clip(lz + 1, 1, 32 - HLL_BITS + 1)
    np.maximum.at(registers, reg, rank.astype(registers.dtype))
    return registers
