"""Host hashing: murmur3 x86 32-bit (Lucene/ES Murmur3 parity), used by
the murmur3 field mapper and by document routing."""
from __future__ import annotations


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
