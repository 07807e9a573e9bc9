"""Packed bit-vectors for kNN pre-filters.

Port of elasticsearch_tpu/ops/bitvec.py. A bool[D] mask packs into D/32
words, 32 docs per word: bit ``d & 31`` of word ``d >> 5`` is doc d. The
reference keeps uint32 words; PyTorch has few uint32 ops, so the port
keeps the same bits in int32 words. A right shift of an int32 is
arithmetic (a set top bit sign-extends), so every test of a bit masks
with ``& 1`` after the shift.
"""
from __future__ import annotations

import torch


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool[D] -> int32[D // 32] (bit i of word w is doc w * 32 + i). D
    must be a multiple of 32, as every segment's max_docs is."""
    D = mask.shape[0]
    if D % 32:
        raise ValueError("mask length must be a multiple of 32")
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    w = torch.sum(mask.reshape(D // 32, 32).to(torch.int64) << shifts, dim=1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def test_bits(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """bool[len(ids)]: membership of each id (0 <= id < 32 * len(words))
    in the packed set."""
    ids = ids.to(torch.int64)
    return ((words[ids >> 5] >> (ids & 31).to(torch.int32)) & 1) != 0


def popcount(words: torch.Tensor) -> int:
    """Total set bits across the packed vector (SWAR per word, on the
    words' 32 bits held in int64 so no shift sign-extends)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    per_word = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return int(per_word.sum())
