"""Shape helpers: power-of-two buckets and padding.

Segments keep the reference's padded shapes (``max_docs`` and postings
lengths are power-of-two buckets) so doc ids and array shapes match the
JAX package one for one.
"""
from __future__ import annotations

import numpy as np


def pow2_bucket(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def pad_to(arr: np.ndarray, length: int, fill, axis: int = 0) -> np.ndarray:
    """Pad `arr` along `axis` to `length` with `fill` (no-op if already there)."""
    cur = arr.shape[axis]
    if cur == length:
        return arr
    if cur > length:
        raise ValueError(f"cannot pad axis of size {cur} down to {length}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, length - cur)
    return np.pad(arr, widths, constant_values=fill)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


#: query rows of one launch of kernels B1 and B2: the pairwise merge of
#: csrc/topk_keys.cuh puts a query on a grid dimension of 65,535 blocks
MAX_QUERY_ROWS = 65535
#: device bytes the per-chunk key lists of one such launch may take
TOPK_SCRATCH_BYTES = 4 << 30


def query_slices(Q: int, D: int, k: int):
    """[(start, stop)] of the query rows each launch of B1 or B2 takes:
    at most ``MAX_QUERY_ROWS``, and no more than keep the two u64 buffers
    of per-chunk key lists (ceil(D / 2048) lists of min(k, 2048) keys a
    row) within ``TOPK_SCRATCH_BYTES``. Rows are independent, so the
    launches' results stack into the whole call's."""
    per_row = 16 * -(-D // 2048) * min(k, 2048)
    step = max(1, min(MAX_QUERY_ROWS, TOPK_SCRATCH_BYTES // per_row))
    return [(a, min(a + step, Q)) for a in range(0, Q, step)]
