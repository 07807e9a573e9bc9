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
