"""The port's compile counter: first-touch events, per thread.

Port of elasticsearch_tpu/tracing/retrace.py. The reference counts
``jax.jit`` traces; eager PyTorch has none. What a new process pays in
front of its first requests here is first-touch work, and that is what
this module counts:

- each kernel-library build or load (``parallel/aot.py``, for
  ``ops/build.py`` and ``native/``): ``nvcc``/``g++``, ``dlopen``;
- the first dispatch of each ``(program, shapes, backend)`` key in the
  process (``monitor/programs.py::ProgramRegistry.timed``): the one
  that pays CUDA's lazy loading of torch's own kernels, the cuBLAS
  set-up and the uploads of the executor's caches.

Counts are kept per thread (``snapshot``/``traces_since``): a neighbour
request's first touch on another thread must not turn this thread's
steady call into a compile. No tracer needs installing, so
:func:`ensure_installed` and :func:`auditor` always return the counter.
"""
from __future__ import annotations

import threading
from typing import Optional, Set, Tuple

_LOCK = threading.Lock()
_LOCAL = threading.local()
_TOTAL = 0
#: dispatch keys this process has run once
_SEEN: Set[Tuple[str, str, str]] = set()


class _Auditor:
    """The reference's auditor surface over this module's counts."""

    @staticmethod
    def total() -> int:
        with _LOCK:
            return _TOTAL

    @staticmethod
    def thread_total() -> int:
        return getattr(_LOCAL, "n", 0)


_AUDITOR = _Auditor()


def ensure_installed() -> _Auditor:
    return _AUDITOR


def auditor() -> _Auditor:
    return _AUDITOR


def note(n: int = 1) -> None:
    """One first-touch event on this thread."""
    global _TOTAL
    _LOCAL.n = getattr(_LOCAL, "n", 0) + n
    with _LOCK:
        _TOTAL += n


def first_dispatch(key: Tuple[str, str, str]) -> bool:
    """Whether ``key`` dispatches for the first time in this process;
    the first counts as a first-touch event on the calling thread."""
    with _LOCK:
        if key in _SEEN:
            return False
        _SEEN.add(key)
    note()
    return True


def snapshot() -> Optional[int]:
    """This thread's first-touch count now."""
    return getattr(_LOCAL, "n", 0)


def traces_since(snap: Optional[int]) -> int:
    """First-touch events on this thread since ``snap`` (-1 for no
    snapshot, the reference's unknown)."""
    if snap is None:
        return -1
    return getattr(_LOCAL, "n", 0) - snap


def reset() -> None:
    """Forget which keys have dispatched (tests standing in for a new
    process; the counts stay monotone)."""
    with _LOCK:
        _SEEN.clear()
