"""Compile-cache counters: the ledger of the kernel-library blob tier.

Port of elasticsearch_tpu/monitor/compile_cache.py. The port's compiled
artifacts are its kernel libraries: the ``nvcc`` shared object of each
``csrc/*.cu`` and the ``g++`` host codec. ``parallel/aot.py`` resolves
each one through a lookup (the process memo, the build directory, the
blob tier, a fresh build) and records every resolution here, so a
"no build on restart" claim can be read off a counter.

Event names (the ``source`` label of ``estpu_compile_cache_events_total``);
the reference's names where the meaning holds:

  aot_hit          a library loaded from the blob tier: written into the
                   build directory and opened, no compiler run
  build_dir_hit    the library was already in the build directory
                   (the reference's ``xla_dir_hit``: a persistent
                   directory served the compile)
  fresh            built by ``nvcc`` or ``g++``
  corrupt_miss     a blob failed its digest or its framing: deleted
  mismatch_miss    a valid blob for another library, fingerprint or
                   version: deleted
  deserialize_error  a blob ``dlopen`` refused: deleted, rebuilt from
                   source
  store            a library persisted to the blob tier
  store_skipped    a library not stored because no data directory is
                   registered (there is no durable tier to hold it)
  store_error      the store failed (the library still serves)

The reference's ``call_fallback`` has no counterpart: a library is
either loaded or the launch raises; nothing falls back.

Phase seconds (``estpu_compile_cache_seconds_total``): ``deserialize``
(a blob written out and opened), ``compile`` (a build), ``serialize``
(a store).

``enabled_state()`` is None until the blob tier first resolves a
library; ``counter_values`` then reports the -1 unknown sentinel.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

EVENTS = ("aot_hit", "build_dir_hit", "fresh", "corrupt_miss",
          "mismatch_miss", "deserialize_error", "store", "store_skipped",
          "store_error")
PHASES = ("deserialize", "compile", "serialize")

_LOCK = threading.Lock()
_EVENTS: Dict[str, int] = {}
_SECONDS: Dict[str, float] = {}
#: None = the blob tier never resolved a library (unknown)
_ENABLED: Optional[bool] = None


def note_enabled(flag: bool) -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = bool(flag)


def enabled_state() -> Optional[bool]:
    with _LOCK:
        return _ENABLED


def event(name: str, n: int = 1) -> None:
    with _LOCK:
        _EVENTS[name] = _EVENTS.get(name, 0) + n


def seconds(phase: str, s: float) -> None:
    with _LOCK:
        _SECONDS[phase] = _SECONDS.get(phase, 0.0) + float(s)


def events_snapshot() -> Dict[str, int]:
    """Every event name, zero-filled: collectors need the stable label
    set, not just the names that happened to fire."""
    with _LOCK:
        return {name: _EVENTS.get(name, 0) for name in EVENTS}


def seconds_snapshot() -> Dict[str, float]:
    with _LOCK:
        return {p: _SECONDS.get(p, 0.0) for p in PHASES}


def counter_values() -> Dict[str, float]:
    """Flat ``compile_cache.*`` keys for process_counters and bench
    deltas; every value is the -1 unknown sentinel while the blob tier
    has never resolved a library."""
    with _LOCK:
        unknown = _ENABLED is None
        out: Dict[str, float] = {}
        for name in EVENTS:
            out[f"compile_cache.{name}"] = \
                -1.0 if unknown else float(_EVENTS.get(name, 0))
        for p in PHASES:
            out[f"compile_cache.{p}_seconds"] = \
                -1.0 if unknown else round(_SECONDS.get(p, 0.0), 6)
        return out


def reset() -> None:
    """Test isolation only."""
    global _ENABLED
    with _LOCK:
        _EVENTS.clear()
        _SECONDS.clear()
        _ENABLED = None
