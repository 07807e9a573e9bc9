"""The host machine's identity.

Port of :func:`host_fingerprint` from elasticsearch_tpu/utils/platform.py.
A kernel library built on one machine is kept in the blob tier beside the
IVF/PQ blobs (``parallel/aot.py``); the host fingerprint in its key makes
a blob carried to another machine a clean miss, never a load. The
reference's two XLA settings of the same module (the persistent
compilation cache and the CPU platform guard) have no counterpart: the
port has no XLA.
"""
from __future__ import annotations

import hashlib
import threading

_HOST_FP_LOCK = threading.Lock()
_HOST_FP: str = ""


def host_fingerprint() -> str:
    """12-hex digest of this host machine's CPU identity. Sources, in
    order of specificity: /proc/cpuinfo's model name + feature flags
    (Linux), falling back to the platform module's
    machine/processor/platform tuple. Deterministic per machine, cached
    after first resolution, never raises."""
    global _HOST_FP
    if _HOST_FP:
        return _HOST_FP
    with _HOST_FP_LOCK:
        if _HOST_FP:
            return _HOST_FP
        parts = []
        try:
            with open("/proc/cpuinfo") as fh:
                seen = set()
                for line in fh:
                    key = line.split(":", 1)[0].strip()
                    if key in ("model name", "flags", "Features") \
                            and key not in seen:
                        seen.add(key)
                        parts.append(line.strip())
                    if len(seen) == 2:
                        break
        except OSError:
            pass
        if not parts:
            import platform as _platform

            parts = [_platform.machine(), _platform.processor(),
                     _platform.platform()]
        _HOST_FP = hashlib.sha1(
            "|".join(parts).encode("utf-8", "replace")).hexdigest()[:12]
        return _HOST_FP
