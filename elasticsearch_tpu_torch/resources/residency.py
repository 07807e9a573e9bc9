"""Device placement choke point.

Reference counterpart: elasticsearch_tpu/resources/residency.py. Every
tensor a segment keeps on the device is placed here, onto the owning
``Node``'s device:

- :meth:`Residency.device_put` — always-resident structures (postings,
  live masks, field lengths). Admission control for them is the
  engine's per-segment ``segments``-breaker charge at freeze.
- :meth:`Residency.put_array` — structures charged at placement to the
  ``fielddata`` breaker (doc-value columns and dense impact blocks). A
  denied charge raises ``CircuitBreakingException``,
  or returns None when the caller marked the structure best-effort.

- :meth:`Residency.charge` / :meth:`Residency.release` — bytes a caller
  places itself and frees on its own schedule (the mesh executor's
  stacked copies and prepared queries), charged to the same breaker.

LRU eviction and rehydration of the fielddata tier are not ported yet
(ROADMAP A10d): a charged tensor stays resident until its segment is dropped.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from elasticsearch_tpu_torch.resources.breakers import CircuitBreakerService


class Residency:
    def __init__(self, device: torch.device,
                 breakers: Optional[CircuitBreakerService] = None):
        self.device = torch.device(device)
        self.breakers = breakers if breakers is not None \
            else CircuitBreakerService()
        # the owning Node's ``<data>/_ivf``: where its segments store the
        # IVF/PQ blobs they build (index/ivf_cache.py); None keeps them
        # in memory
        self.blob_dir: Optional[str] = None

    def device_put(self, x: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """Always-resident placement of a host array (copied), or of a
        tensor built on any device (moved; kept as it is when it already
        lies on this device)."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device).contiguous()
        a = np.ascontiguousarray(x)
        if not a.flags.writeable:  # torch.from_numpy wants writable memory
            a = a.copy()
        return torch.from_numpy(a).to(self.device, copy=True)

    def put_array(self, x: Union[np.ndarray, torch.Tensor], label: str,
                  best_effort: bool = False) -> Optional[torch.Tensor]:
        """Charge ``x``'s bytes to the ``fielddata`` breaker, then place it.
        ``best_effort``: a denied charge returns None (the structure only
        accelerates); otherwise it raises CircuitBreakingException."""
        n = int(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                else x.nbytes)
        br = self.breakers.breaker("fielddata")
        if best_effort:
            if not br.reserve(n):
                return None
        else:
            br.break_or_reserve(n, label=label)
        try:
            return self.device_put(x)
        except Exception:
            br.release(n)  # a failed placement must not leak its charge
            raise

    def charge(self, nbytes: int, label: str, force: bool = False) -> None:
        """Charge ``nbytes`` the caller is about to place to the
        ``fielddata`` breaker: a denial raises CircuitBreakingException,
        unless ``force`` (bounded caches whose own cap is the ceiling)."""
        br = self.breakers.breaker("fielddata")
        if force:
            br.force(nbytes)
        else:
            br.break_or_reserve(nbytes, label=label)

    def release(self, nbytes: int) -> None:
        """Return bytes charged by :meth:`charge`."""
        self.breakers.breaker("fielddata").release(nbytes)
