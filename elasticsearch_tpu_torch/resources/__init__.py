"""Device-memory resource management: breakers + residency.

- :mod:`breakers` — ES-shaped hierarchical circuit breakers (parent,
  fielddata, request, in_flight_requests + ``segments``).
- :mod:`residency` — the one choke point for device placement: every
  tensor a segment keeps on the device goes through it. Fielddata is
  evictable (``ResidentArray``: placed on first touch, evicted least
  recently used first under its breaker, rehydrated from its host
  mirror); bytes a caller owns are pinned charges (``PinnedToken``).
- :mod:`census` — each index's program census, persisted beside the
  IVF/PQ blobs and replayed by the pre-warm service.

Each ``Node`` owns one breaker service and one residency registry per
device of its device list (a ``ResidencySet``), and passes them down:
a shard's copies and segments live on its device's registry.
"""
from elasticsearch_tpu_torch.resources.breakers import (  # noqa: F401
    CircuitBreaker, CircuitBreakerService, hbm_capacity, parse_limit)
from elasticsearch_tpu_torch.resources.residency import (  # noqa: F401
    PinnedToken, Residency, ResidencySet, ResidentArray)
