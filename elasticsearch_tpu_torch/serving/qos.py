"""Per-tenant QoS admission: weighted shares of the in-flight budget.

Reference: there is no tenant concept in ES 2.x — the nearest ancestor
is the netty-level in-flight-requests circuit breaker this layer rides
on (org/elasticsearch/http/netty/NettyHttpServerTransport.java request
accounting + indices/breaker/HierarchyCircuitBreakerService.java).

Model: every search-family request names a tenant (``X-Tenant-Id``
header or ``?tenant=`` param; absent → ``_default``). Each tenant owns a
*weighted share* of the ``in_flight_requests`` breaker's byte limit:

    share(t) = max(MIN_CHARGE, limit * weight(t) / Σ weight(active ∪ configured))

A request charges ``max(body_bytes, MIN_CHARGE)`` — the floor makes
admission behave like weighted concurrency slots even for empty GET
bodies — first against the tenant's share, then against the real
breaker (the global cap). Exceeding either raises the breaker's typed
``CircuitBreakingException`` ("Data too large", HTTP 429), so a greedy
tenant starves *itself* while other tenants' shares stay serveable.

Weights are dynamic cluster settings (``serving.qos.tenant.<id>.weight``,
``serving.qos.default_weight``, ``serving.qos.enabled``) applied through
the same idempotent full-map path the breaker limits use.

Port of elasticsearch_tpu/serving/qos.py. One difference: the reference
admits against its process-wide breaker service; the port's breakers
belong to each node (``node.breakers``), so the admission takes that
service when it is built and two nodes in one process never share an
in-flight budget.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException


def _human(n: int) -> str:
    from elasticsearch_tpu_torch.resources.breakers import human_bytes

    return human_bytes(n)


class TenantAdmission:
    """Weighted per-tenant admission over the in_flight_requests breaker."""

    #: byte floor per admitted request: empty search bodies still consume
    #: share, so admission degenerates to weighted concurrency slots
    MIN_CHARGE = 4096
    DEFAULT_TENANT = "_default"

    def __init__(self, breakers, metrics):
        self._breakers = breakers
        self._lock = threading.Lock()
        self.enabled = True
        self.default_weight = 1.0
        self.weights: Dict[str, float] = {}
        self._used: Dict[str, int] = {}  # in-flight charged bytes by tenant
        self._m_admitted = metrics.counter(
            "estpu_coalescer_tenant_admitted_total",
            "Search requests admitted per tenant (QoS layer)",
            ("tenant",))
        self._m_rejected = metrics.counter(
            "estpu_coalescer_tenant_rejected_total",
            "Search requests rejected 429 per tenant (share or "
            "breaker exceeded)", ("tenant",))

    # -- settings ------------------------------------------------------------

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        """Idempotent from the MERGED settings map (absent key = default),
        the breaker-service discipline — null deletion needs no special
        casing at the call site."""
        prefix = "serving.qos.tenant."
        with self._lock:
            v = flat.get("serving.qos.enabled")
            self.enabled = (str(v).lower() not in ("false", "0", "off")
                            if v is not None else True)
            v = flat.get("serving.qos.default_weight")
            self.default_weight = float(v) if v is not None else 1.0
            weights: Dict[str, float] = {}
            for k, val in flat.items():
                if k.startswith(prefix) and k.endswith(".weight"):
                    tenant = k[len(prefix): -len(".weight")]
                    if tenant:
                        weights[tenant] = max(float(val), 0.0)
            self.weights = weights

    # -- admission -----------------------------------------------------------

    def _share(self, tenant: str, limit: int) -> int:
        """Caller holds self._lock. The tenant's byte share of `limit`."""
        if limit < 0:
            return 1 << 62
        known = set(self.weights) | set(self._used) | {tenant}
        total = sum(self.weights.get(t, self.default_weight) for t in known)
        w = self.weights.get(tenant, self.default_weight)
        if total <= 0 or w <= 0:
            return 0
        return max(self.MIN_CHARGE, int(limit * w / total))

    def admit(self, tenant: Optional[str],
              nbytes: int) -> Tuple[str, int]:
        """Admit one request; returns the (tenant, charge) token for
        :meth:`release`. Raises the typed ``CircuitBreakingException``
        (429) when the tenant's share or the global breaker trips."""
        breaker = self._breakers.breaker("in_flight_requests")
        tenant = (str(tenant).strip() or self.DEFAULT_TENANT) if tenant \
            else self.DEFAULT_TENANT
        if not self.enabled:
            # QoS off: the seed behavior — raw body bytes, no floor
            breaker.break_or_reserve(nbytes, "<http_request>")
            return (self.DEFAULT_TENANT, -nbytes - 1)  # marker: raw charge
        charge = max(int(nbytes), self.MIN_CHARGE)
        with self._lock:
            used = self._used.get(tenant, 0)
            share = self._share(tenant, breaker.limit)
            if used + charge > share:
                self._m_rejected.labels(tenant).inc()
                w = self.weights.get(tenant, self.default_weight)
                raise CircuitBreakingException(
                    f"[in_flight_requests] Data too large, data for "
                    f"[tenant:{tenant}] would be [{used + charge}/"
                    f"{_human(used + charge)}], which is larger than the "
                    f"tenant share of [{share}/{_human(share)}] "
                    f"(weight [{w}])",
                    bytes_wanted=used + charge, bytes_limit=share)
            # reserve the tenant slot BEFORE the breaker call: two racing
            # admits for one tenant must not both pass the share check
            self._used[tenant] = used + charge
        try:
            breaker.break_or_reserve(charge, f"<tenant:{tenant}>")
        except CircuitBreakingException:
            with self._lock:
                left = self._used.get(tenant, 0) - charge
                if left > 0:
                    self._used[tenant] = left
                else:
                    self._used.pop(tenant, None)
            self._m_rejected.labels(tenant).inc()
            raise
        self._m_admitted.labels(tenant).inc()
        return (tenant, charge)

    def release(self, token: Tuple[str, int]) -> None:
        tenant, charge = token
        breaker = self._breakers.breaker("in_flight_requests")
        if charge < 0:  # raw-charge marker from the disabled path
            breaker.release(-charge - 1)
            return
        breaker.release(charge)
        with self._lock:
            left = self._used.get(tenant, 0) - charge
            if left > 0:
                self._used[tenant] = left
            else:
                self._used.pop(tenant, None)

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "default_weight": self.default_weight,
                    "weights": dict(self.weights),
                    "in_flight_bytes": dict(self._used)}
