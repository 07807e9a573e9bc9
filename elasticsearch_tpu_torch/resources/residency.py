"""Tiered device residency: one choke point for device-resident tensors.

Port of elasticsearch_tpu/resources/residency.py. The reference keeps
fielddata in an IndicesFieldDataCache whose entries load lazily, count
against the ``fielddata`` breaker and evict under pressure. Here the
device copies of doc-value columns, vector slabs, sort mirrors, geo
arrays, dense impact blocks and PQ codes play that role: they are
*evictable*. The registry keeps each one's host mirror, drops the device
copy least recently used first when a reservation does not fit, and
rehydrates it on the next touch (a ``tpu.rehydrate`` span on the node's
tracer and the request's ``rehydrate`` profile phase, so running over
the budget shows, never silently).

One registry per mesh device of a ``Node`` (a :class:`ResidencySet`
holds them), each bound to its device, its own byte budget and the
node's breakers:

- :meth:`Residency.put_array` — an EVICTABLE device copy of a host array
  (a :class:`ResidentArray`: ``get()`` returns the device tensor,
  rehydrating it when it was evicted). It charges the tier's breaker and
  under pressure evicts least recently used handles of any tier before
  it trips; ``best_effort`` returns None instead of raising.
- :meth:`Residency.track` — a pinned charge (:class:`PinnedToken`) for
  device memory a caller owns: the mesh executor's stacked copies and
  prepared queries, positional CSRs and suggester tables. Forced by
  default (the owner's own cap is the ceiling); ``reserve=True`` goes
  through the same eviction and refusal as a handle. ``close()`` releases
  it.
- :meth:`Residency.device_put` — always-resident placements (postings,
  live masks, block-join arrays), counted per call; their admission
  control is the engine's per-segment ``segments`` charge at freeze.

Release is deterministic: whoever frees memory (a merge retiring a
segment, an index closing, the percolator's segment) closes the handles
and tokens it owns. ``weakref.finalize`` and ``PinnedToken.__del__`` are
only a backstop for an owner dropped without that.

Eviction drops the registry's reference only. Every kernel of the port
runs on the default stream, so a request that already holds the tensor
keeps it alive (and ordered) past the eviction, a momentary over-commit
the reference accepts too; a later side stream must ``record_stream``
what it reads. PyTorch's caching allocator keeps a freed block
reserved: ``memory_allocated`` falls on eviction, ``memory_reserved``
does not. The breakers account logically, as the reference's do.

Several devices: each registry's LRU evicts and rehydrates only its own
device's handles, and its budget (the device's memory, split evenly
among the entries of the node's device list that name the device) caps
the bytes its handles and pinned charges hold; a reservation that
overruns it evicts this registry's handles only and then raises. The
breakers stay the node's, shared by every registry, so their totals
count every device. A request denied on one device evicts nothing on
another. Each registry knows the node's registries
(``Residency.node_registries``), so a structure spread over the node's
devices from one segment (the postings split,
``parallel/postings_shard.py``) places and charges each part on its
own registry.

Fault point ``resources.reserve`` (``utils/faults.py``) fires before
every breaker reservation.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from elasticsearch_tpu_torch.resources.breakers import CircuitBreakerService
from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException
from elasticsearch_tpu_torch.utils.faults import FAULTS

#: residency tiers, each charged to the breaker of the same name
TIERS = ("fielddata", "segments", "request")


def host_array(x: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    """A contiguous, writable host copy-or-view of ``x`` that
    ``torch.from_numpy`` accepts (a tensor on the card is copied back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().numpy()
    a = np.ascontiguousarray(x)
    return a if a.flags.writeable else a.copy()


class ResidentArray:
    """Handle of one evictable device copy of a host array.

    ``get()`` returns the device tensor and touches the LRU; when the
    copy was evicted it rehydrates (reserve, place, span). The host
    mirror is immutable (segments are frozen), so evict then rehydrate
    gives the same bytes. ``peek()`` reads without placing: the device
    tensor while resident, else the host mirror."""

    def __init__(self, registry: "Residency", host: np.ndarray, label: str,
                 tier: str):
        self.label = label
        self.tier = tier
        self.nbytes = int(host.nbytes)
        self.evictions = 0
        self.rehydrations = 0
        self._host = host
        self._dev: Optional[torch.Tensor] = None
        self._closed = False
        self._lock = threading.Lock()
        self._registry = registry
        # the finalizer's state: a handle collected while resident gives
        # its charge back without being resurrected
        self._cell = {"resident": False, "nbytes": self.nbytes,
                      "tier": tier, "key": id(self)}
        registry._adopt(self)
        self._finalizer = weakref.finalize(self, registry._on_gc, self._cell)

    @property
    def resident(self) -> bool:
        return self._dev is not None

    @property
    def host(self) -> np.ndarray:
        return self._host

    def _place(self) -> torch.Tensor:
        # a copy also on the CPU: the device tensor never aliases the
        # mirror that rehydration reads
        return torch.from_numpy(self._host).to(self._registry.device,
                                               copy=True)

    def peek(self) -> Union[torch.Tensor, np.ndarray]:
        dev = self._dev
        return dev if dev is not None else self._host

    def get(self) -> torch.Tensor:
        dev = self._dev
        if dev is not None:
            self._registry._touch(self)
            return dev
        if self._closed:
            # its owner released it (a retired segment still read by a
            # request in flight): a transient copy, charged to no one
            return self._place()
        return self._rehydrate()

    def _rehydrate(self) -> torch.Tensor:
        reg = self._registry
        t0 = time.perf_counter()
        reg._reserve(self.nbytes, self.tier, self.label, exclude=self)
        try:
            tracer = reg._tracer
            if tracer is not None:
                with tracer.span("tpu.rehydrate", label=self.label,
                                 tier=self.tier, bytes=self.nbytes):
                    dev = self._place()
            else:
                dev = self._place()
        except BaseException:
            # a failed placement (device OOM, a transfer error) must not
            # keep its reservation
            reg._release(self.nbytes, self.tier)
            raise
        ns = int((time.perf_counter() - t0) * 1e9)
        with self._lock:
            if self._dev is None and not self._closed:
                self._dev = dev
                fresh = True
            else:  # lost a rehydrate race: take the winner's copy
                dev = self._dev if self._dev is not None else dev
                fresh = False
        if fresh:
            self.rehydrations += 1
            self._cell["resident"] = True
            reg._on_rehydrated(self, ns)
        else:
            reg._release(self.nbytes, self.tier)
        return dev

    def evict(self) -> bool:
        """Drop the device copy (the host mirror stays); False when it was
        not resident. The next ``get()`` rehydrates."""
        with self._lock:
            if self._dev is None:
                return False
            self._dev = None
        self.evictions += 1
        self._cell["resident"] = False
        self._registry._on_evicted(self)
        return True

    def close(self) -> None:
        """The owner's release: drop the device copy and its charge and
        leave the registry. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            was = self._dev is not None
            self._dev = None
        self._cell["resident"] = False
        self._finalizer.detach()
        self._registry._on_closed(self, was)


class PinnedToken:
    """A pinned byte charge tied to what its owner keeps: ``close()`` (or
    collection) releases it."""

    def __init__(self, registry: "Residency", nbytes: int, label: str,
                 tier: str):
        self.nbytes = int(nbytes)
        self.label = label
        self.tier = tier
        self._registry = registry
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._registry._untrack(self)

    def __del__(self):  # its owner dropped it without closing it
        try:
            self.close()
        except Exception:
            pass


class Residency:
    """A node's registry of device-resident tensors on one device.
    ``budget``: the bytes its handles and pinned charges may hold (None:
    the breakers alone bound them)."""

    def __init__(self, device: torch.device,
                 breakers: Optional[CircuitBreakerService] = None,
                 budget: Optional[int] = None):
        self.device = torch.device(device)
        self.breakers = breakers if breakers is not None \
            else CircuitBreakerService()
        self.budget = budget
        # the owning Node's ``<data>/_ivf``: where its segments store the
        # IVF/PQ blobs they build (index/ivf_cache.py); None keeps them
        # in memory
        self.blob_dir: Optional[str] = None
        self._lock = threading.Lock()
        # id(handle) -> weakref; insertion order is the LRU order
        self._lru: "OrderedDict[int, weakref.ref]" = OrderedDict()
        self._tracer = None
        self._tiers: Dict[str, Dict[str, int]] = {
            t: {"resident_bytes": 0, "handles": 0, "loads": 0,
                "evictions": 0, "rehydrations": 0,
                "rehydrate_time_in_nanos": 0}
            for t in TIERS}
        self._pinned_bytes = 0
        self._pinned_tokens = 0
        self._placements = 0
        self._placed_bytes_total = 0
        # the node's registries, in device-list order, when a
        # ResidencySet holds this one (node_registries)
        self._node_members: Optional[List["Residency"]] = None

    def set_tracer(self, tracer) -> None:
        """The node's tracer: each rehydration files a span there."""
        self._tracer = tracer

    # -- the device list's view of one registry ----------------------------

    @property
    def members(self) -> List["Residency"]:
        return [self]

    @property
    def devices(self):
        return (self.device,)

    def for_shard(self, shard_id: int, n_shards: int) -> "Residency":
        """The registry a shard's copies and segments live on: this one."""
        return self

    @property
    def node_registries(self) -> List["Residency"]:
        """Every registry of the node's device list this one belongs to,
        in order: what a structure spread over the node's devices (the
        postings split) places on; this one alone when it stands
        alone."""
        return list(self._node_members or (self,))

    # -- always-resident placement --------------------------------------------

    def device_put(self, x: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """Always-resident placement of a host array (copied), or of a
        tensor built on any device (moved; kept as it is when it already
        lies on this device), counted in ``stats()["device_put"]``."""
        if isinstance(x, torch.Tensor):
            dev = x.to(self.device).contiguous()
        else:
            dev = torch.from_numpy(host_array(x)).to(self.device, copy=True)
        with self._lock:
            self._placements += 1
            self._placed_bytes_total += int(dev.numel()) * dev.element_size()
        return dev

    # -- evictable handles ------------------------------------------------------

    def put_array(self, host: Union[np.ndarray, torch.Tensor], *, label: str,
                  tier: str = "fielddata", best_effort: bool = False,
                  placed: Optional[torch.Tensor] = None
                  ) -> Optional[ResidentArray]:
        """Register ``host`` and place its device copy, charging the tier's
        breaker (evicting least recently used handles under pressure).
        Raises CircuitBreakingException when nothing evictable covers the
        charge, or returns None with ``best_effort`` (a structure that only
        accelerates: the caller has a slower, correct path). ``placed``: a
        copy already on the device (a build made there), adopted as the
        first device copy once the charge is granted."""
        handle = ResidentArray(self, host_array(host), label, tier)
        try:
            self._reserve(handle.nbytes, tier, label, exclude=handle)
        except CircuitBreakingException:
            handle.close()
            if best_effort:
                return None
            raise
        try:
            dev = placed.to(self.device).contiguous() if placed is not None \
                else handle._place()
        except BaseException:
            self._release(handle.nbytes, tier)
            handle.close()
            raise
        with handle._lock:
            handle._dev = dev
        handle._cell["resident"] = True
        with self._lock:
            self._tiers[tier]["resident_bytes"] += handle.nbytes
            self._tiers[tier]["loads"] += 1
        return handle

    def _adopt(self, handle: ResidentArray) -> None:
        with self._lock:
            self._lru[id(handle)] = weakref.ref(handle)
            self._tiers[handle.tier]["handles"] += 1

    def _on_gc(self, cell: dict) -> None:
        with self._lock:
            self._lru.pop(cell["key"], None)
            t = self._tiers[cell["tier"]]
            t["handles"] -= 1
            if cell["resident"]:
                t["resident_bytes"] -= cell["nbytes"]
        if cell["resident"]:
            self.breakers.breaker(cell["tier"]).release(cell["nbytes"])

    def _on_closed(self, handle: ResidentArray, resident: bool) -> None:
        with self._lock:
            self._lru.pop(id(handle), None)
            t = self._tiers[handle.tier]
            t["handles"] -= 1
            if resident:
                t["resident_bytes"] -= handle.nbytes
        if resident:
            self.breakers.breaker(handle.tier).release(handle.nbytes)

    def _touch(self, handle: ResidentArray) -> None:
        with self._lock:
            if id(handle) in self._lru:
                self._lru.move_to_end(id(handle))

    def _reserve(self, n: int, tier: str, label: str,
                 exclude: Optional[ResidentArray] = None) -> None:
        """Charge ``n`` to the tier's breaker, evicting least recently
        used handles (any tier: they share the parent) until it fits;
        raises the ES-shaped CircuitBreakingException when it cannot."""
        FAULTS.check("resources.reserve", tier=tier, label=label, nbytes=n)
        br = self.breakers.breaker(tier)
        if self._fits(n) and br.reserve(n, count_trip=False):
            return
        for victim in self._victims(exclude):
            victim.evict()
            if self._fits(n) and br.reserve(n, count_trip=False):
                return
        if not self._fits(n):
            held = self._held()
            raise CircuitBreakingException(
                f"[{tier}] Data too large, data for [{label}] would be "
                f"[{held + n}] bytes on [{self.device}], which is larger "
                f"than the device's budget of [{self.budget}]",
                bytes_wanted=held + n, bytes_limit=int(self.budget))
        br.break_or_reserve(n, label)  # counts the trip and raises

    def _held(self) -> int:
        with self._lock:
            return sum(t["resident_bytes"] for t in self._tiers.values()) \
                + self._pinned_bytes

    def _fits(self, n: int) -> bool:
        return self.budget is None or self._held() + n <= self.budget

    def _victims(self, exclude: Optional[ResidentArray]) -> List[ResidentArray]:
        with self._lock:
            refs = list(self._lru.values())
        out = []
        for r in refs:  # oldest first
            h = r()
            if h is not None and h is not exclude and h.resident:
                out.append(h)
        return out

    def _release(self, n: int, tier: str) -> None:
        self.breakers.breaker(tier).release(n)

    def _on_evicted(self, handle: ResidentArray) -> None:
        self.breakers.breaker(handle.tier).release(handle.nbytes)
        with self._lock:
            t = self._tiers[handle.tier]
            t["resident_bytes"] -= handle.nbytes
            t["evictions"] += 1

    def _on_rehydrated(self, handle: ResidentArray, ns: int) -> None:
        with self._lock:
            t = self._tiers[handle.tier]
            t["resident_bytes"] += handle.nbytes
            t["rehydrations"] += 1
            t["rehydrate_time_in_nanos"] += ns
            if id(handle) in self._lru:  # placed again: most recent
                self._lru.move_to_end(id(handle))
        from elasticsearch_tpu_torch.tracing import profiler

        profiler.record_rehydrate(ns)

    def evict_all(self, tier: Optional[str] = None) -> int:
        """Evict every resident handle (of ``tier``, or of all): the
        operator's pressure valve and the evict/rehydrate checks."""
        n = 0
        for h in self._victims(None):
            if tier is None or h.tier == tier:
                n += bool(h.evict())
        return n

    # -- pinned charges ---------------------------------------------------------

    def track(self, nbytes: int, label: str, tier: str = "fielddata",
              reserve: bool = False) -> PinnedToken:
        """A pinned charge of ``nbytes`` the caller places and owns.
        Forced (never trips) unless ``reserve``: then least recently used
        handles are evicted to fit it and a refusal raises
        CircuitBreakingException."""
        if reserve:
            self._reserve(int(nbytes), tier, label)
        else:
            self.breakers.breaker(tier).force(int(nbytes))
        tok = PinnedToken(self, nbytes, label, tier)
        with self._lock:
            self._pinned_bytes += tok.nbytes
            self._pinned_tokens += 1
        return tok

    def pin(self, x: Union[np.ndarray, torch.Tensor], label: str,
            tier: str = "fielddata"):
        """(device tensor, PinnedToken): ``x`` placed and its bytes
        reserved as a pinned charge (``track(reserve=True)``); a failed
        placement gives its reservation back."""
        n = int(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                else x.nbytes)
        tok = self.track(n, label, tier, reserve=True)
        try:
            return self.device_put(x), tok
        except BaseException:
            tok.close()
            raise

    def _untrack(self, tok: PinnedToken) -> None:
        self.breakers.breaker(tok.tier).release(tok.nbytes)
        with self._lock:
            self._pinned_bytes -= tok.nbytes
            self._pinned_tokens -= 1

    # -- stats ------------------------------------------------------------------

    def stats(self) -> dict:
        """``nodes_stats``' ``resources`` section."""
        with self._lock:
            return {
                "tiers": {t: dict(c) for t, c in self._tiers.items()},
                "pinned": {"bytes": self._pinned_bytes,
                           "tokens": self._pinned_tokens},
                "device_put": {"placements": self._placements,
                               "bytes_total": self._placed_bytes_total},
            }


def device_budget(device: torch.device, share: int,
                  breakers: CircuitBreakerService) -> int:
    """One registry's budget: its device's memory (a card's total, the
    CPU's the breakers' capacity) over the ``share`` entries of the
    device list that name that device."""
    if device.type == "cuda":
        total = int(torch.cuda.get_device_properties(device).total_memory)
    else:
        total = int(breakers.capacity)
    return total // max(1, share)


class ResidencySet:
    """A node's registries, one per entry of its device list, in order,
    sharing the node's breakers: what the node hands its indices. A
    shard's copies and segments take ``for_shard``'s registry, the
    reference's slot rule (shard i on mesh device i % min(shards,
    devices)); placements of the index as a whole (the percolator's
    segment) and ``device`` are the first registry's. ``stats()`` sums
    the registries and, with more than one, lists each."""

    def __init__(self, devices, breakers: CircuitBreakerService):
        devs = [torch.device(d) for d in devices]
        self.breakers = breakers
        self._members = [
            Residency(d, breakers,
                      budget=device_budget(d, devs.count(d), breakers))
            for d in devs]
        for m in self._members:
            m._node_members = self._members
        self._blob_dir: Optional[str] = None

    @property
    def members(self) -> List[Residency]:
        return list(self._members)

    @property
    def devices(self):
        return tuple(m.device for m in self._members)

    @property
    def device(self) -> torch.device:
        return self._members[0].device

    @property
    def node_registries(self) -> List[Residency]:
        """Every registry, in order (a segment placed with the set itself
        spreads over them as one placed with a member does)."""
        return list(self._members)

    def for_shard(self, shard_id: int, n_shards: int) -> Residency:
        n = min(max(1, int(n_shards)), len(self._members))
        return self._members[int(shard_id) % n]

    @property
    def blob_dir(self) -> Optional[str]:
        return self._blob_dir

    @blob_dir.setter
    def blob_dir(self, path: Optional[str]) -> None:
        self._blob_dir = path
        for m in self._members:
            m.blob_dir = path

    def set_tracer(self, tracer) -> None:
        for m in self._members:
            m.set_tracer(tracer)

    # the index-wide placements: the first device's
    def device_put(self, x):
        return self._members[0].device_put(x)

    def put_array(self, host, **kw):
        return self._members[0].put_array(host, **kw)

    def track(self, nbytes: int, label: str, tier: str = "fielddata",
              reserve: bool = False) -> PinnedToken:
        return self._members[0].track(nbytes, label, tier, reserve)

    def pin(self, x, label: str, tier: str = "fielddata"):
        return self._members[0].pin(x, label, tier)

    def evict_all(self, tier: Optional[str] = None) -> int:
        return sum(m.evict_all(tier) for m in self._members)

    def stats(self) -> dict:
        per = [m.stats() for m in self._members]
        if len(per) == 1:
            return per[0]
        out = {"tiers": {t: {k: sum(p["tiers"][t][k] for p in per)
                             for k in per[0]["tiers"][t]} for t in TIERS},
               "pinned": {k: sum(p["pinned"][k] for p in per)
                          for k in per[0]["pinned"]},
               "device_put": {k: sum(p["device_put"][k] for p in per)
                              for k in per[0]["device_put"]}}
        out["devices"] = [
            dict(p, device=str(m.device), budget_bytes=m.budget,
                 resident_bytes=m._held())
            for m, p in zip(self._members, per)]
        return out
