"""Shard routing & allocation: which node owns each copy of a shard.

Port of elasticsearch_tpu/cluster/routing.py (reference:
org/elasticsearch/cluster/routing/OperationRouting.java, doc → shard
hash; routing/allocation/AllocationService.java and the decider chain
under routing/allocation/decider/, SameShardAllocationDecider,
FilterAllocationDecider, ThrottlingAllocationDecider, …; and
BalancedShardsAllocator for an even spread).

A node here is a member process. The watermarks read device memory as
the breakers budget it (``hbm_capacity()``, ``ESTPU_HBM_BYTES``), so
several members on one card each hold their own share.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.cluster.state import DiscoveryNode, ShardRouting
from elasticsearch_tpu_torch.utils.hashing import routing_hash


# -- operation routing ---------------------------------------------------------

def shard_id_for(doc_id: str, num_shards: int, routing: Optional[str] = None) -> int:
    """OperationRouting.generateShardId: murmur3(routing ?: id) % shards —
    the reference's exact UTF-16LE signed murmur, so doc→shard placement
    matches ES 2.0 byte for byte."""
    key = routing if routing is not None else str(doc_id)
    return routing_hash(key) % num_shards


def select_primary(owners: List[str], in_sync: List[str],
                   checkpoints: Optional[Dict[str, int]] = None) -> List[str]:
    """The replication-safety promotion rule (reference: the allocation
    pass promoting primaries from the in-sync allocation ids): reorder
    ``owners`` so an IN-SYNC copy leads. A copy that missed an
    acknowledged write or is still recovering must never become primary —
    that would silently roll back acks — so when NO in-sync copy
    survives, the answer is an empty list (shard red; gateway
    resurrection may later re-adopt from on-disk data) rather than a
    non-in-sync promotion.

    Among the promotable in-sync copies, ``checkpoints`` (node id →
    local checkpoint, best-effort) breaks the tie by RECENCY: the copy
    with the highest local checkpoint wins, so the promotion's follow-up
    re-replication replays the shortest op suffix to the other
    survivors. Copies with no report sort below any reported one (an
    unreachable copy must not out-rank a known-fresh one on position
    alone); with no map at all the owners order decides, as before.
    Used by the master's reconcile pass (cluster/search_action.py) on
    every membership change."""
    if not owners:
        return []
    if owners[0] in in_sync:
        # the sitting primary survived in-sync: no promotion happens, so
        # recency must not reorder (a spurious reorder would bump the
        # term and fence in-flight ops for nothing)
        return list(owners)
    promotable = [o for o in owners if o in in_sync]
    if not promotable:
        return []
    if checkpoints:
        best = max(promotable,
                   key=lambda o: (checkpoints.get(o, -2),
                                  -owners.index(o)))
    else:
        best = promotable[0]
    return [best] + [o for o in owners if o != best]


# -- allocation deciders -------------------------------------------------------

ALWAYS, THROTTLE, NO = "YES", "THROTTLE", "NO"


class Decider:
    name = "base"

    def can_allocate(self, shard: ShardRouting, node: DiscoveryNode,
                     allocation: "Allocation") -> str:
        return ALWAYS


class SameShardDecider(Decider):
    """A node must not hold two copies of the same shard (reference:
    SameShardAllocationDecider)."""

    name = "same_shard"

    def can_allocate(self, shard, node, allocation):
        for existing in allocation.assigned:
            if (existing.index == shard.index and existing.shard_id == shard.shard_id
                    and existing.node_id == node.node_id):
                return NO
        return ALWAYS


class FilterDecider(Decider):
    """index.routing.allocation.{include,exclude,require}.<attr> settings
    (reference: FilterAllocationDecider)."""

    name = "filter"

    def __init__(self, index_settings: Optional[dict] = None):
        s = (index_settings or {}).get("index", index_settings or {})
        alloc = s.get("routing", {}).get("allocation", {})
        self.include = alloc.get("include", {})
        self.exclude = alloc.get("exclude", {})
        self.require = alloc.get("require", {})

    @staticmethod
    def _matches(rule_val: str, node_val: Optional[str]) -> bool:
        return node_val is not None and node_val in [v.strip() for v in str(rule_val).split(",")]

    def can_allocate(self, shard, node, allocation):
        attrs = dict(node.attributes)
        attrs.setdefault("_name", node.name)
        attrs.setdefault("_id", node.node_id)
        for k, v in self.require.items():
            if not self._matches(v, attrs.get(k)):
                return NO
        for k, v in self.exclude.items():
            if self._matches(v, attrs.get(k)):
                return NO
        if self.include:
            if not any(self._matches(v, attrs.get(k)) for k, v in self.include.items()):
                return NO
        return ALWAYS


class ThrottlingDecider(Decider):
    """Cap concurrent incoming recoveries per node (reference:
    ThrottlingAllocationDecider, node_concurrent_recoveries)."""

    name = "throttling"

    def __init__(self, concurrent_recoveries: int = 2):
        self.concurrent = concurrent_recoveries

    def can_allocate(self, shard, node, allocation):
        initializing = sum(1 for r in allocation.assigned
                           if r.node_id == node.node_id and r.state == "INITIALIZING")
        return THROTTLE if initializing >= self.concurrent else ALWAYS


class WatermarkDecider(Decider):
    """HBM/host-pressure watermarks over the breakers' ``ESTPU_HBM_BYTES``
    capacity (reference: DiskThresholdDecider, with device memory in
    place of disk). Three thresholds, ES
    ``cluster.routing.allocation.disk.watermark.*`` grammar (percent or
    absolute byte-size strings):

    - **low** — no NEW shard copy is allocated to a node at/over it
      (relocations already under way complete);
    - **high** — the allocator actively moves shards OFF the node
      (:meth:`over_high`);
    - **flood_stage** — the node is an emergency: besides ``NO`` here,
      the allocator treats its shards as first to move.

    ``usage_fn(node_id) -> (used_bytes, capacity_bytes)`` supplies the
    live signal (the allocator's cached per-node usage probe); a node
    with no report allocates freely (an unknown must not strand
    recovery — the reference likewise allocates when disk info is
    missing)."""

    name = "watermark"

    def __init__(self, usage_fn: Callable[[str], Optional[Tuple[int, int]]],
                 low: str = "85%", high: str = "90%",
                 flood_stage: str = "95%"):
        self.usage_fn = usage_fn
        self.set_watermarks(low, high, flood_stage)

    def set_watermarks(self, low, high, flood_stage) -> None:
        self.low, self.high, self.flood_stage = (str(low), str(high),
                                                 str(flood_stage))

    def _threshold(self, spec: str, capacity: int) -> int:
        from elasticsearch_tpu_torch.resources.breakers import parse_limit

        return parse_limit(spec, capacity)

    def level(self, node_id: str) -> str:
        """``ok`` | ``low`` | ``high`` | ``flood`` — the `_cat/allocation`
        watermark column and the allocator's move-away trigger."""
        usage = self.usage_fn(node_id)
        if usage is None:
            return "ok"
        used, capacity = usage
        if capacity <= 0:
            return "ok"
        for name, spec in (("flood", self.flood_stage), ("high", self.high),
                           ("low", self.low)):
            limit = self._threshold(spec, capacity)
            if limit >= 0 and used >= limit:
                return name
        return "ok"

    def over_high(self, node_id: str) -> bool:
        return self.level(node_id) in ("high", "flood")

    def can_allocate(self, shard, node, allocation):
        return NO if self.level(node.node_id) != "ok" else ALWAYS


class LoadDecider(Decider):
    """Serving-pressure signal over the live ``estpu_*`` families
    (per-shard qps, breaker trips, residency eviction churn — the
    allocator's usage probe aggregates them into one per-node score).
    A node whose score is over ``factor ×`` the fleet mean is too hot to
    receive MORE work: rebalancing toward it throttles (it stays a legal
    last resort — recovery of a red shard outranks load shaping, so this
    decider never answers NO)."""

    name = "load"

    def __init__(self, load_fn: Callable[[str], Optional[float]],
                 mean_fn: Callable[[], float], factor: float = 2.0):
        self.load_fn = load_fn
        self.mean_fn = mean_fn
        self.factor = factor

    def can_allocate(self, shard, node, allocation):
        score = self.load_fn(node.node_id)
        if score is None:
            return ALWAYS
        mean = self.mean_fn()
        if mean <= 0.0:
            return ALWAYS
        return THROTTLE if score > self.factor * mean else ALWAYS


class ClusterFilterDecider(Decider):
    """Cluster-level ``cluster.routing.allocation.{include,exclude,
    require}._name/_id`` (reference: the cluster-scope half of
    FilterAllocationDecider) — the node-drain lever: setting
    ``exclude._name`` makes every copy on the named nodes illegal, and
    the allocator relocates them away. Values are comma-separated exact
    names/ids."""

    name = "cluster_filter"

    def __init__(self):
        self.include: Dict[str, str] = {}
        self.exclude: Dict[str, str] = {}
        self.require: Dict[str, str] = {}

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        """Rebuild from the MERGED settings map (absent key = reset),
        the same idempotent contract as the breaker service."""
        prefix = "cluster.routing.allocation."
        for rule in ("include", "exclude", "require"):
            d: Dict[str, str] = {}
            for k, v in flat.items():
                if k.startswith(f"{prefix}{rule}.") and v is not None:
                    d[k[len(prefix) + len(rule) + 1:]] = str(v)
            setattr(self, rule, d)

    def excludes(self, node: DiscoveryNode) -> bool:
        """True when ``node`` is named by an exclude/require rule — the
        drain trigger (can_allocate vetoes NEW copies; this answers
        whether EXISTING copies must move away)."""
        return self.can_allocate(None, node, None) == NO

    def can_allocate(self, shard, node, allocation):
        attrs = dict(node.attributes)
        attrs.setdefault("_name", node.name)
        attrs.setdefault("_id", node.node_id)
        for k, v in self.require.items():
            if not FilterDecider._matches(v, attrs.get(k)):
                return NO
        for k, v in self.exclude.items():
            if FilterDecider._matches(v, attrs.get(k)):
                return NO
        if self.include:
            if not any(FilterDecider._matches(v, attrs.get(k))
                       for k, v in self.include.items()):
                return NO
        return ALWAYS


@dataclass
class Allocation:
    """Mutable allocation round state."""

    nodes: List[DiscoveryNode]
    assigned: List[ShardRouting] = field(default_factory=list)


class ShardAllocator:
    """Balanced allocation with a decider chain (reference:
    AllocationService.reroute + BalancedShardsAllocator: pick the eligible
    node with the fewest shards)."""

    def __init__(self, deciders: Optional[List[Decider]] = None):
        self.deciders = deciders if deciders is not None else [
            SameShardDecider(), ThrottlingDecider()]

    def decide(self, shard: ShardRouting, node: DiscoveryNode,
               allocation: Allocation) -> str:
        verdict = ALWAYS
        for d in self.deciders:
            v = d.can_allocate(shard, node, allocation)
            if v == NO:
                return NO
            if v == THROTTLE:
                verdict = THROTTLE
        return verdict

    def decide_verbose(self, shard: ShardRouting, node: DiscoveryNode,
                       allocation: Allocation) -> List[dict]:
        """Every decider's individual verdict — the ``?explain`` payload
        of ``POST /_cluster/reroute`` (reference: RerouteExplanation's
        Decision.Multi, one entry per decider)."""
        out: List[dict] = []
        for d in self.deciders:
            v = d.can_allocate(shard, node, allocation)
            out.append({"decider": d.name, "decision": v,
                        "explanation":
                            f"[{d.name}] answered {v} for "
                            f"[{shard.index}][{shard.shard_id}] on "
                            f"node [{node.node_id}]"})
        return out

    def allocate_index(self, index: str, num_shards: int, num_replicas: int,
                       nodes: List[DiscoveryNode],
                       index_settings: Optional[dict] = None,
                       state: str = "STARTED") -> List[ShardRouting]:
        """Assign every copy of every shard; unassignable copies come back
        with state UNASSIGNED (=> yellow/red health, like the reference)."""
        chain = self
        if index_settings:
            chain = ShardAllocator(self.deciders + [FilterDecider(index_settings)])
        alloc = Allocation(nodes=nodes)
        out: List[ShardRouting] = []
        for sid in range(num_shards):
            for copy in range(1 + num_replicas):
                shard = ShardRouting(index, sid, node_id="", primary=(copy == 0),
                                     state="UNASSIGNED")
                # fewest-shards-first among eligible nodes
                counts: Dict[str, int] = {n.node_id: 0 for n in nodes}
                for r in alloc.assigned:
                    counts[r.node_id] = counts.get(r.node_id, 0) + 1
                best = None
                for node in sorted(nodes, key=lambda n: counts.get(n.node_id, 0)):
                    v = chain.decide(shard, node, alloc)
                    if v == ALWAYS:
                        best = node
                        break
                    if v == THROTTLE and best is None:
                        best = node  # throttled target still wins over none
                if best is not None:
                    shard.node_id = best.node_id
                    # NOTE: pass state="INITIALIZING" for recovery-time
                    # allocation so ThrottlingDecider's cap is live; the
                    # default STARTED models already-recovered placement
                    shard.state = state
                alloc.assigned.append(shard)
                out.append(shard)
        return out
