"""Live shard allocation: the master's continuous placement loop.

Port of elasticsearch_tpu/cluster/allocator.py. Reference: org/elasticsearch/cluster/routing/allocation/
AllocationService.java + BalancedShardsAllocator + DiskThresholdDecider
— the reference re-runs allocation on every cluster-state change (node
join/leave, settings update, reroute command) and moves shards until the
desired and actual placements agree. Before this module the repo's
allocation was creation-time-only: ``ShardAllocator.allocate_index``
placed once and ``reconcile`` (cluster/search_action.py) only TOPPED UP
missing copies — a node joining a loaded cluster served nothing and
pressure on one node had no relief valve.

The :class:`ClusterAllocator` closes the loop. Each ``tick`` (driven
from the master's fault-detection rounds, join handling, settings
changes, and reroute commands) compares desired vs actual placement and
schedules **relocations** — recover-to-target-then-drop-source moves
that flow through the existing checkpoint-handshake recovery path
(``_on_recover`` / ``recovery.py::recover_peer``) and graduate under the
two-phase publish, so a partitioned master's moves can never commit.

Move sources, in priority order:

1. **drain** — copies on nodes named by
   ``cluster.routing.allocation.exclude._name/_id`` (the rolling-restart
   lever: primaries move first, under term bumps, with zero acked-op
   loss; ``drain_status`` feeds ``/_cluster/health``).
2. **watermark** — copies on nodes at/over the HIGH device-memory
   watermark (``cluster.routing.allocation.disk.watermark.*`` grammar
   over the breakers' ``ESTPU_HBM_BYTES`` capacity, resources/breakers).
3. **rebalance** — evening out per-node copy counts after a join
   (fewest-copies node pulls from the most-loaded one, LoadDecider
   steering toward cold nodes).

Every candidate move runs the decider chain (SameShard → cluster
include/exclude/require filter → Watermark → Load → Throttling) with
``FAULTS.check("allocation.decide")`` making the decision point
chaos-testable; ``ThrottlingDecider`` bounds concurrent relocations per
node (``cluster.routing.allocation.node_concurrent_recoveries``) so
rebalancing can never starve serving.

Stuck-move robustness: every in-flight relocation is visible through
:meth:`inflight_snapshot`, which the stall watchdog's
``relocation_stall`` detector reads (monitor/watchdog.py); a wedged
stream — ``relocation.stream`` fault, dead target, hung transport — is
cancelled through :meth:`cancel_relocation`, its throttle slot released,
and the move rescheduled onto a different target with the wedged one
banned.

Thread discipline: relocation streams run on daemon threads whose retry
loops gate on the per-task cancel event AND the allocator's stop event;
``close()`` stops everything. Ages use ``time.monotonic()``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from elasticsearch_tpu_torch.cluster.routing import (ALWAYS, NO,
                                               ClusterFilterDecider,
                                               LoadDecider, SameShardDecider,
                                               ShardAllocator,
                                               ThrottlingDecider,
                                               WatermarkDecider)
from elasticsearch_tpu_torch.utils.faults import FAULTS

logger = logging.getLogger("elasticsearch_tpu_torch.cluster.allocator")

#: settings prefix every knob below lives under
_PREFIX = "cluster.routing.allocation."


class RelocationTask:
    """One in-flight shard move: bookkeeping + the cancel gate the
    watchdog pulls. ``age_seconds`` drives the stall detector."""

    def __init__(self, index: str, shard: int, source: str, target: str,
                 reason: str, banned: Optional[Set[str]] = None):
        self.index = index
        self.shard = shard
        self.source = source
        self.target = target
        self.reason = reason
        self.banned: Set[str] = set(banned or ())
        self.cancel = threading.Event()
        self.started = time.monotonic()
        self.attempts = 0

    @property
    def key(self) -> Tuple[str, int, str]:
        return (self.index, self.shard, self.target)

    def snapshot(self) -> dict:
        return {"index": self.index, "shard": self.shard,
                "source": self.source, "target": self.target,
                "reason": self.reason, "attempts": self.attempts,
                "age_seconds": time.monotonic() - self.started,
                "cancelled": self.cancel.is_set()}


class ClusterAllocator:
    """Master-driven desired-vs-actual reconciliation over the published
    ``dist_indices`` metadata. Construction is cheap; every mutation
    happens under the cluster's ``_indices_lock`` and commits through
    the two-phase publish (``publish_indices`` raising
    ``FailedToCommitClusterStateException`` aborts the move)."""

    #: per-tick cap on NEW moves (beyond the per-node throttle): one
    #: membership event must not flood the transport with streams
    MAX_MOVES_PER_TICK = 8
    #: relocation stream retry cadence / attempt cap — the watchdog
    #: usually cancels a wedged move long before the cap
    RETRY_WAIT_S = 0.2
    MAX_ATTEMPTS = 20
    #: usage-probe cache TTL: deciders may consult usage for every
    #: (shard, node) pair in a tick — probe each node once per window
    USAGE_TTL_S = 2.0

    def __init__(self, cluster):
        self.cluster = cluster
        self.node = cluster.node
        self._lock = threading.Lock()          # leaf: inflight bookkeeping
        self._stop = threading.Event()
        self._last_tick = float("-inf")        # monotonic stamp
        self.inflight: Dict[Tuple[str, int, str], RelocationTask] = {}
        # settings (cluster.routing.allocation.*)
        self.enabled = True
        self.concurrent_recoveries = 2
        self.filter = ClusterFilterDecider()
        self.watermark = WatermarkDecider(self._usage)
        self.load = LoadDecider(self._load_score, self._mean_load)
        self._usage_cache: Dict[str, Tuple[float, Optional[dict]]] = {}
        # counters (allocator stats + the chaos gate's assertions)
        self.moves_started = 0
        self.moves_completed = 0
        self.moves_failed = 0
        self.moves_cancelled = 0
        self.reschedules = 0
        self.decide_faults = 0
        self.peak_inflight = 0
        self._m_moves = self.node.metrics.counter(
            "estpu_allocator_moves_total",
            "Shard relocations by outcome", ("outcome",))

    # -- settings ------------------------------------------------------------

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        """Apply the MERGED persistent+transient map (absent key =
        default), the idempotent contract the breaker service set. An
        exclusion change kicks a tick — that is the drain trigger."""
        v = flat.get(_PREFIX + "enable")
        self.enabled = str(v).lower() != "none" if v is not None else True
        v = flat.get(_PREFIX + "node_concurrent_recoveries")
        self.concurrent_recoveries = int(v) if v is not None else 2
        wm = _PREFIX + "disk.watermark."
        self.watermark.set_watermarks(
            flat.get(wm + "low", "85%") or "85%",
            flat.get(wm + "high", "90%") or "90%",
            flat.get(wm + "flood_stage", "95%") or "95%")
        before = (dict(self.filter.exclude), dict(self.filter.require),
                  dict(self.filter.include))
        self.filter.apply_cluster_settings(flat)
        after = (dict(self.filter.exclude), dict(self.filter.require),
                 dict(self.filter.include))
        if before != after:
            self.kick("allocation filters changed")

    # -- usage / load signals ------------------------------------------------

    def _probe(self, node_id: str) -> Optional[dict]:
        """Per-node usage report (HBM bytes, copy count, load score),
        cached for USAGE_TTL_S — local reads for this node, one
        transport round for peers; None when unreachable (deciders then
        treat the node as unknown rather than ineligible)."""
        now = time.monotonic()
        with self._lock:
            hit = self._usage_cache.get(node_id)
            if hit is not None and now - hit[0] < self.USAGE_TTL_S:
                return hit[1]
        data = self.cluster.data
        try:
            if node_id == self.node.node_id:
                report = data.local_alloc_usage()
            else:
                from elasticsearch_tpu_torch.cluster.search_action import \
                    ACTION_ALLOC_USAGE

                report = data._send(node_id, ACTION_ALLOC_USAGE, {},
                                    timeout=2.0)
        except Exception:
            report = None  # unreachable: fault detection's job, not ours
        with self._lock:
            self._usage_cache[node_id] = (now, report)
        return report

    def _usage(self, node_id: str) -> Optional[Tuple[int, int]]:
        r = self._probe(node_id)
        if not r:
            return None
        return int(r.get("hbm_used", 0)), int(r.get("hbm_capacity", 0))

    def _load_score(self, node_id: str) -> Optional[float]:
        r = self._probe(node_id)
        if not r:
            return None
        return float(r.get("load", 0.0))

    def _mean_load(self) -> float:
        alive = list(self.node.cluster_state.nodes)
        scores = [s for s in (self._load_score(n) for n in alive)
                  if s is not None]
        return sum(scores) / len(scores) if scores else 0.0

    def watermark_level(self, node_id: str) -> str:
        """``ok`` | ``low`` | ``high`` | ``flood`` for `_cat/allocation`."""
        return self.watermark.level(node_id)

    # -- placement view ------------------------------------------------------

    def _placement(self) -> Tuple[Dict[str, List[Tuple[str, int, bool]]],
                                  Dict[str, dict]]:
        """(node → [(index, shard, is_primary)], index → meta snapshot)
        under the indices lock; initializing targets count as placed so
        balance math and the throttle see moves already under way."""
        per_node: Dict[str, List[Tuple[str, int, bool]]] = {}
        metas: Dict[str, dict] = {}
        with self.cluster._indices_lock:
            import json as _json

            metas = _json.loads(_json.dumps(self.cluster.dist_indices))
        for name, meta in metas.items():
            for sid in range(int(meta.get("num_shards", 0))):
                owners = meta.get("assignment", {}).get(str(sid), [])
                for i, nid in enumerate(owners):
                    per_node.setdefault(nid, []).append((name, sid, i == 0))
                for nid in meta.get("initializing", {}).get(str(sid), []):
                    per_node.setdefault(nid, []).append((name, sid, False))
        return per_node, metas

    def _allocation_view(self, metas: Dict[str, dict]):
        """A routing-table view of the dist metadata for the decider
        chain: STARTED rows for assigned copies, INITIALIZING rows for
        recovering/relocating targets (the ThrottlingDecider's basis)."""
        from elasticsearch_tpu_torch.cluster.routing import Allocation
        from elasticsearch_tpu_torch.cluster.state import ShardRouting

        state = self.node.cluster_state
        nodes = list(state.nodes.values())
        assigned: List[ShardRouting] = []
        for name, meta in metas.items():
            for sid in range(int(meta.get("num_shards", 0))):
                owners = meta.get("assignment", {}).get(str(sid), [])
                for i, nid in enumerate(owners):
                    assigned.append(ShardRouting(name, sid, node_id=nid,
                                                 primary=(i == 0),
                                                 state="STARTED"))
                for nid in meta.get("initializing", {}).get(str(sid), []):
                    assigned.append(ShardRouting(name, sid, node_id=nid,
                                                 primary=False,
                                                 state="INITIALIZING"))
        return Allocation(nodes=nodes, assigned=assigned)

    def _chain(self) -> ShardAllocator:
        return ShardAllocator([
            SameShardDecider(), self.filter, self.watermark, self.load,
            ThrottlingDecider(self.concurrent_recoveries)])

    def explain(self, index: str, shard: int, node_id: str) -> List[dict]:
        """Per-decider verdicts for placing ``index[shard]`` on
        ``node_id`` — the reroute ``?explain`` payload."""
        from elasticsearch_tpu_torch.cluster.state import ShardRouting

        _, metas = self._placement()
        alloc = self._allocation_view(metas)
        node = self.node.cluster_state.nodes.get(node_id)
        if node is None:
            return [{"decider": "membership", "decision": NO,
                     "explanation": f"node [{node_id}] is not in the "
                                    "cluster"}]
        sr = ShardRouting(index, shard, node_id="", primary=False,
                          state="UNASSIGNED")
        return self._chain().decide_verbose(sr, node, alloc)

    # -- the reconciliation tick ---------------------------------------------

    #: min seconds between periodic ticks (run_fd_round calls every round)
    TICK_INTERVAL_S = 5.0

    def maybe_tick(self) -> None:
        """Rate-limited periodic tick, called from every master-side
        fault-detection round — the loop's heartbeat when no membership
        or settings event drives it."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_tick < self.TICK_INTERVAL_S:
                return
            self._last_tick = now
        self.kick("periodic")

    def kick(self, reason: str) -> None:
        """Async tick — membership/settings events must not block their
        transport handler on usage probes and publishes."""
        if not self.cluster.is_master or self._stop.is_set():
            return
        threading.Thread(target=self._tick_safe, args=(reason,),
                         name="tpu-allocator", daemon=True).start()

    def _tick_safe(self, reason: str) -> None:
        try:
            self.tick(reason)
        except Exception:
            logger.exception("allocator tick [%s] failed", reason)

    def tick(self, reason: str = "periodic") -> List[RelocationTask]:
        """One reconciliation pass. Computes candidate moves (drain →
        watermark → rebalance), runs each through the decider chain, and
        starts the survivors on background streams. Returns the tasks it
        started (tests drive ticks synchronously)."""
        if not self.enabled or self._stop.is_set() \
                or not self.cluster.is_master:
            return []
        state = self.node.cluster_state
        alive = set(state.nodes)
        per_node, metas = self._placement()
        moves = self._plan(per_node, metas, alive)
        if not moves:
            return []
        alloc = self._allocation_view(metas)
        chain = self._chain()
        started: List[RelocationTask] = []
        for index, sid, source, target_hint, why, banned in moves:
            if len(started) >= self.MAX_MOVES_PER_TICK:
                break
            task = self._try_start(index, sid, source, target_hint, why,
                                   banned, alive, metas, alloc, chain)
            if task is not None:
                started.append(task)
        return started

    def _plan(self, per_node, metas, alive):
        """Candidate moves as (index, sid, source, target_hint, reason,
        banned). target_hint None = let the decider chain pick."""
        moves: list = []
        inflight_keys = set()
        with self._lock:
            inflight_keys = {(t.index, t.shard, t.source)
                             for t in self.inflight.values()}
        excluded = {nid for nid in alive
                    if (n := self.node.cluster_state.nodes.get(nid))
                    is not None and self.filter.excludes(n)}

        def _movable(nid):
            # primaries first off a draining node: the term-bump path is
            # the risky half of a drain, get it done while replicas
            # still provide redundancy
            return sorted(per_node.get(nid, ()),
                          key=lambda c: (not c[2], c[0], c[1]))

        for nid in sorted(excluded):                       # 1. drain
            for index, sid, _primary in _movable(nid):
                if (index, sid, nid) not in inflight_keys:
                    moves.append((index, sid, nid, None, "drain", set()))
        for nid in sorted(alive - excluded):               # 2. watermark
            if not self.watermark.over_high(nid):
                continue
            for index, sid, _primary in _movable(nid)[:1]:
                # one shard per tick per hot node: move, re-measure,
                # repeat — pressure relief must not itself flood HBM
                if (index, sid, nid) not in inflight_keys:
                    moves.append((index, sid, nid, None, "watermark",
                                  set()))
        # 3. rebalance: nodes with spare capacity pull from the fullest
        eligible = [nid for nid in sorted(alive - excluded)
                    if self.watermark.level(nid) == "ok"]
        if len(eligible) >= 2:
            # who holds which shard (owners + initializing): the
            # destination must not already hold a copy of the shard it
            # pulls, or SameShardDecider vetoes the hinted move every
            # tick and the imbalance never converges
            holders: Dict[Tuple[str, int], Set[str]] = {}
            for nid, copies in per_node.items():
                for index, sid, _p in copies:
                    holders.setdefault((index, sid), set()).add(nid)
            counts = {nid: len(per_node.get(nid, ())) for nid in eligible}
            for _ in range(self.MAX_MOVES_PER_TICK):
                lo = min(counts, key=lambda n: (counts[n], n))
                hi = max(counts, key=lambda n: (counts[n], n))
                if counts[hi] - counts[lo] <= 1:
                    break
                picked = None
                for index, sid, _primary in _movable(hi):
                    if (index, sid, hi) in inflight_keys:
                        continue
                    if any(m[0] == index and m[1] == sid for m in moves):
                        continue
                    if lo in holders.get((index, sid), ()):
                        continue  # lo already holds this shard
                    picked = (index, sid, hi, lo, "rebalance", set())
                    break
                if picked is None:
                    break
                moves.append(picked)
                holders.setdefault((picked[0], picked[1]), set()).add(lo)
                per_node.setdefault(lo, []).append(
                    (picked[0], picked[1], False))
                per_node[hi] = [c for c in per_node[hi]
                                if (c[0], c[1]) != (picked[0], picked[1])]
                counts[hi] -= 1
                counts[lo] += 1
        return moves

    def _try_start(self, index, sid, source, target_hint, why, banned,
                   alive, metas, alloc, chain) -> Optional[RelocationTask]:
        """Decide a target through the chain and launch the stream; None
        when no node is currently eligible (THROTTLE defers — the next
        tick retries; NO everywhere parks the move)."""
        from elasticsearch_tpu_torch.cluster.state import ShardRouting

        meta = metas.get(index)
        if meta is None:
            return None
        owners = meta.get("assignment", {}).get(str(sid), [])
        init = meta.get("initializing", {}).get(str(sid), [])
        holders = set(owners) | set(init)
        if source not in owners:
            return None  # raced: the copy already moved or died
        sr = ShardRouting(index, sid, node_id="", primary=False,
                          state="UNASSIGNED")
        candidates = [target_hint] if target_hint else \
            sorted(alive - holders - banned - {source},
                   key=lambda n: (len([r for r in alloc.assigned
                                       if r.node_id == n]), n))
        target = None
        for cand in candidates:
            if cand is None or cand in holders or cand in banned \
                    or cand not in alive:
                continue
            node = self.node.cluster_state.nodes.get(cand)
            if node is None:
                continue
            try:
                FAULTS.check("allocation.decide", index=index, shard=sid,
                             source=source, target=cand, reason=why)
            except Exception:
                self.decide_faults += 1
                continue  # an injected veto parks THIS candidate only
            verdict = chain.decide(sr, node, alloc)
            if verdict == ALWAYS:
                target = cand
                break
            # THROTTLE: this node is at its concurrent-recovery cap;
            # NO: ineligible — either way, try the next candidate
        if target is None:
            return None
        task = self._start_relocation(index, sid, source, target, why,
                                      banned)
        if task is not None:
            # the shared view must see THIS start, or every later move in
            # the same tick reads a stale throttle count and one drain
            # tick can exceed node_concurrent_recoveries at one target
            alloc.assigned.append(ShardRouting(index, sid, node_id=target,
                                               primary=False,
                                               state="INITIALIZING"))
        return task

    # -- relocation execution ------------------------------------------------

    def _start_relocation(self, index, sid, source, target, why,
                          banned) -> Optional[RelocationTask]:
        """Register the move, publish the INITIALIZING target (two-phase
        — a lost quorum aborts before any stream runs), and launch the
        stream thread."""
        task = RelocationTask(index, sid, source, target, why, banned)
        with self._lock:
            if task.key in self.inflight:
                return None
            self.inflight[task.key] = task
            self.peak_inflight = max(self.peak_inflight, len(self.inflight))
        body = None
        try:
            with self.cluster._indices_lock:
                meta = self.cluster.dist_indices.get(index)
                owners = (meta or {}).get("assignment", {}).get(str(sid))
                if meta is None or not owners or source not in owners \
                        or target in owners:
                    raise LookupError("placement changed under the move")
                body = meta.get("body")
                pend = meta.setdefault("initializing", {}) \
                    .setdefault(str(sid), [])
                if target not in pend:
                    pend.append(target)
            self.cluster.publish_indices()
        except Exception:
            # no quorum / raced placement: roll the target back out —
            # nothing streamed yet, so the rollback is metadata-only
            with self.cluster._indices_lock:
                meta = self.cluster.dist_indices.get(index)
                if meta is not None:
                    pend = meta.get("initializing", {}).get(str(sid), [])
                    if target in pend:
                        pend.remove(target)
            with self._lock:
                self.inflight.pop(task.key, None)
            return None
        self.moves_started += 1
        self._m_moves.labels("started").inc()
        task._directive = {"index": index, "shard": sid, "target": target,
                           "source": source, "body": body,
                           "relocate": True}
        threading.Thread(target=self._run_relocation, args=(task,),
                         name=f"tpu-relocate-{index}-{sid}",
                         daemon=True).start()
        return task

    def _run_relocation(self, task: RelocationTask) -> None:
        """The stream thread: drive the recovery to the target (retrying
        transient failures) and graduate or roll back. The loop gates on
        the task's cancel event and the allocator's stop event, so both
        close() and the watchdog's cancel stop it promptly."""
        data = self.cluster.data
        ok = False
        while not task.cancel.is_set() and not self._stop.is_set():
            task.attempts += 1
            try:
                if task.target == self.node.node_id:
                    data._on_recover(task._directive)
                else:
                    data._send(task.target,
                               _recover_action(), task._directive,
                               timeout=120.0)
                ok = True
                break
            except Exception:
                if task.attempts >= self.MAX_ATTEMPTS:
                    break
                # stop-gated backoff: a cancel (watchdog) or close()
                # interrupts the wait immediately
                if task.cancel.wait(self.RETRY_WAIT_S):
                    break
        self._finish_relocation(task, ok and not task.cancel.is_set())

    def _finish_relocation(self, task: RelocationTask, ok: bool) -> None:
        """Graduate (swap source→target under the lock, term bump when
        the primary moved) or roll back; always release the throttle
        slot; publish the outcome."""
        index, sid = task.index, task.shard
        changed = False
        with self.cluster._indices_lock:
            meta = self.cluster.dist_indices.get(index)
            if meta is not None:
                pend = meta.get("initializing", {}).get(str(sid), [])
                if task.target in pend:
                    pend.remove(task.target)
                    changed = True
                owners = meta.get("assignment", {}).get(str(sid))
                if ok and owners and task.target not in owners \
                        and task.target in self.node.cluster_state.nodes:
                    insync = meta.setdefault("in_sync", {}) \
                        .setdefault(str(sid), [])
                    if task.source in owners:
                        was_primary = owners[0] == task.source
                        pos = owners.index(task.source)
                        owners[pos] = task.target
                        if task.source in insync:
                            insync.remove(task.source)
                        if was_primary:
                            # the primary changed hands: bump the term so
                            # in-flight ops from the old copy are fenced
                            # by everyone who adopts this publish
                            terms = meta.setdefault("primary_terms", {})
                            terms[str(sid)] = \
                                int(terms.get(str(sid), 0)) + 1
                    else:
                        owners.append(task.target)  # source died mid-move
                    if task.target not in insync:
                        insync.append(task.target)
                    changed = True
        with self._lock:
            self.inflight.pop(task.key, None)
        if ok:
            self.moves_completed += 1
            self._m_moves.labels("completed").inc()
        elif task.cancel.is_set():
            self.moves_cancelled += 1
            self._m_moves.labels("cancelled").inc()
        else:
            self.moves_failed += 1
            self._m_moves.labels("failed").inc()
        if changed:
            try:
                self.cluster.publish_indices()
            except Exception:
                # lost quorum mid-move: this master stepped down; the
                # quorum's master re-runs allocation from ITS metadata
                logger.warning("relocation [%s][%s] %s->%s outcome could "
                               "not be published", index, sid,
                               task.source, task.target)

    def cancel_relocation(self, key: Tuple[str, int, str],
                          reschedule: bool = False,
                          reason: str = "cancelled") -> bool:
        """Cancel an in-flight move: pull the cancel gate (the stream
        thread rolls back and releases the slot). With ``reschedule``,
        immediately retry the move onto a different target with the
        wedged one banned — the watchdog's recovery action."""
        with self._lock:
            task = self.inflight.get(key)
        if task is None:
            return False
        task.cancel.set()
        logger.warning("cancelling relocation [%s][%s] %s->%s (%s)",
                       task.index, task.shard, task.source, task.target,
                       reason)
        if reschedule and not self._stop.is_set():
            self.reschedules += 1
            banned = task.banned | {task.target}
            threading.Thread(
                target=self._reschedule_safe,
                args=(task.index, task.shard, task.source, task.reason,
                      banned),
                name="tpu-allocator-resched", daemon=True).start()
        return True

    def _reschedule_safe(self, index, sid, source, why, banned) -> None:
        try:
            alive = set(self.node.cluster_state.nodes)
            _, metas = self._placement()
            alloc = self._allocation_view(metas)
            self._try_start(index, sid, source, None, why, banned, alive,
                            metas, alloc, self._chain())
        except Exception:
            logger.exception("reschedule of [%s][%s] failed", index, sid)

    # -- views / lifecycle ---------------------------------------------------

    def inflight_snapshot(self) -> List[dict]:
        with self._lock:
            return [t.snapshot() for t in self.inflight.values()]

    def drain_status(self) -> Dict[str, int]:
        """node id → copies still placed on it, for every node the
        cluster-level filters exclude — ``{}`` everywhere empty means
        the drain is complete and a kill is safe."""
        per_node, _ = self._placement()
        out: Dict[str, int] = {}
        for nid, dn in self.node.cluster_state.nodes.items():
            if self.filter.excludes(dn):
                out[nid] = len(per_node.get(nid, ()))
        return out

    def stats(self) -> dict:
        with self._lock:
            inflight = len(self.inflight)
        return {"enabled": self.enabled,
                "concurrent_recoveries": self.concurrent_recoveries,
                "inflight": inflight,
                "peak_inflight": self.peak_inflight,
                "moves_started": self.moves_started,
                "moves_completed": self.moves_completed,
                "moves_failed": self.moves_failed,
                "moves_cancelled": self.moves_cancelled,
                "reschedules": self.reschedules,
                "decide_faults": self.decide_faults}

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            tasks = list(self.inflight.values())
        for t in tasks:
            t.cancel.set()


def _recover_action() -> str:
    from elasticsearch_tpu_torch.cluster.search_action import ACTION_RECOVER

    return ACTION_RECOVER
