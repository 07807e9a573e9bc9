"""Multi-process cluster: membership, quorum-elected master, publication.

Port of elasticsearch_tpu/cluster/bootstrap.py (reference:
org/elasticsearch/discovery/zen/ZenDiscovery.java, join / publish / fault
detection, and bootstrap/Bootstrap.java, with the coordination-era
guarantees of cluster/coordination/Coordinator.java): term-based quorum
elections, two-phase (publish → quorum ack → commit) state publication,
stale-term fencing and NO_MASTER write blocks. Each member is one process
with its own node; the control plane and the data plane
(cluster/search_action.py) both ride the TCP JSON transport
(cluster/transport.py).

Process rank 0 bootstraps as the first elected master (term 1); node ids
are rank-prefixed (``0000-…``) so candidacy tiebreaks are deterministic.
After bootstrap, mastership moves only by election: when
``MasterFaultDetection`` declares the master dead, the lowest-id
master-eligible survivor solicits one-vote-per-term ballots over the
transport; a quorum (``minimum_master_nodes``, by default a majority of
the master-eligible voting configuration) wins the bumped term,
reconstructs the distributed index metadata from the freshest
``(term, version)`` copy among its voters, promotes primaries through the
reconcile/term-bump path, and publishes. A master that cannot commit (no
publish quorum, or a follower view below quorum) steps down instead of
split-braining; a headless node blocks writes and metadata
(``cluster_block_exception`` 503) while searches keep serving the last
committed state.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.cluster.discovery import (FaultDetector,
                                                 MasterFaultDetection,
                                                 VoteCollector, ZenDiscovery,
                                                 election_candidate)
from elasticsearch_tpu_torch.cluster.state import NO_MASTER_BLOCK, DiscoveryNode
from elasticsearch_tpu_torch.cluster.transport import (RemoteException,
                                                 TransportService)
from elasticsearch_tpu_torch.utils.errors import (
    ClusterBlockException, FailedToCommitClusterStateException,
    StaleMasterException)
from elasticsearch_tpu_torch.utils.faults import FAULTS

logger = logging.getLogger("elasticsearch_tpu_torch.discovery")


def initialize_distributed(coordinator: str, num_processes: int,
                           process_id: int) -> None:
    """Join the members' process group: ``torch.distributed``'s gloo
    backend over ``tcp://<coordinator>`` (``host:port`` of process 0, the
    same address every process passes). Idempotent when the group exists.

    Gloo, not NCCL: several members may share one card, and NCCL refuses
    two ranks on one device. No collective crosses processes on the data
    plane either: the query, fetch and write phases ride the JSON
    transport, so the group is the launcher's rendezvous (every member is
    up before any serves) and nothing more."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _node_json(n: DiscoveryNode) -> dict:
    return {"node_id": n.node_id, "name": n.name,
            "transport_address": n.transport_address}


def _vote_key(node_id: str) -> str:
    """Voting-configuration identity of a member: the RANK prefix of its
    `NNNN-<hex>` node id. A restart mints a fresh hex suffix — keying the
    grow-only voting configuration by the full id would let a few
    bounces inflate the quorum past the live node count and brick the
    cluster headless; the rank is the stable identity of the seat."""
    head, sep, _ = node_id.partition("-")
    return head if sep else node_id


class MultiHostCluster:
    """Control-plane membership for one process of the distributed world."""

    def __init__(self, node, rank: int, world: int,
                 bind_host: str = "127.0.0.1", transport_port: int = 9300,
                 master_host: str = "127.0.0.1",
                 ping_interval: float = 1.0, ping_retries: int = 3,
                 minimum_master_nodes: Optional[int] = None):
        self.node = node
        self.rank = rank
        self.world = world
        nid = f"{rank:04d}-{node.node_id}"
        # ONE identity everywhere: cluster state, /_nodes maps, cat rows
        # (the reference's node id is likewise a single value across APIs);
        # the rank prefix stays so lowest-id candidacy is deterministic.
        # Gateway-recovered indices registered their shard routings under
        # the PRE-rename id — rewrite them, or the routing table dangles
        # on a node id no nodes/_nodes map contains
        old_id = node.node_id
        node.node_id = nid
        # observability identities follow the rename: task ids and span
        # node tags must carry the cluster-visible id, or /_tasks entries
        # from this node would name an id no nodes map contains
        node.tasks.node_id = nid
        node.tracer.node_id = nid
        # and so does the flight recorder's (the reference's keeps the
        # id from before the rename, which no nodes map contains)
        fl = getattr(node, "flight", None)
        if fl is not None:
            fl.node_id = nid
        state = node.cluster_state
        for r in state.routing:
            if r.node_id == old_id:
                r.node_id = nid
        state.nodes.clear()  # replace the single-node bootstrap entry
        self.transport = TransportService(nid)
        # remote sends/handles record spans on this node's tracer and
        # stitch into one trace via the frame ctx header
        self.transport.tracer = node.tracer
        # and counters/latency land in this node's metrics registry
        # (rx/tx bytes, per-action rounds, retry/breaker-open counts)
        self.transport.metrics = node.metrics
        host, port = self.transport.bind(
            bind_host, transport_port if rank == 0 else 0)
        self.local = DiscoveryNode(nid, node.name,
                                   transport_address=f"{host}:{port}")
        self.discovery = ZenDiscovery(state, self.local, vote_master=True)
        #: explicit quorum; None = majority of the master-eligible VOTING
        #: CONFIGURATION (every master-eligible RANK ever seen — grow-only,
        #: so a partition cannot shrink the quorum it must clear, keyed by
        #: rank so restart-minted node ids cannot inflate it)
        self.minimum_master_nodes = minimum_master_nodes
        self._voting_config: set = {_vote_key(nid)}
        self._seed_addr: Tuple[str, int] = (master_host, transport_port)
        #: every member address ever observed (grow-only): the headless
        #: rejoin scan and vote solicitation reach nodes the local view
        #: may have already dropped
        self._peer_addrs: Dict[str, Tuple[str, int]] = {}
        self._ping_retries = ping_retries
        #: one ballot per term (VoteCollector) + the election serializer
        self._votes = VoteCollector()
        self._election_lock = threading.Lock()
        #: while campaigning for term T, publications below T are fenced
        #: (Raft's candidacy term bump; _votes.highest_granted() extends
        #: the same floor to every ballot this node GRANTED, so a master
        #: deposed by an election it can't see is fenced by the voters
        #: themselves — see _term_floor)
        self._campaign_term = 0
        #: highest (term, version) cluster state COMMITTED on this node;
        #: the bounded history is the chaos-audit trail (conflicting-
        #: commit detection), not a log — 512 commits of lookback
        self.committed: Tuple[int, int] = (0, 0)
        self.committed_history: deque = deque(maxlen=512)
        #: phase-1 publication parked until its commit arrives; the slot
        #: is read/written under the discovery lock (concurrent handler
        #: threads must not interleave a park with a commit's
        #: read-compare-clear)
        self._pending_publish: Optional[dict] = None
        #: serializes _publish: concurrent publishers must never ship
        #: different states under one (term, version)
        self._publish_lock = threading.Lock()
        self._adopted_version = -1
        self._adopted_term = 0
        self._stop = threading.Event()
        self._fd_thread: Optional[threading.Thread] = None
        self._fd_rounds = 0  # anti-entropy cadence (every 5th round)
        #: master-side follower detection and follower-side master
        #: detection — persistent across rounds so strikes accumulate
        self._node_fd = FaultDetector(self._ping, self._on_node_failed,
                                      ping_retries=ping_retries)
        self._master_fd = MasterFaultDetection(self._ping,
                                               self._on_master_failed,
                                               ping_retries=ping_retries)
        #: address-less members the fault detector cannot probe
        #: (satellite gauge estpu_discovery_unpingable; logged once each)
        self._unpingable: set = set()
        self._indices_lock = threading.RLock()
        # indices metadata is versioned separately from membership so a
        # stale join reply can't roll back a newer publish (same reason
        # _adopt guards with _adopted_version/_adopted_term)
        self._indices_version = 0
        self._indices_adopted = -1
        self._indices_adopted_term = 0
        #: the master term the current dist metadata was last written or
        #: adopted under — the freshness half of the (term, version) key
        #: metadata takeover compares across voters
        self._meta_term = 0
        #: the highest (meta_term, indices_version) this node knows to be
        #: quorum-COMMITTED — the key it ADVERTISES on vote replies and
        #: join requests. The working key above advances (and persists)
        #: before publish quorum, so advertising it would let a
        #: stepped-down master's uncommitted mutations win a metadata
        #: takeover labeled as "the freshest committed copy"
        self._committed_meta: Tuple[int, int] = (0, 0)
        #: the dist-indices content AS OF _committed_meta — what
        #: discovery:meta serves, so post-commit working-copy mutations
        #: (a conservative in-sync shrink on a stepped-down master)
        #: can't ride a takeover fetch labeled committed
        self._committed_snapshot: dict = {}
        # distributed index metadata: name -> {body, num_shards,
        # assignment {shard_id_str: node_id}} — master-authoritative,
        # carried on join replies and publishes (the routing-table slice of
        # the reference's published ClusterState)
        self.dist_indices: dict = {}
        # names this process has adopted as distributed — a name that
        # disappears from a publish was deleted cluster-wide
        self._dist_known: set = set()
        if node.data_path:
            # EVERY member persists the dist metadata it adopted (not just
            # rank 0): metadata takeover reconstructs from the freshest
            # (term, version) copy among the new master's voters, and a
            # whole-cluster restart recovers the layout from whichever
            # disk survived (reference: the gateway persists the cluster
            # state's MetaData on all master-eligible nodes)
            self._meta_path = os.path.join(node.data_path, "_cluster",
                                           "dist_indices.json")
            # the Raft durable pair (cluster term + last granted ballot)
            # lives in its OWN small fsynced file: the election path must
            # be durable BEFORE every vote reply, and rewriting the full
            # dist-meta blob (all index metadata) per ballot would make
            # each vote cost a metadata-sized write. The blob still
            # snapshots the pair on its own writes; ballot.json outranks
            # on load when newer.
            self._ballot_path = os.path.join(node.data_path, "_cluster",
                                             "ballot.json")
            # serializes read-pair-then-write: two concurrent grants
            # racing unserialized could land the STALER pair last on
            # disk (a leaf lock — never held while acquiring others)
            self._ballot_lock = threading.Lock()
            # EVERY rank loads (not just the bootstrap master): a
            # non-rank-0 survivor advertises its disk copy's freshness on
            # vote replies AND on its join request, so both metadata
            # takeover and a whole-cluster restart can recover the layout
            # from whichever disk held the freshest committed copy —
            # persisting on all ranks would otherwise be write-only
            self._load_dist_meta()
            # after the blob: a voter can have granted ballots before any
            # metadata ever existed, and a newer ballot must outrank the
            # blob's last snapshot of the pair
            self._load_ballot()
        else:
            self._meta_path = None
            self._ballot_path = None
        from elasticsearch_tpu_torch.cluster.search_action import \
            DistributedDataService

        self.data = DistributedDataService(self)
        from elasticsearch_tpu_torch.cluster.allocator import ClusterAllocator

        # the live allocation loop: master-driven desired-vs-actual
        # placement reconciliation (join rebalancing, watermark relief,
        # drain) — ticked from joins, settings changes, and fd rounds
        self.allocator = ClusterAllocator(self)
        # REST handlers route dist-index operations through the data
        # plane when this hook is present (rest/server.py::_mh)
        node.multihost = self
        t = self.transport
        t.register("cluster:publish", self._on_publish)
        t.register("cluster:publish_commit", self._on_publish_commit)
        t.register("cluster:join", self._on_join)
        t.register("cluster:leave", self._on_leave)
        t.register("cluster:nodes",
                   lambda p: [_node_json(n) for n in state.nodes.values()])
        t.register("cluster:state_brief", self._on_state_brief)
        t.register("discovery:request_vote", self._on_request_vote)
        t.register("discovery:meta", self._on_meta)
        if rank == 0:
            if self.quorum() > 1:
                # this disk remembers a multi-node era (persisted voting
                # config has peers) and no explicit minimum_master_nodes
                # says one seat suffices: self-appointing as a one-seat
                # master would split-brain against a possibly-live
                # cluster — the in-memory quorum would be 1 while the
                # real quorum is a majority of the remembered seats.
                # Start HEADLESS: the boot-time scan rejoins a live
                # master at a persisted peer address, and after a
                # whole-cluster restart the first joiner's arrival
                # triggers a proper quorum election instead (_on_join).
                state.master_node_id = None
                self._go_headless()
                try:
                    self._try_join_cluster()
                except Exception:
                    logger.exception("boot-time rejoin scan failed")
            else:
                # bootstrap election: the coordinator everyone joins is
                # the first master, under term 1 (the zen lowest-id rule
                # with the process rank as the tiebreak) — a
                # fresh disk or a single-seat world boots standalone
                state.master_node_id = nid
                state.term = max(state.term, 1)
                self._meta_term = max(self._meta_term, state.term)
        else:
            # the master may still be binding its transport (Node() startup
            # cost varies — translog replay, the device's first use); retry with backoff
            # instead of dying on the startup race
            state.master_node_id = None  # no master until the join lands
            got = None
            joined = False
            for attempt in range(30):
                try:
                    got = self.transport.send_remote(
                        self._seed_addr, "cluster:join",
                        self._join_payload())
                    break
                except Exception:
                    # the seed may no longer be the master (mastership
                    # moves by election) or may be gone: scan the
                    # persisted peer addresses for the LIVE master
                    # before retrying the seed — without this a
                    # restarted member could never rejoin a cluster
                    # whose mastership moved off rank 0
                    if self._peer_addrs:
                        try:
                            joined = self._try_join_cluster()
                        except Exception:  # scan is best-effort
                            joined = False
                        if joined:
                            break
                    if attempt == 29:
                        raise
                    time.sleep(min(0.2 * (attempt + 1), 2.0))
            if not joined:
                self._apply_join_reply(got)
        if ping_interval > 0:
            self._fd_thread = threading.Thread(
                target=self._fault_loop, args=(ping_interval,),
                name="tpu-fault-detector", daemon=True)
            self._fd_thread.start()
        # a cluster member is a serving node: the watchdog ticks for the
        # life of the member (ESTPU_WATCHDOG=0 opts out)
        wd = getattr(node, "watchdog", None)
        if wd is not None:
            wd.ensure_started()

    # -- quorum / blocks ------------------------------------------------------

    @property
    def master_addr(self) -> Tuple[str, int]:
        """The CURRENT master's transport address (the seed coordinator
        address until a committed state names another master)."""
        state = self.node.cluster_state
        m = state.nodes.get(state.master_node_id or "")
        if m is not None and ":" in m.transport_address:
            h, p = m.transport_address.rsplit(":", 1)
            return h, int(p)
        return self._seed_addr

    def quorum(self) -> int:
        """Votes/acks an election or publication must gather.
        ``minimum_master_nodes`` when configured, else a majority of the
        grow-only master-eligible voting configuration — NEVER of the
        live view, which a partition shrinks (the split-brain hole)."""
        if self.minimum_master_nodes is not None:
            return max(1, int(self.minimum_master_nodes))
        return len(self._voting_config) // 2 + 1

    def ensure_not_blocked(self, level: str = "write") -> None:
        """Raise the typed 503 when a global block (or simply the absence
        of an elected master) covers ``level`` — the ES NO_MASTER_BLOCK
        write semantics: metadata and writes fail, searches keep serving
        the last committed state."""
        state = self.node.cluster_state
        b = state.global_block(level)
        if b is None and state.master_node_id is None \
                and level in NO_MASTER_BLOCK["levels"]:
            b = NO_MASTER_BLOCK
        if b is not None:
            raise ClusterBlockException([b])

    def _go_headless(self) -> None:
        """No elected master: block writes/metadata, keep serving reads."""
        self.node.cluster_state.add_global_block(NO_MASTER_BLOCK)

    def _clear_headless(self) -> None:
        self.node.cluster_state.clear_global_block(NO_MASTER_BLOCK["id"])

    def step_down(self, reason: str = "") -> None:
        """This node stops being master WITHOUT committing anything more:
        it lost its publish/follower quorum or saw a newer term. The
        membership view survives (searches keep serving); writes block
        until a quorum master publishes a committed state here."""
        state = self.node.cluster_state
        with self.discovery._lock:
            if state.master_node_id != self.local.node_id:
                return
            state.master_node_id = None
            state.next_version()
        self._go_headless()
        logger.warning("[%s] stepping down as master: %s",
                       self.local.node_id, reason or "quorum lost")
        self._flight("cluster", event="step_down",
                     reason=reason or "quorum lost")
        try:
            self.node.metrics.counter(
                "estpu_discovery_master_stepdowns_total",
                "Masters that resigned on lost quorum or a newer term"
            ).inc()
        except Exception:  # metrics never gate
            pass           # a step-down

    def _note_peer(self, node_id: str, transport_address: str) -> None:
        if ":" in transport_address:
            h, p = transport_address.rsplit(":", 1)
            # a restart mints a fresh id for the same SEAT: drop the
            # superseded same-rank entries or the persisted address book
            # grows one dead 2s-timeout probe per bounce forever
            rank = _vote_key(node_id)
            for old in [nid for nid in self._peer_addrs
                        if nid != node_id and _vote_key(nid) == rank]:
                del self._peer_addrs[old]
            self._peer_addrs[node_id] = (h, int(p))
        self._voting_config.add(_vote_key(node_id))

    def _persist_membership(self) -> None:
        """Best-effort persist after a membership change: the voting
        config and peer addresses ride the dist-meta blob, and a restart
        must remember its seats/peers even on an index-less cluster
        (where no metadata mutation would otherwise trigger a write)."""
        with self._indices_lock:
            self._persist_dist_meta()

    # -- master handlers ----------------------------------------------------

    def _require_master(self, action: str) -> None:
        state = self.node.cluster_state
        if state.master_node_id is None:
            raise ClusterBlockException([NO_MASTER_BLOCK])
        if state.master_node_id != self.local.node_id:
            from elasticsearch_tpu_torch.cluster.transport import TransportError

            raise TransportError(
                f"[{action}] sent to [{self.local.node_id}] which is not "
                f"the master; current master is "
                f"[{state.master_node_id}]")

    def _join_payload(self) -> dict:
        """The join request: this node's identity plus its dist-metadata
        freshness key, so a master holding a staler committed copy (e.g.
        a freshly-bootstrapped rank 0 after a whole-cluster restart that
        lost its disk) adopts the joiner's instead of wiping it."""
        p = _node_json(self.local)
        p["meta_term"], p["indices_version"] = self._committed_meta
        return p

    def _on_join(self, payload: dict) -> dict:
        if self.node.cluster_state.master_node_id is None:
            # a join reaching a HEADLESS node is itself the discovery
            # signal (zen: joins trigger elections): admit the joiner to
            # the electorate and run a quorum election right now — a
            # restarted seed node recovering a whole-cluster restart wins
            # it once enough seats are back; anything short of quorum
            # fails typed below and the joiner retries
            self._note_peer(payload["node_id"],
                            payload.get("transport_address", "local"))
            self.discovery.join(DiscoveryNode(
                payload["node_id"], payload.get("name", ""),
                payload.get("transport_address", "local")))
            self._start_election()
        self._require_master("cluster:join")
        self._note_peer(payload["node_id"],
                        payload.get("transport_address", "local"))
        self.discovery.join(DiscoveryNode(
            payload["node_id"], payload.get("name", ""),
            payload.get("transport_address", "local")))
        # a rejoining seat supersedes its old-id twin: the stale entry
        # answers pings at the same address (never reaped) and would
        # double-count acks/quorum for one live process. NEVER evict the
        # local node — a master handling its own seat's twin must not
        # depose itself (a duplicate live process simply joins as a
        # follower and the rank-keyed quorum dedup keeps counts honest)
        rank = _vote_key(payload["node_id"])
        for stale in [nid for nid in self.node.cluster_state.nodes
                      if nid != payload["node_id"]
                      and nid != self.local.node_id
                      and _vote_key(nid) == rank]:
            self.discovery.leave(stale)
        self._persist_membership()
        # gateway recovery on join: a joiner advertising a FRESHER
        # committed (term, version) metadata copy than the master's is a
        # surviving disk from a previous era — fetch and adopt it before
        # allocating, the same freshest-copy rule metadata takeover
        # applies to voters (without this, every non-rank-0 disk is
        # write-only and a restart under a fresh rank 0 loses the layout)
        jkey = (int(payload.get("meta_term", 0)),
                int(payload.get("indices_version", 0)))
        if jkey > self._committed_meta:
            addr = self._peer_addrs.get(payload["node_id"])
            if addr is not None:
                try:
                    got = self.transport.send_remote(
                        addr, "discovery:meta", {}, timeout=5.0)
                    self._adopt_indices(
                        got.get("indices", {}),
                        int(got.get("indices_version", 0)),
                        term=int(got.get("meta_term", 0)), elected=True)
                except Exception:
                    from elasticsearch_tpu_torch.cluster.transport import \
                        TransportError

                    # FAIL the join: answering with the staler local
                    # copy would make the joiner delete and overwrite
                    # the only surviving fresher disk copy on adopt —
                    # the joiner retries and the fetch gets another
                    # chance
                    raise TransportError(
                        f"joiner [{payload['node_id']}] advertised "
                        f"fresher metadata {jkey} but the fetch "
                        f"failed; retry the join")
        # allocation pass: under-replicated shards get a copy on the new
        # node, recovered by streaming from a surviving copy
        directives, changed = self.data.reconcile()
        if changed:
            self._bump_indices_version()
        if not self._publish():
            # the join never committed (the master stepped down mid-way):
            # a reply would be recorded by the joiner as a COMMITTED
            # (term, version) the quorum never acked — fail typed, the
            # joiner retries against whoever is master next
            raise FailedToCommitClusterStateException(
                "join could not be committed: publish lost quorum")
        self.data.start_recoveries(directives)  # async internally
        # rebalance ONTO the joiner: top-up only covers under-replicated
        # shards — a fully-replicated cluster still wants existing copies
        # spread onto the new capacity (async; throttled by the deciders)
        self.allocator.kick("node-join")
        # gateway allocation: shards that lost EVERY copy (e.g. a master
        # restart while this member was away) adopt the joiner's on-disk
        # data — async, it probes over the transport
        threading.Thread(target=self.data.resurrect_lost,
                         name="tpu-resurrect", daemon=True).start()
        return {"nodes": [_node_json(n)
                          for n in self.node.cluster_state.nodes.values()],
                "master": self.node.cluster_state.master_node_id,
                "term": self.node.cluster_state.term,
                "version": self.node.cluster_state.version,
                "indices": self.indices_snapshot(),
                "indices_version": self._indices_version}

    def _on_leave(self, payload: dict) -> dict:
        self._require_master("cluster:leave")
        self.discovery.leave(payload["node_id"])
        directives, changed = self.data.reconcile()
        if changed:
            self._bump_indices_version()
        if self._publish():
            self.data.start_recoveries(directives)
        self.allocator.kick("node-leave")
        return {"ok": True}

    def _on_state_brief(self, payload: dict) -> dict:
        """Lightweight discovery probe: who does THIS node believe is
        master, under which term, and where? (the headless rejoin scan's
        input — reference: zen pinging's master discovery)."""
        state = self.node.cluster_state
        m = state.nodes.get(state.master_node_id or "")
        return {"master": state.master_node_id, "term": state.term,
                "version": state.version,
                "committed": list(self.committed),
                "master_address": (m.transport_address
                                   if m is not None else None)}

    # -- election ------------------------------------------------------------

    def _term_floor(self) -> int:
        """The lowest publication term this node will still honor: its
        committed cluster term, raised by an in-flight candidacy of its
        own AND by every ballot it granted (a voter that elected term T
        must fence a deposed master's term-(T-1) publishes even before
        the winner's first publish arrives — otherwise the old master
        can gather a quorum of acks from the new master's own voters
        and commit a divergent state)."""
        return max(self.node.cluster_state.term, self._campaign_term,
                   self._votes.highest_granted())

    def _accepted_meta(self) -> Tuple[int, int]:
        """The freshest metadata key this node can VOUCH for: its
        committed copy, or a parked phase-1 publication that outranks it.
        Advertising the parked state is Raft's leader-completeness rule:
        a master that gathered quorum acks (all parked, volatile) and
        died before the commit fan-out may already have ACKED the client
        — any new quorum intersects the acking one, so at least one
        voter advertises the parked copy and the election recovers the
        acknowledged change instead of silently discarding it."""
        park = self._pending_publish
        pk = (0, 0)
        if park and "indices" in park:
            pk = (int(park.get("term", 0)),
                  int(park.get("indices_version", 0)))
        return max(self._committed_meta, pk)

    def _on_request_vote(self, payload: dict) -> dict:
        """Grant or refuse a ballot: one vote per term, never for a term
        at or below the highest committed one. The reply carries this
        voter's dist-metadata freshness key so the winner can reconstruct
        from the highest (term, version) copy among its voters."""
        term = int(payload["term"])
        candidate = payload["candidate"]
        FAULTS.check("discovery.vote", term=term, candidate=candidate,
                     voter=self.local.node_id)
        with self.discovery._lock:
            granted = self._votes.grant(term, candidate,
                                        self.node.cluster_state.term)
        if granted:
            # the ballot is durable BEFORE the reply (Raft's votedFor
            # fsync): a voter that bounces after granting must not grant
            # the same term to a second candidate. Only the small
            # ballot.json is written — not the full dist-meta blob.
            self._persist_ballot()
        # the voter's identity rides the grant: the winner must admit its
        # electorate to the view BEFORE the takeover publish, or that
        # publish reaches nobody and the new master immediately steps
        # down (a restarted candidate's view is only itself)
        adv = self._accepted_meta()
        return {"granted": granted, "term": self.node.cluster_state.term,
                "meta_term": adv[0], "indices_version": adv[1],
                "voter": self.local.node_id,
                "voter_name": self.local.name,
                "voter_address": self.local.transport_address}

    def _on_meta(self, payload: dict) -> dict:
        """Full dist-metadata snapshot with its freshness key (the
        takeover fetch after a vote reply advertised a fresher copy)."""
        park = self._pending_publish
        if park and "indices" in park \
                and (int(park.get("term", 0)),
                     int(park.get("indices_version", 0))) \
                > self._committed_meta:
            # the parked (quorum-acked but uncommitted) copy is what the
            # vote reply advertised — serve exactly it
            return {"meta_term": int(park.get("term", 0)),
                    "indices_version": int(park.get("indices_version",
                                                    0)),
                    "indices": park["indices"]}
        with self._indices_lock:
            snap = self._committed_snapshot \
                if self._committed_snapshot or not self.dist_indices \
                else self.indices_snapshot()  # disk-loaded, pre-commit
            return {"meta_term": self._committed_meta[0],
                    "indices_version": self._committed_meta[1],
                    "indices": snap}

    def _eligible_members(self) -> List[DiscoveryNode]:
        """One entry per SEAT: a restarted member can transiently leave
        its old-id twin in the view (same rank, same address, both
        pingable) — counting both would inflate quorum checks and
        double-count publish acks from one live process."""
        by_rank: Dict[str, DiscoveryNode] = {}
        for n in self.node.cluster_state.nodes.values():
            if "master" in n.roles:
                by_rank[_vote_key(n.node_id)] = n
        return list(by_rank.values())

    def _start_election(self) -> bool:
        """Solicit one-vote-per-term ballots from every master-eligible
        member; quorum wins the bumped term and takes over. Returns True
        when this node became master."""
        with self._election_lock:
            state = self.node.cluster_state
            if state.master_node_id is not None:
                return state.master_node_id == self.local.node_id
            # base past any term this node already granted a ballot in:
            # a one-vote-per-term book means a campaign for an already-
            # voted term can never gather this voter again — start fresh
            term = max(state.term, self._votes.highest_granted()) + 1
            with self.discovery._lock:
                # the candidate votes for itself — through the same
                # one-vote-per-term book every other ballot uses
                if not self._votes.grant(term, self.local.node_id,
                                         state.term):
                    return False
                self._campaign_term = term
            # the SELF-ballot is durable too (same Raft votedFor rule as
            # _on_request_vote): a candidate that wins, commits on a
            # voter, and bounces before persisting could otherwise grant
            # its own term to the next candidate — two winners of one
            # term
            self._persist_ballot()
            try:
                return self._run_campaign(term)
            finally:
                self._campaign_term = 0

    def _run_campaign(self, term: int) -> bool:
        """The solicitation half of _start_election, under its lock and
        the campaign-term fence (an old master's in-flight publication
        must not rebuild the view mid-count)."""
        votes = 1
        voters: List[Tuple[str, str, str]] = []  # (id, name, address)
        peer_term = 0  # highest current term any voter reported
        # freshest metadata seen: (meta_term, indices_version, addr) —
        # the local base includes OUR parked publication (addr None =
        # local; _takeover adopts the own park when it stays freshest)
        acc = self._accepted_meta()
        best = (acc[0], acc[1], None)
        # the solicitation set is every DISTINCT address this node can
        # reach — view members first, then every persisted/observed peer
        # address outside the view: a restarted master's view is only
        # {self}, and a campaign that cannot reach live voters beyond it
        # can never clear quorum (one process = one address = one
        # ballot; VoteCollector enforces one vote per term regardless)
        solicit: Dict[Tuple[str, int], str] = {}
        for n in self._eligible_members():
            if n.node_id == self.local.node_id:
                continue
            addr = self._peer_addrs.get(n.node_id)
            if addr is None and ":" in n.transport_address:
                h, p = n.transport_address.rsplit(":", 1)
                addr = (h, int(p))
            if addr is not None:
                solicit[addr] = n.node_id
        own = None
        if ":" in self.local.transport_address:
            h, p = self.local.transport_address.rsplit(":", 1)
            own = (h, int(p))
        for nid, addr in sorted(self._peer_addrs.items()):
            if nid != self.local.node_id and addr != own:
                solicit.setdefault(addr, nid)
        for addr in solicit:
            try:
                resp = self.transport.send_remote(
                    addr, "discovery:request_vote",
                    {"term": term, "candidate": self.local.node_id},
                    timeout=2.0)
            except Exception:
                continue  # unreachable voter: no ballot
            peer_term = max(peer_term, int(resp.get("term", 0)))
            if resp.get("granted"):
                votes += 1
                if resp.get("voter"):
                    voters.append((resp["voter"],
                                   resp.get("voter_name", ""),
                                   resp.get("voter_address",
                                            f"{addr[0]}:{addr[1]}")))
                key = (int(resp.get("meta_term", 0)),
                       int(resp.get("indices_version", 0)))
                if key > best[:2]:
                    best = (key[0], key[1], addr)
        quorum = self.quorum()
        won = votes >= quorum
        try:
            self.node.metrics.counter(
                "estpu_discovery_elections_total",
                "Quorum master elections run by this node, by outcome",
                ("outcome",)).labels("won" if won else "lost").inc()
        except Exception:  # metrics never
            pass           # gate an election
        if not won:
            logger.warning(
                "[%s] election for term %d failed: %d/%d votes",
                self.local.node_id, term, votes, quorum)
            if peer_term > self.node.cluster_state.term:
                # Raft's term fast-forward: voters refuse campaigns at or
                # below their current term — without adopting the highest
                # reported one, catching up to a peer with a high
                # persisted term costs one failed election PER term
                with self.discovery._lock:
                    self.node.cluster_state.term = max(
                        self.node.cluster_state.term, peer_term)
                self._persist_membership()
            return False  # stays headless: no quorum -> no master
        return self._takeover(term, best, voters)

    def _takeover(self, term: int, best_meta: tuple,
                  voters: Optional[List[Tuple[str, str, str]]] = None
                  ) -> bool:
        """Win the election: admit the granting voters to the view (the
        takeover publish must reach the electorate — a restarted
        candidate's view is only itself), adopt the freshest voter
        metadata, bump the cluster term, promote primaries (which bumps
        their shard terms so old-era zombies stay fenced), and publish
        the committed state."""
        for vid, vname, vaddr in voters or []:
            if vid not in self.node.cluster_state.nodes:
                self._note_peer(vid, vaddr)
                self.discovery.join(DiscoveryNode(vid, vname, vaddr))
        if best_meta[2] is None:
            # the freshest accepted copy is LOCAL — possibly our own
            # parked (quorum-acked, uncommitted) publication: adopt it
            # now so the acked change the dead master never finished
            # committing survives into the new reign
            park = self._pending_publish
            if park and "indices" in park \
                    and (int(park.get("term", 0)),
                         int(park.get("indices_version", 0))) \
                    > self._committed_meta:
                self._adopt_indices(park["indices"],
                                    int(park.get("indices_version", 0)),
                                    term=int(park.get("term", 0)),
                                    elected=True)
        if best_meta[2] is not None:
            got = None
            for _ in range(2):
                try:
                    got = self.transport.send_remote(
                        best_meta[2], "discovery:meta", {}, timeout=5.0)
                    break
                except Exception:
                    continue
            if got is None:
                # the election chose that copy as the freshest COMMITTED
                # metadata: proceeding with the staler local copy would
                # stamp it with the new term, permanently outranking the
                # fresher one and deleting its indices cluster-wide on
                # the next publish. ABORT — stay headless; the next
                # fault-detection round re-elects (fresh term) and the
                # fetch gets another chance
                logger.warning(
                    "[%s] could not fetch the elected dist metadata "
                    "from %s; aborting takeover of term %d",
                    self.local.node_id, best_meta[2], term)
                return False
            self._adopt_indices(got.get("indices", {}),
                                int(got.get("indices_version", 0)),
                                term=int(got.get("meta_term", 0)),
                                elected=True)
        state = self.node.cluster_state
        with self.discovery._lock:
            state.term = term
            state.master_node_id = self.local.node_id
            state.next_version()
        # under _indices_lock like every other _meta_term write: this
        # stamp races the _on_meta/_on_publish transport handlers, and a
        # torn read there would advertise a stale meta term for a fresh
        # snapshot 
        with self._indices_lock:
            self._meta_term = term
        self._clear_headless()
        logger.warning("[%s] elected master for term %d",
                       self.local.node_id, term)
        self._flight("cluster", event="elected", term=term)
        # metadata takeover: drop dead members from every copy list
        # (promoting in-sync survivors under BUMPED shard terms — the
        # reconcile/_sync_local_terms path) and re-replicate
        directives, changed = self.data.reconcile()
        if changed:
            self._bump_indices_version()
        if self._publish():
            self.data.start_recoveries(directives)
            return True
        # the first publish of the new reign found no quorum (the
        # partition is still flapping) — the takeover steps down inside
        # _publish and recoveries must NOT start under a state the
        # majority never saw
        return False

    # -- two-phase publish ----------------------------------------------------

    def _on_publish(self, payload: dict) -> dict:
        """Phase 1 on a follower: fence stale terms (typed 409), adopt
        the publisher's term, PARK the state — nothing applies until the
        commit arrives, so an unquorate publication is never visible."""
        term = int(payload.get("term", 0))
        state = self.node.cluster_state
        with self.discovery._lock:
            floor = self._term_floor()
            if term < floor:
                raise StaleMasterException(
                    payload.get("master") or "?", term, floor)
            newer = term > state.term
            state.term = term
            self._pending_publish = payload
        if newer:
            self._persist_ballot()  # the adopted term is durable (the
            # pair's small file — a term adoption is an election-path
            # write too)
            if self.is_master:
                # a newer master exists: resign after parking its state
                self.step_down(f"saw publication with newer term {term}")
        return {"ok": True, "term": state.term}

    def _on_publish_commit(self, payload: dict) -> dict:
        """Phase 2: apply the parked publication iff it matches the
        committed (term, version) — a commit for a publication this node
        never parked is a protocol error, not silently honored."""
        with self.discovery._lock:  # atomic read-compare-clear
            p = self._pending_publish
            if p is not None \
                    and int(p.get("term", -1)) == int(payload["term"]) \
                    and int(p.get("version", -1)) \
                    == int(payload["version"]):
                self._pending_publish = None
            else:
                p = None
        if p is None:
            from elasticsearch_tpu_torch.cluster.transport import TransportError

            raise TransportError(
                f"no pending publication matching term "
                f"[{payload['term']}] version [{payload['version']}]")
        self._apply_committed(p)
        return {"ok": True}

    def _apply_committed(self, p: dict) -> None:
        term = int(p.get("term", 0))
        if term < self._term_floor():
            # parked BEFORE an election this node has since seen (or is
            # itself running, or granted a ballot in): a stale master's
            # commit must never clobber the quorum's state — the term
            # fence, applied at commit time too
            return
        self._adopt(p["nodes"], p.get("version", 0),
                    master=p.get("master"), term=term)
        if "indices" in p:
            self._adopt_indices(p["indices"], p.get("indices_version", 0),
                                term=term)
        self._record_committed(term, int(p.get("version", 0)))
        self._pin_version(term, int(p.get("version", 0)))
        if self.node.cluster_state.master_node_id is not None:
            self._clear_headless()

    def _pin_version(self, term: int, version: int) -> None:
        """The adopted state is the master's: a member reports the
        published version, as an ES node does, not a count of its own
        local changes while applying it (ROADMAP C25; the reference's
        followers count their own)."""
        with self.discovery._lock:
            if (term, version) == (self._adopted_term,
                                   self._adopted_version):
                self.node.cluster_state.version = version

    def _record_committed(self, term: int, version: int) -> None:
        key = (term, version)
        if key > self.committed:
            self.committed = key
            self.committed_history.append(key)

    def _publish(self) -> bool:
        """Master → members, two-phase: send (term, version, state) to
        every other member, COMMIT only after quorum acks (self
        included), then fan the commit to the ackers. No quorum — or a
        stale-term rejection, which means a newer master exists — and
        this master STEPS DOWN without committing. Returns whether the
        state committed."""
        # the watchdog's board: the publish is visible while in flight (a
        # wedged quorum round is a stall no completion counter shows);
        # the wait for the lock counts
        wd = getattr(self.node, "watchdog", None)
        tok = wd.board.begin("publish_commit") if wd is not None else None
        try:
            with self._publish_lock:
                return self._publish_locked(self.node.cluster_state)
        finally:
            if wd is not None:
                wd.board.end(tok)

    def _flight(self, ring: str, **fields) -> None:
        """Best-effort flight-recorder entry (monitor/flight.py): the
        control plane's election and publish transitions are the
        evidence an incident dump needs to explain a write outage."""
        try:
            fl = getattr(self.node, "flight", None)
            if fl is not None:
                fl.record(ring, **fields)
        except Exception:  # recording must never perturb the control
            pass           # plane

    def _publish_locked(self, state) -> bool:
        # serialized: two concurrent publishers (join handler thread vs a
        # REST metadata op) must never ship DIFFERENT states under one
        # (term, version) — followers dedup on that key and would drop
        # one forever; under the lock the later snapshot simply contains
        # both mutations and the duplicate send dedups harmlessly
        with self.discovery._lock:  # (term, version, nodes) atomically
            nodes = [_node_json(n) for n in state.nodes.values()]
            term, version = state.term, state.version
        with self._indices_lock:  # (state, version) read atomically
            indices = self.indices_snapshot()
            indices_version = self._indices_version
        payload = {"nodes": nodes, "version": version, "term": term,
                   "master": self.local.node_id, "indices": indices,
                   "indices_version": indices_version}
        t0 = time.perf_counter()
        acked: List[Tuple[str, int]] = []
        superseded = False
        seen_addrs: set = set()
        for n in list(state.nodes.values()):
            if n.node_id == self.local.node_id \
                    or ":" not in n.transport_address:
                continue
            host, port = n.transport_address.rsplit(":", 1)
            addr = (host, int(port))
            if addr in seen_addrs:
                # a stale same-seat twin at the same address: one live
                # process must count as ONE ack, or a partitioned master
                # reaches phantom quorum on duplicate entries
                continue
            seen_addrs.add(addr)
            try:
                self.transport.send_remote(addr, "cluster:publish", payload)
                acked.append(addr)
            except RemoteException as e:
                if e.error_type == "stale_master_exception":
                    superseded = True  # a newer term is out there
            except Exception:
                pass  # unreachable: no ack (fault detection will reap it)
        quorum = self.quorum()
        if superseded or 1 + len(acked) < quorum:
            self.step_down(
                "superseded by a newer term" if superseded else
                f"publish reached {1 + len(acked)}/{quorum} acks")
            return False
        # quorum acked: the state IS committed — record it, then fan the
        # commit (a follower missing its commit lags one round and
        # catches up on the next full-state publish)
        self._record_committed(term, version)
        # the (key, content) pair must move together: _on_meta serves
        # `self._committed_snapshot` AS OF `self._committed_meta` under
        # _indices_lock — an unlocked two-field update here let a reader
        # between the two assignments pair the NEW key with the OLD
        # snapshot and hand an elected master stale metadata under a
        # fresh freshness key 
        with self._indices_lock:
            self._committed_meta = max(self._committed_meta,
                                       (term, indices_version))
            self._committed_snapshot = indices  # the deep copy just shipped
        self._flight("cluster", event="publish_commit", term=term,
                     version=version, acks=1 + len(acked))
        try:
            FAULTS.check("publish.commit", term=term, version=version)
        except Exception:
            # the injected master death between phases: followers hold an
            # uncommitted pending state they will never apply; recorded
            # so the watchdog's publish detector trips on the window
            self._flight("cluster", event="publish_commit_window_fault",
                         term=term, version=version)
            return True
        for addr in acked:
            try:
                self.transport.send_remote(
                    addr, "cluster:publish_commit",
                    {"term": term, "version": version})
            except Exception:  # the state IS
                pass  # committed (quorum acked phase 1); a follower that
                # missed its commit lags exactly one round and catches up
                # on the next full-state publish, and a DEAD follower is
                # fault detection's job, not the commit fan-out's
        try:
            self.node.metrics.histogram(
                "estpu_discovery_publish_commit_seconds",
                "Two-phase cluster-state publish latency, phase 1 "
                "through commit fan-out").observe(time.perf_counter() - t0)
        except Exception:  # dropping one metric
            pass           # sample must never fail the publish
        return True

    def _adopt_indices(self, meta: dict, version: int,
                       term: Optional[int] = None,
                       elected: bool = False) -> None:
        """Adopt the master's index metadata; create any index this process
        doesn't hold yet (every process keeps the full S-shard layout so
        shard numbering agrees with shard_id_for everywhere — only owned
        shards ever receive documents). Locked: the join-reply path and a
        concurrent publish handler must not both create the same index; the
        (term, version) check stops a stale join reply — or a superseded
        master's inflated local versions — regressing a newer publish.
        ``elected=True`` is the metadata-takeover fetch: the election
        already chose this copy as the freshest COMMITTED one among the
        voters, so the cluster-term fence below must not apply — a
        candidate whose state.term was raised by a parked-but-uncommitted
        phase-1 publication would otherwise discard the very copy it won
        with and publish its own staler metadata cluster-wide."""
        with self._indices_lock:
            if term is None:
                term = self._indices_adopted_term
            if term < self.node.cluster_state.term and not elected:
                # a stale era's metadata (e.g. a commit parked before an
                # election this node has since seen) never replaces the
                # current era's — the data-plane term fences depend on it
                return
            if (term, version) <= (self._indices_adopted_term,
                                   self._indices_adopted):
                return
            self._indices_adopted_term = term
            self._indices_adopted = version
            self._meta_term = max(self._meta_term, term)
            # an adoption only ever applies a COMMITTED copy (commit
            # phase, join reply, elected takeover fetch) — the key this
            # node may now advertise as committed, and the content it
            # may serve for it (copied: `meta` becomes the LIVE map and
            # later local mutations must not leak into the snapshot)
            self._committed_meta = max(self._committed_meta,
                                       (term, version))
            import json as _json
            self._committed_snapshot = _json.loads(_json.dumps(meta))
            # versions stay monotonic across master generations: a later
            # takeover continues from at least this high-water mark
            self._indices_version = max(self._indices_version, version)
            # an index that LEFT the published metadata was deleted
            # cluster-wide: remove the local copy (only names this process
            # adopted as distributed — a coordinator-local index never
            # enters _dist_known and is never touched)
            for gone in self._dist_known - set(meta):
                if gone in self.node.indices:
                    try:
                        self.node._delete_local_index(gone)
                    except Exception:
                        pass
            self._dist_known = set(meta)
            self.dist_indices = meta
            for name, spec in meta.items():
                if not self.node.index_exists(name):
                    self.node.create_index(name, spec.get("body"))
                if "aliases" in spec and name in self.node.indices:
                    # published aliases are authoritative cluster state:
                    # REPLACE (not update) the local map so alias removals
                    # propagate instead of being resurrected each publish
                    self.node.indices[name].aliases = dict(spec["aliases"])
                if name in self.node.indices and \
                        bool(spec.get("closed")) \
                        != self.node.indices[name].closed:
                    from elasticsearch_tpu_torch.cluster.metadata import (
                        close_index, open_index)

                    (close_index if spec.get("closed")
                     else open_index)(self.node, name)
            self._sync_local_terms()
            self._persist_dist_meta()

    def _sync_local_terms(self) -> None:
        """Apply published primary terms to this node's shard engines
        EAGERLY (reference: IndexShard.updatePrimaryTerm on cluster-state
        apply). A promoted primary must operate under its bumped term
        from the moment of promotion — not from its first write — so a
        recovery source snapshot taken before any new-term op still
        outranks (and prunes) a zombie copy's stale-era docs, and every
        copy fences stale ops even before new-term traffic arrives."""
        for name, spec in self.dist_indices.items():
            svc = self.node.indices.get(name)
            if svc is None:
                continue
            for sid_s, term in (spec.get("primary_terms") or {}).items():
                sid = int(sid_s)
                if sid < len(svc.shards):
                    svc.shards[sid].engine.bump_term(int(term))

    def publish_indices(self) -> None:
        self._bump_indices_version()
        self.node.cluster_state.next_version()  # order vs membership publishes
        if not self._publish():
            # the metadata change did NOT reach a quorum: the driving op
            # must fail typed instead of acking a state the majority
            # never saw (the master already stepped down)
            raise FailedToCommitClusterStateException(
                "cluster state publish failed to gather a quorum of acks")

    def _persist_ballot(self) -> None:
        """Durably persist the Raft pair — cluster term + last granted
        ballot — as a SMALL standalone file, fsynced before the caller
        replies to the candidate (Raft's votedFor fsync). This bounds the
        election-path write: the full dist-meta blob (every index's
        metadata) is no longer rewritten per ballot."""
        if not self._ballot_path:
            return
        import json as _json

        # read AND write under one lock: the vote book/term only grow,
        # so the last writer always persists the freshest pair — two
        # unserialized grants could otherwise land the staler pair last
        # (re-arming too little after a bounce = one term, two masters)
        with self._ballot_lock:
            vt, vf = self._votes.last_vote()
            raw = _json.dumps({"cluster_term": self.node.cluster_state.term,
                               "voted_term": vt, "voted_for": vf})
            try:
                os.makedirs(os.path.dirname(self._ballot_path),
                            exist_ok=True)
                tmp = (f"{self._ballot_path}.{os.getpid()}."
                       f"{threading.get_ident()}.tmp")
                with open(tmp, "w") as f:
                    f.write(raw)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._ballot_path)
            except OSError:
                # can't be durable — the grant already happened in
                # memory; the blob's next full write still snapshots it
                pass

    def _load_ballot(self) -> None:
        """Ballot.json outranks the blob's snapshot of the pair when
        newer (the blob only refreshes it on full metadata writes)."""
        if not self._ballot_path:
            return
        try:
            with open(self._ballot_path) as f:
                import json as _json

                blob = _json.load(f)
        except (OSError, ValueError):
            return
        state = self.node.cluster_state
        state.term = max(state.term, int(blob.get("cluster_term", 0)))
        self._votes.seed(int(blob.get("voted_term", 0)),
                         blob.get("voted_for") or "")

    def _persist_dist_meta(self) -> None:
        """Write the metadata atomically; ALWAYS called under
        _indices_lock (a unique tmp suffix additionally guards against a
        future unlocked caller). ONE serialization: json.dumps straight
        from dist_indices under the lock."""
        if not self._meta_path:
            return
        import json as _json

        # the local node id is persisted so a restart (which mints a NEW
        # id) can map the old master's copies to itself — its shard data
        # is still on this disk; (term, indices_version) is the freshness
        # key metadata takeover compares across voters
        # membership memory rides the same blob: the voting configuration
        # (rank-keyed — its size determines the quorum a restarted node
        # must respect), every peer address ever seen (the rejoin scan's
        # candidate list after a restart), and the Raft durable pair —
        # the cluster term + the last granted ballot (a bounced voter
        # must not grant one term twice, or two masters win it)
        vt, vf = self._votes.last_vote()
        raw = _json.dumps({"local": self.local.node_id,
                           "term": self._meta_term,
                           "indices_version": self._indices_version,
                           "voting_config": sorted(self._voting_config),
                           "peer_addrs": {nid: list(addr) for nid, addr
                                          in self._peer_addrs.items()},
                           "cluster_term": self.node.cluster_state.term,
                           "committed_meta": list(self._committed_meta),
                           "voted_term": vt, "voted_for": vf,
                           "indices": self.dist_indices})
        try:
            os.makedirs(os.path.dirname(self._meta_path), exist_ok=True)
            tmp = (f"{self._meta_path}.{os.getpid()}."
                   f"{threading.get_ident()}.tmp")
            with open(tmp, "w") as f:
                f.write(raw)
            os.replace(tmp, self._meta_path)
        except OSError:
            pass  # metadata persistence is best-effort; publishes carry it

    def _load_dist_meta(self) -> None:
        try:
            with open(self._meta_path) as f:
                import json as _json

                blob = _json.load(f)
        except (OSError, ValueError):
            return
        meta = blob.get("indices", {})
        old_local = blob.get("local")
        self._voting_config.update(blob.get("voting_config", []))
        for nid, addr in (blob.get("peer_addrs") or {}).items():
            if nid != old_local and isinstance(addr, list) \
                    and len(addr) == 2:
                self._peer_addrs.setdefault(nid, (addr[0], int(addr[1])))
        # Raft durable state: resume at the persisted term (a restarted
        # node must refuse campaigns/publications from eras it already
        # outlived) and re-arm the last granted ballot (never grant one
        # term twice across a bounce)
        state0 = self.node.cluster_state
        state0.term = max(state0.term, int(blob.get("cluster_term", 0)))
        # blobs from before the committed-key discipline carry only the
        # working (term, indices_version) — the best available estimate
        # of what that disk had committed
        cm = blob.get("committed_meta") or [
            int(blob.get("term", 0)), int(blob.get("indices_version", 0))]
        if isinstance(cm, list) and len(cm) == 2:
            self._committed_meta = max(self._committed_meta,
                                       (int(cm[0]), int(cm[1])))
        self._votes.seed(int(blob.get("voted_term", 0)),
                         blob.get("voted_for") or "")
        with self._indices_lock:
            self.dist_indices = meta
            self._dist_known = set(meta)
            self._indices_version = max(1, int(blob.get("indices_version",
                                                        1)))
            self._meta_term = int(blob.get("term", 0))
            # the restart minted a NEW node id: copies recorded under the
            # OLD id are THIS disk's shards — remap them; copies on
            # currently-absent members drop, and when those members
            # rejoin, reconcile re-replicates under-replicated shards
            # while resurrect_lost (gateway allocation) re-adopts shards
            # that lost EVERY copy from the joiner's on-disk data
            alive = {self.local.node_id}
            for name, spec in meta.items():
                for sid, owners in spec.get("assignment", {}).items():
                    kept = [self.local.node_id if o == old_local else o
                            for o in owners]
                    spec["assignment"][sid] = [o for o in kept
                                               if o in alive]
                # the in-sync copy set and primary terms follow the same
                # remap: the restarted master's on-disk copies stay
                # in-sync under their recorded terms, absent members must
                # re-sync (and re-enter the set) via recovery
                for sid, members in spec.get("in_sync", {}).items():
                    kept = [self.local.node_id if o == old_local else o
                            for o in members]
                    spec["in_sync"][sid] = [o for o in kept if o in alive]
                spec["initializing"] = {}
                if not self.node.index_exists(name):
                    self.node.create_index(name, spec.get("body"))

    def _bump_indices_version(self) -> None:
        # read-modify-write under the indices lock: concurrent join/fault
        # handlers must never publish distinct states under one version.
        # EVERY metadata mutation funnels through here, so persistence
        # lives here too (reconcile-driven changes don't go through
        # publish_indices); serializing INSIDE the lock keeps concurrent
        # bumps from interleaving writes into one tmp file
        with self._indices_lock:
            self._indices_version += 1
            self._meta_term = max(self._meta_term,
                                  self.node.cluster_state.term)
            self._persist_dist_meta()
            # the master applies its own published terms the same way
            # every peer does on adopt (eager, not first-write-lazy)
            self._sync_local_terms()

    def indices_snapshot(self) -> dict:
        """Deep copy under the lock: publishes and join replies must not
        serialize dist_indices while reconcile/recovery threads mutate it."""
        import json as _json

        with self._indices_lock:
            return _json.loads(_json.dumps(self.dist_indices))

    _UNSET = object()

    def _adopt(self, nodes: List[dict], version: int, master=_UNSET,
               term: Optional[int] = None) -> None:
        """Replace the local membership view with the master's publication
        (reference: PublishClusterStateAction — full-state publish).
        Rebuild-then-swap under the discovery lock: transport handler
        threads and readers must never observe a half-built dict, and a
        join reply racing a newer concurrent publish must not regress the
        view (the publisher's (term, version) orders publications across
        master generations). ``master`` explicitly names the elected
        incumbent; legacy two-argument callers keep the view's current
        master (vote_master mode never recomputes it from ids)."""
        state = self.node.cluster_state
        fresh = {n["node_id"]: DiscoveryNode(
            n["node_id"], n.get("name", ""),
            n.get("transport_address", "local")) for n in nodes}
        fresh.setdefault(self.local.node_id, self.local)
        before = (len(self._peer_addrs), len(self._voting_config))
        for n in fresh.values():
            self._note_peer(n.node_id, n.transport_address)
        if (len(self._peer_addrs), len(self._voting_config)) != before:
            self._persist_membership()
        with self.discovery._lock:
            if term is None:
                term = self._adopted_term
            if term < state.term:
                return  # an older era's state never replaces the view
            if (term, version) <= (self._adopted_term,
                                   self._adopted_version):
                return
            self._adopted_term = term
            self._adopted_version = version
            state.term = max(state.term, term)
            state.nodes = fresh
            if master is not MultiHostCluster._UNSET:
                state.master_node_id = master
            state.next_version()
            self.discovery._reelect()

    def _apply_join_reply(self, got: dict) -> None:
        """A join reply IS a committed state (the master answered it
        after publishing): adopt membership + master + metadata."""
        term = int(got.get("term", 0))
        self._adopt(got["nodes"], got.get("version", 0),
                    master=got.get("master"), term=term)
        self._adopt_indices(got.get("indices", {}),
                            got.get("indices_version", 0), term=term)
        self._record_committed(term, int(got.get("version", 0)))
        self._pin_version(term, int(got.get("version", 0)))
        if self.node.cluster_state.master_node_id is not None:
            self._clear_headless()

    # -- fault detection ------------------------------------------------------

    def _set_unpingable_gauge(self) -> None:
        try:
            self.node.metrics.gauge(
                "estpu_discovery_unpingable",
                "Members without a probeable transport address"
            ).set(len(self._unpingable))
        except Exception:  # dropping one
            pass           # gauge sample must never fail the round

    def _ping(self, n: DiscoveryNode) -> bool:
        if ":" not in n.transport_address:
            # an address-less member can't be probed over TCP: it must
            # not silently count as alive forever without anyone knowing
            # — typed-log once per node, keep the gauge current, and give
            # it the benefit of the doubt (declaring it dead on OUR
            # missing channel would evict a healthy member)
            if n.node_id not in self._unpingable:
                self._unpingable.add(n.node_id)
                logger.warning(
                    "[%s] member [%s] has no transport address "
                    "(transport_address=%r): fault detection cannot "
                    "probe it", self.local.node_id, n.node_id,
                    n.transport_address)
            self._set_unpingable_gauge()
            return True
        if n.node_id in self._unpingable:
            self._unpingable.discard(n.node_id)
            self._set_unpingable_gauge()
        host, port = n.transport_address.rsplit(":", 1)
        return self.transport.ping((host, int(port)))

    def run_fd_round(self) -> None:
        """One fault-detection round (the _fault_loop body; tests with
        ping_interval=0 drive rounds explicitly): the master pings its
        followers (and steps down if its view lost quorum), a follower
        pings the master (N consecutive failures fire the election), a
        headless node scans known peers for a cluster to rejoin."""
        state = self.node.cluster_state
        gone = self._unpingable - set(state.nodes)
        if gone:
            # departed members keep no phantom gauge entries (and a
            # same-id rejoin gets its one-shot warning back) — the same
            # prune-against-the-view rule as FaultDetector strike counts
            self._unpingable -= gone
            self._set_unpingable_gauge()
        if self.is_master:
            others = [n for n in list(state.nodes.values())
                      if n.node_id != self.local.node_id]
            self._node_fd.check(others)
            self._check_follower_quorum()
            # anti-entropy every few rounds, not every round: the sweep
            # is N serial briefs — at the default 1s interval that would
            # double steady-state control traffic and let one slow peer
            # stall failure detection of the rest
            self._fd_rounds += 1
            if self._fd_rounds % 5 == 0:
                self._heal_lagging_followers(others)
            # the allocation loop's periodic heartbeat (rate-limited
            # internally): drains progress, watermark pressure gets
            # relief, and parked moves retry without a membership event
            self.allocator.maybe_tick()
        elif state.master_node_id is not None:
            self._master_fd.check(state.nodes.get(state.master_node_id))
        else:
            self._try_join_cluster()

    def _fault_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.run_fd_round()
            except Exception:
                logger.exception("fault-detection round failed")

    def _heal_lagging_followers(self, others: List[DiscoveryNode]) -> None:
        """Master-side anti-entropy (every 5th fault-detection round): a
        follower that missed one publish (transient phase-1 send failure,
        dropped commit fan-out) but keeps answering pings is never reaped
        and — on a quiescent cluster — never sees a 'next publish' to
        catch up on. Probe each live follower's committed (term, version)
        and re-publish the full state when anyone trails; redundant
        adopts dedup on the key, so the repair is idempotent."""
        if self.committed == (0, 0):
            return
        for n in others:
            if ":" not in n.transport_address:
                continue
            h, p = n.transport_address.rsplit(":", 1)
            try:
                brief = self.transport.send_remote(
                    (h, int(p)), "cluster:state_brief", {}, timeout=2.0)
            except Exception:
                continue  # unreachable: fault detection's job
            if tuple(brief.get("committed") or (0, 0)) < self.committed:
                logger.warning(
                    "[%s] follower [%s] committed %s trails %s; "
                    "re-publishing", self.local.node_id, n.node_id,
                    brief.get("committed"), self.committed)
                self._publish()
                return

    def _check_follower_quorum(self) -> None:
        """A master whose VIEW no longer holds a quorum of master-eligible
        members cannot commit anything — resign now rather than on the
        next doomed publish."""
        if len(self._eligible_members()) < self.quorum():
            self.step_down("follower view below quorum")

    def _on_node_failed(self, n: DiscoveryNode) -> None:
        self.discovery.leave(n.node_id)
        if len(self._eligible_members()) < self.quorum():
            # nothing this master publishes can commit any more; don't
            # reroute shards under a state the majority will never see
            self.step_down("follower view below quorum")
            return
        # drop the dead node from every shard's copy list (promoting the
        # next surviving copy to primary) and re-replicate where possible
        directives, changed = self.data.reconcile()
        if changed:
            self._bump_indices_version()
        if self._publish():
            self.data.start_recoveries(directives)

    def _on_master_failed(self, master: DiscoveryNode) -> None:
        """The elected master stopped answering pings: drop it from the
        view, go headless (writes block), and — when this node is the
        deterministic candidate (lowest-id eligible survivor) — solicit
        votes for the next term."""
        state = self.node.cluster_state
        with self.discovery._lock:
            if state.master_node_id != master.node_id:
                return  # a publication already installed a newer master
            state.nodes.pop(master.node_id, None)
            state.master_node_id = None
            for r in state.routing:
                if r.node_id == master.node_id:
                    r.state = "UNASSIGNED"
                    r.node_id = ""
            state.next_version()
        self._go_headless()
        logger.warning("[%s] master [%s] failed fault detection",
                       self.local.node_id, master.node_id)
        cand = election_candidate(self._eligible_members())
        if cand is not None and cand.node_id == self.local.node_id:
            self._start_election()

    def _try_join_cluster(self) -> bool:
        """Headless: scan every known peer. Pass 1 joins through a peer
        that KNOWS a live master; pass 2 joins a reachable-but-headless
        peer directly — a join reaching a headless node triggers a
        quorum election there (_on_join), so our ballot may be exactly
        the missing vote (without this, a restarted member and a
        headless survivor defer to each other forever). Fallback: when
        nobody is mastered and this node is the lowest-id reachable
        candidate, run the election itself."""
        state = self.node.cluster_state
        candidates = dict(self._peer_addrs)
        candidates.setdefault("", self._seed_addr)
        own = None
        if ":" in self.local.transport_address:
            h, p = self.local.transport_address.rsplit(":", 1)
            own = (h, int(p))
        reachable: List[DiscoveryNode] = [self.local]
        briefs: List[Tuple[Tuple[str, int], dict]] = []
        for nid, addr in sorted(candidates.items()):
            if nid == self.local.node_id or addr == own:
                # a restarted rank 0's seed address IS its own port:
                # don't brief/join ourselves every round
                continue
            try:
                brief = self.transport.send_remote(
                    addr, "cluster:state_brief", {}, timeout=2.0)
            except Exception:
                continue
            if nid:
                reachable.append(DiscoveryNode(nid, "", f"{addr[0]}:"
                                                        f"{addr[1]}"))
            briefs.append((addr, brief))
        for _addr, brief in briefs:  # pass 1: somebody knows a master
            m_addr = brief.get("master_address")
            if not brief.get("master") or not m_addr \
                    or ":" not in str(m_addr):
                continue
            if int(brief.get("term", 0)) < state.term:
                continue  # its master is from an era we already outrank
            h, p = str(m_addr).rsplit(":", 1)
            if self._join_via((h, int(p))):
                return True
        for addr, brief in briefs:  # pass 2: headless peers elect on join
            if not brief.get("master") and self._join_via(addr):
                return True
        cand = election_candidate(reachable)
        if len(reachable) > 1 and cand is not None \
                and cand.node_id == self.local.node_id:
            return self._start_election()
        return False

    def _join_via(self, addr: Tuple[str, int]) -> bool:
        try:
            got = self.transport.send_remote(
                addr, "cluster:join", self._join_payload())
        except Exception:
            return False  # dead, not master, or its election lost quorum
        self._apply_join_reply(got)
        return True

    # -- lifecycle ------------------------------------------------------------

    @property
    def is_master(self) -> bool:
        return self.discovery.is_master

    def close(self) -> None:
        self._stop.set()
        self.allocator.close()
        if not self.is_master:
            try:
                self.transport.send_remote(
                    self.master_addr, "cluster:leave",
                    {"node_id": self.local.node_id}, timeout=1.0)
            except Exception:
                pass
        self.transport.close()
