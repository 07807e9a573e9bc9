"""Discovery: membership, master election, failure detection.

Reference: org/elasticsearch/discovery/zen/ — ZenDiscovery.java
(join/leave + publish), ElectMasterService.java (lowest-sorted
master-eligible node wins, minimum_master_nodes quorum),
fd/NodesFaultDetection.java + MasterFaultDetection.java (periodic pings,
N consecutive failures → node removed / master re-elected).

Port of elasticsearch_tpu/cluster/discovery.py. cluster/bootstrap.py
connects these pieces to member processes: ``MultiHostCluster`` runs the
quorum election and ping fault detection over the TCP transport
(``python -m elasticsearch_tpu_torch.server --coordinator host:port``). A
dead member's shards reroute via cluster/routing.py and replicas promote
via cluster/replication.py.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.cluster.state import ClusterState, DiscoveryNode


class ElectMasterService:
    """Reference: ElectMasterService — sort master-eligible nodes by id,
    lowest wins; refuse election without quorum."""

    def __init__(self, minimum_master_nodes: int = 1):
        self.minimum_master_nodes = minimum_master_nodes

    def elect(self, nodes: List[DiscoveryNode]) -> Optional[DiscoveryNode]:
        eligible = sorted((n for n in nodes if "master" in n.roles),
                          key=lambda n: n.node_id)
        if len(eligible) < self.minimum_master_nodes:
            return None  # no quorum -> no master (reference: null master, red)
        return eligible[0] if eligible else None


class FaultDetector:
    """Ping-based failure detection (reference: fd/NodesFaultDetection).

    ``ping_fn(node) -> bool`` is injected so tests (and the future TCP
    transport) supply the real ping; ``ping_retries`` consecutive failures
    mark the node dead and fire ``on_failure``."""

    def __init__(self, ping_fn: Callable[[DiscoveryNode], bool],
                 on_failure: Callable[[DiscoveryNode], None],
                 ping_retries: int = 3):
        self.ping_fn = ping_fn
        self.on_failure = on_failure
        self.ping_retries = ping_retries
        self._fail_counts: Dict[str, int] = {}

    def check(self, nodes: List[DiscoveryNode]) -> List[DiscoveryNode]:
        """One detection round; returns nodes declared failed this round.

        Strike counts are pruned against the CURRENT membership view
        first: a node that left keeps no stale strikes, so a rejoin
        under the same id starts from zero instead of inheriting old
        failures and being insta-declared dead."""
        present = {n.node_id for n in nodes}
        for nid in [k for k in self._fail_counts if k not in present]:
            del self._fail_counts[nid]
        failed = []
        for node in nodes:
            if self.ping_fn(node):
                self._fail_counts.pop(node.node_id, None)
                continue
            c = self._fail_counts.get(node.node_id, 0) + 1
            self._fail_counts[node.node_id] = c
            if c >= self.ping_retries:
                failed.append(node)
                self._fail_counts.pop(node.node_id, None)
                self.on_failure(node)
        return failed


class MasterFaultDetection:
    """Every NON-master pings the elected master (reference:
    fd/MasterFaultDetection.java); ``ping_retries`` consecutive failures
    fire ``on_master_failure`` — the trigger for a quorum election among
    the master-eligible survivors (cluster/bootstrap.py). Built on
    FaultDetector, so a master change automatically prunes the old
    incumbent's strikes."""

    def __init__(self, ping_fn: Callable[[DiscoveryNode], bool],
                 on_master_failure: Callable[[DiscoveryNode], None],
                 ping_retries: int = 3):
        self._fd = FaultDetector(ping_fn, on_master_failure,
                                 ping_retries=ping_retries)

    def check(self, master: Optional[DiscoveryNode]) -> bool:
        """One round against the current master; True when this round
        declared it dead (and fired the callback)."""
        if master is None:
            self._fd.check([])  # prunes strikes of any former master
            return False
        return bool(self._fd.check([master]))


class VoteCollector:
    """Per-node ballot box: ONE vote per term, granted only for terms
    strictly above the highest term this node has accepted a state from
    (reference: CoordinationState.handleStartJoin/handleJoin — a node
    never votes twice in a term and never votes backwards). The caller
    holds its own lock; this object is plain bookkeeping."""

    def __init__(self):
        self._voted: Dict[int, str] = {}

    def grant(self, term: int, candidate: str, current_term: int) -> bool:
        prior = self._voted.get(term)
        if prior is not None:
            return prior == candidate  # idempotent re-ask, never a switch
        if term <= current_term or term < self.highest_granted():
            # stale candidacy: a committed state — or a ballot already
            # granted in a later term — outranks it (never vote backwards)
            return False
        self._voted[term] = candidate
        return True

    def voted_in(self, term: int) -> Optional[str]:
        return self._voted.get(term)

    def seed(self, term: int, candidate: str) -> None:
        """Restore a persisted ballot (Raft's votedFor): a restarted
        voter must not grant the same term twice — without this, a
        quick bounce lets two candidates both win one term."""
        if term > 0 and candidate:
            self._voted.setdefault(term, candidate)

    def last_vote(self) -> Tuple[int, Optional[str]]:
        t = self.highest_granted()
        return t, self._voted.get(t)

    def highest_granted(self) -> int:
        """The highest term this node ever granted a ballot in. Granting
        a vote PROMISES not to honor older masters (Raft's currentTerm
        bump on vote): publications below this floor are fenced even
        before the winner's first publish lands — without it, a deposed
        master partitioned only from the candidate could still gather a
        quorum of acks at its old term from the very voters that just
        elected its successor, committing a divergent state."""
        return max(self._voted, default=0)


def election_candidate(nodes: List[DiscoveryNode]) -> Optional[DiscoveryNode]:
    """The node expected to RUN the election among the reachable
    master-eligible survivors: lowest id wins the tiebreak (zen's
    lowest-sorted-id rule applied to candidacy — every survivor computes
    the same winner, so exactly one solicits votes per detection round
    instead of the herd splitting the ballot)."""
    eligible = sorted((n for n in nodes if "master" in n.roles),
                      key=lambda n: n.node_id)
    return eligible[0] if eligible else None


class ZenDiscovery:
    """Single-process-capable zen-style discovery over a shared ClusterState.

    ``vote_master=True`` (the multi-host mode): mastership is decided by
    quorum elections and term-fenced publications (cluster/bootstrap.py),
    NOT recomputed from membership — ``_reelect`` then only clears a
    master that left the view, never assigns one (a lower-id joiner must
    not steal an elected incumbent's seat)."""

    def __init__(self, state: ClusterState, local: DiscoveryNode,
                 minimum_master_nodes: int = 1, vote_master: bool = False):
        self.state = state
        self.local = local
        self.vote_master = vote_master
        self.elect_service = ElectMasterService(minimum_master_nodes)
        self._lock = threading.Lock()
        if local.node_id not in state.nodes:
            state.add_node(local)
        self._reelect()

    def join(self, node: DiscoveryNode) -> None:
        with self._lock:
            self.state.nodes[node.node_id] = node
            self.state.next_version()
            self._reelect()

    def leave(self, node_id: str) -> None:
        with self._lock:
            self.state.nodes.pop(node_id, None)
            # shards on the departed node become unassigned (reroute input)
            for r in self.state.routing:
                if r.node_id == node_id:
                    r.state = "UNASSIGNED"
                    r.node_id = ""
            self.state.next_version()
            self._reelect()

    def _reelect(self) -> None:
        if self.vote_master:
            # elected mastership: only CLEAR a master that left the view
            # (its failure fires an election); never assign one here
            cur = self.state.master_node_id
            if cur is not None and cur not in self.state.nodes:
                self.state.master_node_id = None
            return
        winner = self.elect_service.elect(list(self.state.nodes.values()))
        self.state.master_node_id = winner.node_id if winner else None

    @property
    def is_master(self) -> bool:
        return self.state.master_node_id == self.local.node_id

    def make_fault_detector(self, ping_fn: Callable[[DiscoveryNode], bool],
                            ping_retries: int = 3) -> FaultDetector:
        return FaultDetector(
            ping_fn=ping_fn,
            on_failure=lambda n: self.leave(n.node_id),
            ping_retries=ping_retries,
        )
