"""Node: the top-level runtime holding indices.

Port of elasticsearch_tpu/node.py: create an index (the matching
templates applied first, lowest ``order`` first), index / get / delete
documents, ``bulk`` (index, create, update and delete items, an index
created on first write), refresh, flush, search over an index
expression, ``msearch``, the index admin surface (``delete_index``,
``index_exists``, ``put_mapping``/``get_mapping``, ``update_aliases``,
``put_template``/``delete_template``, ``close_index``/``open_index``,
``update_index_settings``), snapshot repositories (``repositories``,
``index/snapshots.py``), close. The node owns its devices (every
visible card unless the caller names one, a list, or ``cpu``;
``utils/device.py::resolve_devices``), one breaker service, one residency
registry a device (``resources/residency.py::ResidencySet``), whose
registry for a shard it passes down to the shard's segments, and the serving
front-end (``node.serving``): a search of one index goes through its
coalescer, so that concurrent searches run as one batch
(``serving/coalescer.py``), and an ``msearch`` batches its eligible
items itself (``search/batch.py``).

On a data path the node is durable: each index's metadata (settings,
mappings, aliases, closed) is kept in ``<data>/<index>/_meta.json``, the
JAX package's format, and a new ``Node`` over the same path reopens
every index there (the gateway): each shard replays its commit and its
translog. ``<data>/_ivf`` is registered with the IVF/PQ blob cache before
the replay, so a replayed vector segment loads its quantizer.

``search`` takes an index expression: names, aliases, wildcards,
``_all``, ``*`` or None. Wildcards skip closed indices; a closed index
named (or reached through an alias) is refused. An alias's ``filter``
restricts the hits and its ``search_routing`` the shards searched, and
its ``index_routing`` routes single-doc operations, as in ES 2.0; the
reference stores them and applies neither (ROADMAP C13). One index keeps
the mesh path and the coalescer; several run the host loop over all
their shards, with the dfs statistics summed over every searched index
and ``indices_boost`` applied before the global merge. A body's
``suggest`` over several indices runs each index's suggesters and merges
their entries (``execute_suggest_multi``), as ES 2.0 does; the
reference's multi-index route drops the key (ROADMAP C10). A name that
is neither an index nor an alias answers 404, also inside a comma list
(ES 2.0's answer; the reference drops such a name).

An index with ``number_of_replicas`` holds that many in-process copies
of each shard (``cluster/replication.py``): ``search`` and ``msearch``
take ES's ``preference`` (``_primary``, ``_replica``, or the next copy in
turn), picked once per shard and request on every route; ``bulk`` writes
through each shard's group; ``nodes_stats`` sums over every copy; the
gateway rebuilds an index's replicas from its ``_meta.json`` and
re-syncs them from the recovered primaries.

The node's span tracer (``node.tracer``, ``tracing/tracer.py``) is handed
to its residency registry, which files a ``tpu.rehydrate`` span for every
evicted fielddata copy it places again; ``nodes_stats`` reports the
registry (``resources``), the tracer, the slow logs, the process, the
host and the card (``accelerator``), and ``info()`` the node.

What the REST layer (``rest/server.py``) reads besides: the task
registry (``node.tasks``), the metrics registry (``node.metrics``, fed
by the tracer's span sink and scrape-time collectors over the thread
pools, breakers, residency tiers and kernel counters), the named thread
pools (``node.thread_pool``, built on first use), the dynamic cluster
settings (``node.cluster_settings``) and the stored search templates'
versions. ``nodes_stats`` adds their ``thread_pool``, ``tasks``,
``metrics`` and ``serving`` sections, the dispatch counters under
``indices.search.kernels`` and the kernels' launches under
``indices.search.launches``. Each node owns a flight recorder
(``node.flight``, monitor/flight.py), registered with the process fan,
and a stall watchdog (``node.watchdog``, monitor/watchdog.py) whose tick
thread the serving entry points start; ``nodes_stats`` carries their
``flight`` and ``watchdog`` sections, and ``programs`` the program
registry's totals (monitor/programs.py). ``close`` persists each index's
program census and the kernel libraries the process loaded into the
data path's blob tier (resources/census.py, parallel/aot.py), which the
next node over it replays and loads before its first request
(serving/warmup.py). A member of a cluster (``node.multihost``,
``cluster/bootstrap.py``) routes the writes, searches, index deletes and
alias changes of a distributed index through the cluster's data plane,
and ``nodes_stats`` carries its ``transport`` address.
"""
from __future__ import annotations

import copy
import fnmatch
import json
import logging
import os
import re
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from elasticsearch_tpu_torch.cluster import metadata
from elasticsearch_tpu_torch.cluster.state import (ClusterState,
                                                   DiscoveryNode,
                                                   IndexMetadata)
from elasticsearch_tpu_torch.index import ivf_cache
from elasticsearch_tpu_torch.index.engine import _deep_merge
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch import __version__
from elasticsearch_tpu_torch.monitor import compile_cache
from elasticsearch_tpu_torch.monitor import flight as flight_mod
from elasticsearch_tpu_torch.monitor import kernels, programs
from elasticsearch_tpu_torch.monitor.metrics import MetricsRegistry, span_sink
from elasticsearch_tpu_torch.monitor.stats import (SearchStats,
                                                   aggregate_recovery,
                                                   aggregate_slowlog,
                                                   device_stats, os_stats,
                                                   process_stats)
from elasticsearch_tpu_torch.monitor.watchdog import WatchdogService
from elasticsearch_tpu_torch.parallel import aot
from elasticsearch_tpu_torch.resources import census
from elasticsearch_tpu_torch.resources.breakers import CircuitBreakerService
from elasticsearch_tpu_torch.resources.residency import ResidencySet
from elasticsearch_tpu_torch.search.batch import (msearch_error_entry,
                                                  try_batched_msearch)
from elasticsearch_tpu_torch.search.context import global_stats
from elasticsearch_tpu_torch.search.queries import rewrite_mlt_in_body
from elasticsearch_tpu_torch.search.service import search_shards
from elasticsearch_tpu_torch.search.suggest import execute_suggest_multi
from elasticsearch_tpu_torch.serving import ServingFrontend
from elasticsearch_tpu_torch.tracing import retrace
from elasticsearch_tpu_torch.tracing.tasks import TaskRegistry
from elasticsearch_tpu_torch.tracing.tracer import Tracer
from elasticsearch_tpu_torch.utils.device import resolve_devices
from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                  IllegalArgumentException,
                                                  IndexAlreadyExistsException,
                                                  IndexNotFoundException)

logger = logging.getLogger(__name__)


class Node:
    def __init__(self, name: str = "node-1", data_path: Optional[str] = None,
                 device: Union[None, str, torch.device,
                               Sequence[Union[str, torch.device]]] = None,
                 cluster_name: str = "elasticsearch_tpu"):
        # the mesh devices, in order: an index's shard i lives on device
        # i % min(shards, devices); ``device`` is the first, where the
        # devices' results merge
        self.devices: Tuple[torch.device, ...] = resolve_devices(device)
        self.device: torch.device = self.devices[0]
        self.node_id = uuid.uuid4().hex[:12]
        self.name = name
        self.data_path = data_path
        self.breakers = CircuitBreakerService()
        self.residency = ResidencySet(self.devices, self.breakers)
        self.tracer = Tracer(self.node_id)
        self.residency.set_tracer(self.tracer)
        self.tasks = TaskRegistry(self.node_id)
        # continuous metrics: a registry of this node's, fed by every
        # finished span and by scrape-time collectors
        self.metrics = MetricsRegistry(include_shared=True)
        self.tracer.set_sink(span_sink(self.metrics))
        self._register_metric_collectors()
        # flight recorder and stall watchdog: the recorder joins the
        # process fan so node-less sources (engines) reach it, and the
        # node's breakers record their trips into it; the watchdog's tick
        # thread starts with a serving entry point (RestServer.start, a
        # cluster member)
        self.flight = flight_mod.FlightRecorder(self.node_id, name)
        flight_mod.register(self.flight)
        self.breakers.flight = self.flight
        self.watchdog = WatchdogService(self)
        self.indices: Dict[str, IndexService] = {}
        # stored search templates (carried by a snapshot's global state)
        # and each one's version (the REST layer's PUT bumps it)
        self.search_templates: Dict[str, Any] = {}
        self.search_template_versions: Dict[str, int] = {}
        # dynamic cluster settings as PUT /_cluster/settings stored them
        self.cluster_settings: Dict[str, Dict[str, Any]] = {
            "persistent": {}, "transient": {}}
        # snapshot repositories by name (index/snapshots.py::FsRepository)
        self.repositories: Dict[str, Any] = {}
        # the indices on disk that the gateway could not reopen, with why
        self.failed_indices: Dict[str, dict] = {}
        self.cluster_state = ClusterState(cluster_name)
        self.cluster_state.add_node(DiscoveryNode(self.node_id, name),
                                    master=True)
        # cheap to build: the coalescer's drain thread starts on first use
        self.serving = ServingFrontend(self)
        # the named request pools start their threads on first use
        self._thread_pool = None
        self._tp_lock = threading.Lock()
        self._ivf_dir = None
        # the cluster this node is a member of (cluster/bootstrap.py's
        # MultiHostCluster sets it); None for a node on its own
        self.multihost = None
        if data_path:
            # the blob cache's disk layer must be in place before the
            # replay freezes segments, or recovery pays the k-means again
            self._ivf_dir = os.path.join(data_path, "_ivf")
            ivf_cache.register(self._ivf_dir)
            self.residency.blob_dir = self._ivf_dir
            self._gateway_recover()

    @property
    def thread_pool(self):
        """The named request pools (``utils/threadpool.py``), built on
        first use under a lock: concurrent first requests must not each
        start a set of worker threads."""
        if self._thread_pool is None:
            from elasticsearch_tpu_torch.utils.threadpool import ThreadPool

            with self._tp_lock:
                if self._thread_pool is None:
                    self._thread_pool = ThreadPool()
        return self._thread_pool

    def _register_metric_collectors(self) -> None:
        """Scrape-time families over state counted elsewhere: the thread
        pools, the breakers, the residency tiers and the kernel
        counters. Reading them at a scrape costs one walk per scrape
        instead of a second lock on every hot path."""
        m = self.metrics

        def _pools():
            tp = self._thread_pool
            return tp.stats().items() if tp is not None else ()

        m.collector("estpu_threadpool_queue_depth",
                    "Queued work items per named thread pool", ("pool",),
                    lambda: [((n,), st["queue"]) for n, st in _pools()])
        m.collector("estpu_threadpool_active",
                    "Active workers per named thread pool", ("pool",),
                    lambda: [((n,), st["active"]) for n, st in _pools()])
        m.collector("estpu_threadpool_rejected_total",
                    "Work rejected by a full queue, per pool", ("pool",),
                    lambda: [((n,), st["rejected"]) for n, st in _pools()],
                    kind="counter")
        m.collector("estpu_threadpool_completed_total",
                    "Work completed per named thread pool", ("pool",),
                    lambda: [((n,), st["completed"]) for n, st in _pools()],
                    kind="counter")

        def _breakers():
            return self.breakers.stats().items()

        m.collector("estpu_breaker_used_bytes",
                    "Estimated bytes held per circuit breaker",
                    ("breaker",),
                    lambda: [((n,), br["estimated_size_in_bytes"])
                             for n, br in _breakers()])
        m.collector("estpu_breaker_limit_bytes",
                    "Configured byte limit per circuit breaker",
                    ("breaker",),
                    lambda: [((n,), br["limit_size_in_bytes"])
                             for n, br in _breakers()])
        m.collector("estpu_breaker_tripped_total",
                    "Trips per circuit breaker", ("breaker",),
                    lambda: [((n,), br["tripped"]) for n, br in _breakers()],
                    kind="counter")

        def _tiers():
            return self.residency.stats()["tiers"].items()

        m.collector("estpu_residency_tier_bytes",
                    "Device-resident bytes per residency tier", ("tier",),
                    lambda: [((t,), st["resident_bytes"])
                             for t, st in _tiers()])
        m.collector("estpu_residency_evictions_total",
                    "Device-copy evictions per residency tier", ("tier",),
                    lambda: [((t,), st["evictions"]) for t, st in _tiers()],
                    kind="counter")
        m.collector("estpu_residency_rehydrations_total",
                    "Evicted-copy rehydrations per residency tier",
                    ("tier",),
                    lambda: [((t,), st["rehydrations"])
                             for t, st in _tiers()],
                    kind="counter")
        m.collector("estpu_kernel_dispatch_total",
                    "Kernel launches and dispatch decisions "
                    "(monitor/kernels.py names)", ("kernel",),
                    lambda: [((k,), v) for k, v in kernels.snapshot().items()],
                    kind="counter")
        m.collector("estpu_jit_traces_total",
                    "First-touch events since process start: kernel-"
                    "library builds and loads, first dispatches of a key "
                    "(tracing/retrace.py)", (),
                    lambda: [((), retrace.auditor().total())],
                    kind="counter")

        # the program registry's rows, one walk serving the three
        # families of a scrape (their collect calls land within one
        # render); the registry's key cap bounds them
        memo = {"t": float("-inf"), "rows": ()}

        def _programs():
            now = time.monotonic()
            if now - memo["t"] > 0.2:
                memo["rows"] = programs.REGISTRY.counters_snapshot()
                memo["t"] = now
            return memo["rows"]

        m.collector("estpu_program_compiles_total",
                    "Calls that paid first-touch work, per (program, "
                    "shapes, backend) key", ("program", "shapes", "backend"),
                    lambda: [((p, s, b), c)
                             for p, s, b, c, _cs, _es in _programs()],
                    kind="counter")
        m.collector("estpu_program_compile_seconds",
                    "Wall seconds of calls that paid first-touch work, "
                    "per program key", ("program", "shapes", "backend"),
                    lambda: [((p, s, b), cs)
                             for p, s, b, _c, cs, _es in _programs()],
                    kind="counter")
        m.collector("estpu_program_execute_seconds",
                    "Wall seconds of steady dispatches, device time "
                    "included, per program key",
                    ("program", "shapes", "backend"),
                    lambda: [((p, s, b), es)
                             for p, s, b, _c, _cs, es in _programs()],
                    kind="counter")
        m.collector("estpu_compile_cache_events_total",
                    "Kernel-library resolutions by source "
                    "(parallel/aot.py): aot_hit / build_dir_hit / fresh, "
                    "detected misses and store outcomes", ("source",),
                    lambda: [((k,), v) for k, v in
                             compile_cache.events_snapshot().items()],
                    kind="counter")
        m.collector("estpu_compile_cache_seconds_total",
                    "Wall seconds in blob-tier phases: deserialize (a "
                    "blob written out and opened), compile (a build), "
                    "serialize (a store)", ("phase",),
                    lambda: [((k,), v) for k, v in
                             compile_cache.seconds_snapshot().items()],
                    kind="counter")

    # -- the gateway -----------------------------------------------------------

    def _index_meta_path(self, name: str) -> str:
        return os.path.join(self.data_path, name, "_meta.json")

    def _persist_index_meta(self, name: str) -> None:
        """Write the index's metadata beside its shards (without it the
        translogs are orphans at restart)."""
        if not self.data_path or name not in self.indices:
            return
        svc = self.indices[name]
        path = self._index_meta_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"settings": svc.settings,
                       "mappings": svc.mappings.to_json(),
                       "aliases": svc.aliases,
                       "closed": bool(svc.closed)}, f)
        os.replace(tmp, path)

    def _gateway_recover(self) -> None:
        """Reopen every index under the data path; each replays its
        shards. An index whose metadata or replay fails does not stop the
        node from starting: it is logged and kept in ``failed_indices``
        with its data on disk, so it is neither served nor created over
        (``delete_index`` drops it)."""
        if not os.path.isdir(self.data_path):
            return
        for name in sorted(os.listdir(self.data_path)):
            meta_path = self._index_meta_path(name)
            if not os.path.isfile(meta_path):
                continue
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                svc = IndexService(
                    name, self.residency, settings=meta.get("settings"),
                    mappings_json=meta.get("mappings") or {},
                    data_path=self.data_path, node=self)
            except Exception as e:
                logger.error("index [%s] failed to recover from [%s]",
                             name, self.data_path, exc_info=True)
                self.failed_indices[name] = {
                    "type": getattr(e, "error_type", type(e).__name__),
                    "reason": str(e)}
                continue
            svc.aliases = dict(meta.get("aliases", {}))
            svc.closed = bool(meta.get("closed", False))
            self._register(svc, meta.get("mappings", {}))

    def _register(self, svc: IndexService, mappings_json: dict) -> None:
        self.indices[svc.name] = svc
        self.cluster_state.add_index(
            IndexMetadata(svc.name, svc.settings, mappings_json,
                          svc.aliases,
                          state="close" if svc.closed else "open"),
            svc.num_shards, self.node_id)

    # -- index admin -------------------------------------------------------------

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        if name in self.indices or name in self.failed_indices:
            raise IndexAlreadyExistsException(name)
        _validate_index_name(name)
        body = body or {}
        aliases = copy.deepcopy(dict(body.get("aliases", {})))
        # the templates whose pattern matches, lowest order first; the
        # body's own settings and mappings merge last
        tmpls = sorted(
            (t for t in self.cluster_state.templates.values()
             if any(fnmatch.fnmatch(name, pat) for pat in
                    t.get("index_patterns", [t.get("template", "")]))),
            key=lambda t: t.get("order", 0))
        settings: dict = {}
        mappings: dict = {}
        for t in tmpls:
            _deep_merge(settings, copy.deepcopy(t.get("settings", {})))
            _deep_merge(mappings, copy.deepcopy(t.get("mappings", {})))
            aliases.update(copy.deepcopy(t.get("aliases", {})))
        _deep_merge(settings, copy.deepcopy(dict(body.get("settings", {}))))
        _deep_merge(mappings, copy.deepcopy(dict(body.get("mappings", {}))))
        svc = IndexService(name, self.residency, settings=settings,
                           mappings_json=mappings, data_path=self.data_path,
                           node=self)
        svc.aliases = {a: _alias_spec(spec) for a, spec in aliases.items()}
        # run at every refresh (IndexService._run_warmers)
        for wname, wspec in dict(body.get("warmers", {})).items():
            svc.warmers[wname] = (wspec.get("source", wspec)
                                  if isinstance(wspec, dict) else wspec)
        self._register(svc, mappings)
        self._persist_index_meta(name)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": name}

    def delete_index(self, name: str) -> dict:
        """Delete every index the expression names, with its directory
        (an index that failed to recover by its name)."""
        if name in self.failed_indices:
            del self.failed_indices[name]
            shutil.rmtree(os.path.join(self.data_path, name),
                          ignore_errors=True)
            return {"acknowledged": True}
        found = self.resolve_indices(name)
        if not found:
            raise IndexNotFoundException(name)
        mh = self.multihost
        for n in found:
            if mh is not None and n in mh.dist_indices:
                # cluster-wide: dropped from the published metadata, so
                # the members remove their copies (a local delete would
                # come back with the next publish)
                mh.data.delete_index(n)
            else:
                self._delete_local_index(n)
        return {"acknowledged": True}

    def _delete_local_index(self, n: str) -> None:
        self.indices.pop(n).close()
        self.cluster_state.remove_index(n)
        if self.data_path:
            shutil.rmtree(os.path.join(self.data_path, n),
                          ignore_errors=True)

    def index_exists(self, name: str) -> bool:
        return name in self.indices or bool(self._alias_targets(name))

    def put_mapping(self, index: str, body: dict) -> dict:
        """Merge ``body`` into every named index's mappings; each merge is
        tried on a copy first, so a refused update changes no index."""
        names = self.resolve_indices(index)
        for n in names:
            trial = copy.deepcopy(self.indices[n].mappings)
            trial.merge(body)
            self.indices[n]._validate_analyzers(trial)
        for n in names:
            self.indices[n].mappings.merge(body)
            self._persist_index_meta(n)
        return {"acknowledged": True}

    def get_mapping(self, index: Optional[str] = None) -> dict:
        out = {}
        for n in self.resolve_indices(index):
            m = self.indices[n].mappings
            mj = m.to_json()
            # indices created with 2.0 type blocks read back under them
            out[n] = {"mappings": ({t: mj for t in m.type_names}
                                   if m.type_names else mj)}
        return out

    def update_aliases(self, actions: List[dict]) -> dict:
        """``add`` and ``remove`` actions (``index``/``indices``,
        ``alias``, ``filter``, ``routing``, ``index_routing``,
        ``search_routing``). In a cluster, aliases of a distributed index
        are cluster state: a member forwards those actions to the master,
        which folds them into the published metadata."""
        mh = self.multihost
        if mh is not None:
            # metadata: a headless node refuses up front (typed 503)
            mh.ensure_not_blocked("metadata_write")
            if not mh.is_master:
                # split per index: the expressions resolve here, each
                # name becomes a single-index action, and only the
                # distributed ones go to the master
                fwd: List[dict] = []
                local: List[dict] = []
                for action in actions:
                    for op, spec in action.items():
                        for nm in (self.resolve_indices(
                                spec.get("index", spec.get("indices")))
                                or []):
                            single = {k: v for k, v in spec.items()
                                      if k not in ("index", "indices")}
                            single["index"] = nm
                            (fwd if nm in mh.dist_indices
                             else local).append({op: single})
                if fwd:
                    from elasticsearch_tpu_torch.cluster.search_action \
                        import ACTION_ALIASES

                    mh.transport.send_remote(
                        mh.master_addr, ACTION_ALIASES, {"actions": fwd})
                    actions = local
                    if not actions:
                        return {"acknowledged": True}
        touched: List[str] = []
        for action in actions:
            for op, spec in action.items():
                if op not in ("add", "remove"):
                    raise IllegalArgumentException(
                        f"unknown alias action [{op}]")
                alias = spec["alias"]
                for n in self.resolve_indices(
                        spec.get("index", spec.get("indices"))):
                    if op == "add":
                        self.indices[n].aliases[alias] = _alias_spec(
                            {k: v for k, v in spec.items()
                             if k not in ("index", "indices", "alias")})
                    else:
                        self.indices[n].aliases.pop(alias, None)
                    self._persist_index_meta(n)
                    touched.append(n)
        if mh is not None and mh.is_master:
            self._publish_aliases(mh, [n for n in touched
                                       if n in mh.dist_indices])
        return {"acknowledged": True}

    def _publish_aliases(self, mh, names: List[str]) -> None:
        """The master folds the alias maps of distributed indices into
        the published metadata (members replace theirs with it, so a
        removal spreads); a publish without quorum restores both halves
        and fails typed."""
        if not names:
            return
        with mh._indices_lock:
            prior = {n: dict(mh.dist_indices[n].get("aliases") or {})
                     for n in names}
            for n in names:
                mh.dist_indices[n]["aliases"] = dict(self.indices[n].aliases)
        try:
            mh.publish_indices()
        except Exception:
            with mh._indices_lock:
                for n, aliases in prior.items():
                    if n in mh.dist_indices:
                        mh.dist_indices[n]["aliases"] = dict(aliases)
                    if n in self.indices:
                        self.indices[n].aliases = dict(aliases)
                        self._persist_index_meta(n)
                mh._persist_dist_meta()
            raise

    def put_template(self, name: str, body: dict,
                     create: bool = False) -> dict:
        if create and name in self.cluster_state.templates:
            raise IndexAlreadyExistsException(name)
        body = copy.deepcopy(dict(body))
        if body.get("aliases"):
            body["aliases"] = {a: _alias_spec(s)
                               for a, s in body["aliases"].items()}
        self.cluster_state.templates[name] = body
        return {"acknowledged": True}

    def delete_template(self, name: str) -> dict:
        if self.cluster_state.templates.pop(name, None) is None:
            raise IndexNotFoundException(name)
        return {"acknowledged": True}

    def close_index(self, name: str) -> dict:
        return metadata.close_index(self, name)

    def open_index(self, name: str) -> dict:
        return metadata.open_index(self, name)

    def update_index_settings(self, name: str, body: dict) -> dict:
        for n in self.resolve_indices(name):
            metadata.update_index_settings(self.indices[n], body, node=self)
        return {"acknowledged": True}

    def get_index(self, name: str) -> IndexService:
        """The one index a name, an alias or an expression resolves to."""
        names = self.resolve_indices(name)
        if not names:
            raise IndexNotFoundException(name)
        if len(names) > 1:
            raise ElasticsearchTpuException(
                f"alias/expression [{name}] resolves to multiple indices "
                f"for a single-index op")
        return self.indices[names[0]]

    # -- documents ---------------------------------------------------------------

    def _doc_target(self, name: str,
                    routing: Optional[str]) -> Tuple[IndexService,
                                                     Optional[str]]:
        """The index a single-doc op names and its routing: an alias's
        ``index_routing`` when the caller gives none."""
        svc = self.get_index(name)
        if routing is None and name not in self.indices:
            routing = svc.aliases.get(name, {}).get("index_routing")
        return svc, routing

    def index(self, index: str, doc_id: Optional[str], source: dict,
              routing: Optional[str] = None, **kw) -> dict:
        svc, routing = self._doc_target(index, routing)
        return svc.index_doc(doc_id, source, routing=routing, **kw)

    def get(self, index: str, doc_id: str, routing: Optional[str] = None,
            **kw) -> dict:
        svc, routing = self._doc_target(index, routing)
        return svc.get_doc(doc_id, routing=routing, **kw)

    def delete(self, index: str, doc_id: str, routing: Optional[str] = None,
               **kw) -> dict:
        svc, routing = self._doc_target(index, routing)
        return svc.delete_doc(doc_id, routing=routing, **kw)

    def bulk(self, operations: List[dict]) -> dict:
        """``_bulk`` over parsed NDJSON lines: an action line ({op: meta})
        then, for index, create and update, its source. Each item answers
        with ``status`` 201 (created) or 200, or with the typed error's
        ``status`` and ``error``; ``errors`` says whether any item
        failed. A child routes by its ``parent`` unless it names a
        routing; ``_timestamp`` and ``_ttl`` in the action line feed those
        meta fields, as in ES 2.0's bulk. In a cluster, an item of a
        distributed index goes to its shard's primary owner
        (``cluster/search_action.py``, ES's shard-bulk routing)."""
        items = []
        errors = False
        i = 0
        while i < len(operations):
            (op, meta), = operations[i].items()
            i += 1
            source = None
            if op in ("index", "create", "update"):
                source = operations[i]
                i += 1
            index_name = meta.get("_index")
            doc_id = meta.get("_id")
            parent = meta.get("parent", meta.get("_parent"))
            routing = meta.get("routing", meta.get("_routing")) or parent
            doc_type = meta.get("_type")
            try:
                mh = self.multihost
                data = (mh.data if mh is not None
                        and index_name in mh.dist_indices else None)
                # a distributed index's data plane takes the index first
                args = (index_name,) if data is not None else ()
                svc = data
                if data is None:
                    svc = self.get_or_autocreate(index_name)
                    if routing is None and index_name not in self.indices:
                        routing = svc.aliases.get(index_name, {}).get(
                            "index_routing")
                if op in ("index", "create"):
                    kw = {}
                    if doc_type and doc_type != "_doc":
                        kw["doc_type"] = doc_type
                    if parent:
                        kw["parent"] = parent
                    for key in ("timestamp", "ttl"):
                        v = meta.get(f"_{key}", meta.get(key))
                        if v is not None:
                            kw[key] = v
                    r = svc.index_doc(*args, doc_id, source,
                                      routing=routing, op_type=op, **kw)
                    status = 201 if r.get("created") else 200
                elif op == "update":
                    r = svc.update_doc(*args, doc_id, source,
                                       routing=routing)
                    status = 200
                elif op == "delete":
                    r = svc.delete_doc(*args, doc_id, routing=routing)
                    status = 200
                else:
                    raise ElasticsearchTpuException(f"unknown bulk op [{op}]")
                items.append({op: {**r, "status": status}})
            except ElasticsearchTpuException as e:
                errors = True
                items.append({op: {
                    "_index": index_name, "_id": doc_id, "status": e.status,
                    "error": {"type": e.error_type, "reason": str(e)}}})
        return {"took": 0, "errors": errors, "items": items}

    def get_or_autocreate(self, name: str) -> IndexService:
        """The one index a write names, created when there is none."""
        try:
            names = self.resolve_indices(name)
        except IndexNotFoundException:
            names = []
        if names:
            if len(names) == 1:
                return self.indices[names[0]]
            raise ElasticsearchTpuException(
                f"[{name}] resolves to multiple indices for a write")
        self.create_index(name)
        return self.indices[name]

    def _shards_total(self, names: List[str]) -> dict:
        n = sum(self.indices[x].num_shards for x in names)
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    def refresh(self, index: Optional[str] = None) -> dict:
        names = self.resolve_indices(index)
        for n in names:
            self.indices[n].refresh()
        return self._shards_total(names)

    def flush(self, index: Optional[str] = None) -> dict:
        """Commit every named index durably (``IndexService.flush``)."""
        names = self.resolve_indices(index)
        for n in names:
            self.indices[n].flush()
        return self._shards_total(names)

    # -- index expressions ---------------------------------------------------------

    def resolve_indices(self, expr: Optional[str]) -> List[str]:
        """The indices an expression names, in order, each once: a comma
        list of names, aliases and wildcards; ``_all``, ``*``, "" or None
        name every index; a list is a comma list. A part that is neither
        an index nor an alias raises IndexNotFoundException."""
        if isinstance(expr, (list, tuple)):
            expr = ",".join(expr)
        if expr in (None, "", "_all", "*"):
            return list(self.indices)
        out: List[str] = []
        for part in str(expr).split(","):
            part = part.strip()
            if "*" in part or "?" in part:
                out.extend(n for n in self.indices
                           if fnmatch.fnmatch(n, part))
            elif part in self.indices:
                out.append(part)
            else:
                targets = self._alias_targets(part)
                if not targets:
                    raise IndexNotFoundException(part)
                out.extend(targets)
        return list(dict.fromkeys(out))

    def _alias_targets(self, alias: str) -> List[str]:
        return [n for n, svc in self.indices.items() if alias in svc.aliases]

    def _search_plan(self, expr: Optional[str]) -> List[Tuple[
            str, Optional[dict], Optional[str]]]:
        """(index, alias filter, search routing) for each index an
        expression searches. Wildcards (and ``_all``) skip closed
        indices; a closed index named or reached through an alias is
        refused. An index reached by name or wildcard, or through an
        alias without a filter (or routing), is searched unfiltered (or
        on every shard); otherwise the filters of its aliases are OR-ed
        and their routings joined, as in ES 2.0."""
        parts = ["*"] if expr in (None, "", "_all", "*") \
            else [p.strip() for p in str(expr).split(",")]
        order: List[str] = []
        filters: Dict[str, Optional[List[dict]]] = {}
        routes: Dict[str, Optional[List[str]]] = {}
        for part in parts:
            wild = "*" in part or "?" in part
            if wild or part in self.indices:
                names = [n for n in self.indices if fnmatch.fnmatch(n, part)
                         and not (wild and self.indices[n].closed)]
                specs = [None] * len(names)
            else:
                names = self._alias_targets(part)
                if not names:
                    raise IndexNotFoundException(part)
                specs = [self.indices[n].aliases[part] for n in names]
            for n, spec in zip(names, specs):
                if not wild:
                    metadata.check_open(self.indices[n], op="read")
                if n not in filters:
                    order.append(n)
                    filters[n], routes[n] = [], []
                f = (spec or {}).get("filter")
                r = (spec or {}).get("search_routing")
                if filters[n] is not None:
                    filters[n] = None if f is None else filters[n] + [f]
                if routes[n] is not None:
                    routes[n] = None if r is None else routes[n] + [str(r)]
        out = []
        for n in order:
            f = filters[n]
            if f:
                f = f[0] if len(f) == 1 else {"bool": {
                    "should": f, "minimum_should_match": 1}}
            r = routes[n]
            out.append((n, f or None, ",".join(r) if r else None))
        return out

    # -- search ------------------------------------------------------------------

    def search(self, index: Optional[str], body: Optional[dict] = None,
               preference: Optional[str] = None) -> dict:
        """``preference`` picks the copy of each shard read: ``_primary``,
        ``_replica``, or by default the next copy in turn (one pick per
        shard and request). In a cluster, a distributed index (by name
        or alias, or as the only open index of ``_all``) scatters over
        its members (``cluster/search_action.py``)."""
        mh = self.multihost
        if mh is not None:
            dist = self._dist_search_target(mh, index)
            if dist is not None:
                return mh.data.search(dist, body or {})
        plan = self._search_plan(index)
        if not plan and index not in (None, "", "_all", "*"):
            raise IndexNotFoundException(str(index))
        body = body or {}
        if len(plan) == 1:
            name, flt, routing = plan[0]
            svc = self.indices[name]
            if flt is not None:
                body = _with_filter(body, flt)
            if routing is not None or preference is not None \
                    or body.get("search_type") == "dfs_query_then_fetch":
                # never coalesced
                return svc.search(body, routing=routing,
                                  preference=preference)

            def run():
                return svc.search(body)

            # the serving coalescer: eligible bodies of concurrent
            # requests park briefly and run as one batch; a lone request
            # or an ineligible body runs the normal path unchanged
            out = self.serving.coalescer.execute(svc, body, run)
            return out if out is not None else run()
        names = [n for n, _f, _r in plan]
        svcs = [self.indices[n] for n in names]
        if any(f is not None for _n, f, _r in plan):
            # each index's own alias filter, by the owning index of each
            # segment
            body = _with_filter(body, {"bool": {"should": [
                {"indices": {"indices": [n], "query": f or {"match_all": {}},
                             "no_match_query": "none"}}
                for n, f, _r in plan], "minimum_should_match": 1}})
        if body.get("query"):
            # more_like_this liked ids resolve over every searched index
            # (an explicit _index over that index) before the fan-out
            def lookup(doc_id, routing=None, index=None):
                if index:
                    return svcs[0].mlt_source(doc_id, routing=routing,
                                              index=index)
                for svc in svcs:
                    src = svc.mlt_source(doc_id, routing=routing)
                    if src is not None:
                        return src
                return None

            q2 = rewrite_mlt_in_body(body["query"], lookup)
            if q2 is not body["query"]:
                body = dict(body, query=q2)
        groups = [g for (_n, _f, r), svc in zip(plan, svcs)
                  for g in svc.routed_groups(r)]
        searchers = [g.reader(preference).searcher for g in groups]
        if not searchers:
            return {"took": 0, "timed_out": False,
                    "_shards": {"total": 0, "successful": 0, "failed": 0},
                    "hits": {"total": 0, "max_score": None, "hits": []}}
        gs = None
        if body.get("search_type") == "dfs_query_then_fetch":
            # one idf over every searched index (ES's DfsPhase collects
            # over all the request's shards)
            # (the primaries' segments, as each index's own dfs reads)
            gs = global_stats(seg for g in groups
                              for seg in g.primary.segments)
        resp = search_shards(searchers, body, index_name=",".join(names),
                             global_stats=gs)
        if body.get("suggest"):
            resp["suggest"] = execute_suggest_multi(
                [(svc.shards, svc.analysis, svc.mappings) for svc in svcs],
                body["suggest"])
        return resp

    def _dist_search_target(self, mh, index: Optional[str]
                            ) -> Optional[str]:
        """The distributed index a search names, or None to search
        locally. The all-indices spelling rides the data plane too when
        it means one distributed index (a local search would see only
        this member's shards); several, or one beside local indices, is
        refused."""
        if index not in (None, "", "_all", "*"):
            rname = mh.data.resolve_index(index)
            return rname if rname in mh.dist_indices else None
        open_names = [nm for nm in self.resolve_indices(index)
                      if not self.indices[nm].closed]
        dist = [nm for nm in open_names if nm in mh.dist_indices]
        if len(dist) == 1 and len(open_names) == 1:
            return dist[0]
        if dist:
            raise IllegalArgumentException(
                "all-indices search over multiple (or mixed "
                "local/distributed) indices is not supported in "
                "coordinator mode; name one index (distributed "
                f"here: {sorted(dist)})")
        return None

    def msearch(self, pairs: List[Tuple[dict, dict]],
                preference: Optional[str] = None) -> dict:
        """``_msearch`` over (header, body) pairs. When every header names
        the same expression and it resolves to one open index with no
        alias filter or routing, the eligible items run as one batch
        (``search/batch.py``: one device pass per segment, one copy of
        each shard picked for the batch); the rest run one by one through
        ``search``, and a typed error becomes that item's ES-shaped
        failure entry. A header's ``preference`` overrides
        ``preference``; items whose preferences differ never batch."""
        pre: List[Optional[dict]] = [None] * len(pairs)
        prefs = [h.get("preference", preference) for h, _ in pairs]
        if len(pairs) >= 2 and len(set(prefs)) == 1:
            names = {h.get("index") if isinstance(h.get("index"), str)
                     else None for h, _ in pairs}
            if len(names) == 1 and None not in names:
                try:
                    plan = self._search_plan(next(iter(names)))
                except ElasticsearchTpuException:
                    plan = []
                # one concrete index batches; anything else runs through
                # the sequential search below, and so does a distributed
                # index, whose local service holds only this member's
                # shards (each item scatters through the data plane)
                mh = self.multihost
                svc = self.indices[plan[0][0]] \
                    if len(plan) == 1 and plan[0][1:] == (None, None) \
                    and not (mh is not None
                             and plan[0][0] in mh.dist_indices) \
                    else None
                out = None
                if svc is not None:
                    try:
                        out = try_batched_msearch(svc, [b for _, b in pairs],
                                                  preference=prefs[0])
                    except ElasticsearchTpuException:
                        # a typed refusal (a breaker denial): each item
                        # runs alone and reports its own error; a device
                        # fault is not typed and propagates
                        out = None
                if out is not None:
                    pre = out
        responses = []
        for (header, body), served, pref in zip(pairs, pre, prefs):
            if served is not None:
                responses.append(served)
                continue
            try:
                responses.append(self.search(header.get("index"), body,
                                             preference=pref))
            except ElasticsearchTpuException as e:
                responses.append(msearch_error_entry(e))
        return {"responses": responses}

    def nodes_stats(self) -> dict:
        """ES's ``_nodes/stats`` for this node: its ``indices`` section
        (search, indexing, segments and fielddata sum over every copy of
        every shard, as the node holds them all; ``docs`` counts the
        primaries'), the process and host, ``jvm.mem`` (the process's
        resident set, for the reference's shape), breakers, the residency
        registry (``resources``), the tracer, the slow logs and the card
        (``accelerator``), the thread pools (empty until a request
        starts them), the task registry, the metrics registry's summaries
        and the serving front-end; ``indices.search.kernels`` holds the
        dispatch counters (``monitor/kernels.py``), with the mesh's
        fallback gauges beside them, and ``indices.search.launches``
        each hand-written kernel's launches in this process. The
        ``transport`` gives the node's transport address (a cluster
        member's TCP endpoint). ``flight`` holds the flight recorder's ring
        counts, ``watchdog`` the watchdog's trips and state, and
        ``programs`` the program registry's totals (the per-key table is
        at ``/_nodes/_local/xla/programs`` and ``/_cat/programs``)."""
        search = {k: 0 for k in SearchStats().to_json()}
        indexing = {"index_total": 0, "delete_total": 0,
                    "index_time_in_millis": 0}
        seg_count = seg_mem = fd_mem = fd_ev = fd_rh = 0
        tl_frames = tl_bytes = 0
        for svc in self.indices.values():
            for g in svc.groups:
                for shard in g.copies:
                    st = shard.stats()
                    for k in search:
                        search[k] += st["search"].get(k, 0)
                    for k in indexing:
                        indexing[k] += st["indexing"][k]
                    seg_count += st["segments"]["count"]
                    seg_mem += st["segments"]["memory_in_bytes"]
                    fd_mem += st["fielddata"]["memory_size_in_bytes"]
                    fd_ev += st["fielddata"]["evictions"]
                    fd_rh += st["fielddata"]["rehydrations"]
                    tl_frames += st["translog"].get(
                        "corrupt_tail_events", 0)
                    tl_bytes += st["translog"].get(
                        "corrupt_tail_bytes_dropped", 0)
        snap = kernels.snapshot()
        search["kernels"] = snap
        search["launches"] = kernels.launches()
        for k in ("mesh_fallback_total", "span_clause_truncated",
                  "mesh_host_by_design"):
            search[k] = snap.get(k, 0)
        proc = process_stats()
        return {
            "cluster_name": self.cluster_state.cluster_name,
            "nodes": {self.node_id: {
                "name": self.name,
                "indices": {
                    "docs": {"count": sum(s.num_docs
                                          for s in self.indices.values())},
                    "search": search,
                    "indexing": indexing,
                    "segments": {"count": seg_count,
                                 "memory_in_bytes": seg_mem},
                    "fielddata": {"memory_size_in_bytes": fd_mem,
                                  "evictions": fd_ev,
                                  "rehydrations": fd_rh},
                    "translog_recovery": {
                        "corrupt_tail_frames_skipped": tl_frames,
                        "corrupt_tail_bytes_dropped": tl_bytes},
                    "recovery": aggregate_recovery(self.indices.values()),
                },
                "process": proc,
                "os": os_stats(),
                "jvm": {"mem": {"heap_used_in_bytes":
                                proc["mem"]["resident_in_bytes"]}},
                "thread_pool": (self._thread_pool.stats()
                                if self._thread_pool is not None else {}),
                "breakers": self.breakers.stats(),
                "resources": self.residency.stats(),
                "tasks": self.tasks.stats(),
                "tracing": self.tracer.stats(),
                "metrics": self.metrics.summaries(),
                "serving": self.serving.stats(),
                "slowlog": aggregate_slowlog(self.indices.values()),
                "programs": programs.REGISTRY.stats(),
                "flight": self.flight.stats(),
                "watchdog": self.watchdog.stats(),
                "accelerator": device_stats(self.device),
                "transport": self._transport_info(),
            }},
        }

    def _transport_info(self) -> dict:
        """The transport section (ES's TransportInfo): the bound and
        publish address, and no profiles (a netty notion; a member has
        one binding)."""
        addr = "local[in-process]"
        if self.multihost is not None:
            addr = self.multihost.local.transport_address or addr
        return {"bound_address": [addr], "publish_address": addr,
                "profiles": {}}

    def info(self) -> dict:
        """The node's info (the reference's ``Node.info``); ``devices``
        lists the node's mesh devices in order."""
        return {
            "name": self.name,
            "cluster_name": self.cluster_state.cluster_name,
            "version": {
                "number": __version__,
                "build_flavor": "gpu" if self.device.type == "cuda"
                else self.device.type,
                "lucene_version": "n/a (device-resident segments)",
            },
            "tagline": "You Know, for Search",
            "devices": [str(d) for d in self.devices],
        }

    def close(self):
        # the watchdog stops and the recorder leaves the process fan
        # first: a detector must not race the indices closing under it
        self.watchdog.close()
        flight_mod.unregister(self.flight)
        # the coalescer next: parked requests resolve before the indices
        # they search close
        self.serving.close()
        for svc in self.indices.values():
            svc.close()
        if self._ivf_dir is not None:
            # the next process over this data path reads the programs
            # and bodies each index served, and the kernel libraries,
            # before its first request: persist them before the tier
            # unregisters (best-effort: a failed write costs the next
            # process a warmup, never this close)
            for name in self.indices:
                try:
                    census.store_census(name)
                except Exception:
                    logger.exception("census of [%s] not stored", name)
            try:
                aot.store_loaded()
            except Exception:
                logger.exception("kernel libraries not stored")
            ivf_cache.unregister(self._ivf_dir)
            self._ivf_dir = None
        self.indices.clear()
        if self._thread_pool is not None:
            self._thread_pool.shutdown()
            self._thread_pool = None


def _alias_spec(spec: Optional[dict]) -> dict:
    """An alias's stored spec: ``routing`` fans out into ``index_routing``
    and ``search_routing``, and routings are strings (settings are)."""
    meta = copy.deepcopy(dict(spec or {}))
    if "routing" in meta:
        r = str(meta.pop("routing"))
        meta.setdefault("index_routing", r)
        meta.setdefault("search_routing", r)
    for rk in ("index_routing", "search_routing"):
        if rk in meta:
            meta[rk] = str(meta[rk])
    return meta


def _with_filter(body: dict, flt: dict) -> dict:
    """The body with ``flt`` as a non-scoring filter beside its query."""
    return dict(body, query={"bool": {
        "must": [body.get("query") or {"match_all": {}}], "filter": [flt]}})


def _validate_index_name(name: str):
    if not name or name != name.lower() or re.search(r'[\\/*?"<>| ,#]', name) \
            or name.startswith(("_", "-", "+")):
        raise IllegalArgumentException(f"Invalid index name [{name}]")
