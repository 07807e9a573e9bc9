"""REST layer: ES-compatible HTTP JSON API.

Port of elasticsearch_tpu/rest/server.py (reference: ES's
org/elasticsearch/rest/ — RestController.java, method and path routing;
rest/action/*, the handlers: document CRUD, bulk, search, msearch, count,
explain, analyze, mappings, settings, aliases, templates, the cat family,
cluster health/state/stats, node stats, refresh/flush/optimize, mget,
scroll; and http/netty/NettyHttpServerTransport.java for the server).

A stdlib ThreadingHTTPServer (the HTTP layer is control plane only: the
heavy work is the kernels on the card), a route table of (method,
compiled regex) → handler, each request run on the named thread pool its
route belongs to, and ES-shaped JSON error envelopes.

Every route the reference registers is registered here and served. The
program observatory (``/_nodes/_local/xla/programs``, ``/_cat/programs``)
reads monitor/programs.py, and the three ``_warmup`` routes drive the
node's pre-warm service (serving/warmup.py). The flight recorder's surface
(``/_nodes/_local/flight``, ``/_cat/incidents``, ``/_cluster/diagnostics``
and its incident route) reads the node's recorder and watchdog
(monitor/flight.py, monitor/watchdog.py). On a node that
is a cluster member (``node.multihost``, cluster/bootstrap.py), the
routes of a distributed index go through the cluster's data plane
(``_mh``/``_mh_for``), and the node-level views (``_nodes``, ``_tasks``,
``_cat/shards``, ``_cat/segments``, ``_cluster/stats``, the pending
tasks) merge every member's own answer, fetched over the transport's
REST proxy (``ACTION_REST_PROXY``; ``_local_only`` pins a proxied
request to the member that receives it).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.tracing import TaskCancelledException
from elasticsearch_tpu_torch.utils.errors import (
    ElasticsearchTpuException,
    IllegalArgumentException,
    IndexNotFoundException,
)

Handler = Callable[..., Tuple[int, Any]]


# guards the get-or-register of a scroll context's persistent task
# (rest/_scroll): concurrent pages for one scroll_id race on it
_SCROLL_TASK_LOCK = threading.Lock()


class RestController:
    def __init__(self, node: Node):
        self.node = node
        self.routes: List[Tuple[str, re.Pattern, Handler]] = []
        # compiled regex -> the registered pattern string: the metrics
        # endpoint label (a raw request path would be unbounded-cardinality
        # — every doc id its own series; the ROUTE pattern is the bounded
        # name ES uses for its own handler stats)
        self._pattern_of: Dict[re.Pattern, str] = {}
        _register_all(self)

    def add(self, method: str, pattern: str, handler: Handler):
        # {name} -> named group (no slashes); {index} additionally excludes a
        # leading underscore so /_bulk, /_search etc. never bind as an index
        # (ES forbids index names starting with _, RestController does the same
        # disambiguation via path registration order)
        def group(m):
            name = m.group(1)
            if name == "index":
                # _all is the one _-prefixed segment that IS an index
                # expression (reference: /_all/_mapping, /_all/_warmer/x)
                return r"(?P<index>_all|[^/_][^/]*)"
            return rf"(?P<{name}>[^/]+)"

        rx = re.sub(r"\{(\w+)\}", group, pattern)
        compiled = re.compile(f"^{rx}/?$")
        self.routes.append((method, compiled, handler))
        self._pattern_of[compiled] = pattern

    @staticmethod
    def pool_for(method: str, path: str) -> str:
        """Route → thread pool name (reference: each TransportAction names
        its executor; here whole path SEGMENTS decide — substring matching
        would misroute index names like `logs_search`). A by-query runs
        on `bulk`, whose writes it makes: on `management`, as the
        reference runs it, two long ones hold both of that pool's
        workers and the `_tasks` cancel that should stop them waits
        behind them (ROADMAP C22)."""
        parts = [p for p in path.split("/") if p]
        seg_set = set(parts)
        if seg_set & {"_bulk", "_delete_by_query", "_update_by_query",
                      "_query"}:
            return "bulk"
        if seg_set & {"_search", "_msearch", "_count", "_suggest",
                      "_percolate", "_validate", "_explain", "_field_stats",
                      "_knn_search"}:
            return "search"
        if "_mget" in seg_set:
            return "get"
        if seg_set & {"_update", "_doc", "_create"}:
            return "get" if method in ("GET", "HEAD") else "index"
        if len(parts) >= 2 and not parts[-1].startswith("_") \
                and not parts[0].startswith("_"):
            # /{index}/{type}/{id}-style document CRUD
            return "get" if method in ("GET", "HEAD") else "index"
        return "management"

    def dispatch(self, method: str, path: str, params: Dict[str, str],
                 body: bytes,
                 headers: Optional[Dict[str, str]] = None) -> Tuple[int, Any]:
        for m, rx, handler in self.routes:
            if m != method:
                continue
            match = rx.match(path)
            if match:
                # in_flight_requests breaker (reference: the netty-level
                # inflight-requests accounting): body bytes held in
                # memory while the request runs; trip → 429 before any
                # handler work. Search-family routes admit through the
                # per-tenant QoS layer (serving/qos.py) over the SAME
                # breaker: the tenant (X-Tenant-Id header / ?tenant=)
                # charges its weighted share, so a greedy tenant 429s
                # while other tenants keep serving.
                t0 = time.perf_counter()
                pool = self.pool_for(method, path)
                inflight = self.node.breakers.breaker("in_flight_requests")
                nbytes = len(body or b"")
                qos_token = None
                try:
                    if pool == "search":
                        tenant = params.get("tenant") or (
                            headers or {}).get("x-tenant-id")
                        qos_token = self.node.serving.qos.admit(
                            tenant, nbytes)
                    else:
                        inflight.break_or_reserve(nbytes, "<http_request>")
                except ElasticsearchTpuException as e:
                    return self._finish(rx, method, t0, e.status,
                                        _error_body(e))
                try:
                    # run on the route's named pool: bounded concurrency,
                    # full queues reject with 429 (ThreadPool.java contract)
                    status, out = self.node.thread_pool.execute(
                        pool,
                        handler, self.node, params, body,
                        **{k: _decode_path_part(v)
                           for k, v in match.groupdict().items()})
                except ElasticsearchTpuException as e:
                    status, out = e.status, _error_body(e)
                except json.JSONDecodeError as e:
                    status, out = 400, {
                        "error": {"type": "parse_exception",
                                  "reason": str(e)}, "status": 400}
                except Exception as e:  # noqa: BLE001 — a handler bug must
                    # surface as an ES-style 500 envelope, never a dropped
                    # connection (mirrors ES catching Throwable per request)
                    status, out = 500, {
                        "error": {"type": "internal_server_error",
                                  "reason": f"{type(e).__name__}: {e}"},
                        "status": 500,
                    }
                finally:
                    if qos_token is not None:
                        self.node.serving.qos.release(qos_token)
                    else:
                        inflight.release(nbytes)
                return self._finish(rx, method, t0, status, out)
        return 400, {
            "error": {"type": "illegal_argument_exception",
                      "reason": f"no handler found for uri [{path}] and method [{method}]"},
            "status": 400,
        }

    def _finish(self, rx: re.Pattern, method: str, t0: float,
                status: int, out: Any) -> Tuple[int, Any]:
        """Per-endpoint REST metrics: latency histogram + status-class
        counter, labeled by the registered ROUTE pattern (bounded set —
        never the raw path). Recording failures are swallowed: dropping
        one sample must never fail the request it measured."""
        try:
            endpoint = self._pattern_of.get(rx, "<unregistered>")
            m = self.node.metrics
            m.histogram(
                "estpu_rest_request_duration_seconds",
                "REST dispatch latency by route pattern",
                ("endpoint", "method"),
            ).labels(endpoint, method).observe(time.perf_counter() - t0)
            m.counter(
                "estpu_rest_requests_total",
                "REST requests by route pattern and status class",
                ("endpoint", "method", "status"),
            ).labels(endpoint, method, f"{int(status) // 100}xx").inc()
        except Exception:  # dropping one metric sample must never fail
            pass           # the measured request
        return status, out


def _decode_path_part(v: Optional[str]) -> Optional[str]:
    """Routes match the %-encoded request path; handlers get decoded
    values (non-ASCII doc ids). Raw UTF-8 request lines arrive read as
    latin-1 by http.server — rescue those too when they round-trip."""
    if v is None:
        return None
    from urllib.parse import unquote

    v = unquote(v)
    try:
        return v.encode("latin-1").decode("utf-8")
    except (UnicodeEncodeError, UnicodeDecodeError):
        return v


def _refresh_requested(p) -> bool:
    """refresh=true|1|''|wait_for all force visibility (2.0 treats the
    param as a boolean-ish flag; wait_for refreshes inline here)."""
    return p.get("refresh") in ("true", "", "1", "wait_for")


def _error_body(e: ElasticsearchTpuException) -> dict:
    return {
        "error": {"type": e.error_type, "reason": str(e),
                  "root_cause": [{"type": e.error_type, "reason": str(e)}]},
        "status": e.status,
    }


def _json(body: bytes) -> dict:
    if not body:
        return {}
    try:
        return json.loads(body)
    except json.JSONDecodeError:
        # the reference's Jackson parser is lenient about unquoted field
        # names — quote them and retry (no YAML-style scalar coercion:
        # values must stay exactly what strict JSON would produce)
        import re as _re

        text = body.decode() if isinstance(body, bytes) else str(body)
        fixed = _re.sub(r'([,{]\s*)([A-Za-z_][A-Za-z0-9_.]*)(\s*:)',
                        r'\1"\2"\3', text)
        try:
            return json.loads(fixed)
        except json.JSONDecodeError:
            pass
        raise


def _ndjson(body: bytes) -> List[dict]:
    return [json.loads(line) for line in body.decode().splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# handlers (grouped like rest/action/*)
# ---------------------------------------------------------------------------

def _register_all(rc: RestController):
    add = rc.add
    # root / info / health
    add("GET", "/", lambda n, p, b: (200, n.info()))
    add("HEAD", "/", lambda n, p, b: (200, None))
    add("GET", "/_cluster/health", _cluster_health)
    add("GET", "/_cluster/state", lambda n, p, b: (200, n.cluster_state.to_json()))
    add("GET", "/_cluster/stats", _cluster_stats)
    add("GET", "/_nodes/stats", _nodes_info)
    add("GET", "/_nodes", _nodes_info)
    add("GET", "/_stats", lambda n, p, b: _index_stats(n, p, b, None))

    # task management API over tracing/tasks.py (reference: rest/action/
    # admin/cluster/node/tasks — RestListTasksAction, RestCancelTasksAction)
    add("GET", "/_tasks", _tasks_list)
    add("GET", "/_tasks/{task_id}", _task_get)
    add("POST", "/_tasks/{task_id}/_cancel", _task_cancel)
    add("GET", "/_cat/tasks", _cat_tasks)
    # chrome-trace dump of the local span ring (tracing/tracer.py) —
    # registered before the /_nodes/{nodeid}/... patterns so the literal
    # path wins
    add("GET", "/_nodes/_local/trace", _node_trace)
    # device-program observatory (monitor/programs.py) — also before the
    # /_nodes/{nodeid} patterns so the literal path wins
    add("GET", "/_nodes/_local/xla/programs", _node_programs)
    # flight recorder + watchdog + incident surface (monitor/flight.py,
    # monitor/watchdog.py): per-node black box, cluster-wide support
    # bundle, cat listing of captured incidents
    add("GET", "/_nodes/_local/flight", _node_flight)
    # pre-warm pipeline (serving/warmup.py): manual census-replay
    # trigger + status (the runs are cancellable cluster:admin/warmup
    # tasks in GET /_tasks)
    add("POST", "/_warmup", _warmup_trigger)
    add("GET", "/_warmup", _warmup_status)
    add("POST", "/{index}/_warmup", _warmup_trigger_index)
    add("GET", "/_cat/incidents", _cat_incidents)
    add("GET", "/_cluster/diagnostics", _cluster_diagnostics)
    add("GET", "/_cluster/diagnostics/incidents/{incident_id}",
        _get_incident)
    # continuous metrics scrape (text exposition format 0.0.4): the node
    # registry + the process-shared families (monitor/metrics.py)
    add("GET", "/_prometheus/metrics", _prometheus_metrics)

    # cat API (text/plain-ish, returned as JSON rows when format=json)
    add("GET", "/_cat/indices", _cat_indices)
    add("GET", "/_cat/health", _cat_health)
    add("GET", "/_cat/shards", _cat_shards)
    add("GET", "/_cat/nodes", _cat_nodes)
    add("GET", "/_cat/count", _cat_count)
    add("GET", "/_cat/count/{index}", _cat_count)
    add("GET", "/_cat/templates", lambda n, p, b: (200, [
        {"name": k, "index_patterns": v.get("index_patterns", [v.get("template", "")])}
        for k, v in n.cluster_state.templates.items()]))
    add("GET", "/_cat/master", _cat_master)
    add("GET", "/_cat/aliases", _cat_aliases)
    add("GET", "/_cat/allocation", _cat_allocation)
    add("GET", "/_cat/segments", _cat_segments)
    add("GET", "/_cat/recovery", _cat_recovery)
    add("GET", "/_cat/plugins", lambda n, p, b: (200, []))
    add("GET", "/_cat/pending_tasks", _cat_pending_tasks)
    add("GET", "/_cat/programs", _cat_programs)
    add("GET", "/_cat/thread_pool", _cat_thread_pool)
    add("GET", "/_cat/fielddata", _cat_fielddata)
    add("GET", "/_cat/repositories", lambda n, p, b: (200, [
        {"id": name, "type": "fs"} for name in n.repositories]))
    add("GET", "/_cat/snapshots/{repo}", _cat_snapshots)

    # REST-spec tail: cluster admin, global-index forms, JSON
    # segments/recovery, mpercolate/mtermvectors/mlt, search_exists/shards,
    # snapshot status/verify, indexed scripts. Registered before the
    # snapshot + /{index} blocks so literal _-prefixed paths win.
    add("GET", "/_cluster/settings", _cluster_get_settings)
    add("PUT", "/_cluster/settings", _cluster_put_settings)
    add("GET", "/_cluster/pending_tasks", _cluster_pending_tasks)
    add("POST", "/_cluster/reroute", _cluster_reroute)
    add("GET", "/_nodes/hot_threads", _hot_threads)
    add("GET", "/_nodes/{nodeid}/hot_threads",
        lambda n, p, b, nodeid: _hot_threads(n, p, b))
    add("GET", "/_cat", _cat_help)
    add("GET", "/_count", lambda n, p, b: _count(n, p, b, None))
    add("POST", "/_count", lambda n, p, b: _count(n, p, b, None))
    add("GET", "/_field_stats", lambda n, p, b: _field_stats(n, p, b, None))
    add("POST", "/_field_stats", lambda n, p, b: _field_stats(n, p, b, None))
    add("POST", "/_flush", lambda n, p, b: _flush(n, p, b, None))
    add("GET", "/_flush", lambda n, p, b: _flush(n, p, b, None))
    add("POST", "/_optimize", lambda n, p, b: _optimize(n, p, b, None))
    add("POST", "/_forcemerge", lambda n, p, b: _optimize(n, p, b, None))
    add("GET", "/_segments", _segments_json)
    add("GET", "/_recovery", _recovery_json)
    add("POST", "/_cache/clear", _clear_cache)
    add("POST", "/_upgrade", _upgrade)
    add("GET", "/_upgrade", _get_upgrade)
    add("POST", "/_mpercolate", _mpercolate)
    add("POST", "/_mtermvectors", _mtermvectors)
    add("GET", "/_mtermvectors", _mtermvectors)
    add("GET", "/_search/scroll", _scroll)
    add("GET", "/_search/template", lambda n, p, b: _search_template(n, p, b, None))
    add("POST", "/_search/template", lambda n, p, b: _search_template(n, p, b, None))
    add("GET", "/_mapping/field/{field}",
        lambda n, p, b, field: _get_field_mapping(n, p, b, field))
    add("GET", "/_snapshot/_status",
        lambda n, p, b: _snapshot_status(n, p, b))
    add("PUT", "/_scripts/{lang}/{id}", _put_script)
    add("POST", "/_scripts/{lang}/{id}", _put_script)
    add("GET", "/_scripts/{lang}/{id}", _get_script)
    add("DELETE", "/_scripts/{lang}/{id}", _delete_script)
    add("HEAD", "/_alias/{alias}",
        lambda n, p, b, alias: _alias_exists(n, p, b, alias))
    add("HEAD", "/_template/{name}", _template_exists)
    add("GET", "/_snapshot/{repo}/{snap}/_status",
        lambda n, p, b, repo, snap: _snapshot_status(n, p, b, repo, snap))
    add("POST", "/_snapshot/{repo}/_verify", _verify_repo)

    # snapshot API (before /{index} patterns so the literal prefix wins)
    add("PUT", "/_snapshot/{repo}", _put_repo)
    add("POST", "/_snapshot/{repo}", _put_repo)
    add("GET", "/_snapshot", _get_repos)
    add("GET", "/_snapshot/{repo}", _get_repo)
    add("DELETE", "/_snapshot/{repo}", _delete_repo)
    add("PUT", "/_snapshot/{repo}/{snap}", _put_snapshot)
    add("GET", "/_snapshot/{repo}/{snap}", _get_snapshot)
    add("DELETE", "/_snapshot/{repo}/{snap}", _delete_snapshot)
    add("POST", "/_snapshot/{repo}/{snap}/_restore", _restore_snapshot)

    # rest-api-spec sweep: root-scoped + alternate-spelling + GET forms
    add("GET", "/_cat/aliases/{name}", _cat_aliases)
    add("GET", "/_cat/allocation/{nodeid}", _cat_allocation)
    add("GET", "/_cat/fielddata/{fields}",
        lambda n, p, b, fields: _cat_fielddata(n, p, b, fields))
    add("GET", "/_cat/indices/{index}", _cat_indices)
    add("GET", "/_cat/recovery/{index}", _cat_recovery)
    add("GET", "/_cat/segments/{index}", _cat_segments)
    add("GET", "/_cat/shards/{index}", _cat_shards)
    add("DELETE", "/_search/scroll/{scroll_id}",
        lambda n, p, b, scroll_id: _clear_scroll(
            n, {**p, "scroll_id": scroll_id}, b))  # body ids win
    add("GET", "/_cluster/health/{index}",
        lambda n, p, b, index: _cluster_health(n, p, b))
    add("GET", "/_cluster/state/{metric}", _cluster_state_metric)
    add("GET", "/_cluster/state/{metric}/{index}",
        lambda n, p, b, metric, index: _cluster_state_metric(
            n, p, b, metric, index))
    add("GET", "/_cluster/stats/nodes/{nodeid}",
        lambda n, p, b, nodeid: _cluster_stats(n, p, b))
    add("GET", "/_mapping", _get_mapping_root)
    add("GET", "/_mappings", _get_mapping_root)
    add("GET", "/_mapping/{type}", _get_mapping_root)
    add("PUT", "/_mapping/{type}", _put_mapping_root)
    add("PUT", "/_mappings/{type}", _put_mapping_root)
    add("POST", "/_mapping/{type}", _put_mapping_root)
    add("POST", "/_mappings/{type}", _put_mapping_root)
    add("GET", "/_settings", _get_settings_root)
    add("GET", "/_settings/{name}", _get_settings_root)
    add("PUT", "/_settings", _put_settings_root)
    add("GET", "/_alias", _get_aliases)
    add("GET", "/_aliases/{alias}", _get_alias)
    add("GET", "/_template",
        lambda n, p, b: _get_template(n, p, b, None))
    add("POST", "/_template/{name}", lambda n, p, b, name: (
        200, n.put_template(name, _json(b), create=str(
            p.get("create", "false")).lower() in ("", "true"))))
    add("GET", "/_warmer", _get_warmers_root)
    add("GET", "/_warmer/{name}", _get_warmers_root)
    add("PUT", "/_warmer/{name}", _put_warmer_root)
    add("PUT", "/_warmers/{name}", _put_warmer_root)
    add("POST", "/_warmer/{name}", _put_warmer_root)
    add("POST", "/_warmers/{name}", _put_warmer_root)
    add("GET", "/_refresh", _refresh_all)
    add("GET", "/_optimize", lambda n, p, b: _optimize(n, p, b, None))
    add("GET", "/_cache/clear", _clear_cache)
    add("GET", "/_mget", _mget)
    add("GET", "/_mpercolate", _mpercolate)
    add("GET", "/_msearch", _msearch)
    add("GET", "/_search/scroll/{scroll_id}",
        lambda n, p, b, scroll_id: _scroll(n, {**p, "scroll_id": scroll_id}, b))
    add("POST", "/_search/scroll/{scroll_id}",
        lambda n, p, b, scroll_id: _scroll(n, {**p, "scroll_id": scroll_id}, b))
    add("GET", "/_search/exists", lambda n, p, b: _search_exists(n, p, b, None))
    add("POST", "/_search/exists", lambda n, p, b: _search_exists(n, p, b, None))
    add("GET", "/_search_shards", lambda n, p, b: _search_shards(n, p, b, None))
    add("POST", "/_search_shards", lambda n, p, b: _search_shards(n, p, b, None))
    add("GET", "/_validate/query", lambda n, p, b: _validate_query(n, p, b, None))
    add("POST", "/_validate/query", lambda n, p, b: _validate_query(n, p, b, None))
    add("GET", "/_stats/{metric}",
        lambda n, p, b, metric: _index_stats(n, p, b, None, metric))
    add("POST", "/_snapshot/{repo}/{snap}", _put_snapshot)
    add("PUT", "/_snapshot/{repo}/{snap}/_create", _put_snapshot)
    add("POST", "/_snapshot/{repo}/{snap}/_create", _put_snapshot)
    add("POST", "/_search/template/{id}", _put_search_template)
    add("GET", "/_mapping/{type}/field/{field}",
        lambda n, p, b, type, field: _get_field_mapping(
            n, p, b, field, None, doc_type=type))
    # nodes.info / nodes.stats scoped forms (single node: node_id/metric
    # selectors accept anything and return this node's full view)
    add("GET", "/_nodes/hotthreads", _hot_threads)
    add("GET", "/_nodes/{nodeid}/hotthreads",
        lambda n, p, b, nodeid: _hot_threads(n, p, b))
    add("GET", "/_cluster/nodes/hotthreads", _hot_threads)
    add("GET", "/_cluster/nodes/hot_threads", _hot_threads)
    add("GET", "/_cluster/nodes/{nodeid}/hotthreads",
        lambda n, p, b, nodeid: _hot_threads(n, p, b))
    add("GET", "/_cluster/nodes/{nodeid}/hot_threads",
        lambda n, p, b, nodeid: _hot_threads(n, p, b))
    add("GET", "/_nodes/stats/{metric}", _nodes_info)
    add("GET", "/_nodes/stats/{metric}/{imetric}", _nodes_info)
    add("GET", "/_nodes/{nodeid}/stats", _nodes_info)
    add("GET", "/_nodes/{nodeid}/stats/{metric}", _nodes_info)
    add("GET", "/_nodes/{nodeid}/stats/{metric}/{imetric}", _nodes_info)
    add("GET", "/_nodes/{nodeid}", _nodes_info)
    add("GET", "/_nodes/{nodeid}/{metric}", _nodes_info)

    # index admin
    add("PUT", "/{index}", _create_index)
    add("POST", "/{index}", _create_index)
    add("DELETE", "/{index}", lambda n, p, b, index: (200, n.delete_index(index)))
    add("HEAD", "/{index}", _index_exists)
    add("GET", "/{index}/_mapping", _get_mapping_index)
    add("GET", "/{index}/_mapping/{type}", _get_mapping_typed)
    add("GET", "/{index}/_mappings/{type}", _get_mapping_typed)
    for _m in ("PUT", "POST"):
        add(_m, "/{index}/{type}/_mapping",
            lambda n, p, b, index, type: (
                200, n.put_mapping(index,
                                   _typed_mapping_body(type, _json(b)))))
        add(_m, "/{index}/{type}/_mappings",
            lambda n, p, b, index, type: (
                200, n.put_mapping(index,
                                   _typed_mapping_body(type, _json(b)))))
    add("GET", "/{index}/_settings/{name}",
        lambda n, p, b, index, name: _get_settings_name(n, p, b, index, name))
    add("PUT", "/{index}/_mapping", lambda n, p, b, index: (200, n.put_mapping(index, _json(b))))
    add("PUT", "/{index}/_mapping/{type}", lambda n, p, b, index, type: (
        200, n.put_mapping(index, _typed_mapping_body(type, _json(b)))))
    add("GET", "/{index}/_settings", _get_settings)
    add("PUT", "/{index}/_settings", _put_settings)
    add("POST", "/{index}/_close", _close_index)
    add("POST", "/{index}/_open", _open_index)
    add("GET", "/{index}", _get_index_meta)
    add("POST", "/_aliases", lambda n, p, b: (200, n.update_aliases(_json(b).get("actions", []))))
    add("GET", "/_aliases", _get_aliases)
    add("GET", "/_alias/{alias}", _get_alias)
    add("PUT", "/_template/{name}", lambda n, p, b, name: (
        200, n.put_template(name, _json(b), create=str(
            p.get("create", "false")).lower() in ("", "true"))))
    add("GET", "/_template/{name}", _get_template)
    add("DELETE", "/_template/{name}", lambda n, p, b, name: (200, n.delete_template(name)))

    # index lifecycle ops
    add("POST", "/{index}/_refresh", _refresh)
    add("GET", "/{index}/_refresh", _refresh)
    add("POST", "/_refresh", _refresh_all)
    add("POST", "/{index}/_flush", _flush)
    add("POST", "/{index}/_optimize", _optimize)  # ES 2.0 name
    add("POST", "/{index}/_forcemerge", _optimize)
    add("GET", "/{index}/_stats", _index_stats)
    add("GET", "/{index}/_count", _count)
    add("POST", "/{index}/_count", _count)

    # analyze
    add("GET", "/_analyze", _analyze)
    add("POST", "/_analyze", _analyze)
    add("GET", "/{index}/_analyze", _analyze_index)
    add("POST", "/{index}/_analyze", _analyze_index)

    # documents
    add("PUT", "/{index}/_doc/{id}", _index_doc)
    add("POST", "/{index}/_doc/{id}", _index_doc)
    add("POST", "/{index}/_doc", _index_doc_auto)
    add("PUT", "/{index}/_create/{id}", _create_doc)
    add("GET", "/{index}/_doc/{id}", _get_doc)
    add("HEAD", "/{index}/_doc/{id}", _doc_exists)
    add("DELETE", "/{index}/_doc/{id}", _delete_doc)
    add("POST", "/{index}/_update/{id}", _update_doc)
    add("POST", "/{index}/_delete_by_query", _delete_by_query)
    add("DELETE", "/{index}/_query", _delete_by_query)  # ES 2.0 plugin path
    add("POST", "/{index}/_update_by_query", _update_by_query)
    add("GET", "/{index}/_source/{id}", _get_source)
    add("POST", "/_mget", _mget)
    add("POST", "/{index}/_mget", _mget_index)

    # bulk
    add("POST", "/_bulk", _bulk)
    add("PUT", "/_bulk", _bulk)
    add("POST", "/{index}/_bulk", _bulk_index)

    # search family
    add("GET", "/_search", _search_all)
    add("POST", "/_search", _search_all)
    add("GET", "/{index}/_search", _search)
    add("POST", "/{index}/_search", _search)
    add("POST", "/_msearch", _msearch)
    add("POST", "/{index}/_msearch", _msearch_index)
    add("POST", "/_search/scroll", _scroll)
    add("DELETE", "/_search/scroll", _clear_scroll)
    add("GET", "/{index}/_search/template", _search_template)
    add("POST", "/{index}/_search/template", _search_template)
    add("POST", "/_render/template", _render_template_ep)
    add("PUT", "/_search/template/{id}", _put_search_template)
    add("GET", "/_search/template/{id}", _get_search_template)
    add("DELETE", "/_search/template/{id}", _delete_search_template)
    add("PUT", "/{index}/_warmer/{name}", _put_warmer)
    add("PUT", "/{index}/_warmers/{name}", _put_warmer)
    add("GET", "/{index}/_warmer", _get_warmers)
    add("GET", "/{index}/_warmer/{name}", _get_warmer)
    add("DELETE", "/{index}/_warmer/{name}", _delete_warmer)
    add("POST", "/{index}/_validate/query", _validate_query)
    add("GET", "/{index}/_validate/query", _validate_query)
    add("POST", "/{index}/_explain/{id}", _explain)
    add("GET", "/{index}/_explain/{id}", _explain)
    add("GET", "/{index}/_field_stats", _field_stats)
    add("POST", "/{index}/_field_stats", _field_stats)
    add("GET", "/{index}/_termvectors/{id}", _termvectors)
    add("GET", "/{index}/{type}/_percolate", _typed(_percolate, keep_type=True))
    add("POST", "/{index}/{type}/_percolate", _typed(_percolate, keep_type=True))
    add("GET", "/{index}/{type}/{id}/_percolate", _typed(_percolate_existing, keep_type=True))
    add("POST", "/{index}/{type}/{id}/_percolate", _typed(_percolate_existing, keep_type=True))
    add("POST", "/_suggest", _suggest_all)
    add("GET", "/_suggest", _suggest_all)
    add("POST", "/{index}/_suggest", _suggest)
    add("GET", "/{index}/_suggest", _suggest)


    # REST-spec tail, per-index forms
    add("PUT", "/{index}/_alias/{name}", _put_alias)
    add("POST", "/{index}/_alias/{name}", _put_alias)
    add("PUT", "/{index}/_aliases/{name}", _put_alias)
    add("DELETE", "/{index}/_alias/{name}", _delete_alias)
    add("DELETE", "/{index}/_aliases/{name}", _delete_alias)
    add("HEAD", "/{index}/_alias/{name}", _index_alias_exists)
    add("HEAD", "/{index}/_aliases/{name}", _index_alias_exists)
    add("HEAD", "/{index}/_alias", _index_any_alias)
    add("GET", "/{index}/_alias", _get_index_alias)
    add("GET", "/{index}/_aliases", _get_index_alias)
    add("GET", "/{index}/_aliases/{alias}",
        lambda n, p, b, index, alias: _get_index_alias(
            n, p, b, index, alias, legacy=True))
    add("GET", "/{index}/_alias/{alias}",
        lambda n, p, b, index, alias: _get_index_alias(n, p, b, index, alias))
    add("HEAD", "/{index}/_mapping/{type}", _type_exists)
    add("GET", "/{index}/_mapping/field/{field}",
        lambda n, p, b, index, field: _get_field_mapping(n, p, b, field, index))
    add("GET", "/{index}/_segments",
        lambda n, p, b, index: _segments_json(n, p, b, index))
    add("GET", "/{index}/_recovery",
        lambda n, p, b, index: _recovery_json(n, p, b, index))
    add("POST", "/{index}/_cache/clear",
        lambda n, p, b, index: _clear_cache(n, p, b, index))
    add("POST", "/{index}/_upgrade",
        lambda n, p, b, index: _upgrade(n, p, b, index))
    add("GET", "/{index}/_upgrade",
        lambda n, p, b, index: _get_upgrade(n, p, b, index))
    add("POST", "/{index}/_mpercolate",
        lambda n, p, b, index: _mpercolate(n, p, b, index))
    add("POST", "/{index}/_mtermvectors",
        lambda n, p, b, index: _mtermvectors(n, p, b, index))
    add("GET", "/{index}/_mtermvectors",
        lambda n, p, b, index: _mtermvectors(n, p, b, index))
    add("GET", "/{index}/_search/exists", _search_exists)
    add("POST", "/{index}/_search/exists", _search_exists)
    add("GET", "/{index}/_search_shards", _search_shards)
    add("POST", "/{index}/_search_shards", _search_shards)
    add("POST", "/{index}/_termvectors/{id}", _termvectors)
    add("GET", "/{index}/{type}/{id}/_termvectors", _typed(_termvectors))
    add("POST", "/{index}/{type}/{id}/_termvectors", _typed(_termvectors))
    add("GET", "/{index}/{type}/_percolate/count", _typed(_percolate_count, keep_type=True))
    add("POST", "/{index}/{type}/_percolate/count", _typed(_percolate_count, keep_type=True))
    add("GET", "/{index}/{type}/{id}/_mlt", _typed(_mlt, keep_type=True))

    # index-scoped GET/alternate forms (rest-api-spec sweep)
    add("GET", "/{index}/_flush", _flush)
    add("GET", "/{index}/_optimize", _optimize)
    add("GET", "/{index}/_cache/clear",
        lambda n, p, b, index: _clear_cache(n, p, b, index))
    add("GET", "/{index}/_mget", _mget_index)
    add("GET", "/{index}/_mpercolate",
        lambda n, p, b, index: _mpercolate(n, p, b, index))
    add("GET", "/{index}/_msearch", _msearch_index)
    add("POST", "/{index}/_mapping", lambda n, p, b, index: (
        200, n.put_mapping(index, _json(b))))
    add("POST", "/{index}/_mapping/{type}", lambda n, p, b, index, type: (
        200, n.put_mapping(index, _typed_mapping_body(type, _json(b)))))
    add("PUT", "/{index}/_mappings", lambda n, p, b, index: (
        200, n.put_mapping(index, _json(b))))
    add("PUT", "/{index}/_mappings/{type}", lambda n, p, b, index, type: (
        200, n.put_mapping(index, _typed_mapping_body(type, _json(b)))))
    add("POST", "/{index}/_mappings", lambda n, p, b, index: (
        200, n.put_mapping(index, _json(b))))
    add("POST", "/{index}/_mappings/{type}", lambda n, p, b, index, type: (
        200, n.put_mapping(index, _typed_mapping_body(type, _json(b)))))
    add("GET", "/{index}/_mappings", lambda n, p, b, index: (
        200, n.get_mapping(index)))
    add("GET", "/{index}/_mapping/{type}/field/{field}",
        lambda n, p, b, index, type, field:
        _get_field_mapping(n, p, b, field, index, doc_type=type))
    add("GET", "/{index}/_stats/{metric}",
        lambda n, p, b, index, metric: _index_stats(n, p, b, index, metric))
    add("GET", "/{index}/_warmers", _get_warmers)
    add("GET", "/{index}/_warmers/{name}",
        lambda n, p, b, index, name: _get_warmer(n, p, b, index, name))

    # ES 2.0 typed forms — registered LAST so every /_-prefixed
    # sub-resource above wins the route (RestController does the same via
    # explicit registration order). {type} segments that start with an
    # underscore are rejected by the handlers, not silently bound.
    add("GET", "/{index}/{type}/_search", _typed(_search_typed, keep_type=True))
    add("POST", "/{index}/{type}/_search", _typed(_search_typed, keep_type=True))
    add("GET", "/{index}/{type}/_count", _typed(_count_typed, keep_type=True))
    add("POST", "/{index}/{type}/_count", _typed(_count_typed, keep_type=True))
    add("POST", "/{index}/{type}/_msearch", _typed(
        lambda n, p, b, index, type=None: _msearch(n, p, b, index,
                                                   doc_type=type),
        keep_type=True))
    add("GET", "/{index}/{type}/_msearch", _typed(
        lambda n, p, b, index, type=None: _msearch(n, p, b, index,
                                                   doc_type=type),
        keep_type=True))
    add("POST", "/{index}/{type}/_mget", _typed(
        lambda n, p, b, index, type=None: _mget_typed(n, p, b, index, type),
        keep_type=True))
    add("GET", "/{index}/{type}/_mget", _typed(
        lambda n, p, b, index, type=None: _mget_typed(n, p, b, index, type),
        keep_type=True))
    add("POST", "/{index}/{type}/_bulk", _typed(
        lambda n, p, b, index, type=None: _bulk(n, p, b, index,
                                                doc_type=type),
        keep_type=True))
    add("PUT", "/{index}/{type}/_bulk", _typed(
        lambda n, p, b, index, type=None: _bulk(n, p, b, index,
                                                doc_type=type),
        keep_type=True))
    add("GET", "/{index}/{type}/_suggest",
        _typed(lambda n, p, b, index: _suggest(n, p, b, index)))
    add("POST", "/{index}/{type}/_suggest",
        _typed(lambda n, p, b, index: _suggest(n, p, b, index)))
    add("GET", "/{index}/{type}/_termvectors", _typed(_termvectors_noid))
    add("POST", "/{index}/{type}/_termvectors", _typed(_termvectors_noid))
    add("POST", "/{index}/{type}/_mtermvectors",
        lambda n, p, b, index, type: _mtermvectors(n, p, b, index, type))
    add("GET", "/{index}/{type}/_mtermvectors",
        lambda n, p, b, index, type: _mtermvectors(n, p, b, index, type))
    add("GET", "/{index}/{type}/_search/template", _typed(_search_template))
    add("POST", "/{index}/{type}/_search/template", _typed(_search_template))
    add("GET", "/{index}/{type}/_search/exists", _typed(_search_exists))
    add("POST", "/{index}/{type}/_search/exists", _typed(_search_exists))
    add("GET", "/{index}/{type}/_validate/query", _typed(_validate_query))
    add("POST", "/{index}/{type}/_validate/query", _typed(_validate_query))
    add("GET", "/{index}/{type}/_warmer/{name}", _typed(_get_warmer))
    add("PUT", "/{index}/{type}/_warmer/{name}", _typed(_put_warmer))
    add("PUT", "/{index}/{type}/_warmers/{name}", _typed(_put_warmer))
    add("POST", "/{index}/{type}/_warmer/{name}", _typed(_put_warmer))
    add("POST", "/{index}/{type}/_warmers/{name}", _typed(_put_warmer))
    add("POST", "/{index}/_warmer/{name}", _put_warmer)
    add("POST", "/{index}/_warmers/{name}", _put_warmer)
    add("GET", "/{index}/{type}/{id}/_explain", _typed(_explain))
    add("POST", "/{index}/{type}/{id}/_explain", _typed(_explain))
    add("GET", "/{index}/{type}/{id}/_source", _typed(
        lambda n, p, b, index, id, type=None: (
            _check_read_routing(n, index, type, id, p)
            or _get_source(n, p, b, index, id)), keep_type=True))
    add("POST", "/{index}/{type}/{id}/_update", _typed(
        lambda n, p, b, index, id, type=None: (
            _check_read_routing(n, index, type, id, p)
            or _update_doc(n, p, b, index, id, doc_type=type)),
        keep_type=True))
    add("GET", "/{index}/{type}/{id}/_percolate/count",
        _typed(_percolate_count_existing, keep_type=True))
    add("POST", "/{index}/{type}/{id}/_percolate/count",
        _typed(_percolate_count_existing, keep_type=True))
    add("POST", "/{index}/{type}/{id}/_mlt", _typed(_mlt, keep_type=True))
    add("PUT", "/{index}/{type}/{id}/_create", _create_doc_typed)
    add("POST", "/{index}/{type}/{id}/_create", _create_doc_typed)
    add("HEAD", "/{index}/{type}/{id}", _doc_exists_typed)
    add("PUT", "/{index}/{type}/{id}", _index_doc_typed)
    add("POST", "/{index}/{type}/{id}", _index_doc_typed)
    add("GET", "/{index}/{type}/{id}", _get_doc_typed)
    add("DELETE", "/{index}/{type}/{id}", _delete_doc_typed)
    add("HEAD", "/{index}/{type}", _type_exists_head)
    add("POST", "/{index}/{type}", _index_doc_auto_typed)
    add("PUT", "/{index}/{type}", _index_doc_auto_typed)
    # indices.get feature form — LAST of all: only segments no literal
    # route claimed can land here, and non-feature values 400
    add("GET", "/{index}/{feature}", _get_index_feature)


# -- snapshot helpers --------------------------------------------------------

def _put_repo(n: Node, p, b, repo: str):
    from elasticsearch_tpu_torch.index.snapshots import FsRepository

    body = _json(b)
    rtype = body.get("type")
    settings = body.get("settings", {})
    if rtype == "fs":
        loc = settings.get("location")
        if not loc:
            raise IllegalArgumentException(
                "fs repository requires [settings.location]")
        r = FsRepository(repo, loc)
    elif rtype == "url":
        # read-only repository over a file: URL (reference:
        # repositories/uri/URLRepository.java — file scheme)
        url = str(settings.get("url", ""))
        if not url:
            raise IllegalArgumentException(
                "url repository requires [settings.url]")
        from urllib.parse import urlparse as _up
        from urllib.request import url2pathname

        is_file = url.startswith("file:")
        loc = url2pathname(_up(url).path) if is_file else url
        # read-only: never create directories (a non-file URL location is
        # not a path at all; reads against it 404 as snapshot-missing)
        r = FsRepository(repo, loc, create=False)
        r.readonly = True
    else:
        raise IllegalArgumentException(
            f"repository type [{rtype}] not supported (fs, url)")
    r.rtype = rtype
    r.repo_settings = dict(settings)
    n.repositories[repo] = r
    return 200, {"acknowledged": True}


def _repo_or_404(n: Node, repo: str):
    from elasticsearch_tpu_torch.index.snapshots import SnapshotMissingException

    r = n.repositories.get(repo)
    if r is None:
        raise SnapshotMissingException(f"[{repo}] missing")
    return r


def _repo_json(r):
    return {"type": getattr(r, "rtype", None) or "fs",
            "settings": getattr(r, "repo_settings", None)
            or {"location": r.location}}


def _get_repos(n: Node, p, b):
    return 200, {name: _repo_json(r) for name, r in n.repositories.items()}


def _get_repo(n: Node, p, b, repo: str):
    import fnmatch

    if any(c in repo for c in "*,") or repo == "_all":
        pats = [x.strip() for x in repo.split(",")]
        out = {name: _repo_json(r) for name, r in n.repositories.items()
               if any(fnmatch.fnmatch(name, pt) or pt == "_all"
                      for pt in pats)}
        if not out and not any("*" in pt or pt == "_all" for pt in pats):
            from elasticsearch_tpu_torch.index.snapshots import                 SnapshotMissingException

            raise SnapshotMissingException(f"[{repo}] missing")
        return 200, out
    r = _repo_or_404(n, repo)
    return 200, {repo: _repo_json(r)}


def _delete_repo(n: Node, p, b, repo: str):
    _repo_or_404(n, repo)
    del n.repositories[repo]
    return 200, {"acknowledged": True}


def _put_snapshot(n: Node, p, b, repo: str, snap: str):
    from elasticsearch_tpu_torch.index.snapshots import create_snapshot

    body = _json(b)
    indices = body.get("indices")
    if isinstance(indices, str):
        indices = [i for part in indices.split(",") if (i := part.strip())]
    if indices:
        indices = [name for pat in indices for name in n.resolve_indices(pat)]
    r = _repo_or_404(n, repo)
    _reject_readonly_repo(r)
    c = _mh(n)
    if c is not None:
        # each shard's owner writes its own blobs into the shared
        # repository; the master assembles the manifest
        return 200, c.data.create_snapshot(
            r.location, snap, indices=indices,
            include_global_state=body.get("include_global_state", True),
            repo_name=repo)
    return 200, create_snapshot(
        n, r, snap, indices=indices,
        include_global_state=body.get("include_global_state", True))


def _get_snapshot(n: Node, p, b, repo: str, snap: str):
    from elasticsearch_tpu_torch.index.snapshots import snapshot_info

    r = _repo_or_404(n, repo)
    if snap == "_all":
        return 200, {"snapshots": [snapshot_info(r, s) for s in r.catalog()]}
    return 200, {"snapshots": [snapshot_info(r, snap)]}


def _reject_readonly_repo(r):
    """Writes against a url repository fail cleanly (reference:
    URLRepository is read-only; snapshot creation raises a repository
    exception instead of touching the location)."""
    if getattr(r, "readonly", False):
        raise IllegalArgumentException(
            f"repository [{r.name}] is read-only; cannot write snapshots")


def _delete_snapshot(n: Node, p, b, repo: str, snap: str):
    r = _repo_or_404(n, repo)
    _reject_readonly_repo(r)
    r.delete_snapshot(snap)
    return 200, {"acknowledged": True}


def _restore_snapshot(n: Node, p, b, repo: str, snap: str):
    from elasticsearch_tpu_torch.index.snapshots import restore_snapshot

    body = _json(b)
    indices = body.get("indices")
    if isinstance(indices, str):
        indices = [i for part in indices.split(",") if (i := part.strip())]
    r = _repo_or_404(n, repo)
    c = _mh(n)
    if c is not None:
        # the master computes a fresh assignment over the members, then
        # every assigned copy replays from the repository
        return 200, c.data.restore_snapshot(
            r.location, snap, indices=indices,
            rename_pattern=body.get("rename_pattern"),
            rename_replacement=body.get("rename_replacement"),
            partial=bool(body.get("partial", False)),
            repo_name=repo)
    return 200, restore_snapshot(
        n, r, snap, indices=indices,
        rename_pattern=body.get("rename_pattern"),
        rename_replacement=body.get("rename_replacement"),
        partial=bool(body.get("partial", False)))


# -- admin helpers -----------------------------------------------------------

def _prometheus_metrics(n: Node, p, b):
    """GET /_prometheus/metrics: the node registry (+ process-shared
    families) in text exposition format 0.0.4. Returned as a str so the
    HTTP layer serves text/plain, the content type every scraper
    accepts."""
    return 200, n.metrics.expose()


def _cluster_stats(n: Node, p, b):
    """GET /_cluster/stats (reference: TransportClusterStatsAction): in a
    cluster, every member's part over the REST proxy (each answers its
    own under ``_local_only``), merged; a dead member counts in
    ``_nodes.failed`` and the answer stays 200."""
    local = _local_cluster_stats(n)
    c = _mh(n)
    if c is not None and "_local_only" in p:
        # a proxied member's part: raw, ``_index_names`` kept for the
        # coordinator's union
        return 200, local
    parts = [local]
    failed = 0
    if c is not None:
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        for nid in c.data._other_nodes():
            try:
                res = c.data._send(nid, ACTION_REST_PROXY, {
                    "method": "GET", "path": "/_cluster/stats",
                    "params": {}})
                if res.get("status") == 200 and res.get("payload"):
                    parts.append(res["payload"])
                else:
                    failed += 1
            except Exception:
                failed += 1
    out = _merge_cluster_stats(parts, failed=failed)
    out["cluster_name"] = n.cluster_state.cluster_name
    out["timestamp"] = int(time.time() * 1000)
    try:
        out["status"] = _cluster_health(n, {"_local_only": "1"}, b"")[1][
            "status"]
    except Exception:
        out["status"] = "green"
    return 200, out


def _local_cluster_stats(n: Node) -> dict:
    """This node's part of ``/_cluster/stats``. ``_index_names`` is for
    the merge, which strips it: every member holds an IndexService for a
    distributed index, so a per-node count would multiply it."""
    docs = 0
    store = seg_count = seg_mem = 0
    fd_mem = fd_ev = 0
    shards_total = primaries = 0
    c = _mh(n)
    for name, svc in n.indices.items():
        # a distributed index's local groups hold this member's copies,
        # primaries of other members' shards among them: its docs count
        # only where this member owns the primary (ROADMAP C23; the
        # reference counts every copy)
        dmeta = c.dist_indices.get(name) if c is not None else None
        for g in svc.groups:
            primaries += 1
            owns = dmeta is None or (
                dmeta["assignment"].get(str(g.shard_id)) or [None]
            )[0] == n.node_id
            for shard in g.copies:
                st = shard.stats()
                shards_total += 1
                if shard is g.primary and owns:
                    # docs count PRIMARIES only (reference:
                    # ClusterStatsIndices — replica copies hold the same
                    # documents; counting them would inflate by the
                    # replication factor and disagree with hits.total)
                    docs += st["docs"]["count"]
                # store/segments/fielddata count EVERY copy — each holds
                # its own device-resident structures (reference: store
                # size in cluster stats includes replicas)
                seg_count += st["segments"]["count"]
                seg_mem += st["segments"]["memory_in_bytes"]
                store += st["segments"]["memory_in_bytes"]
                fd_mem += st["fielddata"]["memory_size_in_bytes"]
                fd_ev += st["fielddata"]["evictions"]
    from elasticsearch_tpu_torch import __version__
    from elasticsearch_tpu_torch.monitor.stats import process_stats

    proc = process_stats()
    fds = proc["open_file_descriptors"]  # -1 where the OS hides it
    tp = {"completed": 0, "rejected": 0, "queue": 0}
    if n._thread_pool is not None:
        for st in n._thread_pool.stats().values():
            for k in tp:
                tp[k] += st[k]
    tripped = sum(br.get("tripped", 0)
                  for br in n.breakers.stats().values())
    # nodes.jit counts the process's first-touch events: kernel-library
    # builds and loads, first dispatches (tracing/retrace.py)
    from elasticsearch_tpu_torch.tracing import retrace

    return {
        "cluster_name": n.cluster_state.cluster_name,
        "_index_names": sorted(n.indices),
        "indices": {
            "count": len(n.indices),
            "shards": {"total": shards_total, "primaries": primaries},
            "docs": {"count": docs},
            "store": {"size_in_bytes": store},
            "fielddata": {"memory_size_in_bytes": fd_mem,
                          "evictions": fd_ev},
            "segments": {"count": seg_count, "memory_in_bytes": seg_mem},
        },
        "nodes": {
            "count": {"total": 1},
            "versions": [__version__],
            "process": {
                "mem": {
                    "resident_in_bytes": proc["mem"]["resident_in_bytes"]},
                "open_file_descriptors": {"min": fds, "max": fds,
                                          "avg": fds},
            },
            "thread_pool": tp,
            "breakers": {"tripped": tripped},
            "jit": {"traces_total": retrace.auditor().total()},
        },
    }


def _merge_cluster_stats(parts: List[dict], failed: int = 0) -> dict:
    """Merge the members' parts (reference: ClusterStatsResponse over
    ClusterStatsNodeResponses): index names union, numbers sum, versions
    union, the fd min/max/avg combine; ``_nodes`` when a member failed."""
    names: set = set()
    versions: List[str] = []
    for pt in parts:
        names.update(pt.pop("_index_names", ()))
        for v in pt["nodes"].pop("versions", ()):
            if v not in versions:
                versions.append(v)
    fds = [pt["nodes"]["process"].pop("open_file_descriptors")
           for pt in parts]
    out = _sum_stats(parts)
    out["indices"]["count"] = len(names)
    out["nodes"]["versions"] = versions
    good = [f for f in fds if f.get("min", -1) >= 0]
    out["nodes"]["process"]["open_file_descriptors"] = {
        "min": min((f["min"] for f in good), default=-1),
        "max": max((f["max"] for f in good), default=-1),
        "avg": (sum(f["avg"] for f in good) // len(good)) if good else -1,
    }
    if failed:
        out["_nodes"] = {"total": len(parts) + failed,
                         "successful": len(parts), "failed": failed}
    return out


def _sum_stats(dicts):
    out: Dict[str, Any] = {}
    for d in dicts:
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = _sum_stats([out.get(k, {}), v])
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = out.get(k, 0) + v
            else:
                out.setdefault(k, v)
    return out


# every section the IndicesStatsResponse carries; sections our runtime has
# no meaningful numbers for report zeroed structures (they exist so metric
# scoping and client consumers see the full 2.0 shape). fielddata reports
# the currently-RESIDENT device column bytes + real eviction counters
# (columns load lazily and evict under HBM pressure — see
# TpuSegment.fielddata_field_bytes / resources/residency.py)
_STATS_SECTIONS = {
    "docs": {"count": 0, "deleted": 0},
    "store": {"size_in_bytes": 0, "throttle_time_in_millis": 0},
    "indexing": {"index_total": 0, "index_time_in_millis": 0,
                 "delete_total": 0},
    "get": {"total": 0, "time_in_millis": 0},
    "search": {"query_total": 0, "query_time_in_millis": 0,
               "fetch_total": 0, "open_contexts": 0},
    "merges": {"total": 0, "total_time_in_millis": 0},
    "refresh": {"total": 0, "total_time_in_millis": 0},
    "flush": {"total": 0, "total_time_in_millis": 0},
    "warmer": {"current": 0, "total": 0, "total_time_in_millis": 0},
    "filter_cache": {"memory_size_in_bytes": 0, "evictions": 0},
    "id_cache": {"memory_size_in_bytes": 0},
    "fielddata": {"memory_size_in_bytes": 0, "evictions": 0},
    "percolate": {"total": 0, "time_in_millis": 0, "current": 0,
                  "queries": 0},
    "completion": {"size_in_bytes": 0},
    "segments": {"count": 0, "memory_in_bytes": 0},
    "translog": {"operations": 0, "size_in_bytes": 0},
    "suggest": {"total": 0, "time_in_millis": 0, "current": 0},
    "recovery": {"current_as_source": 0, "current_as_target": 0,
                 "throttle_time_in_millis": 0},
    # replication safety (index/seqno.py): what checkpoint-based
    # recovery negotiates on (reference: SeqNoStats)
    "seq_no": {"max_seq_no": -1, "local_checkpoint": -1,
               "global_checkpoint": -1, "primary_term": 0},
    "query_cache": {"memory_size_in_bytes": 0, "evictions": 0,
                    "hit_count": 0, "miss_count": 0},
}


def _full_sections(st: dict) -> dict:
    """Shard/primary stats dict -> all sections present (zero-filled)."""
    import copy

    out = copy.deepcopy(_STATS_SECTIONS)
    for k, v in st.items():
        if k in out and isinstance(v, dict):
            out[k].update(v)
    # store size: segment memory is the closest store analogue
    if not out["store"]["size_in_bytes"]:
        out["store"]["size_in_bytes"] = st.get("segments", {}).get(
            "memory_in_bytes", 0)
    return out


def _name_filter(spec):
    """Comma-separated name/wildcard list -> predicate (None = not asked)."""
    if spec in (None, ""):
        return None
    import fnmatch

    pats = [x.strip() for x in str(spec).split(",") if x.strip()]
    return lambda nm: any(fnmatch.fnmatchcase(nm, pt) for pt in pats)


def _stats_envelope(n: Node, names, metric: Optional[str] = None,
                    level: str = "indices",
                    params: Optional[dict] = None) -> dict:
    """IndicesStatsResponse shape: _shards + _all.primaries/total +
    per-index entries (total == primaries here: replica stats mirror the
    primary), every section present, metric-scoped when asked. The
    fields/fielddata_fields/completion_fields/groups/types params scope
    the per-field / per-group / per-type breakdowns exactly like
    CommonStatsFlags: absent param -> the breakdown key is absent."""
    params = params or {}
    fd_keep = _name_filter(params.get("fielddata_fields")
                           or params.get("fields"))
    comp_keep = _name_filter(params.get("completion_fields")
                             or params.get("fields"))
    grp_keep = _name_filter(params.get("groups"))
    type_keep = _name_filter(params.get("types"))

    def _scope_breakdowns(st):
        for section, key, keep in (("fielddata", "fields", fd_keep),
                                   ("completion", "fields", comp_keep),
                                   ("search", "groups", grp_keep),
                                   ("indexing", "types", type_keep)):
            d = st.get(section)
            if not isinstance(d, dict):
                continue
            if keep is None:
                d.pop(key, None)
            else:
                d[key] = {k2: v2 for k2, v2 in (d.get(key) or {}).items()
                          if keep(k2)}
        return st

    per = {}
    shards_per = {}
    for nm in names:
        raw = n.indices[nm].stats()
        shard_stats = {}
        for sid, sh in raw.get("shards", {}).items():
            full = _full_sections(sh)
            if "commit" in sh:  # CommitStats rides the shards level only
                full["commit"] = sh["commit"]
            shard_stats[sid] = full
        total = _full_sections(_sum_stats(raw.get("shards", {}).values()))
        qc = getattr(n.indices[nm], "query_cache_stats", None)
        if qc:  # shard query cache lives at the index level here
            total["query_cache"].update(
                hit_count=qc["hits"], miss_count=qc["misses"],
                evictions=qc["evictions"])
        per[nm] = total
        shards_per[nm] = shard_stats
    keep = None
    if metric and metric not in ("_all", ""):
        # metric name aliases the API accepts (merge -> merges section)
        alias = {"merge": "merges", "doc": "docs", "warmers": "warmer"}
        keep = {alias.get(m.strip(), m.strip())
                for m in str(metric).split(",")}
    def scope(st):
        return _scope_breakdowns(
            {k: v for k, v in st.items() if k in keep} if keep else st)
    agg = _full_sections(_sum_stats(per.values()))
    out = {
        "_shards": _shards_header(n, names),
        "_all": {"primaries": scope(agg), "total": scope(agg)},
        "indices": {nm: {"primaries": scope(st), "total": scope(st)}
                    for nm, st in per.items()},
    }
    if level == "shards":
        for nm in out["indices"]:
            out["indices"][nm]["shards"] = {
                sid: [scope(sh)] for sid, sh in shards_per[nm].items()}
    elif level == "cluster":
        out.pop("indices")  # cluster level: only the _all rollup
    return out


def _all_stats(n: Node) -> dict:
    return _stats_envelope(n, list(n.indices))


def _index_stats(n: Node, p, b, index: str, metric: Optional[str] = None):
    """GET /{index}/_stats[/{metric}] with multi-index expressions and
    level=indices|shards scoping."""
    names = _resolve_indices_options(n, index, p)
    return 200, _stats_envelope(n, names,
                                metric=metric or p.get("metric"),
                                level=p.get("level", "indices"),
                                params=p)



# -- cat column schemas (RestTable defaults + help listings, ES 2.0) ---------

_CAT_SHARD_TAIL = [
    "completion.size", "fielddata.memory_size", "fielddata.evictions",
    "filter_cache.memory_size", "filter_cache.evictions", "flush.total",
    "flush.total_time", "get.current", "get.time", "get.total",
    "get.exists_time", "get.exists_total", "get.missing_time",
    "get.missing_total", "id_cache.memory_size", "indexing.delete_current",
    "indexing.delete_time", "indexing.delete_total",
    "indexing.index_current", "indexing.index_time", "indexing.index_total",
    "merges.current", "merges.current_docs", "merges.current_size",
    "merges.total", "merges.total_docs", "merges.total_size",
    "merges.total_time", "percolate.current", "percolate.memory_size",
    "percolate.queries", "percolate.time", "percolate.total",
    "refresh.total", "refresh.time", "search.fetch_current",
    "search.fetch_time", "search.fetch_total", "search.open_contexts",
    "search.query_current", "search.query_time", "search.query_total",
    "segments.count", "segments.memory", "segments.index_writer_memory",
    "segments.index_writer_max_memory", "segments.version_map_memory",
    "segments.fixed_bitset_memory", "warmer.current", "warmer.total",
    "warmer.total_time"]

# endpoint (2nd path segment) -> help column list (RestTable's declared
# columns; the row handlers emit the leading subset that carries data)
_CAT_HELP = {
    "aliases": ["alias", "index", "filter", "routing.index",
                "routing.search"],
    "allocation": ["shards", "disk.used", "disk.avail", "disk.total",
                   "disk.percent", "host", "ip", "node"],
    "count": ["epoch", "timestamp", "count"],
    "fielddata": ["id", "host", "ip", "node", "total"],
    "health": ["epoch", "timestamp", "cluster", "status", "node.total",
               "node.data", "shards", "pri", "relo", "init", "unassign",
               "pending_tasks"],
    "indices": ["health", "status", "index", "pri", "rep", "docs.count",
                "docs.deleted", "store.size", "pri.store.size"],
    "master": ["id", "host", "ip", "node"],
    "nodes": ["host", "ip", "heap.percent", "ram.percent", "load",
              "node.role", "master", "name"],
    "pending_tasks": ["insertOrder", "timeInQueue", "priority", "source"],
    "tasks": ["action", "task_id", "parent_task_id", "type", "start_time",
              "running_time", "node"],
    "plugins": ["id", "name", "component", "version", "type", "url",
                "description"],
    "recovery": ["index", "shard", "time", "type", "stage", "source_host",
                 "target_host", "repository", "snapshot", "files",
                 "files_percent", "bytes", "bytes_percent", "total_files",
                 "total_bytes", "translog", "translog_percent",
                 "total_translog"],
    "segments": ["index", "shard", "prirep", "ip", "id", "segment",
                 "generation", "docs.count", "docs.deleted", "size",
                 "size.memory", "committed", "searchable", "version",
                 "compound"],
    "shards": ["index"] + ["shard", "prirep", "state", "docs", "store",
                           "ip", "id", "node"] + _CAT_SHARD_TAIL,
    "thread_pool": ["host", "ip", "bulk.active", "bulk.queue",
                    "bulk.rejected", "index.active", "index.queue",
                    "index.rejected", "search.active", "search.queue",
                    "search.rejected"],
}


def _cat_help_text(path: str):
    """`help` listing for a cat endpoint, or None when unknown."""
    parts = [x for x in path.split("/") if x]
    if len(parts) < 2:
        return None
    cols = _CAT_HELP.get(parts[1])
    if cols is None:
        return None
    width = max(len(c) for c in cols)
    return "\n".join(f"{c.ljust(width)} | | column" for c in cols) + "\n"



def _human_size(n: int) -> str:
    """ES ByteSizeValue text: scaled to kb/mb/gb/tb with one decimal."""
    n = int(n)
    for mul, suf in ((1 << 40, "tb"), (1 << 30, "gb"), (1 << 20, "mb"),
                     (1 << 10, "kb")):
        if n >= mul:
            v = n / mul
            return f"{v:.1f}{suf}" if v < 10 else f"{v:.0f}{suf}"
    return f"{n}b"


def _cat_scope(n: Node, index: Optional[str]):
    """Index names a scoped _cat route covers. A concrete name that
    resolves to nothing is a 404 (reference convention); wildcards and
    _all just narrow to the empty set."""
    names = n.resolve_indices(index)
    if not names and index not in (None, "", "_all", "*") \
            and "*" not in str(index) and "?" not in str(index):
        raise IndexNotFoundException(index)
    return names


def _cat_indices(n: Node, p, b, index: Optional[str] = None):
    rows = []
    for name in _cat_scope(n, index):
        svc = n.indices[name]
        size = sum(seg.memory_bytes() for sh in svc.shards
                   for seg in sh.segments)
        rows.append({
            "health": "green",
            "status": "close" if svc.closed else "open",
            "index": name,
            "pri": str(svc.num_shards), "rep": str(svc.num_replicas),
            "docs.count": str(svc.num_docs),
            "docs.deleted": str(sum(seg.deleted_count for sh in svc.shards
                                    for seg in sh.segments)),
            "store.size": _human_size(size),
            "pri.store.size": _human_size(size),
        })
    return 200, rows


def _cat_health(n: Node, p, b):
    import time as _t

    h = n.cluster_state.health()
    now = int(_t.time())
    return 200, [{
        "epoch": str(now),
        "timestamp": _t.strftime("%H:%M:%S", _t.gmtime(now)),
        "cluster": h["cluster_name"], "status": h["status"],
        "node.total": str(h["number_of_nodes"]),
        "node.data": str(h["number_of_nodes"]),
        "shards": str(h["active_shards"]),
        "pri": str(h["active_shards"]), "relo": "0", "init": "0",
        "unassign": "0",
        "pending_tasks": str(len(_all_pending_tasks(n, p))),
    }]


def _cat_master(n: Node, p, b):
    """RestMasterAction: the ELECTED master's own row — id, transport
    host, name — resolved from the cluster state's node map (the master
    is usually NOT the node serving this request in a multi-host world).
    A headless node answers the ES no-master shape (``-`` columns) with
    200: cat output keeps working under the NO_MASTER block."""
    st = n.cluster_state
    m = st.nodes.get(st.master_node_id) if st.master_node_id else None
    if m is None:
        return 200, [{"id": "-", "host": "-", "ip": "-", "node": "-"}]
    host = (m.transport_address.rsplit(":", 1)[0]
            if ":" in m.transport_address else "local")
    return 200, [{"id": m.node_id, "host": host, "ip": host,
                  "node": m.name or m.node_id}]


def _peer_shard_counts(n: Node, c) -> Dict[str, Dict[tuple, tuple]]:
    """{node_id: {(index, shard): (docs, store)}} from each peer's LOCAL
    cat-shards rows (the `_local_only` pin makes peers report their own
    engines) — one round per request, shared by the shard rows."""
    from elasticsearch_tpu_torch.cluster.search_action import \
        ACTION_REST_PROXY

    out: Dict[str, Dict[tuple, tuple]] = {}
    for nid in c.data._other_nodes():
        try:
            res = c.data._send(nid, ACTION_REST_PROXY, {
                "method": "GET", "path": "/_cat/shards",
                "params": {"format": "json"}, "body": ""})
        except Exception:
            continue
        if res["status"] != 200 or not isinstance(res["payload"], list):
            continue
        out[nid] = {(row["index"], row["shard"]):
                    (row.get("docs", "0"), row.get("store", "0b"))
                    for row in res["payload"]
                    if row.get("prirep") == "p"}
    return out


def _cat_shards(n: Node, p, b, index: Optional[str] = None):
    """One row per shard COPY (primary + each replica), RestShardsAction
    columns; in-process replicas report STARTED on this node (they are
    real copies here, where a one-node reference cluster shows them
    UNASSIGNED — both shapes are legal cat output)."""
    scope = set(_cat_scope(n, index))
    c = _mh(n)
    rows = []
    for iname, svc in n.indices.items():
        if iname not in scope:
            continue
        idx_settings = svc.settings.get("index", svc.settings)
        shadow = str(idx_settings.get("shadow_replicas", "false")
                     ).lower() in ("true", "1")
        dmeta = (c.dist_indices.get(iname)
                 if c is not None and not p.get("_local_only") else None)
        if dmeta is not None:
            # distributed: rows come from the published assignment —
            # one per copy, on its owning NODE; declared replicas with
            # no surviving copy print UNASSIGNED (RoutingTable shape).
            # docs/store come from the copy's OWNER (the coordinator's
            # local engine is empty for remote-owned shards)
            node_names = {nid: dn.name for nid, dn
                          in n.cluster_state.nodes.items()}
            init = dmeta.get("initializing", {})
            peer_counts = _peer_shard_counts(n, c)
            local_id = c.data._local_id()
            for sid in range(dmeta["num_shards"]):
                owners = dmeta["assignment"].get(str(sid), [])
                pending = init.get(str(sid), [])
                want = 1 + int(dmeta.get("replicas", 0))
                for i in range(max(want, len(owners) + len(pending))):
                    if i < len(owners):
                        nid = owners[i]
                        state = "STARTED"
                    elif i < len(owners) + len(pending):
                        nid = pending[i - len(owners)]
                        state = "INITIALIZING"
                    else:
                        nid, state = None, "UNASSIGNED"
                    row = {"index": iname, "shard": str(sid),
                           "prirep": ("p" if i == 0
                                      else "s" if shadow else "r"),
                           "state": state}
                    if state == "UNASSIGNED":
                        row.update(docs="", store="", ip="", node="")
                    else:
                        if nid == local_id:
                            docs = str(svc.shards[sid].engine.num_docs)
                            store = _human_size(sum(
                                seg.memory_bytes()
                                for seg in svc.shards[sid].segments))
                        else:
                            docs, store = peer_counts.get(nid, {}).get(
                                (iname, str(sid)), ("0", "0b"))
                        row.update(docs=docs, store=store, ip="127.0.0.1",
                                   node=node_names.get(nid, nid or ""))
                    rows.append(row)
            continue
        for g in svc.groups:
            for copy in g.copies:
                docs = copy.engine.num_docs
                size = sum(seg.memory_bytes() for seg in copy.segments)
                rows.append({
                    "index": iname, "shard": str(g.shard_id),
                    # shadow replicas print "s" (RestShardsAction)
                    "prirep": ("p" if copy is g.primary
                               else "s" if shadow else "r"),
                    "state": copy.state if copy.state != "CREATED"
                    else "INITIALIZING",
                    "docs": str(docs), "store": _human_size(size),
                    "ip": "127.0.0.1", "node": n.name})
    return 200, rows


def _cat_fielddata(n: Node, p, b, fields: Optional[str] = None):
    """RestFielddataAction: one row per node with `total` plus one column
    per LOADED field; ?fields= (or the path form) narrows the field
    columns. Columns load lazily into the evictable fielddata tier
    (resources/residency.py), so like the reference only fields whose
    device copies are currently resident show up — an evicted column
    drops out until the next search rehydrates it."""
    per_field: Dict[str, int] = {}
    for svc in n.indices.values():
        for shard in svc.shards:
            for seg in shard.segments:
                for fname, nbytes in seg.fielddata_field_bytes().items():
                    if fname.startswith("_"):
                        continue
                    per_field[fname] = per_field.get(fname, 0) + nbytes
    if not per_field:
        return 200, []
    want = fields or p.get("fields")
    shown = per_field
    if want:
        import fnmatch

        pats = [x.strip() for x in str(want).split(",") if x.strip()]
        shown = {f: v for f, v in per_field.items()
                 if any(fnmatch.fnmatchcase(f, pt) for pt in pats)}
    row = {"id": n.node_id[:4], "host": "localhost", "ip": "127.0.0.1",
           "node": n.name, "total": _human_size(sum(per_field.values()))}
    row.update({f: _human_size(v) for f, v in sorted(shown.items())})
    return 200, _cat_rows(
        [row], ["id", "host", "ip", "node", "total"] + sorted(shown))


def _cat_nodes(n: Node, p, b):
    from elasticsearch_tpu_torch.monitor.stats import process_stats

    proc = process_stats()
    rss = proc["mem"]["resident_in_bytes"]
    row = {"host": "localhost", "ip": "127.0.0.1",
           "heap.percent": "0", "ram.percent": "0", "load": "0.00",
           "node.role": "d", "master": "*", "name": n.name,
           # selectable extras (RestNodesAction's full column table)
           "id": n.node_id[:4], "pid": str(os.getpid()), "port": "-",
           "heap.current": _human_size(rss), "heap.max": _human_size(rss),
           "ram.current": _human_size(rss), "ram.max": _human_size(rss),
           "uptime": "0s", "version": "2.0.0", "jdk": "-",
           "disk.avail": "-", "cpu": "0",
           "file_desc.current": str(proc.get("open_file_descriptors", 0)
                                    or 0),
           "file_desc.percent": "1",
           "file_desc.max": str(1 << 16)}
    return 200, _cat_rows([row], ["host", "ip", "heap.percent",
                                  "ram.percent", "load", "node.role",
                                  "master", "name"])


def _cat_aliases(n: Node, p, b, name: Optional[str] = None):
    import fnmatch

    rows = []
    for iname, svc in n.indices.items():
        for alias, spec in svc.aliases.items():
            if name is not None and not any(
                    fnmatch.fnmatch(alias, pat.strip())
                    for pat in name.split(",")):
                continue
            rows.append({"alias": alias, "index": iname,
                         "filter": "*" if spec.get("filter") else "-",
                         "routing.index": spec.get("index_routing", "-"),
                         "routing.search": spec.get("search_routing", "-")})
    return 200, rows


def _cat_allocation(n: Node, p, b, nodeid: Optional[str] = None):
    import shutil

    nid = nodeid or p.get("node_id")
    c = _mh(n)
    if c is not None and "_local_only" not in p:
        # multi-host: one row per member with its copy count, HBM bytes
        # over the breakers' capacity, and watermark state — the same
        # usage fan the allocator's deciders read, so the table an
        # operator sees IS the signal placement runs on (drain runbook:
        # a draining node's `shards` column reaching 0 means kill-safe)
        alloc = c.allocator
        rows = []
        for node_id in sorted(c.node.cluster_state.nodes):
            dn = c.node.cluster_state.nodes[node_id]
            if nid and nid not in ("_master", "_local", "_all", "*",
                                   node_id, dn.name):
                continue
            r = alloc._probe(node_id) or {}
            used = int(r.get("hbm_used", 0))
            cap = int(r.get("hbm_capacity", 0))
            rows.append({
                "shards": str(r.get("shards", 0)),
                "hbm.used": _human_size(used),
                "hbm.total": _human_size(cap),
                "hbm.percent": str(int(used * 100 / cap)) if cap else "-",
                "watermark": alloc.watermark_level(node_id),
                "draining": str(alloc.filter.excludes(dn)).lower(),
                "host": dn.transport_address, "ip": dn.transport_address,
                "node": dn.name or node_id, "node_id": node_id,
            })
        return 200, rows
    if nid and nid not in ("_master", "_local", "_all", "*",
                           n.node_id, n.name):
        return 200, []  # no such node: empty table, like the reference
    shards = 0
    for svc in n.indices.values():
        for g in svc.groups:
            for sh in g.copies:  # primaries AND replicas, same basis
                shards += 1
    du = shutil.disk_usage("/")
    pct = int(du.used * 100 / du.total) if du.total else 0
    return 200, [{"shards": str(shards),
                  "disk.used": _human_size(du.used),
                  "disk.avail": _human_size(du.free),
                  "disk.total": _human_size(du.total),
                  "disk.percent": str(pct), "host": "localhost",
                  "ip": "127.0.0.1", "node": n.name}]


def _cat_segments(n: Node, p, b, index: Optional[str] = None):
    from elasticsearch_tpu_torch.cluster.metadata import check_open

    rows = []
    for iname in _cat_scope(n, index):
        svc = n.indices[iname]
        check_open(svc, op="read")  # closed index: 403, like the reference
        for g in svc.groups:
            for sh in g.copies:  # primaries and replicas, like _cat_shards
                prirep = "p" if sh is g.primary else "r"
                for ordn, seg in enumerate(sh.segments):
                    # PER-SHARD ordinals, like Lucene's per-writer
                    # generations (process-global seg ids stay internal)
                    mem = seg.memory_bytes()
                    rows.append({
                        "index": iname, "shard": str(sh.shard_id),
                        "prirep": prirep, "ip": "127.0.0.1",
                        "segment": f"_{ordn}",
                        "generation": str(ordn),
                        "docs.count": str(seg.live_docs),
                        "docs.deleted": str(seg.deleted_count),
                        "size": _human_size(mem),
                        "size.memory": str(mem),
                        "committed": "true", "searchable": "true",
                        "version": "0.1.0", "compound": "false",
                    })
    c = _mh(n)
    if c is not None and not p.get("_local_only"):
        # segments live where the DOCS live: union every peer's local
        # rows (a dist index's remote-owned shards have no local segments)
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        path = "/_cat/segments" + (f"/{index}" if index else "")
        for nid in c.data._other_nodes():
            try:
                res = c.data._send(nid, ACTION_REST_PROXY, {
                    "method": "GET", "path": path,
                    "params": {"format": "json"}, "body": ""})
            except Exception:
                continue
            if res["status"] == 200 and isinstance(res["payload"], list):
                rows.extend(res["payload"])
    return 200, rows


def _cat_recovery(n: Node, p, b, index: Optional[str] = None):
    """Real rows from each index's RecoveryRegistry: `type` distinguishes
    checkpoint-based ops replay (`ops_replay`) from the full-copy
    fallback (`full_copy`) and gateway translog replay; `translog` is the
    actual ops-replayed count. Shards with no recorded recovery keep the
    synthetic done/gateway row."""
    rows = []
    for iname in _cat_scope(n, index):
        svc = n.indices[iname]
        for g in svc.groups:
            entries = svc.recoveries.entries(g.shard_id)
            if not entries:
                entries = [{"type": "gateway", "stage": "done",
                            "source": "local", "target": "local",
                            "ops_replayed": 0, "docs_copied": 0,
                            "total_time_in_millis": 0, "mode": None}]
            for e in entries:
                mode = e.get("mode")
                rtype = ("ops_replay" if mode == "ops"
                         else "full_copy" if mode == "full"
                         else e.get("type", "gateway"))
                rows.append({
                    "index": iname, "shard": str(g.shard_id),
                    "time": str(e.get("total_time_in_millis", 0)),
                    "type": rtype,
                    "stage": e.get("stage", "done"),
                    "source_host": str(e.get("source", "localhost")),
                    "target_host": str(e.get("target", "localhost")),
                    "repository": "n/a", "snapshot": "n/a",
                    "files": "0", "files_percent": "100.0%",
                    "bytes": str(e.get("docs_copied", 0)),
                    "bytes_percent": "100.0%",
                    "total_files": "0", "total_bytes": "0",
                    "translog": str(e.get("ops_replayed", 0)),
                    "translog_percent": "100.0%",
                    "total_translog": str(e.get("ops_replayed", 0))})
    return 200, rows


def _cat_snapshots(n: Node, p, b, repo: str):
    from elasticsearch_tpu_torch.index.snapshots import snapshot_info

    r = _repo_or_404(n, repo)
    return 200, [snapshot_info(r, s) for s in r.catalog()]


def _cat_count(n: Node, p, b, index: Optional[str] = None):
    import time as _t

    names = n.resolve_indices(index)
    total = sum(n.indices[x].num_docs for x in names)
    now = int(_t.time())
    return 200, [{"epoch": str(now),
                  "timestamp": _t.strftime("%H:%M:%S", _t.gmtime(now)),
                  "count": str(total)}]


def _index_exists(n: Node, p, b, index: str):
    return (200, None) if n.index_exists(index) else (404, None)


def _get_settings(n: Node, p, b, index: str):
    """All setting values render as STRINGS (the reference's Settings is a
    string map); ?flat_settings=true flattens to 'index.x.y' keys."""
    flat = str(p.get("flat_settings", "false")).lower() in ("", "true")
    out = {}
    for name in n.resolve_indices(index):
        svc = n.indices[name]
        idx = {
            "number_of_shards": str(svc.num_shards),
            "number_of_replicas": str(svc.num_replicas),
            **{k: str(v) for k, v in svc.settings.get("index", {}).items()
               if k not in ("number_of_shards", "number_of_replicas")},
            **{k: str(v) for k, v in svc.settings.items() if k != "index"},
        }
        if flat:
            out[name] = {"settings": {f"index.{k}": v
                                      for k, v in idx.items()}}
        else:
            out[name] = {"settings": {"index": idx}}
    if not out:
        raise IndexNotFoundException(index)
    return 200, out


def _put_settings(n: Node, p, b, index: str):
    from elasticsearch_tpu_torch.cluster.metadata import update_index_settings

    names = _resolve_indices_options(n, index, p)
    body = _json(b)
    for nm in names:  # multi-index expressions, like the reference
        update_index_settings(n.indices[nm], body, node=n)
    return 200, {"acknowledged": True}


def _close_index(n: Node, p, b, index: str):
    from elasticsearch_tpu_torch.cluster.metadata import close_index

    names = n.resolve_indices(index)
    if not names:
        raise IndexNotFoundException(index)
    c = _mh(n)
    for nm in names:
        close_index(n, nm)
        if c is not None and nm in c.dist_indices:
            # closed-ness is cluster state: peers adopt it on publish, so
            # a search scattered to shard owners is refused everywhere
            c.data.set_closed(nm, True)
    return 200, {"acknowledged": True}


def _open_index(n: Node, p, b, index: str):
    from elasticsearch_tpu_torch.cluster.metadata import open_index

    names = n.resolve_indices(index)
    if not names:
        raise IndexNotFoundException(index)
    c = _mh(n)
    for nm in names:
        open_index(n, nm)
        if c is not None and nm in c.dist_indices:
            c.data.set_closed(nm, False)
    # a re-opened index serves cold: queue its census replay
    # (serving/warmup.py; cooldown-guarded, no-op without a census)
    n.serving.warmup.kick("index_open", names)
    return 200, {"acknowledged": True}


def _expand_wildcards(n: Node, names, index_expr, p):
    """expand_wildcards=open|closed|open,closed filtering for WILDCARD
    index expressions (concrete names always resolve)."""
    expr = str(index_expr or "")
    if "*" not in expr and expr not in ("_all", ""):
        return names
    want = {x.strip() for x in str(p.get("expand_wildcards", "open")
                                   ).split(",")}
    if {"open", "closed"} <= want or "all" in want:
        return names
    closed_ok = "closed" in want
    return [nm for nm in names if n.indices[nm].closed == closed_ok]


def _get_index_meta(n: Node, p, b, index: str):
    names = _expand_wildcards(n, n.resolve_indices(index), index, p)
    settings_out = _get_settings(n, p, b, index)[1] if names else {}
    out = {}
    for name in names:
        svc = n.indices[name]
        mj = svc.mappings.to_json()
        out[name] = {
            "aliases": svc.aliases,
            "mappings": ({t: mj for t in svc.mappings.type_names}
                         if svc.mappings.type_names else mj),
            "warmers": {k: {"source": v} for k, v in svc.warmers.items()},
            **settings_out.get(name, {}),
        }
    if not out:
        # a wildcard that narrows to nothing (or ignore_unavailable /
        # allow_no_indices) answers {}; only a concrete miss 404s
        wildcard = any(c in str(index) for c in "*,")
        allow_none = str(p.get("allow_no_indices",
                               "true" if wildcard else "false")
                         ).lower() in ("", "true")
        ignore_missing = str(p.get("ignore_unavailable", "false")
                             ).lower() in ("", "true")
        if not ((wildcard and allow_none)
                or (not wildcard and ignore_missing)):
            raise IndexNotFoundException(index)
    return 200, out


def _get_aliases(n: Node, p, b):
    return 200, {name: {"aliases": svc.aliases} for name, svc in n.indices.items()}


def _get_alias(n: Node, p, b, alias: str):
    import fnmatch

    pats = [x.strip() for x in alias.split(",")]
    out = {}
    for name, svc in n.indices.items():
        matched = {a: fa for a, fa in svc.aliases.items()
                   if any(pt in ("_all", "*") or fnmatch.fnmatch(a, pt)
                          for pt in pats)}
        if matched:
            out[name] = {"aliases": matched}
    if not out:
        # concrete name miss -> 404; patterns narrow to empty 200
        if any("*" in pt or pt in ("_all",) for pt in pats):
            return 200, {}
        return 404, {"error": f"alias [{alias}] missing", "status": 404}
    return 200, out


def _refresh(n: Node, p, b, index: str):
    names = _resolve_indices_options(n, index, p)
    for name in names:
        data = _mh_for(n, name)
        if data is not None:
            data.refresh(name)  # refreshes every process's copies
        else:
            n.indices[name].refresh()
    return 200, {"_shards": _shards_header(n, names)}


def _refresh_all(n: Node, p, b):
    for svc in n.indices.values():
        svc.refresh()
    return 200, {"_shards": _shards_header(n, list(n.indices))}


def _shards_header(n: Node, names) -> dict:
    total = sum(n.indices[nm].num_shards
                * (1 + n.indices[nm].num_replicas) for nm in names)
    return {"total": total, "successful": total, "failed": 0}


def _flush(n: Node, p, b, index: str):
    names = n.resolve_indices(index)
    for name in names:
        n.indices[name].flush()
    return 200, {"_shards": _shards_header(n, names)}


def _optimize(n: Node, p, b, index: str):
    max_seg = int(p.get("max_num_segments", 1))
    names = n.resolve_indices(index)
    # cancellable task: engine.merge checkpoints between source segments
    with n.tasks.task("indices:admin/optimize",
                      description=f"force-merge {names}"):
        for name in names:
            n.indices[name].force_merge(max_seg)
    return 200, {"_shards": _shards_header(n, names)}


def _count_with_body(n: Node, index: Optional[str], body: dict):
    svc_names = n.resolve_indices(index)
    if not svc_names:
        if index in (None, "", "_all", "*"):
            return 200, {"count": 0, "_shards": {"total": 0,
                                                 "successful": 0,
                                                 "failed": 0}}
        raise IndexNotFoundException(index)
    total = 0
    nshards = 0
    for name in svc_names:
        data = _mh_for(n, name)
        if data is not None:
            # cross-host count = a size-0 scatter/gather round
            r = data.search(name, {"query": body.get("query",
                                                     {"match_all": {}}),
                                   "size": 0})
            total += r["hits"]["total"]
        else:
            total += n.indices[name].count(body)["count"]
        nshards += n.indices[name].num_shards
    return 200, {"count": total, "_shards": {"total": nshards,
                                             "successful": nshards,
                                             "failed": 0}}


def _count(n: Node, p, b, index: str):
    body = _json(b)
    if "q" in p:
        body = {"query": {"query_string": {"query": p["q"]}}}
    return _count_with_body(n, index, body)


def _analyze_body(p, b) -> dict:
    body = _json(b)
    for k in ("text", "analyzer", "tokenizer", "filters", "filter",
              "char_filters", "char_filter", "field"):
        if k in p:
            body.setdefault(k, p[k])
    return body


def _analyze(n: Node, p, b):
    from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry

    body = _analyze_body(p, b)
    reg = AnalysisRegistry()
    return 200, _do_analyze(reg, body)


def _analyze_index(n: Node, p, b, index: str):
    svc = n.get_index(index)
    return 200, _do_analyze(svc.analysis, _analyze_body(p, b), svc)


def _do_analyze(reg, body: dict, svc=None) -> dict:
    text = body.get("text", "")
    texts = text if isinstance(text, list) else [text]
    if "field" in body and svc is not None:
        fm = svc.mappings.get(body["field"])
        analyzer = reg.get(fm.analyzer) if fm is not None and fm.is_text else reg.get("keyword")
    elif "tokenizer" in body:
        # one-off chain: tokenizer + filters/char_filters params
        # (RestAnalyzeAction's ad-hoc analyzer)
        from elasticsearch_tpu_torch.analysis.analyzer import \
            build_custom_analyzer

        def _lst(v):
            if v is None:
                return []
            if isinstance(v, str):
                return [x.strip() for x in v.split(",") if x.strip()]
            return list(v)

        analyzer = build_custom_analyzer("_adhoc", {
            "tokenizer": body["tokenizer"],
            "filter": _lst(body.get("filters", body.get("filter"))),
            "char_filter": _lst(body.get("char_filters",
                                         body.get("char_filter")))})
    else:
        analyzer = reg.get(body.get("analyzer", "standard"))
    tokens = []
    for t in texts:
        for tok, pos in analyzer.analyze(t):
            tokens.append({"token": tok, "position": pos, "type": "<ALPHANUM>"})
    return {"tokens": tokens}


# -- task management (tracing/tasks.py) ---------------------------------------

def _split_task_id(task_id: str):
    """"node:seq" → (node, seq); a bare number targets the local node."""
    node_id, _, num = str(task_id).rpartition(":")
    if not num.isdigit():
        raise IllegalArgumentException(
            f"malformed task id [{task_id}] (expected nodeId:taskNumber)")
    return node_id, int(num)


def _local_tasks_entry(n: Node, p) -> dict:
    tasks = {t.tagged_id: t.to_json()
             for t in n.tasks.list_tasks(actions=p.get("actions"))}
    return {n.node_id: {
        "name": n.name,
        "transport_address": n._transport_info()["publish_address"],
        "tasks": tasks}}


def _tasks_list(n: Node, p, b):
    """GET /_tasks (RestListTasksAction): every node's in-flight tasks.
    Multi-host fans through the REST proxy (each member reports its own
    registry); a dead peer lands in ``node_failures``, never silently
    missing — its tasks are exactly what an operator hunting a runaway
    delete-by-query needs to see."""
    out: Dict[str, Any] = {"nodes": _local_tasks_entry(n, p)}
    mh = _mh(n)
    if mh is not None and "_local_only" not in p:
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        failures = []
        params = {k: p[k] for k in ("actions",) if k in p}
        for nid in mh.data._other_nodes():
            try:
                res = mh.data._send(nid, ACTION_REST_PROXY, {
                    "method": "GET", "path": "/_tasks", "params": params})
                if res.get("status") == 200:
                    out["nodes"].update(
                        (res.get("payload") or {}).get("nodes", {}))
            except Exception as e:
                failures.append({"node_id": nid, "reason": str(e)})
        if failures:
            out["node_failures"] = failures
    return 200, out


def _task_get(n: Node, p, b, task_id: str):
    """GET /_tasks/{id}: the task's detail from its owning node."""
    from elasticsearch_tpu_torch.tracing.tasks import ResourceNotFoundException

    node_id, num = _split_task_id(task_id)
    if node_id in ("", "_local", n.node_id):
        t = n.tasks.get(num)
        if t is None:
            raise ResourceNotFoundException(
                f"task [{task_id}] isn't running and hasn't stored its "
                "results")
        return 200, {"completed": False, "task": t.to_json()}
    mh = _mh(n)
    if mh is not None and "_local_only" not in p \
            and node_id in n.cluster_state.nodes:
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        res = mh.data._send(node_id, ACTION_REST_PROXY, {
            "method": "GET", "path": f"/_tasks/{task_id}", "params": {}})
        return res["status"], res["payload"]
    # not a member (typo'd or departed node): 404, never a generic 500
    # from an unresolvable transport address
    raise ResourceNotFoundException(
        f"task [{task_id}] belongs to an unknown node")


def _task_cancel(n: Node, p, b, task_id: str):
    """POST /_tasks/{id}/_cancel (RestCancelTasksAction): cancel the task
    AND its descendants — local children directly, remote children via
    the parent-id fanout (cluster/search_action.py::cancel_task_children),
    so cancelling a coordinator by-query stops the remote shard scans."""
    node_id, num = _split_task_id(task_id)
    mh = _mh(n)
    if node_id in ("", "_local", n.node_id):
        reason = "by user request"
        cancelled = n.tasks.cancel(num, reason)  # 404s when absent
        out: Dict[str, Any] = {"nodes": {}}
        if cancelled:
            out["nodes"][n.node_id] = {
                "name": n.name,
                "tasks": {t.tagged_id: t.to_json() for t in cancelled}}
        if mh is not None:
            remote = mh.data.cancel_task_children(n.node_id, num, reason)
            out["nodes"].update(remote.get("nodes", {}))
            if remote.get("node_failures"):
                out["node_failures"] = remote["node_failures"]
        return 200, out
    if mh is not None and "_local_only" not in p \
            and node_id in n.cluster_state.nodes:
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        # the task lives on another member: relay — the owner cancels
        # locally and runs the child fanout itself
        res = mh.data._send(node_id, ACTION_REST_PROXY, {
            "method": "POST", "path": f"/_tasks/{task_id}/_cancel",
            "params": {}})
        return res["status"], res["payload"]
    from elasticsearch_tpu_torch.tracing.tasks import ResourceNotFoundException

    # not a member (typo'd or departed node): 404, never a generic 500
    # from an unresolvable transport address
    raise ResourceNotFoundException(
        f"task [{task_id}] belongs to an unknown node")


def _cat_tasks(n: Node, p, b):
    """GET /_cat/tasks: the /_tasks listing as cat rows."""
    _status, body = _tasks_list(n, p, b)
    rows = []
    from elasticsearch_tpu_torch.tracing.tasks import human_time

    for nid, entry in sorted(body["nodes"].items()):
        for tid, t in sorted(entry.get("tasks", {}).items()):
            nanos = t.get("running_time_in_nanos", 0)
            rows.append({
                "action": t.get("action", ""),
                "task_id": tid,
                "parent_task_id": t.get("parent_task_id", "-"),
                "type": t.get("type", "transport"),
                "start_time": str(t.get("start_time_in_millis", "")),
                # human-scaled (the task's own to_json form when present:
                # remote members computed it from THEIR monotonic clock)
                "running_time": t.get("running_time",
                                      human_time(nanos)),
                "running_time_in_nanos": str(nanos),
                "node": entry.get("name", nid),
                "description": t.get("description", ""),
            })
    return 200, _cat_rows(rows, ["action", "task_id", "parent_task_id",
                                 "type", "start_time", "running_time",
                                 "node"])


def _all_pending_tasks(n: Node, p) -> List[dict]:
    """Cluster-wide pending set: the local registry plus every member's
    (recovery streams queue on whichever member scheduled them, so a
    local-only view would show 0 to an operator polling a different
    node). Best-effort like nodes_fan — a dead peer's queue is
    unknowable and simply absent."""
    rows = list(n.tasks.pending_tasks())
    mh = _mh(n)
    if mh is not None and "_local_only" not in p:
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        for nid in mh.data._other_nodes():
            try:
                res = mh.data._send(nid, ACTION_REST_PROXY, {
                    "method": "GET", "path": "/_cluster/pending_tasks",
                    "params": {}})
            except Exception:
                continue  # unreachable peer: its queue stays absent
            if res.get("status") == 200:
                rows.extend((res.get("payload") or {}).get("tasks", []))
    return rows


def _cluster_pending_tasks(n: Node, p, b):
    """GET /_cluster/pending_tasks: queued-but-not-running tasks (e.g.
    parked coalescer requests) from the node's registry — ES reports
    the master's cluster-state update queue; here the queue-like work is
    the pending task set."""
    return 200, {"tasks": _all_pending_tasks(n, p)}


def _cat_pending_tasks(n: Node, p, b):
    rows = [{"insertOrder": str(t["insert_order"]),
             "timeInQueue": t["time_in_queue"],
             "priority": t["priority"],
             "source": t["source"]} for t in _all_pending_tasks(n, p)]
    return 200, _cat_rows(rows, ["insertOrder", "timeInQueue", "priority",
                                 "source"])


def _node_trace(n: Node, p, b):
    """GET /_nodes/_local/trace: the local span ring in Chrome
    trace-event format for offline flamegraph inspection (chrome://
    tracing / Perfetto / speedscope)."""
    return 200, n.tracer.chrome_trace()


def _node_programs(n: Node, p, b):
    """GET /_nodes/_local/xla/programs: the device-program observatory:
    per-(program, shapes, backend) compiles and their seconds, execute
    calls with p50/p99, cold flags, plus each index's (program, shapes,
    field) census (monitor/programs.py). The registry is the process's
    (the card is shared by every node in it), hence ``_local``."""
    from elasticsearch_tpu_torch.monitor import programs

    reg = programs.REGISTRY
    return 200, {
        "backend": programs.backend_fingerprint(),
        "totals": reg.stats(),
        "programs": reg.snapshot(),
        "census": {ix: reg.census(ix) for ix in reg.census_indices()},
    }


def _warmup_trigger(n: Node, p, b):
    """POST /_warmup: queue a census replay for every open local index
    (serving/warmup.py); cooldown-guarded, each run a cancellable
    ``cluster:admin/warmup`` task."""
    return 200, {"acknowledged": True, "queued": n.serving.warmup.kick("api")}


def _warmup_trigger_index(n: Node, p, b, index: str):
    """POST /{index}/_warmup: queue a census replay for the indices
    ``index`` names."""
    names = n.resolve_indices(index)
    if not names:
        raise IndexNotFoundException(index)
    return 200, {"acknowledged": True,
                 "queued": n.serving.warmup.kick("api", names)}


def _warmup_status(n: Node, p, b):
    """GET /_warmup: the pre-warm service's queue and each index's last
    run (also the ``serving.warmup`` section of /_nodes/stats)."""
    return 200, n.serving.warmup.stats()


def _cat_programs(n: Node, p, b):
    """GET /_cat/programs: one row per (program, shapes, backend) key:
    compiles and their seconds, execute calls, p50/p99, the cold flag
    (no steady execute yet in this process) and the kernel-library
    resolutions inside its dispatches (``aot:1,fresh:1``; ``-`` for
    none)."""
    from elasticsearch_tpu_torch.monitor import programs

    def _cache(sources: dict) -> str:
        short = {"aot_hit": "aot", "build_dir_hit": "build_dir"}
        return ",".join(f"{short.get(k, k)}:{v}"
                        for k, v in sorted(sources.items())) or "-"

    rows = [{
        "program": r["program"],
        "shapes": r["shapes"],
        "backend": r["backend"],
        "compiles": str(r["compiles"]),
        "compile_seconds": f"{r['compile_seconds']:.3f}",
        "calls": str(r["calls"]),
        "execute_p50_ms": f"{r['execute_p50_seconds'] * 1000.0:.2f}",
        "execute_p99_ms": f"{r['execute_p99_seconds'] * 1000.0:.2f}",
        "cold": "true" if r["cold"] else "false",
        "cache": _cache(r["cache_sources"]),
    } for r in programs.REGISTRY.snapshot()]
    return 200, _cat_rows(rows, ["program", "shapes", "backend", "compiles",
                                 "compile_seconds", "calls",
                                 "execute_p50_ms", "execute_p99_ms",
                                 "cold", "cache"])


def _node_flight(n: Node, p, b):
    """GET /_nodes/_local/flight: this node's flight-recorder rings
    (metric deltas, slow ops, breaker trips, compile events, cluster
    transitions, engine failures, watchdog trips), the watchdog's own
    state and the incident listing."""
    return 200, {
        "flight": n.flight.snapshot(),
        "watchdog": n.watchdog.stats(),
        "incidents": n.watchdog.incidents.list(),
    }


def _incident_rows(n: Node, p) -> List[dict]:
    """_cat/incidents rows: this node's incidents and every member's,
    dedup'd by id (members in one process share the persisted index)."""
    rows = []
    for e in n.watchdog.incidents.list():
        rows.append({
            "id": str(e.get("id", "")),
            "detector": str(e.get("detector", "")),
            "node": str(e.get("node_name") or e.get("node") or ""),
            "timestamp": str(e.get("timestamp_ms", "")),
            "persisted": "true" if e.get("persisted") else "false",
            "reason": str(e.get("reason", ""))[:120],
        })
    mh = _mh(n)
    if mh is not None and "_local_only" not in p:
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        for nid in mh.data._other_nodes():
            try:
                res = mh.data._send(nid, ACTION_REST_PROXY, {
                    "method": "GET", "path": "/_cat/incidents",
                    "params": {}})
            except Exception:
                continue  # an unreachable member's incidents stay absent
            if res.get("status") == 200:
                rows.extend(r for r in (res.get("payload") or [])
                            if isinstance(r, dict))
    seen: set = set()
    out = []
    for r in rows:
        if r["id"] in seen:
            continue
        seen.add(r["id"])
        out.append(r)
    out.sort(key=lambda r: r["timestamp"])
    return out


def _cat_incidents(n: Node, p, b):
    """GET /_cat/incidents: one row per captured incident dump,
    cluster-wide, oldest first."""
    return 200, _cat_rows(_incident_rows(n, p),
                          ["id", "detector", "node", "timestamp",
                           "reason"])


def _get_incident(n: Node, p, b, incident_id: str):
    """GET /_cluster/diagnostics/incidents/{id}: one incident's full
    payload: the copy in memory, the digest-checked persisted blob, or,
    when the id names another live member, that member's copy."""
    payload = n.watchdog.incidents.load(incident_id)
    if payload is not None:
        return 200, payload
    owner, _, _seq = incident_id.partition(":")
    mh = _mh(n)
    if mh is not None and "_local_only" not in p \
            and owner and owner != n.node_id \
            and owner in n.cluster_state.nodes:
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        try:
            res = mh.data._send(owner, ACTION_REST_PROXY, {
                "method": "GET",
                "path": f"/_cluster/diagnostics/incidents/{incident_id}",
                "params": {}})
            return res["status"], res["payload"]
        except Exception:
            # the owner just died, the outage incidents exist for: the
            # typed 404 below, never an untyped 500
            pass
    from elasticsearch_tpu_torch.tracing.tasks import \
        ResourceNotFoundException

    raise ResourceNotFoundException(f"incident [{incident_id}] not found")


def _local_diagnostics(n: Node, p) -> dict:
    """One node's part of the diagnostics bundle; its key set is the
    bundle's schema. ``programs`` holds the program totals, compiles
    included, and the dispatches in flight."""
    from elasticsearch_tpu_torch.monitor.watchdog import (
        hot_threads_snapshot, programs_section)

    try:
        k = int(p.get("incidents", 2))
    except (TypeError, ValueError):
        k = 2
    k = max(0, min(k, 8))
    return {
        "name": n.name,
        "flight": n.flight.snapshot(),
        "watchdog": n.watchdog.stats(),
        "incidents": n.watchdog.incidents.list(),
        "incident_payloads": n.watchdog.incidents.recent(k),
        "hot_threads": hot_threads_snapshot(),
        "tasks": [t.to_json() for t in n.tasks.list_tasks()][:64],
        "programs": programs_section(),
        "breakers": n.breakers.stats(),
        "thread_pool": (n._thread_pool.stats()
                        if n._thread_pool is not None else {}),
    }


def _cluster_diagnostics(n: Node, p, b):
    """GET /_cluster/diagnostics: the cluster-wide support bundle, every
    member's flight rings, watchdog state, incidents (the most recent
    payloads inline), hot threads, dispatches in flight and tasks. In a
    cluster each member's part comes over the REST proxy, as
    ``nodes_fan``'s do; a dead member counts in ``_nodes.failed`` and is
    listed under ``failures``, and the answer stays 200: a bundle taken
    during an outage is the point."""
    local = _local_diagnostics(n, p)
    c = _mh(n)
    if c is not None and "_local_only" in p:
        # a proxied member's part: raw and unmerged
        return 200, local
    nodes = {n.node_id: local}
    failures: List[dict] = []
    if c is not None:
        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY

        params = {k: p[k] for k in ("incidents",) if k in p}
        for nid in c.data._other_nodes():
            try:
                res = c.data._send(nid, ACTION_REST_PROXY, {
                    "method": "GET", "path": "/_cluster/diagnostics",
                    "params": params})
                if res.get("status") == 200 and res.get("payload"):
                    nodes[nid] = res["payload"]
                else:
                    failures.append({"node_id": nid,
                                     "reason": f"status {res.get('status')}"})
            except Exception as e:
                failures.append({"node_id": nid, "reason": str(e)})
    return 200, {
        "version": 1,
        "cluster_name": n.cluster_state.cluster_name,
        "timestamp": int(time.time() * 1000),
        "master_node": n.cluster_state.master_node_id,
        "_nodes": {"total": len(nodes) + len(failures),
                   "successful": len(nodes), "failed": len(failures)},
        "nodes": nodes,
        "failures": failures,
    }


# -- document handlers --------------------------------------------------------

def _nodes_info(n: Node, p, b, **_sel):
    """/_nodes[/...] — single node returns its own view; in a multi-host
    world the coordinator merges every member's self-reported entry
    (reference: TransportNodesInfoAction). `_local_only` (set by the
    cross-host REST proxy) pins to this process to prevent re-fanning.
    Node-id/metric selectors are accepted and return the full view, the
    same single-node simplification the scoped stats routes make."""
    mh = _mh(n)
    if mh is not None and "_local_only" not in p:
        return 200, mh.data.nodes_fan()
    return 200, n.nodes_stats()


def _mh(n: Node):
    """The cluster this node is a member of (cluster/bootstrap.py sets
    ``node.multihost``), or None. REST operations on distributed indices
    route through its data plane: writes land on the shard owners'
    processes and searches scatter over the members."""
    return n.multihost


def _mh_for(n: Node, index: Optional[str]):
    """The data service IF `index` names (or aliases) a distributed
    index — an alias-named request must ride the cross-host data plane,
    not fall to the node-local path with only local shards."""
    c = _mh(n)
    if c is not None and index is not None \
            and c.data.resolve_index(index) in c.dist_indices:
        return c.data
    return None


def _create_index(n: Node, p, b, index: str):
    c = _mh(n)
    if c is not None:
        # multi-host world: every create goes through the master so the
        # shard→node assignment is computed once and published; the wire
        # result's assignment map stays internal — clients get the
        # standard create envelope
        c.data.create_index(index, _json(b))
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "index": index}
    return 200, n.create_index(index, _json(b))


def _index_kw(p, doc_type: Optional[str]) -> dict:
    """The index-op kwargs every write route forwards (version checks,
    op_type, parent-as-routing, timestamp/ttl meta)."""
    kw: Dict[str, Any] = {}
    if "version" in p:
        kw["version"] = int(p["version"])
        kw["version_type"] = p.get("version_type", "internal")
    if p.get("op_type") == "create":
        kw["op_type"] = "create"
    if doc_type:
        kw["doc_type"] = doc_type
    if p.get("parent"):
        # parent id doubles as the routing key so parent and child land on
        # the same shard (reference: ParentFieldMapper + routing resolution)
        kw["parent"] = p["parent"]
    if p.get("timestamp"):  # _timestamp meta field (TimestampFieldMapper)
        kw["timestamp"] = p["timestamp"]
    if p.get("ttl"):  # _ttl meta field (TTLFieldMapper)
        kw["ttl"] = p["ttl"]
    return kw


def _index_doc(n: Node, p, b, index: str, id: str, doc_type: Optional[str] = None):
    kw = _index_kw(p, doc_type)
    data = _mh_for(n, index)
    if data is not None:
        r = data.index_doc(index, id, _json(b),
                           routing=p.get("routing") or p.get("parent"),
                           **kw)
        if _refresh_requested(p):
            data.refresh(index)
        return (201 if r.get("created") else 200), r
    svc = n.get_or_autocreate(index)
    r = svc.index_doc(id, _json(b), routing=p.get("routing") or p.get("parent"), **kw)
    if _refresh_requested(p):
        svc.refresh()
    return (201 if r.get("created") else 200), r


def _index_doc_auto(n: Node, p, b, index: str):
    data = _mh_for(n, index)
    if data is not None:
        r = data.index_doc(index, None, _json(b),
                           routing=p.get("routing"))
        if _refresh_requested(p):
            data.refresh(index)
        return 201, r
    svc = n.get_or_autocreate(index)
    r = svc.index_doc(None, _json(b), routing=p.get("routing"))
    if _refresh_requested(p):
        svc.refresh()
    return 201, r


def _create_doc(n: Node, p, b, index: str, id: str):
    data = _mh_for(n, index)
    if data is not None:
        return 201, data.index_doc(index, id, _json(b), op_type="create",
                                   routing=p.get("routing"))
    svc = n.get_or_autocreate(index)
    r = svc.index_doc(id, _json(b), op_type="create", routing=p.get("routing"))
    return 201, r


def _index_doc_typed(n: Node, p, b, index: str, type: str, id: str):
    # any leading-underscore segment is a mis-bound meta path, not a type
    if type.startswith("_"):
        raise IllegalArgumentException(f"unsupported path [{index}/{type}/{id}]")
    return _index_doc(n, p, b, index, id, doc_type=type)


def _create_doc_typed(n: Node, p, b, index: str, type: str, id: str):
    """PUT /{index}/{type}/{id}/_create — the create API: op_type=create
    forced, conflict on an existing id (reference:
    rest/action/document/RestIndexAction CREATE registration)."""
    return _index_doc_typed(n, dict(p, op_type="create"), b, index, type, id)


def _check_read_routing(n: Node, index: str, type: str, id: str, p) -> None:
    """Typed reads/deletes of a parent-mapped or routing-required type
    without routing/parent are rejected (RoutingMissingException), like
    the reference's read-side routing resolution."""
    from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                RoutingMissingException)

    if p.get("routing") or p.get("parent"):
        return
    try:
        m = n.get_index(index).mappings
    except ElasticsearchTpuException:
        return
    if m.routing_required or (type not in ("_all", "_doc")
                              and type in m.parent_types):
        raise RoutingMissingException(index, type, str(id))


def _type_mismatch(n: Node, index: str, type: str, id: str,
                   routing: Optional[str] = None) -> bool:
    """Requested {type} filters doc reads (reference: GetRequest.type) —
    _all/_doc match anything."""
    if type in ("_all", "_doc"):
        return False
    from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException

    try:
        svc = n.get_index(index)
        loc = svc.route(str(id), routing).engine._locations.get(str(id))
    except ElasticsearchTpuException:
        return False
    return (loc is not None and not loc.deleted
            and (loc.doc_type or "_doc") != type)


def _get_doc_typed(n: Node, p, b, index: str, type: str, id: str):
    if type.startswith("_") and type != "_all":
        raise IllegalArgumentException(f"unsupported path [{index}/{type}/{id}]")
    _check_read_routing(n, index, type, id, p)
    if _type_mismatch(n, index, type, id,
                      p.get("routing") or p.get("parent")):
        return 404, {"_index": index, "_type": type, "_id": id,
                     "found": False}
    return _get_doc(n, p, b, index, id)


def _delete_doc_typed(n: Node, p, b, index: str, type: str, id: str):
    if type.startswith("_") and type != "_all":
        raise IllegalArgumentException(f"unsupported path [{index}/{type}/{id}]")
    _check_read_routing(n, index, type, id, p)
    if _type_mismatch(n, index, type, id,
                      p.get("routing") or p.get("parent")):
        from elasticsearch_tpu_torch.utils.errors import DocumentMissingException

        raise DocumentMissingException(index, id)
    return _delete_doc(n, p, b, index, id)


def _realtime_kw(n, p, index: str) -> dict:
    """GET-API realtime/refresh params: realtime=false reads only
    refreshed state; refresh=true refreshes first (GetRequest.realtime/
    refresh). refresh on a distributed index refreshes CLUSTER-wide."""
    if str(p.get("refresh", "false")).lower() in ("", "true", "1"):
        data = _mh_for(n, index)
        if data is not None:
            data.refresh(index)
        else:
            n.get_index(index).refresh()
    rt = str(p.get("realtime", "true")).lower() not in ("false", "0")
    return {"realtime": rt}


def _loc_from_meta(meta):
    """A location-shaped view over the `_meta` dict a cross-host get
    attaches (the coordinator can't reach a remote shard's table)."""
    if not meta:
        return None
    from types import SimpleNamespace

    return SimpleNamespace(routing=meta.get("routing"),
                           parent=meta.get("parent"),
                           timestamp=meta.get("timestamp"),
                           ttl_expiry=meta.get("ttl_expiry"))


def _get_doc(n: Node, p, b, index: str, id: str):
    from elasticsearch_tpu_torch.search.service import _filter_source

    data = _mh_for(n, index)
    if data is not None:
        # cross-host routed read, then the SAME response shaping as the
        # local path; location meta (routing/parent/timestamp/ttl) rides
        # the response so the fields extraction below works for remote docs
        r = data.get_doc(index, id,
                         routing=p.get("routing") or p.get("parent"),
                         with_meta=True, **_realtime_kw(n, p, index))
        loc = _loc_from_meta(r.pop("_meta", None))
    else:
        svc = n.get_index(index)
        r = svc.get_doc(id, routing=p.get("routing") or p.get("parent"),
                        **_realtime_kw(n, p, index))
        loc = svc.route(id, p.get("routing")).engine._locations.get(str(id))
    if not r.get("found"):
        return 404, r
    if "version" in p and p.get("version_type") != "force" \
            and int(p["version"]) != r.get("_version"):
        # version-checked read: ANY mismatch conflicts, internal or
        # external — force never does (VersionType.isVersionConflictForReads)
        from elasticsearch_tpu_torch.utils.errors import VersionConflictException

        raise VersionConflictException(index, id, r.get("_version"),
                                       int(p["version"]))
    sf = p.get("_source")
    if sf is not None:
        if sf.lower() in ("true", "false"):
            sf = sf.lower() == "true"
        elif "," in sf:
            sf = sf.split(",")
        filtered = _filter_source(r.get("_source"), sf)
        r.pop("_source", None)
        if filtered is not None:
            r["_source"] = filtered
    elif "_source_include" in p or "_source_exclude" in p:
        filtered = _filter_source(r.get("_source"), {
            "include": (p.get("_source_include") or "").split(","),
            "exclude": [x for x in
                        (p.get("_source_exclude") or "").split(",") if x]})
        r.pop("_source", None)
        if filtered is not None:
            r["_source"] = filtered
    fields = p.get("fields")
    if fields:
        names = [f.strip() for f in fields.split(",") if f.strip()]
        src = r.get("_source") or {}
        out: Dict[str, Any] = {}
        for f in names:
            if f == "_source":
                continue
            if f == "_routing":
                if loc is not None and loc.routing is not None:
                    out["_routing"] = loc.routing
                continue
            if f == "_parent":
                if loc is not None and loc.parent is not None:
                    out["_parent"] = loc.parent
                continue
            if f == "_timestamp":
                if loc is not None and loc.timestamp is not None:
                    out["_timestamp"] = loc.timestamp
                continue
            if f == "_ttl":
                # remaining millis, as TTLFieldMapper serves it
                if loc is not None and loc.ttl_expiry:
                    import time as _t

                    out["_ttl"] = max(
                        0, loc.ttl_expiry - int(_t.time() * 1000))
                continue
            from elasticsearch_tpu_torch.search.service import source_path

            cur = source_path(src, f)
            if cur is not None:
                out[f] = cur if isinstance(cur, list) else [cur]
        r["fields"] = out
        if "_source" not in names and "_source" not in p \
                and "_source_include" not in p \
                and "_source_exclude" not in p:
            # fields suppress _source unless ANY explicit _source request
            # (true or a filter list) asked for it
            r.pop("_source", None)
    return 200, r


def _doc_exists(n: Node, p, b, index: str, id: str):
    r = n.get_index(index).get_doc(id, routing=p.get("routing")
                                   or p.get("parent"),
                                   **_realtime_kw(n, p, index))
    return (200 if r.get("found") else 404), None


def _get_source(n: Node, p, b, index: str, id: str):
    from elasticsearch_tpu_torch.search.service import _filter_source

    r = n.get_index(index).get_doc(id, routing=p.get("routing")
                                   or p.get("parent"),
                                   **_realtime_kw(n, p, index))
    if not r.get("found"):
        return 404, {"error": "not found", "status": 404}
    src = r["_source"]
    sf = p.get("_source")
    if sf is not None and sf.lower() not in ("true", "false"):
        src = _filter_source(src, sf.split(","))
    elif "_source_include" in p or "_source_exclude" in p:
        src = _filter_source(src, {
            "include": [x for x in (p.get("_source_include") or ""
                                    ).split(",") if x],
            "exclude": [x for x in (p.get("_source_exclude") or ""
                                    ).split(",") if x]})
    return 200, src


def _delete_doc(n: Node, p, b, index: str, id: str):
    kw = {}
    if "version" in p:  # optimistic concurrency, like the index route
        kw["version"] = int(p["version"])
        kw["version_type"] = p.get("version_type", "internal")
    data = _mh_for(n, index)
    if data is not None:
        r = data.delete_doc(index, id,
                            routing=p.get("routing") or p.get("parent"),
                            **kw)
        if _refresh_requested(p):
            data.refresh(index)
        return 200, r
    svc = n.get_index(index)
    r = svc.delete_doc(id, routing=p.get("routing") or p.get("parent"), **kw)
    if _refresh_requested(p):
        svc.refresh()
    return 200, r


def _update_doc(n: Node, p, b, index: str, id: str,
                doc_type: Optional[str] = None):
    # update auto-creates the index (reference: TransportUpdateAction
    # routes through auto-create like index does)
    body = _json(b)
    if "script" in p and "script" not in body:
        # 2.0-era request-param script form (?script=...&lang=groovy)
        body["script"] = p["script"]
    if "lang" in p and "lang" not in body:
        body["lang"] = p["lang"]
    kw: Dict[str, Any] = {}
    if "version" in p:
        kw["version"] = int(p["version"])
        kw["version_type"] = p.get("version_type", "internal")
    if p.get("parent"):
        kw["parent"] = p["parent"]
    if p.get("timestamp"):
        kw["timestamp"] = p["timestamp"]
    if p.get("ttl"):
        kw["ttl"] = p["ttl"]
    fields = p.get("fields") or body.get("fields")

    def _get_env(got) -> Dict[str, Any]:
        # UpdateResponse "get" envelope (UpdateHelper.extractGetResult)
        names = ([f.strip() for f in fields.split(",")]
                 if isinstance(fields, str) else list(fields))
        env: Dict[str, Any] = {"found": bool(got.get("found"))}
        src = got.get("_source") or {}
        fl: Dict[str, Any] = {}
        for f in names:
            if f == "_source":
                env["_source"] = src
                continue
            cur: Any = src
            for part in f.split("."):
                cur = cur.get(part) if isinstance(cur, dict) else None
            if cur is not None:
                fl[f] = cur if isinstance(cur, list) else [cur]
        if fl:
            env["fields"] = fl
        return env

    data = _mh_for(n, index)
    if data is not None:
        # routed to the primary owner: the partial update's merge reads
        # the current source there
        r = data.update_doc(index, id, body,
                            routing=p.get("routing") or p.get("parent"),
                            doc_type=doc_type, **kw)
        if fields:
            r["get"] = _get_env(data.get_doc(
                index, id, routing=p.get("routing") or p.get("parent")))
        if _refresh_requested(p):
            data.refresh(index)
        return 200, r
    svc = n.get_or_autocreate(index)
    r = svc.update_doc(id, body,
                       routing=p.get("routing") or p.get("parent"),
                       doc_type=doc_type, **kw)
    if fields:
        r["get"] = _get_env(svc.get_doc(id, routing=p.get("routing")))
    if _refresh_requested(p):
        svc.refresh()
    return 200, r


def _delete_by_query(n: Node, p, b, index: str):
    from elasticsearch_tpu_torch.search.byquery import failure_entry, run_by_query

    data = _mh_for(n, index)
    if data is not None:
        # distributed index: each primary owner scans + deletes its own
        # shards' docs, replicas follow through the write hop
        return 200, data.by_query(index, _json(b), "delete")
    svc = n.get_index(index)
    svc.refresh()
    body = _json(b)
    counts = {"deleted": 0}
    failures: list = []
    processed: set = set()

    def apply(doc_id, loc):
        # docs indexed with routing/parent don't route by id — the stored
        # routing comes off the location table; EVERY live copy is walked
        # (the same id can live on several shards under different routings)
        processed.add(doc_id)
        try:
            svc.delete_doc(doc_id, routing=loc.routing if loc else None)
            counts["deleted"] += 1
        except ElasticsearchTpuException as e:
            failures.append(failure_entry(svc.name, doc_id, e))

    # cancellable task: the scan loop's checkpoints (search/byquery.py)
    # stop between docs; a cancelled run reports the PARTIAL counts with
    # "canceled" (reference: BulkByScrollResponse reasonCancelled)
    canceled = None
    with n.tasks.task("indices:data/write/delete/byquery",
                      description=f"delete-by-query [{index}]"):
        try:
            run_by_query(svc, body.get("query"), apply)
        except TaskCancelledException as e:
            canceled = str(e)
    out = {"took": 0, "deleted": counts["deleted"],
           "total": len(processed), "failures": failures,
           "timed_out": False}
    if canceled is not None:
        out["canceled"] = canceled
    return 200, out


def _update_by_query(n: Node, p, b, index: str):
    from elasticsearch_tpu_torch.search.byquery import failure_entry, run_by_query

    body = _json(b)
    data = _mh_for(n, index)
    if data is not None:
        return 200, data.by_query(index, body, "update",
                                  script=body.get("script"),
                                  params=body.get("params"))
    svc = n.get_index(index)
    svc.refresh()
    script = body.get("script")
    s_params = body.get("params")  # 2.0 form: sibling body params
    counts = {"updated": 0, "noops": 0}
    failures: list = []
    processed: set = set()

    def apply(doc_id, loc):
        routing = loc.routing if loc else None
        processed.add(doc_id)
        try:
            if script is not None:
                svc.update_doc(doc_id,
                               {"script": script, "params": s_params},
                               routing=routing)
                counts["updated"] += 1
            else:
                # no script: a re-index touch (picks up mapping changes).
                # Carry the doc's _type/_parent/routing meta through the
                # re-index or a routed / parent-child doc would land on a
                # different shard and sever its joins (Engine.update
                # carries meta unconditionally — mirror that).
                got = svc.get_doc(doc_id, routing=routing)
                if got.get("found"):
                    kw = {}
                    if loc is not None and loc.doc_type:
                        kw["doc_type"] = loc.doc_type
                    if loc is not None and loc.parent:
                        kw["parent"] = loc.parent
                    svc.index_doc(doc_id, got["_source"], routing=routing,
                                  **kw)
                    counts["updated"] += 1
                else:
                    # deleted between scan and get: account for it (ES
                    # reports these as noops, never silently)
                    counts["noops"] += 1
        except ElasticsearchTpuException as e:
            failures.append(failure_entry(svc.name, doc_id, e))

    canceled = None
    with n.tasks.task("indices:data/write/update/byquery",
                      description=f"update-by-query [{index}]"):
        try:
            run_by_query(svc, body.get("query"), apply)
        except TaskCancelledException as e:
            canceled = str(e)
    out = {"took": 0, "updated": counts["updated"],
           "total": len(processed), "noops": counts["noops"],
           "failures": failures, "timed_out": False}
    if canceled is not None:
        out["canceled"] = canceled
    return 200, out


def _mget_one(n: Node, spec: dict, default_index: Optional[str], p) -> dict:
    from elasticsearch_tpu_torch.search.service import (_filter_source,
                                                  source_path)
    from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException

    iname = spec.get("_index", default_index)
    want_type = spec.get("_type")
    doc_id = str(spec.get("_id"))
    try:
        svc = n.get_index(iname)
    except ElasticsearchTpuException as e:
        # a missing index reads as a per-doc miss with the request's
        # coordinates echoed (MultiGetResponse keeps the failure per item)
        out = {"_index": iname, "_id": doc_id, "found": False,
               "error": {"type": e.error_type, "reason": str(e)}}
        if want_type is not None:
            out["_type"] = want_type
        return out
    rt = (spec.get("routing") or spec.get("_routing")
          or spec.get("parent") or spec.get("_parent"))
    rt = str(rt) if rt is not None else None
    # realtime only — the refresh param is handled ONCE per index by the
    # mget driver, never per doc (a dist refresh fans to every peer)
    rt_kw = {"realtime":
             str(p.get("realtime", "true")).lower() not in ("false", "0")}
    data = _mh_for(n, svc.name)
    if data is not None:
        got = data.get_doc(svc.name, doc_id, routing=rt, with_meta=True,
                           **rt_kw)
        rloc = _loc_from_meta(got.pop("_meta", None))
    else:
        got = svc.get_doc(doc_id, routing=rt, **rt_kw)
        rloc = svc.route(doc_id, rt).engine._locations.get(doc_id)
    got["_index"] = svc.name  # concrete index, even via an alias
    got["_id"] = doc_id
    if (got.get("found") and want_type not in (None, "_all", "_doc")
            and got.get("_type") != want_type):
        # requested type mismatch reads as not-found (MultiGetRequest)
        got = {"_index": svc.name, "_id": doc_id, "found": False}
    if want_type is not None and not got.get("found"):
        got["_type"] = want_type
    flds = spec.get("fields") or spec.get("_fields") or p.get("fields")
    if flds and got.get("found"):
        names = (flds.split(",") if isinstance(flds, str) else list(flds))
        loc = rloc
        src = got.get("_source") or {}
        if "_source" not in names:
            # requesting fields suppresses _source unless asked for
            # explicitly (GetRequest.fields semantics)
            got.pop("_source", None)
        fl: Dict[str, Any] = {}
        for f in names:
            if f == "_routing" and loc is not None \
                    and loc.routing is not None:
                fl["_routing"] = loc.routing
            elif f == "_parent" and loc is not None \
                    and loc.parent is not None:
                fl["_parent"] = loc.parent
            elif f not in ("_routing", "_parent"):
                cur = source_path(src, f)
                if cur is not None:
                    fl[f] = cur if isinstance(cur, list) else [cur]
        got["fields"] = fl
    sf = spec.get("_source", p.get("_source"))
    if sf is None and ("_source_include" in p or "_source_exclude" in p):
        sf = {"include": [x for x in
                          (p.get("_source_include") or "").split(",") if x],
              "exclude": [x for x in
                          (p.get("_source_exclude") or "").split(",") if x]}
    if isinstance(sf, str) and sf.lower() in ("true", "false"):
        sf = sf.lower() == "true"
    if isinstance(sf, str) and "," in sf:
        sf = sf.split(",")
    if got.get("found") and sf is not None:
        filtered = _filter_source(got.get("_source"), sf)
        got.pop("_source", None)
        if filtered is not None:
            got["_source"] = filtered
    return got


def _mget(n: Node, p, b, index: Optional[str] = None,
          doc_type: Optional[str] = None):
    from elasticsearch_tpu_torch.utils.errors import \
        ActionRequestValidationException

    body = _json(b)
    # body-level index/type are per-request defaults (MultiGetRequest)
    index = index or body.get("index")
    doc_type = doc_type or body.get("type")
    if "ids" in body:
        specs = [{"_id": i} for i in body["ids"]]
    else:
        specs = list(body.get("docs") or [])
    if not specs:
        raise ActionRequestValidationException("no documents to get")
    problems = []
    for spec in specs:
        if doc_type is not None and doc_type != "_all":
            spec.setdefault("_type", doc_type)
        if spec.get("_id") is None:
            problems.append("id is missing")
        if spec.get("_index", index) is None:
            problems.append("index is missing")
    if problems:
        raise ActionRequestValidationException(*problems)
    if str(p.get("refresh", "false")).lower() in ("", "true", "1"):
        # ONCE per distinct index, not once per doc
        for iname in {spec.get("_index", index) for spec in specs}:
            try:
                _realtime_kw(n, p, iname)
            except ElasticsearchTpuException:
                pass  # a missing index reads as per-doc misses below
    return 200, {"docs": [_mget_one(n, spec, index, p) for spec in specs]}


def _mget_index(n: Node, p, b, index: str):
    return _mget(n, p, b, index)


def _bulk(n: Node, p, b, index: Optional[str] = None,
          doc_type: Optional[str] = None):
    ops = _ndjson(b)
    if index is not None or doc_type is not None:
        for line in ops:
            if len(line) == 1:
                (op, meta), = line.items()
                if op in ("index", "create", "update", "delete") and isinstance(meta, dict):
                    if index is not None:
                        meta.setdefault("_index", index)
                    if doc_type is not None:
                        meta.setdefault("_type", doc_type)
    r = n.bulk(ops)
    if _refresh_requested(p):
        for name, svc in list(n.indices.items()):
            # a distributed index refreshes on every member, or the docs
            # its other members own stay invisible (ROADMAP C24; the
            # reference refreshes this member's copies only)
            data = _mh_for(n, name)
            if data is not None:
                data.refresh(name)
            else:
                svc.refresh()
    return 200, r


def _mget_typed(n: Node, p, b, index: str, type: Optional[str]):
    """Typed mget: the path {type} becomes each doc spec's default _type
    (then the usual type-filtered read applies) — ids lists included."""
    return _mget(n, p, b, index, doc_type=type)


def _termvectors_noid(n: Node, p, b, index: str):
    """/{index}/{type}/_termvectors — id carried in the body."""
    body = _json(b)
    if not isinstance(body, dict):
        raise IllegalArgumentException("termvectors expects an object body")
    return _termvectors(n, p, b, index, str(body.get("_id") or ""))


def _bulk_index(n: Node, p, b, index: str):
    return _bulk(n, p, b, index)


# -- search handlers ----------------------------------------------------------

def _search_body(p, b) -> dict:
    body = _json(b)
    if "q" in p:
        body.setdefault("query", {"query_string": {"query": p["q"]}})
    for k in ("size", "from"):
        if k in p:
            body.setdefault(k, int(p[k]))
    if "sort" in p:
        body.setdefault("sort", p["sort"].split(","))
    if "scroll" in p:
        body["scroll"] = p["scroll"]
    if "search_type" in p:
        body["search_type"] = p["search_type"]
    prof_p = p.get("profile")
    if prof_p is not None and str(prof_p).lower() in ("", "1", "true"):
        # ?profile=true (case-insensitive, like the other boolean
        # params): per-shard phase breakdown with the device
        # compile/execute split (tracing/profiler.py)
        body["profile"] = True
    if "timeout" in p:
        # ?timeout= caps the per-shard collect loops; a blown deadline
        # degrades to partial results with timed_out=true
        body.setdefault("timeout", p["timeout"])
    if "query_cache" in p:
        # per-request shard query-cache override (reference:
        # ShardSearchRequest.queryCache beats the index setting)
        body["_query_cache"] = p["query_cache"].lower() in ("", "1", "true")
    if "_source" in p:
        v = p["_source"]
        if v == "":  # bare ?_source flag = true
            body["_source"] = True
        else:
            body["_source"] = (v.lower() == "true" if v.lower()
                               in ("true", "false") else v.split(","))
    if "_source_include" in p or "_source_exclude" in p:
        # URL-level source filtering OVERRIDES the body spec
        # (RestSearchAction fetchSourceContext from params)
        body["_source"] = {
            "include": [x for x in
                        (p.get("_source_include") or "").split(",") if x],
            "exclude": [x for x in
                        (p.get("_source_exclude") or "").split(",") if x]}
    return body


def _with_type_filter(body: dict, type: Optional[str]) -> dict:
    """/{index}/{type}/_search scoping: AND a `_type` filter into the query
    (reference: SearchRequest types -> TypeFilter)."""
    if not type or type == "_all":
        return body
    body = dict(body or {})
    q = body.get("query", {"match_all": {}})
    types = [t.strip() for t in str(type).split(",") if t.strip()]
    tf = ({"term": {"_type": types[0]}} if len(types) == 1
          else {"terms": {"_type": types}})
    body["query"] = {"bool": {"must": [q], "filter": [tf]}}
    return body


def _search(n: Node, p, b, index: str):
    data = _mh_for(n, index)
    if data is not None:
        # distributed index: scatter the query phase to shard-owner
        # processes, merge, fetch (cluster/search_action.py — registers
        # its own coordinator task + root span)
        return 200, data.search(index, _search_body(p, b))
    with n.tasks.task("indices:data/read/search",
                      description=f"indices[{index}]"):
        with n.tracer.span("search", index=index):
            return 200, n.search(index, _search_body(p, b),
                                 preference=p.get("preference"))


def _search_typed(n: Node, p, b, index: str, type: str):
    data = _mh_for(n, index)
    if data is not None:
        return 200, data.search(index,
                                _with_type_filter(_search_body(p, b), type))
    return 200, n.search(index, _with_type_filter(_search_body(p, b), type),
                         preference=p.get("preference"))


def _count_typed(n: Node, p, b, index: str, type: str):
    body = _json(b)
    if "q" in p:
        body = {"query": {"query_string": {"query": p["q"]}}}
    return _count_with_body(n, index, _with_type_filter(body, type))


def _search_all(n: Node, p, b):
    with n.tasks.task("indices:data/read/search",
                      description="indices[_all]"):
        with n.tracer.span("search", index="_all"):
            return 200, n.search(None, _search_body(p, b),
                                 preference=p.get("preference"))


def _msearch(n: Node, p, b, index: Optional[str] = None,
             doc_type: Optional[str] = None):
    lines = _ndjson(b)
    pairs = []
    for i in range(0, len(lines) - 1, 2):
        header = lines[i]
        if index is not None:
            header.setdefault("index", index)
        body = lines[i + 1]
        if doc_type is not None and "type" not in header:
            body = _with_type_filter(body, doc_type)
        pairs.append((header, body))
    return 200, n.msearch(pairs)


def _msearch_index(n: Node, p, b, index: str):
    return _msearch(n, p, b, index)


def _scroll(n: Node, p, b):
    from elasticsearch_tpu_torch.search.service import (clear_scroll,
                                                  scroll_next,
                                                  scroll_state)
    from elasticsearch_tpu_torch.tracing.tasks import reset_current, set_current

    body = _json(b)
    sid = body.get("scroll_id", p.get("scroll_id"))
    # ONE persistent task per scroll CONTEXT, not per page: it lives on
    # the state across page requests, so an operator can find a client
    # draining a huge scroll in /_tasks and cancel it — the NEXT page
    # hits the checkpoint, returns the typed 400, and the context frees.
    # (A per-page task would unregister microseconds after it appeared;
    # the cancel could never land.)
    state = scroll_state(sid) if sid else None
    task = None
    if state is not None:

        def _free_on_cancel(t, _sid=sid):
            # EAGER cleanup on the cancelling thread: an abandoned
            # client may never send the next page, so the context (a
            # full snapshot) and the task must not wait on it — later
            # pages 404 as a missing context, like a cleared scroll; a
            # page already in flight raises at its checkpoint (the
            # typed 400)
            clear_scroll(_sid)
            n.tasks.unregister(t)

        # under a lock: two concurrent pages for one scroll_id
        # (ThreadingHTTPServer + a client retry) must not EACH register
        # a task — the loser would be a permanent ghost /_tasks row
        with _SCROLL_TASK_LOCK:
            task = state.get("_task")
            if task is None or n.tasks.get(task.id) is not task:
                # on_cancel rides register(): the task is cancellable
                # the instant it publishes, and a cancel before a late
                # assignment would lose the cleanup forever
                task = n.tasks.register(
                    "indices:data/read/scroll",
                    description=f"scroll [{str(sid)[:16]}]",
                    on_cancel=_free_on_cancel)
                state["_task"] = task
    token = set_current(task) if task is not None else None
    try:
        return 200, scroll_next(sid)
    finally:
        if token is not None:
            reset_current(token)


def _clear_scroll(n: Node, p, b):
    from elasticsearch_tpu_torch.search.service import (clear_scroll,
                                                  scroll_state)
    from elasticsearch_tpu_torch.utils.errors import \
        SearchContextMissingException

    body = _json(b)
    ids = body.get("scroll_id", p.get("scroll_id", []))
    if isinstance(ids, str):
        ids = ids.split(",")
    for s in ids:
        st = scroll_state(s)
        if st is not None and st.get("_task") is not None:
            # the context's persistent scroll task dies with it
            n.tasks.unregister(st["_task"])
    freed = sum(1 for s in ids if clear_scroll(s))
    if ids and ids != ["_all"] and freed == 0:
        raise SearchContextMissingException(
            f"no search context found for ids {ids}")
    return 200, {"succeeded": True, "num_freed": freed}


def _validate_query(n: Node, p, b, index: str):
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.utils.errors import QueryParsingException

    body = _json(b)
    try:
        q = parse_query(body.get("query"))
        resp = {"valid": True,
                "_shards": {"total": 1, "successful": 1, "failed": 0}}
        if p.get("explain") in ("true", ""):
            # explanation text: the reference prints the rewritten Lucene
            # query; match_all rewrites to *:*
            qtype = type(q).__name__
            text = "*:*" if qtype == "MatchAllQuery" else qtype
            resp["explanations"] = [
                {"index": nm, "valid": True, "explanation": text}
                for nm in n.resolve_indices(index)]
        return 200, resp
    except QueryParsingException as e:
        if p.get("explain") in ("true", ""):
            names = n.resolve_indices(index)
            return 200, {"valid": False, "explanations": [
                {"index": nm, "valid": False, "error": str(e)}
                for nm in (names or [index])]}
        return 200, {"valid": False}


def _forward_doc_op(n: Node, index: str, doc_id, p, b, segment: str):
    """Forward a doc-level op (explain / termvectors) to the doc's
    primary owner; None → serve locally. The `_local_only` param pins a
    PROXIED request to the receiving node — without it, divergent
    ownership views during a reassignment window would re-forward the
    request in an unbounded ping-pong between nodes."""
    if p.get("_local_only"):
        return None
    data = _mh_for(n, index)
    if data is None:
        return None
    from urllib.parse import quote

    return data.proxy_doc_rest(
        index, str(doc_id), p.get("routing"), "POST",
        f"/{quote(index, safe='')}/{segment}/{quote(str(doc_id), safe='')}",
        p, b)


def _explain(n: Node, p, b, index: str, id: str):
    """Per-doc score explanation (RestExplainAction): run the query on the
    owning segment and report the doc's score + matched state."""
    fwd = _forward_doc_op(n, index, id, p, b, "_explain")
    if fwd is not None:
        return fwd
    import numpy as np

    from elasticsearch_tpu_torch.search.context import SegmentContext
    from elasticsearch_tpu_torch.search.queries import parse_query

    svc = n.get_index(index)
    body = _json(b)
    query = parse_query(body.get("query"))
    shard = svc.route(id, p.get("routing"))
    from elasticsearch_tpu_torch.search.joins import prepare_tree

    prepare_tree(query, shard.segments, svc.mappings, svc.analysis)
    loc = shard.engine._locations.get(str(id))
    if loc is None or loc.deleted or loc.where == "buffer":
        return 404, {"_index": svc.name, "_type": "_doc", "_id": id,
                     "matched": False}
    for seg in shard.segments:
        if seg.seg_id == loc.where:
            ctx = SegmentContext(seg, svc.mappings, svc.analysis)
            scores, mask = query.score_or_mask(ctx)
            # transfer each array to host once and index the copies:
            # scalar pulls would re-sync per field as this path grows
            mask_h = np.asarray(mask)
            scores_h = np.asarray(scores)
            matched = bool(mask_h[loc.local_id])
            score = float(scores_h[loc.local_id])
            resp = {
                "_index": svc.name,
                "_type": (loc.doc_type or "_doc"),
                "_id": id, "matched": matched,
                "explanation": {
                    "value": score if matched else 0.0,
                    "description": "sum of per-term BM25 impact scores (tpu segment program)",
                    "details": [],
                },
            }
            if any(k in p for k in ("_source", "_source_include",
                                    "_source_exclude", "fields")):
                # RestExplainAction's GetResult envelope: the doc rides
                # along under `get`, with the same source filtering the
                # GET API applies
                _st, got = _get_doc(n, p, b"", svc.name, id)
                if got.get("found"):
                    env: Dict[str, Any] = {"found": True}
                    if "_source" in got:
                        env["_source"] = got["_source"]
                    if "fields" in got:
                        env["fields"] = got["fields"]
                    resp["get"] = env
            return 200, resp
    return 404, {"_index": svc.name, "_type": "_doc", "_id": id,
                 "matched": False}


def _resolve_template(n: Node, body: dict):
    from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException

    tmpl = body.get("inline", body.get("template"))
    if isinstance(tmpl, dict) and ("inline" in tmpl or "id" in tmpl):
        body = {**body, **tmpl}
        tmpl = tmpl.get("inline")
    if isinstance(tmpl, str) and "{" not in tmpl:
        # a bare name is an indexed/on-disk script reference, not an
        # inline source (RestSearchTemplateAction lookup order)
        found = n.search_templates.get(tmpl)
        if found is None:
            raise ElasticsearchTpuException(
                f"Unable to find on disk script {tmpl}")
        tmpl = found
    if tmpl is None and "id" in body:
        tmpl = n.search_templates.get(body["id"])
        if tmpl is None:
            raise ElasticsearchTpuException(
                f"Unable to find on disk script {body['id']}")
    if tmpl is None:
        raise ElasticsearchTpuException("search template requires [inline] or [id]")
    return tmpl, body.get("params")


def _search_template(n: Node, p, b, index: str):
    from elasticsearch_tpu_torch.search.templates import render_template

    body = _json(b)
    tmpl, params = _resolve_template(n, body)
    rendered = render_template(tmpl, params)
    return _search(n, p, json.dumps(rendered).encode(), index)


def _render_template_ep(n: Node, p, b):
    from elasticsearch_tpu_torch.search.templates import render_template

    body = _json(b)
    tmpl, params = _resolve_template(n, body)
    return 200, {"template_output": render_template(tmpl, params)}


def _put_search_template(n: Node, p, b, id: str):
    body = _json(b)
    tmpl = body.get("template", body)
    if "{{}}" in json.dumps(tmpl):
        # empty mustache tag: the reference's compile step rejects it
        # (ScriptService.validate -> MustacheException)
        raise IllegalArgumentException(
            "Unable to parse mustache template: empty tag {{}}")
    created = id not in n.search_templates
    n.search_templates[id] = tmpl
    ver = n.search_template_versions.get(id, 0) + 1
    n.search_template_versions[id] = ver
    return (201 if created else 200), {
        "acknowledged": True, "_id": id, "_version": ver,
        "created": created}


def _get_search_template(n: Node, p, b, id: str):
    """GetIndexedScriptResponse: the stored source echoes as a STRING
    (scripts are text documents in the .scripts index)."""
    t = n.search_templates.get(id)
    if t is None:
        return 404, {"_id": id, "found": False, "lang": "mustache"}
    return 200, {"_id": id, "found": True, "lang": "mustache",
                 "_version": n.search_template_versions.get(id, 1),
                 "template": (t if isinstance(t, str)
                              else json.dumps(t, separators=(",", ":")))}


def _delete_search_template(n: Node, p, b, id: str):
    found = n.search_templates.pop(id, None) is not None
    if found:
        ver = n.search_template_versions.get(id, 0) + 1
        n.search_template_versions[id] = ver
    else:
        ver = 1
    return (200 if found else 404), {"_id": id, "found": found,
                                     "_index": ".scripts",
                                     "_version": ver}


def _put_warmer(n: Node, p, b, index: str, name: str):
    names = n.resolve_indices(index)
    if not names:
        raise IndexNotFoundException(index)
    body = _json(b)
    for nm in names:  # multi-index expressions, like the reference
        n.indices[nm].warmers[name] = body
    return 200, {"acknowledged": True}


def _get_warmers(n: Node, p, b, index: str):
    out = {}
    for nm in n.resolve_indices(index):
        svc = n.indices[nm]
        out[nm] = {"warmers": {
            k: {"source": v} for k, v in svc.warmers.items()}}
    return 200, out


def _get_warmer(n: Node, p, b, index: str, name: str):
    """RestGetWarmerAction: a missing INDEX 404s; a name that matches
    nothing on existing indices is an empty 200 body (the reference
    returns the empty GetWarmersResponse)."""
    out = {}
    for nm in _resolve_indices_options(n, index, p):
        svc = n.indices[nm]
        ws = {k: {"source": v} for k, v in svc.warmers.items()
              if _warmer_name_match(k, name)}
        if ws:
            out[nm] = {"warmers": ws}
    return 200, out


def _delete_warmer(n: Node, p, b, index: str, name: str):
    """RestDeleteWarmerAction: comma lists / wildcards / _all name forms;
    404 only when a CONCRETE name matched nothing."""
    names = _resolve_indices_options(n, index, p)
    if not names:
        raise IndexNotFoundException(index)
    found = False
    for nm in names:
        svc = n.indices[nm]
        for w in [w for w in list(svc.warmers)
                  if _warmer_name_match(w, name)]:
            svc.warmers.pop(w, None)
            found = True
    if not found and not (any(c in str(name) for c in "*,")
                          or name == "_all"):
        return 404, {"acknowledged": False}
    return 200, {"acknowledged": True}


def _dist_percolate(n: Node, c, index: str, type: str, body: dict):
    """Percolate on a distributed index: registered .percolator queries
    are hash-routed docs, fanned to each PRIMARY owner and merged with
    per-query-id dedup — replica fanout copies a registration onto
    replica holders' registries too, so without the dedup (and the
    primary-owner targeting) the same query would match once per copy.
    Aggs-under-percolate run as a DISTRIBUTED search over the matched
    registration docs after the fan (ids filter + size 0), so partials
    reduce through the same query-then-fetch agg machinery as any other
    search — per-node FINAL aggs never need merging."""
    import json as _json_mod
    from urllib.parse import quote

    from elasticsearch_tpu_torch.cluster.search_action import \
        ACTION_REST_PROXY

    aggs_spec = body.get("aggs") or body.get("aggregations")
    # owners must not compute (and discard) local FINAL aggs, and must not
    # truncate their match pages — "total", and the aggs below, are over
    # ALL matches; the coordinator applies size itself after the merge
    fan_body = {k: v for k, v in body.items()
                if k not in ("aggs", "aggregations", "size")}
    rname = c.data.resolve_index(index)
    meta = c.data._meta(rname)
    by_owner: Dict[str, int] = {}
    failed_shards = 0
    for sid in range(meta["num_shards"]):
        owners = meta["assignment"][str(sid)]
        if owners:
            by_owner[owners[0]] = by_owner.get(owners[0], 0) + 1
        else:
            failed_shards += 1
    req = {"method": "POST",
           "path": (f"/{quote(index, safe='')}/"
                    f"{quote(type, safe='')}/_percolate"),
           "params": {}, "body": _json_mod.dumps(fan_body)}
    matches: list = []
    seen_ids: set = set()
    for owner, n_shards in sorted(by_owner.items()):
        try:
            if owner == c.data._local_id():
                res = c.data._on_rest_proxy(dict(req))
            else:
                res = c.data._send(owner, ACTION_REST_PROXY, dict(req))
        except Exception:
            failed_shards += n_shards
            continue
        if res["status"] != 200:
            failed_shards += n_shards
            continue
        for m in res["payload"].get("matches", []):
            key = (m.get("_index"), m.get("_id"))
            if key not in seen_ids:
                seen_ids.add(key)
                matches.append(m)
    total = len(matches)
    size = body.get("size")
    full_ids = [m.get("_id") for m in matches]
    if size is not None:
        matches = matches[: int(size)]
    total_shards = meta["num_shards"]
    out = {"took": 0,
           "_shards": {"total": total_shards,
                       "successful": total_shards - failed_shards,
                       "failed": failed_shards},
           "total": total, "matches": matches}
    if aggs_spec is not None:
        from elasticsearch_tpu_torch.search.percolator import PERCOLATOR_TYPE

        # same semantics as IndexService.percolate: aggregate over ALL
        # matched registrations' metadata (not the size-truncated page),
        # via the distributed search's shard-partial agg reduce
        r = c.data.search(index, {"query": {"bool": {"filter": [
            {"term": {"_type": PERCOLATOR_TYPE}},
            {"ids": {"values": full_ids}}]}},
            "size": 0, "aggs": aggs_spec})
        out["aggregations"] = r.get("aggregations", {})
    return 200, out


def _percolate(n: Node, p, b, index: str, type: str):
    c = _mh(n)
    if c is not None and not p.get("_local_only") \
            and c.data.resolve_index(index) in c.dist_indices:
        return _dist_percolate(n, c, index, type, _json(b))
    svc = n.get_index(index)
    return 200, svc.percolate(_json(b))


def _percolate_existing(n: Node, p, b, index: str, type: str, id: str):
    """Percolate an already-indexed doc (RestPercolateAction existing-doc
    form: GET /{index}/{type}/{id}/_percolate). percolate_index/
    percolate_type redirect WHICH index's registered queries run
    (TransportPercolateAction getRequest indirection); a version param
    must match the doc's current version."""
    c = _mh(n)
    dist = (c is not None and not p.get("_local_only")
            and c.data.resolve_index(index) in c.dist_indices)
    if dist:
        got = c.data.get_doc(index, str(id), routing=p.get("routing"))
    else:
        svc = n.get_index(index)
        got = svc.get_doc(id, routing=p.get("routing"))
    if not got.get("found"):
        return 404, {"_index": index, "_id": id, "found": False}
    if "version" in p and int(p["version"]) != got.get("_version"):
        from elasticsearch_tpu_torch.utils.errors import VersionConflictException

        raise VersionConflictException(index, id, got.get("_version"),
                                       int(p["version"]))
    body = _json(b)
    body["doc"] = got["_source"]
    target = p.get("percolate_index")
    # the fan-out gates on the TARGET registry's index being distributed
    # — percolate_index can redirect a local source doc at a distributed
    # registry (and vice versa)
    tname = target or index
    if c is not None and not p.get("_local_only") \
            and c.data.resolve_index(tname) in c.dist_indices:
        return _dist_percolate(n, c, tname, type, body)
    psvc = n.get_index(target) if target else n.get_index(index)
    return 200, psvc.percolate(body)


def _suggest(n: Node, p, b, index: str):
    c = _mh(n)
    if c is not None and not p.get("_local_only") \
            and c.data.resolve_index(index) in c.dist_indices:
        # distributed index: one request per primary owner, merged per
        # entry (freq sums, score maxes) — cluster/search_action.py
        from elasticsearch_tpu_torch.search.suggest import validate_suggest_body

        body = _json(b)
        validate_suggest_body(body)  # 400 BEFORE the fan, not shard noise
        res, shards = c.data.suggest_fan(index, body)
        res["_shards"] = shards
        return 200, res
    svc = n.get_index(index)
    sh = p.get("_shards")  # internal: the multi-host fan's shard filter
    shard_ids = [int(i) for i in sh.split(",")] if sh else None
    res = svc.suggest(_json(b), shard_ids=shard_ids)
    served = len(shard_ids) if shard_ids is not None else svc.num_shards
    res["_shards"] = {"total": served, "successful": served, "failed": 0}
    return 200, res


def _suggest_all(n: Node, p, b):
    """Reference: RestSuggestAction with no index = all indices; each index
    runs under its own analysis registry, merged per entry. Distributed
    indices fan per primary owner first (coordinator-local shards of a
    dist index would under-count), then merge like any other index."""
    from elasticsearch_tpu_torch.search.suggest import (execute_suggest_multi,
                                                  validate_suggest_body)

    body = _json(b)
    validate_suggest_body(body)  # a malformed body 400s BEFORE any fan
    c = _mh(n)
    dist_names = (set() if c is None or p.get("_local_only")
                  else set(c.dist_indices))
    groups = [(svc.shards, svc.analysis, svc.mappings)
              for name, svc in n.indices.items()
              if name not in dist_names]
    extra = []
    failed = 0
    for name in sorted(dist_names):
        fanned, sh = c.data.suggest_fan(name, body)
        extra.append(fanned)
        failed += sh.get("failed", 0)
    res = execute_suggest_multi(groups, body, extra_results=extra)
    total = (sum(len(g[0]) for g in groups)
             + sum(c.dist_indices[nm]["num_shards"] for nm in dist_names))
    res["_shards"] = {"total": total, "successful": total - failed,
                      "failed": failed}
    return 200, res


def _field_stats(n: Node, p, b, index: str):
    """RestFieldStatsAction: per-field stats (max_doc/doc_count/density/
    sum_doc_freq/sum_total_term_freq + numeric min/max). Default level is
    `cluster` (everything merged under indices._all); level=indices keys
    per index."""
    import numpy as np

    body = _json(b)
    want = body.get("fields") or ([f.strip() for f in p["fields"].split(",")]
                                  if p.get("fields") else None)

    def _bump(cur, add):
        for k in ("doc_count", "sum_doc_freq", "sum_total_term_freq",
                  "max_doc"):
            cur[k] = cur.get(k, 0) + add.get(k, 0)
        for k, fn in (("min_value", min), ("max_value", max)):
            if add.get(k) is not None:
                cur[k] = (add[k] if cur.get(k) is None
                          else fn(cur[k], add[k]))

    def _dist_fields(c, name: str) -> Dict[str, dict]:
        """Fan to each primary owner (its primary shards only — replica
        copies would double doc counts) and merge with _bump."""
        import json as _json_mod

        from elasticsearch_tpu_torch.cluster.search_action import \
            ACTION_REST_PROXY
        from urllib.parse import quote

        meta = c.data._meta(name)
        by_owner: Dict[str, list] = {}
        for sid in range(meta["num_shards"]):
            owners = meta["assignment"][str(sid)]
            if owners:
                by_owner.setdefault(owners[0], []).append(sid)
        fields: Dict[str, dict] = {}
        for owner, sids in sorted(by_owner.items()):
            params = {"level": "indices",
                      "_shards": ",".join(map(str, sids))}
            if want is not None:
                # filter at the SOURCE: owners must not compute + ship
                # stats for fields the request never asked about
                params["fields"] = ",".join(want)
            req = {"method": "GET",
                   "path": f"/{quote(name, safe='')}/_field_stats",
                   "params": params, "body": _json_mod.dumps(body)}
            try:
                if owner == c.data._local_id():
                    res = c.data._on_rest_proxy(dict(req))
                else:
                    res = c.data._send(owner, ACTION_REST_PROXY, dict(req))
            except Exception:
                continue  # dead owner: its shards' stats are unavailable
            if res["status"] != 200:
                continue
            for fname, st in res["payload"].get("indices", {}).get(
                    name, {}).get("fields", {}).items():
                st.pop("density", None)  # recomputed after the merge
                _bump(fields.setdefault(fname, {}), st)
        return fields

    sh_filter = p.get("_shards")  # internal: the multi-host fan's filter
    shard_ids = ([int(i) for i in sh_filter.split(",")]
                 if sh_filter else None)
    c = _mh(n)
    out = {}
    for name in n.resolve_indices(index):
        if c is not None and not p.get("_local_only") \
                and name in c.dist_indices:
            fields = _dist_fields(c, name)
            for st in fields.values():
                md = st.get("max_doc", 0)
                st["density"] = (int(100 * st.get("doc_count", 0) / md)
                                 if md else 0)
            if want is not None:
                fields = {k: v for k, v in fields.items() if k in want}
            out[name] = {"fields": fields}
            continue
        svc = n.indices[name]
        fields: Dict[str, dict] = {}
        shard_list = (svc.shards if shard_ids is None
                      else [svc.shards[i] for i in shard_ids])
        for shard in shard_list:
            for seg in shard.segments:
                md = int(seg.num_docs)
                for fname, col in seg.numerics.items():
                    ex = col.exact[seg.live_host[: len(col.exact)]
                                   & np.asarray(col.exists)]
                    if ex.size == 0:
                        continue
                    _bump(fields.setdefault(fname, {}), {
                        "doc_count": int(ex.size), "max_doc": md,
                        "min_value": ex.min(), "max_value": ex.max()})
                for fname, inv in seg.inverted.items():
                    if fname.startswith("_") or inv.num_docs == 0:
                        continue
                    add = {
                        "doc_count": int(inv.num_docs), "max_doc": md,
                        "sum_doc_freq": int(inv.df.sum()),
                        "sum_total_term_freq": int(inv.total_terms)}
                    live_terms = [t for i, t in enumerate(inv.terms)
                                  if int(inv.df[i]) > 0]
                    if live_terms:
                        # min/max TERM of the field (FieldStats.Text)
                        add["min_value"] = min(live_terms)
                        add["max_value"] = max(live_terms)
                    _bump(fields.setdefault(fname, {}), add)
        for st in fields.values():
            md = st.get("max_doc", 0)
            st["density"] = (int(100 * st.get("doc_count", 0) / md)
                             if md else 0)
        if want is not None:
            fields = {k: v for k, v in fields.items() if k in want}
        out[name] = {"fields": {
            k: {kk: (int(vv) if isinstance(vv, np.integer) else vv)
                for kk, vv in v.items()} for k, v in fields.items()}}
    if p.get("level", "cluster") != "indices":
        merged: Dict[str, dict] = {}
        for entry in out.values():
            for fname, st in entry["fields"].items():
                _bump(merged.setdefault(fname, {}), st)
        for st in merged.values():
            md = st.get("max_doc", 0)
            st["density"] = (int(100 * st.get("doc_count", 0) / md)
                             if md else 0)
        out = {"_all": {"fields": merged}}
    return 200, {"indices": out}


def _termvectors(n: Node, p, b, index: str, id: str):
    """RestTermVectorsAction (reference: action/termvectors/
    TermVectorsRequest.java): per-field term vectors with positions,
    offsets, term_statistics (doc_freq, ttf) and field_statistics
    (sum_doc_freq, doc_count, sum_ttf). Statistics come from the doc's
    frozen segment; a doc still in the indexing buffer reports vectors
    only (ES reads stats from the shard's live reader the same way).
    Offsets are recovered by cursor-scanning the source text for each
    token (the index stores positions, not offsets); stemmed tokens whose
    surface form can't be located omit offsets."""
    fwd = _forward_doc_op(n, index, id, p, b, "_termvectors")
    if fwd is not None:
        return fwd
    body = _json(b)
    opts = {}
    for k, default in (("positions", True), ("offsets", True),
                       ("term_statistics", False), ("field_statistics", True)):
        v = body.get(k, p.get(k, default))
        opts[k] = str(v).lower() != "false"
    svc = n.get_index(index)
    shard = svc.route(id, p.get("routing"))
    # realtime=false reads only REFRESHED state: a doc still in the
    # indexing buffer is found:false (TermVectorsRequest.realtime)
    realtime = str(p.get("realtime", body.get("realtime", "true"))
                   ).lower() not in ("false", "0")
    got = shard.engine.get(id, realtime=realtime)
    if got is None:
        out = {"_index": index, "_id": id, "found": False}
        loc0 = shard.engine._locations.get(str(id))
        if loc0 is not None and loc0.doc_type:
            out["_type"] = loc0.doc_type
        return 200 if loc0 is not None else 404, out
    parsed = shard.engine.parser.parse(str(id), got["_source"])
    loc = shard.engine._locations.get(str(id))
    seg = None
    if loc is not None and loc.where != "buffer":
        seg = next((s for s in shard.engine.segments
                    if s.seg_id == loc.where), None)
    sel = body.get("fields", p.get("fields"))
    if isinstance(sel, str):
        sel = [f.strip() for f in sel.split(",")]
    term_vectors = {}
    for fname, toks in parsed.text_tokens.items():
        if sel and fname not in sel:
            continue
        inv = seg.inverted.get(fname) if seg is not None else None
        src_text = got["_source"].get(fname)
        src_low = src_text.lower() if isinstance(src_text, str) else None
        terms: Dict[str, dict] = {}
        cursor = 0
        for t, pos in toks:
            e = terms.setdefault(t, {"term_freq": 0, "tokens": []})
            e["term_freq"] += 1
            tok: Dict[str, Any] = {}
            if opts["positions"]:
                tok["position"] = pos
            if opts["offsets"] and src_low is not None:
                at = src_low.find(t, cursor)
                if at < 0:  # stemmed form: try the token as a prefix match
                    at = src_low.find(t[:4], cursor) if len(t) >= 4 else -1
                if at >= 0:
                    end = at + len(t)
                    tok["start_offset"] = at
                    tok["end_offset"] = end
                    cursor = end
            if tok:
                e["tokens"].append(tok)
        if opts["term_statistics"] and inv is not None:
            for t, e in terms.items():
                tid = inv.term_id(t)
                if tid >= 0:
                    e["doc_freq"] = int(inv.df[tid])
                    e["ttf"] = int(inv.cf[tid])
        fv: Dict[str, Any] = {"terms": terms}
        if opts["field_statistics"] and inv is not None:
            fv["field_statistics"] = {
                "sum_doc_freq": int(inv.df.sum()),
                "doc_count": int(inv.num_docs),
                "sum_ttf": int(inv.cf.sum()),
            }
        term_vectors[fname] = fv
    return 200, {"_index": index, "_id": id, "found": True,
                 "term_vectors": term_vectors}


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

# -- REST-spec tail (the routes of ES 2.0's rest-api-spec) -------------------
# Each handler cites its reference action class; together these close the
# spec files that had no route: cluster.get/put_settings, pending_tasks,
# reroute, nodes.hot_threads, count/field_stats/flush/optimize without an
# index, alias single-ops + HEAD forms, exists_template/exists_type,
# get_field_mapping, indices.segments/recovery (JSON forms), upgrade,
# clear_cache, count_percolate, mpercolate, mtermvectors, mlt,
# search_exists, search_shards, snapshot.status/verify, indexed scripts,
# cat.help, GET scroll, un-indexed search_template.


def _cluster_get_settings(n: Node, p, b):
    """RestClusterGetSettingsAction: the two dynamic settings maps."""
    return 200, {"persistent": n.cluster_settings["persistent"],
                 "transient": n.cluster_settings["transient"]}


def _cluster_put_settings(n: Node, p, b):
    """RestClusterUpdateSettingsAction (ClusterUpdateSettingsRequest.java):
    merge dotted-key maps; stored settings are returned by GET and surfaced
    to allocation/recovery code via Node.cluster_settings — settings no
    component reads are stored-but-inert, same as unknown settings in 2.0
    (pre-5.x ES did not validate setting names). The breaker family
    (indices.breaker.* / network.breaker.*) applies LIVE to the node's
    breaker service, like the reference's dynamic
    HierarchyCircuitBreakerService settings; a null value resets to the
    default. In a cluster the allocation family
    (``cluster.routing.allocation.*``) applies live to the allocator, and
    the change is broadcast to every member, so a PUT to any of them
    drives the master's allocation loop."""
    from elasticsearch_tpu_torch.cluster.metadata import flatten_settings

    body = _json(b)
    for scope in ("persistent", "transient"):
        # ES accepts nested and dotted bodies interchangeably; flatten so
        # both forms store (and reset) under the same dotted keys
        for k, v in flatten_settings(body.get(scope) or {}).items():
            if v is None:
                n.cluster_settings[scope].pop(k, None)
            else:
                n.cluster_settings[scope][k] = v
    merged = {**n.cluster_settings["persistent"],
              **n.cluster_settings["transient"]}
    n.breakers.apply_cluster_settings(merged)
    # serving front-end settings (serving.coalescer.* / serving.qos.*)
    # apply live through the same idempotent full-map path
    n.serving.apply_cluster_settings(merged)
    c = _mh(n)
    if c is not None:
        c.allocator.apply_cluster_settings(merged)
        if "_local_only" not in p:
            from elasticsearch_tpu_torch.cluster.search_action import \
                ACTION_CLUSTER_SETTINGS

            payload = {"cluster_settings": n.cluster_settings,
                       "merged": merged}
            for nid in c.data._other_nodes():
                try:
                    c.data._send(nid, ACTION_CLUSTER_SETTINGS, payload,
                                 timeout=5.0)
                except Exception:  # an unreachable member adopts the
                    pass           # settings with the next broadcast
    return 200, {"acknowledged": True,
                 "persistent": n.cluster_settings["persistent"],
                 "transient": n.cluster_settings["transient"]}


def _cluster_health(n: Node, p, b):
    """RestClusterHealthAction: the health summary + pending-task gauges;
    level=indices adds per-index sections (our single-node health is
    uniform, so each index reports its own shard counts). The
    coordination fields ride every response: the master's id, the
    cluster term it was elected under and whether the no-master write
    block is in force (a headless member keeps answering health: reads
    serve under the block). In a cluster, relocations in flight and the
    drain's progress ride along."""
    state = n.cluster_state
    h = dict(state.health())
    h["master_node"] = state.master_node_id
    h["term"] = state.term
    no_master = state.master_node_id is None \
        or state.global_block("write") is not None
    h["no_master_block"] = bool(no_master)
    if no_master:
        h["status"] = "red"  # an unquorate node cannot vouch for shards
        h["cluster_blocks"] = [
            dict(blk) for blk in state.blocks.get("global", [])]
    h["number_of_pending_tasks"] = len(_all_pending_tasks(n, p))
    h.setdefault("number_of_in_flight_fetch", 0)
    h.setdefault("delayed_unassigned_shards", 0)
    h.setdefault("task_max_waiting_in_queue_millis", 0)
    c = _mh(n)
    if c is not None:
        # live relocations and the drain's progress: an operator polls
        # health until an excluded node's count reaches zero
        alloc = c.allocator
        h["relocating_shards"] = len(alloc.inflight_snapshot())
        drain = alloc.drain_status()
        if drain:
            h["draining_nodes"] = {nid: {"remaining_copies": left,
                                         "drained": left == 0}
                                   for nid, left in sorted(drain.items())}
    if p.get("level") in ("indices", "shards"):
        idx = {}
        for name, svc in n.indices.items():
            entry = {
                "status": "green", "number_of_shards": svc.num_shards,
                "number_of_replicas": svc.num_replicas,
                "active_primary_shards": svc.num_shards,
                "active_shards": svc.num_shards
                * (1 + svc.num_replicas),
                "relocating_shards": 0, "initializing_shards": 0,
                "unassigned_shards": 0,
            }
            if p.get("level") == "shards":
                entry["shards"] = {str(g.shard_id): {
                    "status": "green", "primary_active": True,
                    "active_shards": len(g.copies),
                    "relocating_shards": 0, "initializing_shards": 0,
                    "unassigned_shards": 0,
                } for g in svc.groups}
            idx[name] = entry
        h["indices"] = idx
    return 200, h


def _resolve_indices_options(n: Node, index_expr: str, p) -> List[str]:
    """IndicesOptions resolution (reference: IndicesOptions.fromParameters
    + IndexNameExpressionResolver.concreteIndices): expand_wildcards scopes
    which states wildcards see, ignore_unavailable forgives named misses,
    allow_no_indices forgives wildcard no-matches."""
    import fnmatch

    ew = {x.strip() for x in str(p.get("expand_wildcards", "open")
                                 ).split(",")}
    if ew & {"both", "all"}:
        ew = {"open", "closed"}
    ignore_unavailable = str(p.get("ignore_unavailable", "false")
                             ).lower() in ("true", "1", "")
    allow_no = str(p.get("allow_no_indices", "true")
                   ).lower() not in ("false", "0")
    out: List[str] = []
    for part in str(index_expr or "_all").split(","):
        part = part.strip()
        if not part:
            continue
        if part == "_all" or any(c in part for c in "*?"):
            pat = "*" if part == "_all" else part
            matched = [
                nm for nm in n.indices
                if fnmatch.fnmatchcase(nm, pat)
                and (("open" in ew and not n.indices[nm].closed)
                     or ("closed" in ew and n.indices[nm].closed))]
            if not matched and not allow_no:
                raise IndexNotFoundException(part)
            out.extend(sorted(matched))
            continue
        resolved = n.resolve_indices(part)
        if not resolved:
            if not ignore_unavailable:
                raise IndexNotFoundException(part)
            continue
        out.extend(resolved)
    seen = set()
    return [nm for nm in out if not (nm in seen or seen.add(nm))]


def _cluster_state_metric(n: Node, p, b, metric: str,
                          index: Optional[str] = None):
    """RestClusterStateAction metric scoping: only the requested sections
    appear (blocks is always available);
    an index expression filters metadata/routing_table to the concrete
    indices it resolves to under the request's IndicesOptions."""
    import copy

    from elasticsearch_tpu_torch.cluster.metadata import _block

    full = copy.deepcopy(n.cluster_state.to_json())
    # blocks built live from index state/settings (reference:
    # ClusterBlocks — ids: 4 = INDEX_CLOSED_BLOCK, 5 = INDEX_READ_ONLY,
    # 7 = INDEX_READ, 8 = INDEX_WRITE) plus the global blocks the
    # cluster set (2 = NO_MASTER_BLOCK, ES's dict-keyed shape)
    blocks: Dict[str, Any] = {}
    for gb in n.cluster_state.blocks.get("global", []):
        blocks.setdefault("global", {})[str(gb.get("id"))] = {
            "description": gb.get("description", ""),
            "retryable": bool(gb.get("retryable")),
            "levels": list(gb.get("levels", []))}
    _BLOCKS = (("read_only", "5", "index read-only (api)",
                ["write", "metadata_write"]),
               ("read", "7", "index read (api)", ["read"]),
               ("write", "8", "index write (api)", ["write"]))
    for nm, svc in n.indices.items():
        bl = {}
        if getattr(svc, "closed", False):
            bl["4"] = {"description": "index closed", "retryable": False,
                       "levels": ["read", "write"]}
        for key, bid, desc, levels in _BLOCKS:
            if _block(svc, key):
                bl[bid] = {"description": desc, "retryable": False,
                           "levels": levels}
        if bl:
            blocks.setdefault("indices", {})[nm] = bl
    full["blocks"] = blocks
    # routing_nodes: the per-node view of the same shard routings
    if "routing_nodes" not in full:
        rt = full.get("routing_table", {}).get("indices", {})
        assigned = [sh for idx in rt.values()
                    for shards in idx.get("shards", {}).values()
                    for sh in shards]
        nid = full.get("master_node") or "local"
        full["routing_nodes"] = {"unassigned": [], "nodes": {nid: assigned}}
    if index is not None:
        names = set(_resolve_indices_options(n, index, p))
        for section, key in (("metadata", "indices"),
                             ("routing_table", "indices")):
            sec = full.get(section)
            if isinstance(sec, dict) and isinstance(sec.get(key), dict):
                sec[key] = {nm: v for nm, v in sec[key].items()
                            if nm in names}
    keep = {m.strip() for m in metric.split(",")}
    if "_all" in keep or "*" in keep:
        return 200, full
    out = {"cluster_name": full["cluster_name"]}
    for key in ("version", "state_uuid", "master_node", "nodes", "metadata",
                "routing_table", "routing_nodes", "blocks"):
        if key in keep and key in full:
            out[key] = full[key]
    return 200, out


def _cluster_reroute(n: Node, p, b):
    """RestClusterRerouteAction. Commands are validated against the routing
    table; with a single node and static shard→device placement every legal
    move/allocate is already satisfied (there is exactly one node to be
    on), so accepted commands change nothing — the same outcome reroute has
    on a one-node reference cluster. cancel fails the shard, which re-runs
    recovery (AllocationService.reroute's cancel semantics). In a
    cluster the commands drive the live allocator (_cluster_reroute_mh),
    and a member that is not the master forwards to it (reference:
    TransportMasterNodeAction): only the master's allocator starts or
    cancels moves."""
    c = _mh(n)
    if c is not None:
        master = c.node.cluster_state.master_node_id
        if not c.is_master and master is not None \
                and "_local_only" not in p:
            from elasticsearch_tpu_torch.cluster.search_action import \
                ACTION_REST_PROXY

            try:
                res = c.data._send(
                    master, ACTION_REST_PROXY,
                    {"method": "POST", "path": "/_cluster/reroute",
                     "params": {k: str(v) for k, v in p.items()},
                     "body": (b or b"").decode()}, timeout=30.0)
                return res["status"], res["payload"]
            except Exception:  # an unreachable master: the local
                pass           # explain-only view below
        return _cluster_reroute_mh(c, n, p, b)
    body = _json(b)
    explanations = []
    for cmd in body.get("commands", []):
        if not isinstance(cmd, dict) or len(cmd) != 1:
            raise IllegalArgumentException(
                "a reroute command must be an object with exactly one "
                "command name key")
        ((name, args),) = cmd.items()
        if name not in ("move", "cancel", "allocate", "allocate_replica",
                        "allocate_stale_primary", "allocate_empty_primary"):
            raise IllegalArgumentException(f"unknown reroute command [{name}]")
        if not isinstance(args, dict):
            raise IllegalArgumentException(
                f"[{name}] command expects an object body")
        iname = args.get("index")
        if not iname:
            raise IllegalArgumentException(
                f"[{name}] command missing required [index] parameter")
        # absent -> False; a bare valueless flag ("") -> True
        explain = str(p.get("explain", "false")).lower() in ("true", "", "1")
        dry_run = str(p.get("dry_run", "false")).lower() in ("true", "", "1")
        shard_id = int(args.get("shard", 0))
        svc = n.get_index(iname)
        valid = shard_id < svc.num_shards
        if not valid and not explain:
            raise IllegalArgumentException(
                f"shard [{shard_id}] out of range for [{iname}]")
        if valid and name == "cancel" and not dry_run:
            if svc.groups[shard_id].replicas:
                svc.fail_shard(shard_id)
            # a sole primary cancels into an immediate local re-recovery —
            # on one node the recovered state IS the current state, so the
            # observable outcome matches the reference's cancel+recover
        params = {"index": iname, "shard": shard_id,
                  "node": args.get("node"),
                  "allow_primary": bool(args.get("allow_primary", False))}
        if valid:
            decision = {"decider": "same_node", "decision": "YES",
                        "explanation": "single-node placement is already "
                                       "satisfied"}
        else:
            # an impossible command EXPLAINS as a NO decision instead of
            # erroring (RerouteExplanation from the allocation deciders)
            decision = {"decider": f"{name}_allocation_command",
                        "decision": "NO",
                        "explanation": f"shard [{shard_id}] of [{iname}] "
                                       f"cannot be found or is not there"}
        explanations.append({"command": name, "parameters": params,
                             "decisions": [decision]})
    # the echoed state defaults to everything EXCEPT metadata; an explicit
    # ?metric= keeps only the requested sections (RestClusterRerouteAction
    # response filtering)
    import copy as _copy

    state = _copy.deepcopy(n.cluster_state.to_json())
    metric = p.get("metric")
    if metric:
        keep = {m.strip() for m in str(metric).split(",")}
        state = {k: v for k, v in state.items()
                 if k in keep or k == "cluster_name"}
    else:
        state.pop("metadata", None)
    resp = {"acknowledged": True, "state": state}
    if str(p.get("explain", "false")).lower() in ("true", "", "1"):
        resp["explanations"] = explanations
    return 200, resp


# stack tops that mean "parked, waiting for work" — the threads
# ignore_idle_threads (default true) filters, the reference's known-idle
# frame list (ThreadPool.Info idle states) translated to stdlib waits
_IDLE_TOPS = {
    ("threading.py", "wait"),
    ("threading.py", "_wait_for_tstate_lock"),
    ("queue.py", "get"),
    ("selectors.py", "select"),
    ("socketserver.py", "serve_forever"),
    ("socketserver.py", "service_actions"),
}


def _cluster_reroute_mh(c, n: Node, p, b):
    """The REAL reroute, against the live allocator (reference:
    TransportClusterRerouteAction → AllocationService.reroute with
    AllocationCommands): ``move`` starts a relocation stream through the
    decider chain, ``cancel`` pulls an in-flight move's cancel gate
    (releasing its throttle slot), ``allocate``/``allocate_replica``
    starts a recovery of a new copy onto the named node. ``?explain``
    answers with per-node decider verdicts from the same chain the
    command ran through; ``?dry_run`` explains without acting."""
    body = _json(b)
    explain = str(p.get("explain", "false")).lower() in ("true", "", "1")
    dry_run = str(p.get("dry_run", "false")).lower() in ("true", "", "1")
    alloc = c.allocator
    explanations = []
    acked = True
    for cmd in body.get("commands", []):
        if not isinstance(cmd, dict) or len(cmd) != 1:
            raise IllegalArgumentException(
                "a reroute command must be an object with exactly one "
                "command name key")
        ((name, args),) = cmd.items()
        if name not in ("move", "cancel", "allocate", "allocate_replica",
                        "allocate_stale_primary", "allocate_empty_primary"):
            raise IllegalArgumentException(
                f"unknown reroute command [{name}]")
        if not isinstance(args, dict):
            raise IllegalArgumentException(
                f"[{name}] command expects an object body")
        iname = args.get("index")
        if not iname:
            raise IllegalArgumentException(
                f"[{name}] command missing required [index] parameter")
        sid = int(args.get("shard", 0))
        meta = c.dist_indices.get(iname)
        if meta is None or sid >= int(meta.get("num_shards", 0)):
            raise IllegalArgumentException(
                f"shard [{sid}] of [{iname}] cannot be found")
        owners = list(meta["assignment"].get(str(sid), []))
        params = {"index": iname, "shard": sid}
        decisions = []
        if name == "move":
            src = _resolve_member(c, args.get("from_node"))
            dst = _resolve_member(c, args.get("to_node"))
            params.update({"from_node": args.get("from_node"),
                           "to_node": args.get("to_node")})
            if src is None or dst is None:
                raise IllegalArgumentException(
                    f"[move] unknown node in "
                    f"[{args.get('from_node')}]->[{args.get('to_node')}]")
            if src not in owners:
                decisions.append({
                    "decider": "move_allocation_command", "decision": "NO",
                    "explanation": f"node [{src}] holds no copy of "
                                   f"[{iname}][{sid}]"})
                acked = False
            else:
                decisions.extend(alloc.explain(iname, sid, dst))
                if not dry_run:
                    task = alloc._start_relocation(iname, sid, src, dst,
                                                   "reroute", set())
                    if task is None:
                        acked = False
        elif name == "cancel":
            dst = _resolve_member(c, args.get("node"))
            params["node"] = args.get("node")
            cancelled = dst is not None and alloc.cancel_relocation(
                (iname, sid, dst), reason="reroute cancel")
            decisions.append({
                "decider": "cancel_allocation_command",
                "decision": "YES" if cancelled else "NO",
                "explanation": (f"cancelled the relocation of "
                                f"[{iname}][{sid}] to [{dst}]" if cancelled
                                else f"no relocation of [{iname}][{sid}] "
                                     f"to [{args.get('node')}] in flight")})
            acked = acked and cancelled
        else:  # allocate / allocate_replica / allocate_*_primary
            dst = _resolve_member(c, args.get("node"))
            params["node"] = args.get("node")
            if dst is None:
                raise IllegalArgumentException(
                    f"[{name}] unknown node [{args.get('node')}]")
            decisions.extend(alloc.explain(iname, sid, dst))
            pend = meta.get("initializing", {}).get(str(sid), [])
            if dst in owners or dst in pend:
                decisions.append({
                    "decider": f"{name}_allocation_command",
                    "decision": "NO",
                    "explanation": f"node [{dst}] already holds a copy "
                                   f"of [{iname}][{sid}]"})
                acked = False
            elif not owners:
                decisions.append({
                    "decider": f"{name}_allocation_command",
                    "decision": "NO",
                    "explanation": f"[{iname}][{sid}] has no active copy "
                                   "to recover from (resurrect_lost "
                                   "handles primaries)"})
                acked = False
            elif not dry_run:
                # a NEW copy recovers onto the node through the standard
                # top-up path: initializing + publish, then the stream,
                # then graduation into assignment + in_sync
                with c._indices_lock:
                    live = c.dist_indices.get(iname)
                    if live is not None:
                        live.setdefault("initializing", {}) \
                            .setdefault(str(sid), []).append(dst)
                c.publish_indices()
                c.data.start_recoveries([{
                    "index": iname, "shard": sid, "target": dst,
                    "source": owners[0], "body": meta.get("body")}])
        explanations.append({"command": name, "parameters": params,
                             "decisions": decisions})
    state = {"cluster_name": n.cluster_state.cluster_name,
             "version": n.cluster_state.version,
             "master_node": n.cluster_state.master_node_id,
             "relocations": alloc.inflight_snapshot()}
    resp = {"acknowledged": acked, "state": state}
    if explain or dry_run:
        resp["explanations"] = explanations
    return 200, resp


def _resolve_member(c, ref: Optional[str]) -> Optional[str]:
    """A reroute command's node argument (name or id) → member node id."""
    if not ref:
        return None
    nodes = c.node.cluster_state.nodes
    if ref in nodes:
        return ref
    for nid, dn in nodes.items():
        if dn.name == ref:
            return nid
    return None


def _stack_is_idle(stack: tuple) -> bool:
    if not stack:
        return True
    fname, _line, func = stack[-1]
    return (os.path.basename(fname), func) in _IDLE_TOPS


def _hot_threads(n: Node, p, b):
    """RestNodesHotThreadsAction with the reference's sampling semantics:
    N snapshots taken ``?interval=`` apart (``?snapshots=``, default 10 ×
    500ms), identical stacks collated per thread ("M/N snapshots sharing
    following K elements"), busiest threads first, idle threads filtered
    unless ``ignore_idle_threads=false``. Python exposes no per-thread
    CPU clock, so "busy" is the fraction of snapshots in which the
    thread sat in a non-idle frame — honest sampling, not fake
    percentages."""
    import sys
    import traceback

    from elasticsearch_tpu_torch.search.service import _parse_timeout

    limit = int(p.get("threads", 3))
    snapshots = max(1, min(int(p.get("snapshots", 10)), 64))
    interval = _parse_timeout(p.get("interval", "500ms")) or 0.5
    # bound one request's sampling wall time: the management pool has 2
    # workers — a 10-minute interval ask must not wedge half of it
    interval = max(0.0, min(interval, 10.0 / snapshots))
    ignore_idle = str(p.get("ignore_idle_threads", "true")).lower() \
        not in ("false", "0")

    # per-thread: sample-count per distinct stack signature
    seen: Dict[int, Dict[tuple, int]] = {}
    names: Dict[int, Any] = {}
    busy: Dict[int, int] = {}
    me = threading.get_ident()
    for i in range(snapshots):
        if i:
            time.sleep(interval)
        frames = sys._current_frames()
        for t in threading.enumerate():
            fr = frames.get(t.ident)
            # skip the sampler itself: it is non-idle in every snapshot
            # by construction and would permanently occupy one of the
            # busiest-N output slots
            if fr is None or t.ident == me:
                continue
            stack = tuple((f.filename, f.lineno, f.name)
                          for f in traceback.extract_stack(fr))
            names[t.ident] = t
            seen.setdefault(t.ident, {})
            seen[t.ident][stack] = seen[t.ident].get(stack, 0) + 1
            if not _stack_is_idle(stack):
                busy[t.ident] = busy.get(t.ident, 0) + 1

    ranked = sorted(seen, key=lambda i: (-busy.get(i, 0),
                                         names[i].name or ""))
    if ignore_idle:
        ranked = [i for i in ranked if busy.get(i, 0) > 0]
    out = [f"::: {{{n.name}}}{{{n.node_id}}}",
           f"   Hot threads sampling: interval={int(interval * 1000)}ms, "
           f"snapshots={snapshots}, busiestThreads={limit}, "
           f"ignoreIdleThreads={str(ignore_idle).lower()}:"]
    for ident in ranked[:limit]:
        t = names[ident]
        b_ct = busy.get(ident, 0)
        pct = 100.0 * b_ct / snapshots
        out.append(f"\n   {pct:.1f}% ({b_ct} out of {snapshots} snapshots "
                   f"non-idle) usage by thread '{t.name}'")
        # collate identical stacks, most-sampled first (the reference's
        # "N/M snapshots sharing following K elements" lines)
        for stack, ct in sorted(seen[ident].items(),
                                key=lambda kv: -kv[1]):
            out.append(f"     {ct}/{snapshots} snapshots sharing "
                       f"following {len(stack)} elements")
            out.extend(f"       {fname}:{line} {func}"
                       for fname, line, func in stack)
    return 200, "\n".join(out)


def _put_alias(n: Node, p, b, index: str, name: str):
    """RestIndexPutAliasAction → IndicesAliasesRequest add. Only the
    alias metadata keys are read from the body — a stray "index"/"alias"
    there must not override the URL targets."""
    body = _json(b)
    extras = {k: v for k, v in body.items()
              if k in ("routing", "index_routing", "search_routing",
                       "filter")}
    action = {"add": {"index": index, "alias": name, **extras}}
    return 200, n.update_aliases([action])


def _delete_alias(n: Node, p, b, index: str, name: str):
    import fnmatch

    names = n.resolve_indices(index)
    if not names:
        raise IndexNotFoundException(index)
    pats = [x.strip() for x in name.split(",")]
    found = False
    for nm in names:
        svc = n.indices[nm]
        for a in list(svc.aliases):
            if any(pt in ("_all", "*") or fnmatch.fnmatch(a, pt)
                   for pt in pats):
                found = True
                n.update_aliases([{"remove": {"index": nm, "alias": a}}])
    if not found:
        return 404, {"error": f"aliases [{name}] missing", "status": 404}
    return 200, {"acknowledged": True}


def _alias_exists(n: Node, p, b, alias: str, index: Optional[str] = None):
    """RestAliasesExistAction (HEAD /_alias/{name}); name may be a
    comma list / wildcard / _all."""
    import fnmatch

    pats = [x.strip() for x in str(alias).split(",")]
    names = n.resolve_indices(index) if index else list(n.indices)
    for iname in names:
        svc = n.indices[iname]
        for a in svc.aliases:
            if any(pt in ("_all", "*") or fnmatch.fnmatch(a, pt)
                   for pt in pats):
                return 200, None
    return 404, None


def _index_alias_exists(n: Node, p, b, index: str, name: str):
    return _alias_exists(n, p, b, name, index)


def _get_index_alias(n: Node, p, b, index: str, alias: Optional[str] = None,
                     legacy: bool = False):
    """RestGetAliasesAction scoped to an index; {name} supports comma
    lists / wildcards / _all; partial matches return the existing subset.
    A name matching NOTHING is an empty 200 body — the new `_alias` API
    omits empty index entries entirely, the legacy `_aliases` form keeps
    each index with an empty aliases map."""
    import fnmatch

    names = n.resolve_indices(index)
    if not names:
        raise IndexNotFoundException(index)
    pats = ([x.strip() for x in alias.split(",")]
            if alias is not None else None)

    def hit(a: str) -> bool:
        return pats is None or any(
            pt in ("_all", "*") or fnmatch.fnmatch(a, pt) for pt in pats)

    out = {}
    for iname in names:
        svc = n.indices[iname]
        matched = {a: (fa or {}) for a, fa in svc.aliases.items() if hit(a)}
        if matched or pats is None or legacy:
            out[iname] = {"aliases": matched}
    return 200, out


def _template_json(body: dict, flat: bool) -> dict:
    """GetIndexTemplatesResponse echo: order/template plus flat-string
    settings (nested when ?flat_settings=false)."""
    def _flatten(d, prefix=""):
        out = {}
        for k, v in (d or {}).items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out.update(_flatten(v, f"{key}."))
            else:
                out[key] = str(v)
        return out

    raw = dict(body.get("settings") or {})
    if raw and "index" not in raw:
        raw = {"index": raw}
    flat_map = _flatten(raw)
    if flat:
        settings = flat_map
    else:
        settings: dict = {}
        for k, v in flat_map.items():
            cur = settings
            parts = k.split(".")
            for part in parts[:-1]:
                cur = cur.setdefault(part, {})
            cur[parts[-1]] = v
    return {
        "order": int(body.get("order", 0)),
        "template": body.get("template", ""),
        "settings": settings,
        "mappings": body.get("mappings", {}),
        "aliases": body.get("aliases", {}),
    }


def _get_template(n: Node, p, b, name: Optional[str]):
    import fnmatch

    # GetIndexTemplates default is the NESTED settings form;
    # ?flat_settings=true flattens (opposite default to index settings GET)
    flat = str(p.get("flat_settings", "false")).lower() in ("", "true")
    tmpls = n.cluster_state.templates
    if name is None:
        names = list(tmpls)
    else:
        pats = [x.strip() for x in name.split(",")]
        names = [t for t in tmpls
                 if any(pt in ("_all", "*") or fnmatch.fnmatch(t, pt)
                        for pt in pats)]
        if not names and not any("*" in pt or pt == "_all" for pt in pats):
            raise IndexNotFoundException(name)
    return 200, {t: _template_json(tmpls[t], flat) for t in names}


def _template_exists(n: Node, p, b, name: str):
    return (200 if name in n.cluster_state.templates else 404), None


def _type_exists(n: Node, p, b, index: str, type: str):
    """RestTypesExistsAction: our single-type model registers the mapped
    _type names per index (doc_parser stores _type per doc)."""
    for iname in n.resolve_indices(index):
        svc = n.indices[iname]
        if type in ("_doc", "_default_"):
            return 200, None
        if type in svc.mappings.type_names:  # typed-mapping blocks
            return 200, None
        for shard in svc.shards:
            if any(loc.doc_type == type and not loc.deleted
                   for loc in shard.engine._locations.values()):
                return 200, None
    return 404, None


def _get_field_mapping(n: Node, p, b, field: str,
                       index: Optional[str] = None,
                       doc_type: Optional[str] = None):
    """RestGetFieldMappingAction / TransportGetFieldMappingsIndexAction:
    per-index leaf mapping for field patterns. A pattern is tried against
    the FULL name first (key = full name); failing that, against the leaf
    ("index") name — then the response key is the leaf name with
    `full_name` pointing at the real path. Indices with no matching
    fields are omitted; an explicit missing index or type 404s;
    include_defaults echoes the implicit analyzer as `default`."""
    import fnmatch

    from elasticsearch_tpu_torch.index.mappings import _field_to_json
    from elasticsearch_tpu_torch.utils.errors import TypeMissingException

    pats = [f.strip() for f in field.split(",")]
    include_defaults = str(p.get("include_defaults", "false")
                           ).lower() in ("true", "1", "")
    names = _resolve_indices_options(n, index, p)
    type_pats = None
    if doc_type not in (None, "", "_all", "*"):
        type_pats = [t.strip() for t in str(doc_type).split(",")]
    out = {}
    type_matched = False
    for iname in names:
        svc = n.indices[iname]
        tnames = svc.mappings.type_names or ["_doc"]
        if type_pats is not None:
            tnames = [t for t in tnames
                      if any(fnmatch.fnmatchcase(t, tp)
                             for tp in type_pats)]
            if not tnames:
                continue
        type_matched = True
        leaves = []
        for fname, fm in svc.mappings.fields.items():
            leaves.append((fname, fm))
            # multi-field sub-fields ("title.raw") live only under their
            # parent's fields map, not in the flat index
            leaves.extend((f"{fname}.{sub}", sfm)
                          for sub, sfm in fm.fields.items())
        fields = {}

        def entry(fname, fm, leaf):
            mj = _field_to_json(fm)
            if include_defaults and fm.is_text:
                mj.setdefault("analyzer", "default")
            return {"full_name": fname, "mapping": {leaf: mj}}

        # pass 1: full-name matches (keyed by full name); pass 2:
        # leaf-name matches fill remaining keys only — a relative match
        # must never shadow a full-name one (t* keeps {t1, t2} even though
        # obj.t1's leaf also matches)
        taken = set()
        for fname, fm in leaves:
            leaf = fname.rpartition(".")[2]
            if not fname.startswith("_") and any(
                    fnmatch.fnmatchcase(fname, pat) for pat in pats):
                fields[fname] = entry(fname, fm, leaf)
                taken.add(fname)
        for fname, fm in leaves:
            leaf = fname.rpartition(".")[2]
            if fname.startswith("_") or fname in taken or leaf in fields:
                continue
            if any(fnmatch.fnmatchcase(leaf, pat) for pat in pats):
                fields[leaf] = entry(fname, fm, leaf)
        if fields:
            out[iname] = {"mappings": {t: dict(fields) for t in tnames}}
    if type_pats is not None and not type_matched and names:
        raise TypeMissingException(",".join(type_pats))
    return 200, out


def _segments_json(n: Node, p, b, index: Optional[str] = None):
    """RestIndicesSegmentsAction (JSON form of _cat/segments). Segment
    names/generations are PER-SHARD ordinals in this response (fresh
    shard → `_0`), like Lucene's per-IndexWriter generations — process-
    global seg ids stay internal. An explicitly named CLOSED index is
    forbidden (IndexClosedException)."""
    from elasticsearch_tpu_torch.cluster.metadata import IndexClosedException

    names = _resolve_indices_options(n, index, p)
    explicit = {x.strip() for x in str(index or "").split(",")
                if x.strip() and not any(c in x for c in "*?")}
    ignore_unavail = str(p.get("ignore_unavailable", "false")
                         ).lower() in ("true", "1", "")
    out = {}
    for iname in names:
        svc = n.indices[iname]
        if svc.closed:
            if iname in explicit and not ignore_unavail:
                raise IndexClosedException(f"closed index [{iname}]")
            continue
        shards = {}
        for g in svc.groups:
            entries = []
            for sh in g.copies:
                segs = {f"_{i}": {
                    "generation": i,
                    "num_docs": seg.live_docs,
                    "deleted_docs": seg.deleted_count,
                    "size_in_bytes": seg.memory_bytes(),
                    "memory_in_bytes": seg.memory_bytes(),
                    "search": True, "committed": True, "compound": False,
                    "version": "5.2.1",
                } for i, seg in enumerate(sh.segments)}
                entries.append({
                    "routing": {"state": sh.state,
                                "primary": sh is g.primary,
                                "node": n.node_id},
                    "num_committed_segments": len(segs),
                    "num_search_segments": len(segs), "segments": segs})
            shards[str(g.primary.shard_id)] = entries
        out[iname] = {"shards": shards}
    return 200, {"indices": out,
                 "_shards": {"total": sum(len(n.indices[i].shards)
                                          for i in out),
                             "successful": sum(len(n.indices[i].shards)
                                               for i in out),
                             "failed": 0}}


def _recovery_entry_json(n: Node, sh, primary: bool, e: dict) -> dict:
    """One RecoveryState row (reference: RecoveryState.toXContent) built
    from a RecoveryRegistry entry. ``mode``/``ops_replayed`` are the
    replication-safety extras: mode "ops" with translog.recovered < the
    shard's doc count PROVES the recovery replayed a checkpoint suffix
    instead of re-shipping the shard."""
    type_map = {"gateway": "GATEWAY", "replica": "REPLICA",
                "peer": "REPLICA", "relocation": "RELOCATION"}
    size = sum(seg.memory_bytes() for seg in sh.segments)
    full = e.get("mode") == "full"
    docs = e.get("docs_copied", 0)
    ops = e.get("ops_replayed", 0)
    return {
        "id": sh.shard_id, "type": type_map.get(e["type"], "REPLICA"),
        "mode": e.get("mode") or ("translog" if e["type"] == "gateway"
                                  else None),
        "primary": primary,
        "stage": e["stage"].upper(),
        "source": ({} if e.get("source") in (None, "local")
                   else {"id": e["source"]}),
        "target": {"id": n.node_id, "name": n.name,
                   "ip": "127.0.0.1", "host": "localhost"},
        "start_time_in_millis": e.get("start_millis", 0),
        "total_time_in_millis": e.get("total_time_in_millis", 0),
        "index": {
            "files": {"total": 0, "reused": 0, "recovered": 0,
                      "percent": "100.0%"},
            "size": {"total_in_bytes": size,
                     "reused_in_bytes": 0 if full else size,
                     "recovered_in_bytes": size if full else 0,
                     "percent": "100.0%"},
            "docs_recovered": docs,
            "docs_skipped": e.get("docs_skipped", 0),
            "source_throttle_time_in_millis": 0,
            "target_throttle_time_in_millis": 0,
            "total_time_in_millis": e.get("total_time_in_millis", 0),
        },
        "translog": {
            "recovered": ops,
            "total": ops,
            "total_on_start": ops,
            "percent": "100.0%",
            "total_time_in_millis": e.get("total_time_in_millis", 0),
        },
        "verify_index": {"check_index_time_in_millis": 0,
                         "total_time_in_millis": 0},
        # what checkpoint-based recovery negotiates on (index/seqno.py)
        "seq_no": sh.engine.seq_no_stats(),
    }


def _recovery_json(n: Node, p, b, index: Optional[str] = None):
    """RestRecoveryAction: real RecoveryState JSON driven by each index's
    RecoveryRegistry (index/recovery.py) — type GATEWAY for a primary
    recovered from local state (the 2.0 name; EMPTY_STORE is the 5.x
    rename), REPLICA for copies, with stage/mode/ops counters from the
    actual recovery executions. ?active_only=true filters to in-flight
    streams (the reference param)."""
    active_only = str(p.get("active_only", "false")).lower() \
        in ("", "true")
    out = {}
    for iname in _resolve_indices_options(n, index, p):
        svc = n.indices[iname]
        shards = []
        for g in svc.groups:
            entries = svc.recoveries.entries(g.shard_id)
            if active_only:
                entries = [e for e in entries
                           if e["stage"] not in ("done", "failed")]
            for e in entries:
                tgt = g.primary
                if e["type"] == "replica" and g.replicas:
                    tgt = g.replicas[0]
                shards.append(_recovery_entry_json(
                    n, tgt, e["type"] == "gateway", e))
            if not entries and not active_only:
                # no recorded recovery (a fresh in-memory shard): a
                # synthetic DONE gateway row keeps the 2.0 shape
                for sh in g.copies:
                    shards.append(_recovery_entry_json(
                        n, sh, sh is g.primary,
                        {"type": "gateway" if sh is g.primary
                         else "replica", "stage": "done"}))
        out[iname] = {"shards": shards}
    return 200, out


def _upgrade(n: Node, p, b, index: Optional[str] = None):
    """RestUpgradeAction. Segments here have no versioned on-disk codec to
    migrate (device arrays are regenerated from _source at freeze), so
    upgrade completes with zero bytes to recover — the same response shape
    a fully-current Lucene index returns."""
    names = n.resolve_indices(index)
    total = sum(n.indices[x].num_shards for x in names)
    return 200, {"_shards": {"total": total, "successful": total, "failed": 0},
                 "upgraded_indices": {x: {"upgrade_version": "2.0.0"}
                                      for x in names}}


def _get_upgrade(n: Node, p, b, index: Optional[str] = None):
    names = n.resolve_indices(index)
    return 200, {"indices": {x: {"size_to_upgrade_in_bytes": 0,
                                 "size_to_upgrade_ancient_in_bytes": 0}
                             for x in names}}


def _clear_cache(n: Node, p, b, index: Optional[str] = None):
    """RestClearIndicesCacheAction. The port's cache tiers: compiled
    scripts, the suggest vocabulary cache and the per-segment bigram and
    completion caches, and each index's query cache (the reference also
    drops its jit-compiled IVF probe programs, which eager PyTorch does
    not keep). Segment arrays themselves are the index, not a cache, and
    stay resident."""
    from elasticsearch_tpu_torch.search import scripting as _scr
    from elasticsearch_tpu_torch.search import suggest as _sug

    _scr._CACHE.clear()
    if getattr(_sug, "_VOCAB_CACHE", None) is not None:
        _sug._VOCAB_CACHE.clear()
    names = n.resolve_indices(index)
    total = 0
    for iname in names:
        svc = n.indices[iname]
        total += svc.num_shards
        svc.clear_query_cache()  # shard query cache is part of the contract
        for shard in svc.shards:
            for seg in shard.segments:
                for attr in ("_bigram_cache", "_completion_cache"):
                    if hasattr(seg, attr):
                        delattr(seg, attr)
    return 200, {"_shards": {"total": total, "successful": total, "failed": 0}}


def _percolate_count(n: Node, p, b, index: str, type: str):
    """RestPercolateAction count form (count_percolate.json)."""
    c = _mh(n)
    if c is not None and not p.get("_local_only") \
            and c.data.resolve_index(index) in c.dist_indices:
        status, res = _dist_percolate(n, c, index, type, _json(b))
        return status, {"total": res["total"], "_shards": res["_shards"]}
    svc = n.get_index(index)
    res = svc.percolate(_json(b))
    return 200, {"total": res["total"], "_shards": {
        "total": svc.num_shards, "successful": svc.num_shards, "failed": 0}}


def _mpercolate(n: Node, p, b, index: Optional[str] = None):
    """RestMultiPercolateAction: NDJSON of {percolate: header} / doc pairs."""
    c = _mh(n)
    lines = _ndjson(b)
    responses = []
    for i in range(0, len(lines) - 1, 2):
        head = lines[i].get("percolate", {})
        iname = head.get("index", index)
        try:
            if (c is not None and not p.get("_local_only") and iname
                    and c.data.resolve_index(iname) in c.dist_indices):
                _st, res = _dist_percolate(
                    n, c, iname, head.get("type", "_all"), lines[i + 1])
                responses.append(res)
                continue
            svc = n.get_index(iname)
            responses.append(svc.percolate(lines[i + 1]))
        except ElasticsearchTpuException as e:
            legacy = {"index_not_found_exception": "IndexMissingException"}
            nm = legacy.get(e.error_type, e.error_type)
            responses.append({"error": f"{nm}[{e}]", "status": e.status})
    return 200, {"responses": responses}


def _mtermvectors(n: Node, p, b, index: Optional[str] = None,
                  doc_type: Optional[str] = None):
    """RestMultiTermVectorsAction: {docs: [{_index,_id,...}]}, body ids,
    or the ?ids= query-param form with a path index."""
    body = _json(b)
    docs = body.get("docs")
    if docs is None:
        ids = body.get("ids")
        if ids is None and p.get("ids"):
            ids = [x for x in str(p["ids"]).split(",") if x]
        docs = [{"_index": index, "_id": i} for i in (ids or [])]
    out = []
    for d in docs:
        iname = d.get("_index", index)
        did = d.get("_id")
        sub = {k: v for k, v in d.items() if not k.startswith("_")}
        try:
            status, tv = _termvectors(n, dict(p), json.dumps(sub).encode(),
                                      iname, str(did))
            tv.setdefault("_index", iname)
            out.append(tv)
        except ElasticsearchTpuException as e:
            out.append({"_index": iname, "_id": did,
                        "error": _error_body(e)["error"]})
    return 200, {"docs": out}


def _mlt(n: Node, p, b, index: str, type: str, id: str):
    """RestMoreLikeThisAction (mlt.json, GET /{index}/{type}/{id}/_mlt):
    runs a more_like_this query seeded with the stored doc."""
    fields = p.get("mlt_fields")
    like = {"_index": index, "_id": id}
    q: Dict[str, Any] = {"like": [like],
                         "min_term_freq": int(p.get("min_term_freq", 2)),
                         "min_doc_freq": int(p.get("min_doc_freq", 5))}
    if fields:
        q["fields"] = [f.strip() for f in fields.split(",")]
    body = _json(b) or {}
    body.setdefault("query", {"more_like_this": q})
    return 200, n.search(index, body)


def _search_exists(n: Node, p, b, index: str):
    """RestSearchExistsAction: terminate after the first hit."""
    body = _search_body(p, b)
    body["size"] = 0
    body["terminate_after"] = 1
    res = n.search(index, body)
    total = res["hits"]["total"]
    total = total["value"] if isinstance(total, dict) else total
    if total == 0:
        return 404, {"exists": False}
    return 200, {"exists": True}


def _search_shards(n: Node, p, b, index: str):
    """RestClusterSearchShardsAction: which shard copies a search fans out
    to (query-then-fetch scatter targets)."""
    nodes = {n.node_id: {"name": n.name,
                         "transport_address": "local[in-process]"}}
    groups = []
    indices_meta = {}
    for iname in n.resolve_indices(index):
        svc = n.indices[iname]
        indices_meta[iname] = {}
        for g in svc.groups:
            groups.append([{
                "index": iname, "shard": sh.shard_id,
                "node": n.node_id, "primary": sh is g.primary,
                "state": sh.state,
            } for sh in g.copies])
    return 200, {"nodes": nodes, "indices": indices_meta, "shards": groups}


def _snapshot_status(n: Node, p, b, repo: Optional[str] = None,
                     snap: Optional[str] = None):
    """RestSnapshotsStatusAction: per-snapshot shard accounting from the
    manifest (all our snapshots are complete by the time the manifest is
    written, so stage is always DONE)."""
    if repo is None:
        return 200, {"snapshots": []}
    r = _repo_or_404(n, repo)
    names = [snap] if snap else r.catalog()
    out = []
    for name in names:
        from elasticsearch_tpu_torch.index.snapshots import snapshot_info

        info = snapshot_info(r, name)
        manifest = r.get_manifest(name)
        shard_count = sum(len(i["shards"])
                         for i in manifest["indices"].values())
        out.append({
            "snapshot": name, "repository": repo,
            "state": info.get("state", "SUCCESS"),
            "shards_stats": {"done": shard_count, "failed": 0,
                             "total": shard_count},
            "indices": {iname: {"shards_stats": {"done": len(im["shards"]),
                                                 "total": len(im["shards"])}}
                        for iname, im in manifest["indices"].items()},
        })
    return 200, {"snapshots": out}


def _verify_repo(n: Node, p, b, repo: str):
    """RestVerifyRepositoryAction: prove the repository location is
    writable by round-tripping a marker blob."""
    import os as _os

    r = _repo_or_404(n, repo)
    if getattr(r, "readonly", False):
        # url repositories are read-only: verification never writes
        # (reference: URLRepository has no write verification marker)
        return 200, {"nodes": {n.node_id: {"name": n.name}}}
    probe = _os.path.join(r.location, f".verify-{n.node_id}")
    try:
        with open(probe, "w") as fh:
            fh.write("ok")
        _os.unlink(probe)
    except OSError as e:
        raise IllegalArgumentException(
            f"repository [{repo}] location not writable: {e}")
    return 200, {"nodes": {n.node_id: {"name": n.name}}}


def _put_script(n: Node, p, b, lang: str, id: str):
    """RestPutIndexedScriptAction → ScriptService indexed scripts."""
    from elasticsearch_tpu_torch.search import scripting

    body = _json(b)
    src = body.get("script", body.get("source", ""))
    if isinstance(src, dict):
        src = src.get("inline", src.get("source", ""))
    if lang not in ("groovy", "painless", "painless-lite", "expression",
                    "mustache"):
        raise IllegalArgumentException(f"script_lang not supported [{lang}]")
    created = scripting.get_stored_script(lang, id) is None
    from elasticsearch_tpu_torch.utils.errors import ScriptException

    try:
        ver = scripting.store_script(
            lang, id, src, version=p.get("version"),
            version_type=p.get("version_type", "internal"))
    except ScriptException as e:
        # reference message shape (GroovyScriptEngineService compile
        # failures): "Unable to parse ..."
        raise ScriptException(f"Unable to parse [{src}]: {e}")
    return (201 if created else 200), {"_id": id, "created": created,
                                       "_version": ver}


def _get_script(n: Node, p, b, lang: str, id: str):
    from elasticsearch_tpu_torch.search import scripting
    from elasticsearch_tpu_torch.utils.errors import VersionConflictException

    src = scripting.get_stored_script(lang, id)
    if src is None:
        return 404, {"_id": id, "found": False, "lang": lang,
                     "_index": ".scripts"}
    ver = scripting.stored_script_version(lang, id)
    if (p.get("version") is not None
            and p.get("version_type") != "force"
            and ver != int(p["version"])):
        raise VersionConflictException(".scripts", id, ver or 0,
                                       int(p["version"]))
    return 200, {"_id": id, "found": True, "lang": lang, "script": src,
                 "_version": ver}


def _delete_script(n: Node, p, b, lang: str, id: str):
    """DELETE /_scripts/{lang}/{id}: indexed scripts live in the
    .scripts index, so the response carries document-delete versioning
    (the tombstone bumps the version)."""
    from elasticsearch_tpu_torch.search import scripting

    ver = scripting.stored_script_version(lang, id)
    found = scripting.delete_stored_script(
        lang, id, version=p.get("version"),
        version_type=p.get("version_type", "internal"))
    body = {"_id": id, "found": found, "_index": ".scripts",
            "lang": lang,
            # the reference reports version 1 for a missing-doc delete
            "_version": ((ver or 0) + 1) if found else 1}
    return (200 if found else 404), body


# -- rest-api-spec sweep: root-scoped and typed route forms ------------------
# (tests/integration/test_rest_spec_coverage.py asserts every path x method
# of the reference's rest-api-spec/api/*.json resolves in our route table)

def _get_mapping_index(n: Node, p, b, index: str):
    """GET /{index}/_mapping honoring expand_wildcards (incl. `none`,
    which expands wildcards to nothing → empty 200 body)."""
    if "expand_wildcards" in p and any(c in str(index) for c in "*?"):
        names = _resolve_indices_options(n, index, p)
        out = {}
        for nm in names:
            out.update(n.get_mapping(nm))
        return 200, out
    return 200, n.get_mapping(index)


def _get_mapping_root(n: Node, p, b, type: Optional[str] = None):
    """GET /_mapping[/{type}] (indices.get_mapping root forms)."""
    if type:
        return _get_mapping_typed(n, p, b, None, type)
    return 200, n.get_mapping(None)


def _type_name_matches(svc, pat: str):
    """Type names of `svc` matching a pattern/comma/_all expression. The
    single-type model records typed-mapping block names in
    mappings.type_names; '_doc' stands in when none were declared."""
    import fnmatch

    known = list(svc.mappings.type_names) or ["_doc"]
    out = []
    for part in str(pat).split(","):
        part = part.strip()
        if part in ("_all", "*", ""):
            out.extend(known)
        else:
            out.extend(t for t in known if fnmatch.fnmatch(t, part))
    return sorted(dict.fromkeys(out))


def _get_mapping_typed(n: Node, p, b, index: Optional[str], type: str):
    """GET [/{index}]/_mapping/{type}: mappings keyed by the matched type
    names. A missing INDEX 404s; a missing type reads back {} (the
    RestGetMappingAction distinction)."""
    names = n.resolve_indices(index)
    if not names and index not in (None, "", "_all", "*") \
            and "*" not in str(index):
        raise IndexNotFoundException(index)
    out = {}
    for iname in names:
        svc = n.indices[iname]
        tnames = _type_name_matches(svc, type)
        if tnames:
            mj = svc.mappings.to_json()
            out[iname] = {"mappings": {t: mj for t in tnames}}
    if not out:
        return 200, {}  # missing types read back empty (RestGetMapping)
    return 200, out


def _typed_mapping_body(type: Optional[str], body: dict) -> dict:
    """A path {type} wraps an untyped body so Mappings.merge records the
    type name (response echo / exists_type)."""
    if type and type not in body:
        return {type: body}
    return body


def _put_mapping_root(n: Node, p, b, type: Optional[str] = None):
    """PUT/POST /_mapping/{type}: apply to every index (all-or-nothing per
    index set, same as MetaDataMappingService over a wildcard)."""
    return 200, n.put_mapping(None, _typed_mapping_body(type, _json(b)))


def _get_settings_name(n: Node, p, b, index: Optional[str], name: str):
    """GET /{index}/_settings/{name}: filter setting keys by pattern —
    comma lists, wildcards, and _all (= no filtering) all valid."""
    import fnmatch

    st, out = _get_settings(n, p, b, index)
    pats = [x.strip() for x in str(name).split(",") if x.strip()]
    if any(pt in ("_all", "*") for pt in pats):
        return st, out

    def keep(k: str) -> bool:
        return any(fnmatch.fnmatch(k, pt) for pt in pats)

    for entry in out.values():
        if "index" in entry["settings"]:
            idx = entry["settings"]["index"]
            entry["settings"]["index"] = {
                k: v for k, v in idx.items()
                if keep(f"index.{k}") or keep(k)}
        else:  # flat_settings form
            entry["settings"] = {k: v for k, v in entry["settings"].items()
                                 if keep(k)}
    return st, out


def _get_settings_root(n: Node, p, b, name: Optional[str] = None):
    """GET /_settings[/{name}] — {name} filters setting keys (wildcard).
    An empty cluster answers 200 {} (only a concrete missing index 404s)."""
    if not n.indices:
        return 200, {}
    if name:
        return _get_settings_name(n, p, b, None, name)
    return _get_settings(n, p, b, None)


def _put_settings_root(n: Node, p, b):
    from elasticsearch_tpu_torch.cluster.metadata import update_index_settings

    body = _json(b)
    for iname in n.resolve_indices(None):
        update_index_settings(n.indices[iname], body, node=n)
    return 200, {"acknowledged": True}


_INDEX_FEATURES = {"_settings": "_settings", "_mappings": "_mappings",
                   "_mapping": "_mappings", "_aliases": "_aliases",
                   "_alias": "_aliases", "_warmers": "_warmers",
                   "_warmer": "_warmers"}


def _get_index_feature(n: Node, p, b, index: str, feature: str):
    """GET /{index}/{feature} (indices.get): feature is a comma list of
    _settings/_mappings/_aliases/_warmers. Registered after every literal
    /{index}/_x route, so only unclaimed segments land here."""
    feats = set()
    for f in feature.split(","):
        f = f.strip()
        if f not in _INDEX_FEATURES:
            raise IllegalArgumentException(f"unknown index feature [{f}]")
        feats.add(_INDEX_FEATURES[f])
    out = {}
    _st, settings_out = (_get_settings(n, p, b, index)
                         if "_settings" in feats else (200, {}))
    for iname in _expand_wildcards(n, n.resolve_indices(index), index, p):
        svc = n.indices[iname]
        entry: Dict[str, Any] = {}
        if "_settings" in feats:
            entry.update(settings_out.get(iname, {}))
        if "_mappings" in feats:
            mj = svc.mappings.to_json()
            entry["mappings"] = ({t: mj for t in svc.mappings.type_names}
                                 if svc.mappings.type_names else mj)
        if "_aliases" in feats:
            entry["aliases"] = svc.aliases
        if "_warmers" in feats:
            entry["warmers"] = {k: {"source": v}
                                for k, v in svc.warmers.items()}
        out[iname] = entry
    if not out:
        raise IndexNotFoundException(index)
    return 200, out


def _warmer_name_match(k: str, name: Optional[str]) -> bool:
    import fnmatch

    if name in (None, "", "_all", "*"):
        return True
    return any(fnmatch.fnmatch(k, pat.strip()) for pat in str(name).split(","))


def _get_warmers_root(n: Node, p, b, name: Optional[str] = None):
    """GET /_warmer[/{name}] across all indices ({name}: pattern/comma/
    _all). The unnamed form lists every index (empty maps included); a
    name only the indices carrying a match."""
    out = {}
    for iname in n.resolve_indices(None):
        svc = n.indices[iname]
        ws = {k: {"source": v} for k, v in svc.warmers.items()
              if _warmer_name_match(k, name)}
        if ws or name is None:
            out[iname] = {"warmers": ws}
    return 200, out


def _put_warmer_root(n: Node, p, b, name: str):
    """PUT/POST /_warmer/{name}: register on every index."""
    body = _json(b)
    for iname in n.resolve_indices(None):
        n.indices[iname].warmers[name] = body
    return 200, {"acknowledged": True}


def _index_any_alias(n: Node, p, b, index: str):
    """HEAD /{index}/_alias — any alias at all on the target indices."""
    for iname in n.resolve_indices(index):
        if n.indices[iname].aliases:
            return 200, None
    return 404, None


def _percolate_count_existing(n: Node, p, b, index: str, type: str, id: str):
    """GET/POST /{index}/{type}/{id}/_percolate/count (count_percolate
    existing-doc form)."""
    status, res = _percolate_existing(n, p, b, index, type, id)
    svc = n.get_index(index)
    return status, {"total": res.get("total", 0), "_shards": {
        "total": svc.num_shards, "successful": svc.num_shards, "failed": 0}}


def _index_doc_auto_typed(n: Node, p, b, index: str, type: str):
    """POST/PUT /{index}/{type} — auto-id index with an explicit type.
    Registered LAST: any unclaimed /_x segment must not become a type.
    Delegates to _index_doc so version/op_type/parent/timestamp/ttl params
    behave identically to every other index route."""
    if type.startswith("_") and type != "_all":
        raise IllegalArgumentException(f"unsupported path [{index}/{type}]")
    return _index_doc(n, p, b, index, None, doc_type=type)


def _doc_exists_typed(n: Node, p, b, index: str, type: str, id: str):
    if type.startswith("_") and type != "_all":
        raise IllegalArgumentException(f"unsupported path [{index}/{type}/{id}]")
    _check_read_routing(n, index, type, id, p)
    if _type_mismatch(n, index, type, id,
                      p.get("routing") or p.get("parent")):
        return 404, None
    return _doc_exists(n, p, b, index, id)


def _type_exists_head(n: Node, p, b, index: str, type: str):
    if type.startswith("_"):
        raise IllegalArgumentException(f"unsupported path [{index}/{type}]")
    return _type_exists(n, p, b, index, type)


def _typed(handler, keep_type: bool = False):
    """Wrap a handler for a /{index}/{type}/... route: a {type} segment
    that starts with an underscore is a mis-bound meta path, not a type —
    reject it instead of silently serving (the reference answers 400 'no
    handler'). keep_type forwards the validated type to handlers that use
    it (percolate, mlt, exists_type)."""
    def h(n, p, b, **kw):
        t = kw.get("type", "")
        if t.startswith("_") and t != "_all":
            raise IllegalArgumentException(f"unsupported path segment [{t}]")
        if not keep_type:
            kw.pop("type", None)
        return handler(n, p, b, **kw)
    return h


def _cat_thread_pool(n: Node, p, b):
    """One row per node, 2.0 columns (bulk/index/search counters); the
    per-pool detail rows come via ?pools=true (format=json). Both forms
    honor the reference's `h=` column selection (RestTable), and the
    pool rows carry `largest`/`queue_size` so saturation history is
    readable without /_nodes/stats."""
    stats = n.thread_pool.stats()
    if str(p.get("pools", "false")).lower() in ("", "true"):
        rows = [
            {"node_name": n.name, "name": name, "active": st["active"],
             "queue": st["queue"], "queue_size": st["queue_size"],
             "rejected": st["rejected"], "threads": st["threads"],
             "largest": st["largest"], "completed": st["completed"]}
            for name, st in stats.items()]
        # _CatRows so the ONE serialization layer (_cat_table /
        # _cat_json_rows) applies h= selection exactly like every other
        # _cat endpoint; default = every column, so format=json keeps
        # threads/queue_size for existing consumers
        return 200, _cat_rows(rows, ["node_name", "name", "active",
                                     "queue", "queue_size", "rejected",
                                     "threads", "largest", "completed"])
    def c(pool, key):
        return str(stats.get(pool, {}).get(key, 0))
    row = {
        "host": "localhost", "ip": "127.0.0.1",
        "bulk.active": c("bulk", "active"),
        "bulk.queue": c("bulk", "queue"),
        "bulk.rejected": c("bulk", "rejected"),
        "index.active": c("index", "active"),
        "index.queue": c("index", "queue"),
        "index.rejected": c("index", "rejected"),
        "search.active": c("search", "active"),
        "search.queue": c("search", "queue"),
        "search.rejected": c("search", "rejected"),
    }
    # selectable extras + the reference's short aliases (RestThreadPool-
    # Action SUPPORTED_NAMES/ALIASES): <x>a/<x>q/<x>r per pool, pid/id/
    # h/i/po for the node columns
    row.update({"pid": str(os.getpid()), "id": n.node_id[:4],
                "h": "localhost", "i": "127.0.0.1", "po": "-",
                "port": "-"})
    for pool, alias in (("bulk", "b"), ("flush", "f"), ("generic", "ge"),
                        ("get", "g"), ("index", "i"), ("management", "ma"),
                        ("optimize", "o"), ("percolate", "p"),
                        ("refresh", "r"), ("search", "s"),
                        ("snapshot", "sn"), ("suggest", "su"),
                        ("warmer", "w"), ("listener", "l"),
                        ("fetch_shard_started", "fs"),
                        ("fetch_shard_store", "fss")):
        row[f"{alias}a"] = c(pool, "active")
        row[f"{alias}q"] = c(pool, "queue")
        row[f"{alias}r"] = c(pool, "rejected")
        # full declared detail columns (RestThreadPoolAction table);
        # blanks render as empty cells, exactly like unset pool config
        row.update({
            f"{pool}.type": "fixed",
            f"{pool}.active": c(pool, "active"),
            f"{pool}.size": c(pool, "threads"),
            f"{pool}.queue": c(pool, "queue"),
            f"{pool}.queueSize": "",
            f"{pool}.rejected": c(pool, "rejected"),
            f"{pool}.largest": c(pool, "threads"),
            f"{pool}.completed": c(pool, "completed"),
            f"{pool}.min": "", f"{pool}.max": "",
            f"{pool}.keepAlive": "",
        })
    return 200, _cat_rows([row], [
        "host", "ip", "bulk.active", "bulk.queue", "bulk.rejected",
        "index.active", "index.queue", "index.rejected", "search.active",
        "search.queue", "search.rejected"])


def _cat_help(n: Node, p, b):
    """GET /_cat (cat.help.json): list of cat endpoints."""
    return 200, "\n".join([
        "=^.^=",
        "/_cat/aliases", "/_cat/allocation", "/_cat/count",
        "/_cat/fielddata", "/_cat/health", "/_cat/incidents",
        "/_cat/indices", "/_cat/master",
        "/_cat/nodes", "/_cat/pending_tasks", "/_cat/plugins",
        "/_cat/recovery", "/_cat/repositories", "/_cat/segments",
        "/_cat/shards", "/_cat/snapshots/{repository}", "/_cat/tasks",
        "/_cat/templates", "/_cat/thread_pool",
    ])


_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)(b|kb|mb|gb|tb)$")
_NUM_RE = re.compile(r"^-?\d[\d.]*[a-z%]*$")


class _CatRows(list):
    """Row list carrying a DEFAULT column order: rows may hold extra
    selectable columns (h=...) that the bare listing doesn't print —
    RestTable's declared-vs-displayed column split."""

    default: Optional[List[str]] = None


def _cat_rows(rows: List[dict], default: List[str]) -> "_CatRows":
    out = _CatRows(rows)
    out.default = default
    return out


def _cat_json_rows(rows: List[dict], params: dict) -> List[dict]:
    """format=json row objects restricted to the displayed columns (the
    default set, or the h= selection)."""
    cols = getattr(rows, "default", None)
    if params.get("h"):
        req = [c.strip() for c in str(params["h"]).split(",") if c.strip()]
        cols = [c for c in req if any(c in r for r in rows)]
    if cols is None:
        return list(rows)
    return [{c: r.get(c, "") for c in cols} for r in rows]


def _cat_table(rows: List[dict], params: dict) -> str:
    """Aligned text rendering of _cat rows (RestTable): `h` selects and
    orders columns, `v` prints the header line, `bytes` re-scales size
    values to a fixed unit, numeric columns right-justify (all reference
    client regexes rely on these RestTable behaviors)."""
    if not rows:
        return ""
    cols = getattr(rows, "default", None) or list(rows[0].keys())
    if params.get("h"):
        cols = [c.strip() for c in str(params["h"]).split(",") if c.strip()]
        if getattr(rows, "default", None):
            # endpoints with a declared column table DROP unknown h
            # selections (RestTable; e.g. 2.0 has no merge pool, so
            # h=ma silently disappears from _cat/thread_pool)
            cols = [c for c in cols if any(c in r for r in rows)]
    unit = str(params.get("bytes", "")).lower()
    mult = {"b": 1, "k": 1 << 10, "kb": 1 << 10, "m": 1 << 20,
            "mb": 1 << 20, "g": 1 << 30, "gb": 1 << 30, "t": 1 << 40,
            "tb": 1 << 40}.get(unit)

    def cell(v) -> str:
        v = str(v)
        if mult:
            m = _SIZE_RE.match(v)
            if m:
                raw = float(m.group(1)) * {"b": 1, "kb": 1 << 10,
                                           "mb": 1 << 20, "gb": 1 << 30,
                                           "tb": 1 << 40}[m.group(2)]
                return str(int(raw // mult))
        return v

    table = [[cell(r.get(c, "")) for c in cols] for r in rows]
    # RestTable right-justifies numeric columns (sizes/counts/percents)
    right = [all(_NUM_RE.match(row[i]) for row in table if row[i])
             for i in range(len(cols))]
    header = str(params.get("v", "false")).lower() in ("", "true")
    if header:
        table.insert(0, cols)
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    out = []
    for ri, row in enumerate(table):
        is_header = header and ri == 0
        line = " ".join(
            (v.ljust(w) if is_header or not right[i] else v.rjust(w))
            for i, (v, w) in enumerate(zip(row, widths)))
        out.append(line + " \n")
    return "".join(out)


class RestServer:
    def __init__(self, node: Node, host: str = "127.0.0.1", port: int = 9200):
        self.controller = RestController(node)
        controller = self.controller

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # the headers and the body go out in two sends: with Nagle
            # on, a keep-alive client's delayed ACK holds the body ~40 ms
            # (ROADMAP C21)
            disable_nagle_algorithm = True

            def _handle(self, method: str):
                parsed = urlparse(self.path)
                params = {k: v[0] for k, v in
                          parse_qs(parsed.query,
                                   keep_blank_values=True).items()}
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                # lower-cased header map: the QoS layer reads the tenant
                # id (X-Tenant-Id) case-insensitively, like HTTP demands
                hdrs = {k.lower(): v for k, v in self.headers.items()}
                if (parsed.path.startswith("/_cat/")
                        and str(params.get("help", "false")).lower()
                        in ("", "true", "1")):
                    help_text = _cat_help_text(parsed.path)
                    if help_text is not None:
                        status, payload = 200, help_text
                    else:
                        status, payload = controller.dispatch(
                            method, parsed.path, params, body,
                            headers=hdrs)
                else:
                    status, payload = controller.dispatch(
                        method, parsed.path, params, body, headers=hdrs)
                ctype = "application/json; charset=UTF-8"
                if isinstance(payload, str):
                    # text endpoints (hot_threads, _cat help): raw body
                    data = payload.encode()
                    ctype = "text/plain; charset=UTF-8"
                elif (parsed.path.startswith("/_cat")
                      and isinstance(payload, list)
                      and params.get("format") != "json"):
                    # _cat default form is a text table (format=json opts
                    # into the row-object form)
                    data = _cat_table(payload, params).encode()
                    ctype = "text/plain; charset=UTF-8"
                elif (parsed.path.startswith("/_cat")
                      and isinstance(payload, list)):
                    # format=json renders only the DISPLAYED columns —
                    # declared-but-unselected extras stay internal
                    # (RestTable renders the same column set every format)
                    data = json.dumps(
                        _cat_json_rows(payload, params),
                        default=_json_default).encode()
                else:
                    data = b"" if payload is None else json.dumps(
                        payload, default=_json_default).encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if method != "HEAD" and data:
                    self.wfile.write(data)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_PUT(self):
                self._handle("PUT")

            def do_DELETE(self):
                self._handle("DELETE")

            def do_HEAD(self):
                self._handle("HEAD")

            def log_message(self, fmt, *args):
                pass

        class _Server(ThreadingHTTPServer):
            # socketserver's default listen backlog (5) RESETS concurrent
            # connection bursts — exactly the traffic shape the serving
            # coalescer exists for; deep backlog, bounded work via pools
            request_queue_size = 128
            daemon_threads = True

        self.httpd = _Server((host, port), _Handler)
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self, background: bool = True):
        # a node serving HTTP runs the stall watchdog for as long as it
        # serves (monitor/watchdog.py; ESTPU_WATCHDOG=0 opts out) and
        # replays each index's persisted census through the real search
        # path before traffic lands (serving/warmup.py)
        node = self.controller.node
        self._watchdog = getattr(node, "watchdog", None)
        if self._watchdog is not None:
            self._watchdog.ensure_started()
        wu = getattr(getattr(node, "serving", None), "warmup", None)
        if wu is not None:
            try:
                wu.kick("boot")
            except Exception:  # pre-warm must never block a bind
                pass
        if background:
            self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
            self._thread.start()
        else:
            self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        # the tick thread this server started stops with it
        wd = getattr(self, "_watchdog", None)
        if wd is not None:
            wd.close()


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
