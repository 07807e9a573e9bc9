"""Python client facade.

Port of elasticsearch_tpu/client.py (reference: ES's client/Client.java
and support/AbstractClient.java: prepareIndex/prepareSearch/prepareGet/...):
a pythonic facade over an in-process Node (the common embedding) or a
remote REST endpoint (``url=``, http mode), mirroring the elasticsearch-py
surface users migrate from. ``Client()`` with neither builds a ``Node()``,
which lives on the card.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException


class ApiError(ElasticsearchTpuException):
    """An HTTP-mode error with the server's error TYPE and status intact,
    so callers can branch on `e.error_type == "engine_failed_exception"`
    (a failed-closed engine, 503) vs a routing 404 the same way in-process
    embedders catch typed exceptions. Note partial shard failures are NOT
    errors: a degraded `_search` returns HTTP 200 with `_shards.failed>0`
    and `_shards.failures[]` — inspect the response, nothing raises."""

    def __init__(self, msg: str, error_type: str, status: int):
        super().__init__(msg)
        self._remote_type = error_type
        self.status = status

    @property
    def error_type(self) -> str:  # the base derives it from the class name
        return self._remote_type


class Client:
    def __init__(self, node: Optional[Node] = None, url: Optional[str] = None):
        if node is None and url is None:
            node = Node()
        self.node = node
        self.url = url.rstrip("/") if url else None
        self.indices = IndicesClient(self)
        self.cluster = ClusterClient(self)

    # -- transport -------------------------------------------------------------

    def _http(self, method: str, path: str, body=None, ndjson: Optional[str] = None):
        import urllib.request

        data = None
        headers = {"Content-Type": "application/json"}
        if ndjson is not None:
            data = ndjson.encode()
            headers["Content-Type"] = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else None
        except urllib.error.HTTPError as e:
            payload = e.read()
            err = json.loads(payload) if payload else {"status": e.code}
            detail = err.get("error", err)
            err_type = (detail.get("type", "exception")
                        if isinstance(detail, dict) else "exception")
            raise ApiError(json.dumps(detail), err_type, e.code)

    # -- document APIs ---------------------------------------------------------

    def index(self, index: str, body: dict, id: Optional[str] = None,
              refresh: bool = False, **kw) -> dict:
        if self.url:
            path = f"/{index}/_doc/{id}" if id is not None else f"/{index}/_doc"
            path += "?refresh=true" if refresh else ""
            return self._http("PUT" if id is not None else "POST", path, body)
        svc = self.node.get_or_autocreate(index)
        r = svc.index_doc(id, body, **kw)
        if refresh:
            svc.refresh()
        return r

    def get(self, index: str, id: str) -> dict:
        if self.url:
            return self._http("GET", f"/{index}/_doc/{id}")
        return self.node.get_index(index).get_doc(id)

    def exists(self, index: str, id: str) -> bool:
        r = self.get(index, id)
        return bool(r.get("found"))

    def delete(self, index: str, id: str, refresh: bool = False) -> dict:
        if self.url:
            return self._http("DELETE", f"/{index}/_doc/{id}" + ("?refresh=true" if refresh else ""))
        svc = self.node.get_index(index)
        r = svc.delete_doc(id)
        if refresh:
            svc.refresh()
        return r

    def update(self, index: str, id: str, body: dict, refresh: bool = False) -> dict:
        if self.url:
            return self._http("POST", f"/{index}/_update/{id}" + ("?refresh=true" if refresh else ""), body)
        svc = self.node.get_index(index)
        r = svc.update_doc(id, body)
        if refresh:
            svc.refresh()
        return r

    def mget(self, index: str, ids: List[str]) -> dict:
        if self.url:
            return self._http("POST", f"/{index}/_mget", {"ids": ids})
        return self.node.get_index(index).mget(ids)

    def bulk(self, operations: List[dict], refresh: bool = False) -> dict:
        if self.url:
            nd = "\n".join(json.dumps(o) for o in operations) + "\n"
            return self._http("POST", "/_bulk" + ("?refresh=true" if refresh else ""), ndjson=nd)
        r = self.node.bulk(operations)
        if refresh:
            for svc in self.node.indices.values():
                svc.refresh()
        return r

    # -- search APIs -----------------------------------------------------------

    def search(self, index: Optional[str] = None, body: Optional[dict] = None) -> dict:
        if self.url:
            path = f"/{index}/_search" if index else "/_search"
            return self._http("POST", path, body or {})
        return self.node.search(index, body or {})

    def count(self, index: str, body: Optional[dict] = None) -> dict:
        if self.url:
            return self._http("POST", f"/{index}/_count", body or {})
        names = self.node.resolve_indices(index)
        total = sum(self.node.indices[nm].count(body or {})["count"] for nm in names)
        return {"count": total}

    def msearch(self, searches: List[tuple]) -> dict:
        if self.url:
            lines = []
            for header, body in searches:
                lines.append(json.dumps(header))
                lines.append(json.dumps(body))
            return self._http("POST", "/_msearch", ndjson="\n".join(lines) + "\n")
        return self.node.msearch(searches)

    def scroll(self, scroll_id: str) -> dict:
        if self.url:
            return self._http("POST", "/_search/scroll", {"scroll_id": scroll_id})
        from elasticsearch_tpu_torch.search.service import scroll_next

        return scroll_next(scroll_id)

    def info(self) -> dict:
        if self.url:
            return self._http("GET", "/")
        return self.node.info()


class IndicesClient:
    def __init__(self, client: Client):
        self.c = client

    def create(self, index: str, body: Optional[dict] = None) -> dict:
        if self.c.url:
            return self.c._http("PUT", f"/{index}", body or {})
        return self.c.node.create_index(index, body)

    def delete(self, index: str) -> dict:
        if self.c.url:
            return self.c._http("DELETE", f"/{index}")
        return self.c.node.delete_index(index)

    def exists(self, index: str) -> bool:
        if self.c.url:
            try:
                self.c._http("GET", f"/{index}/_settings")
                return True
            except Exception:
                return False
        return self.c.node.index_exists(index)

    def refresh(self, index: str) -> dict:
        if self.c.url:
            return self.c._http("POST", f"/{index}/_refresh")
        for n in self.c.node.resolve_indices(index):
            self.c.node.indices[n].refresh()
        return {"_shards": {"successful": 1}}

    def flush(self, index: str) -> dict:
        if self.c.url:
            return self.c._http("POST", f"/{index}/_flush")
        for n in self.c.node.resolve_indices(index):
            self.c.node.indices[n].flush()
        return {"_shards": {"successful": 1}}

    def forcemerge(self, index: str, max_num_segments: int = 1) -> dict:
        if self.c.url:
            return self.c._http("POST", f"/{index}/_forcemerge?max_num_segments={max_num_segments}")
        for n in self.c.node.resolve_indices(index):
            self.c.node.indices[n].force_merge(max_num_segments)
        return {"_shards": {"successful": 1}}

    def put_mapping(self, index: str, body: dict) -> dict:
        if self.c.url:
            return self.c._http("PUT", f"/{index}/_mapping", body)
        return self.c.node.put_mapping(index, body)

    def get_mapping(self, index: str) -> dict:
        if self.c.url:
            return self.c._http("GET", f"/{index}/_mapping")
        return self.c.node.get_mapping(index)

    def put_alias(self, index: str, alias: str) -> dict:
        return self.update_aliases([{"add": {"index": index, "alias": alias}}])

    def update_aliases(self, actions: List[dict]) -> dict:
        if self.c.url:
            return self.c._http("POST", "/_aliases", {"actions": actions})
        return self.c.node.update_aliases(actions)

    def put_template(self, name: str, body: dict) -> dict:
        if self.c.url:
            return self.c._http("PUT", f"/_template/{name}", body)
        return self.c.node.put_template(name, body)

    def stats(self, index: str) -> dict:
        if self.c.url:
            return self.c._http("GET", f"/{index}/_stats")
        return self.c.node.get_index(index).stats()

    def analyze(self, index: Optional[str] = None, body: Optional[dict] = None) -> dict:
        if self.c.url:
            path = f"/{index}/_analyze" if index else "/_analyze"
            return self.c._http("POST", path, body or {})
        from elasticsearch_tpu_torch.rest.server import _do_analyze
        from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry

        if index:
            svc = self.c.node.get_index(index)
            return _do_analyze(svc.analysis, body or {}, svc)
        return _do_analyze(AnalysisRegistry(), body or {})


class ClusterClient:
    def __init__(self, client: Client):
        self.c = client

    def health(self) -> dict:
        if self.c.url:
            return self.c._http("GET", "/_cluster/health")
        return self.c.node.cluster_state.health()

    def state(self) -> dict:
        if self.c.url:
            return self.c._http("GET", "/_cluster/state")
        return self.c.node.cluster_state.to_json()

    def stats(self) -> dict:
        if self.c.url:
            return self.c._http("GET", "/_cluster/stats")
        from elasticsearch_tpu_torch.rest.server import _cluster_stats

        return _cluster_stats(self.c.node, {}, b"")[1]
