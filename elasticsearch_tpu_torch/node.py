"""Node: the top-level runtime holding indices.

Port of elasticsearch_tpu/node.py, slim: create an index, index / get /
delete documents, ``bulk`` (index, create, update and delete items, an
index created on first write), refresh, search over an index
expression, ``msearch``, close. The node owns the device (``cuda`` unless the caller asks for
``cpu``), one breaker service, one residency registry, which it passes
down to every segment, and the serving front-end (``node.serving``): a
search of one index goes through its coalescer, so that concurrent
searches run as one batch (``serving/coalescer.py``), and an ``msearch``
batches its eligible items itself (``search/batch.py``).

``search`` takes an index expression: a name, a comma list, wildcards,
``_all``, ``*`` or None. One index keeps the mesh path and the
coalescer; several run the host loop over all their shards, with the
dfs statistics summed over every searched index and ``indices_boost``
applied before the global merge. A body's ``suggest`` over several
indices runs each index's suggesters and merges their entries
(``execute_suggest_multi``), as ES 2.0 does; the reference's
multi-index route drops the key (ROADMAP C10). A name that is no index
answers 404, also inside a comma list (ES 2.0's answer; the reference
drops such a name). Aliases and closed indices come with ROADMAP A10.
"""
from __future__ import annotations

import fnmatch
import re
from typing import Dict, List, Optional, Tuple

import torch

from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.resources.breakers import CircuitBreakerService
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.search.batch import (msearch_error_entry,
                                                  try_batched_msearch)
from elasticsearch_tpu_torch.search.context import global_stats
from elasticsearch_tpu_torch.search.queries import rewrite_mlt_in_body
from elasticsearch_tpu_torch.search.service import search_shards
from elasticsearch_tpu_torch.search.suggest import execute_suggest_multi
from elasticsearch_tpu_torch.serving import ServingFrontend
from elasticsearch_tpu_torch.utils.device import resolve_device
from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                  IllegalArgumentException,
                                                  IndexAlreadyExistsException,
                                                  IndexNotFoundException)


class Node:
    def __init__(self, name: str = "node-1", data_path: Optional[str] = None,
                 device: Optional[str] = None):
        self.device: torch.device = resolve_device(device)
        self.name = name
        self.data_path = data_path
        self.breakers = CircuitBreakerService()
        self.residency = Residency(self.device, self.breakers)
        self.indices: Dict[str, IndexService] = {}
        # cheap to build: the coalescer's drain thread starts on first use
        self.serving = ServingFrontend(self)

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        if name in self.indices:
            raise IndexAlreadyExistsException(name)
        _validate_index_name(name)
        body = body or {}
        self.indices[name] = IndexService(
            name, self.residency, settings=dict(body.get("settings", {})),
            mappings_json=dict(body.get("mappings", {})),
            data_path=self.data_path, node=self)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": name}

    def get_index(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundException(name)
        return svc

    def index(self, index: str, doc_id: Optional[str], source: dict,
              **kw) -> dict:
        return self.get_index(index).index_doc(doc_id, source, **kw)

    def get(self, index: str, doc_id: str, **kw) -> dict:
        return self.get_index(index).get_doc(doc_id, **kw)

    def delete(self, index: str, doc_id: str, **kw) -> dict:
        return self.get_index(index).delete_doc(doc_id, **kw)

    def bulk(self, operations: List[dict]) -> dict:
        """``_bulk`` over parsed NDJSON lines: an action line ({op: meta})
        then, for index, create and update, its source. Each item answers
        with ``status`` 201 (created) or 200, or with the typed error's
        ``status`` and ``error``; ``errors`` says whether any item
        failed. A child routes by its ``parent`` unless it names a
        routing. (The reference's branch for an index spread over hosts
        has no counterpart here: the port's indices live on one node.)"""
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
                svc = self.get_or_autocreate(index_name)
                if op in ("index", "create"):
                    kw = {}
                    if doc_type and doc_type != "_doc":
                        kw["doc_type"] = doc_type
                    if parent:
                        kw["parent"] = parent
                    r = svc.index_doc(doc_id, source, routing=routing,
                                      op_type=op, **kw)
                    status = 201 if r.get("created") else 200
                elif op == "update":
                    r = svc.update_doc(doc_id, source, routing=routing)
                    status = 200
                elif op == "delete":
                    r = svc.delete_doc(doc_id, routing=routing)
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

    def refresh(self, index: Optional[str] = None) -> dict:
        names = list(self.indices) if index is None else [index]
        for n in names:
            self.get_index(n).refresh()
        return {"_shards": {"total": sum(self.indices[n].num_shards
                                         for n in names),
                            "successful": sum(self.indices[n].num_shards
                                              for n in names),
                            "failed": 0}}

    def resolve_indices(self, expr: Optional[str]) -> List[str]:
        """The indices an expression names, in order, each once: a comma
        list of names and wildcards; ``_all``, ``*``, "" or None name
        every index. A name that is no index raises
        IndexNotFoundException."""
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
                raise IndexNotFoundException(part)
        return list(dict.fromkeys(out))

    def search(self, index: Optional[str], body: Optional[dict] = None
               ) -> dict:
        names = self.resolve_indices(index)
        if not names and index not in (None, "", "_all", "*"):
            raise IndexNotFoundException(str(index))
        body = body or {}
        if len(names) == 1:
            svc = self.indices[names[0]]
            if body.get("search_type") == "dfs_query_then_fetch":
                return svc.search(body)  # never coalesced, as in ES

            def run():
                return svc.search(body)

            # the serving coalescer: eligible bodies of concurrent
            # requests park briefly and run as one batch; a lone request
            # or an ineligible body runs the normal path unchanged
            out = self.serving.coalescer.execute(svc, body, run)
            return out if out is not None else run()
        svcs = [self.indices[n] for n in names]
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
        searchers = [s.searcher for svc in svcs for s in svc.shards]
        if not searchers:
            return {"took": 0, "timed_out": False,
                    "_shards": {"total": 0, "successful": 0, "failed": 0},
                    "hits": {"total": 0, "max_score": None, "hits": []}}
        gs = None
        if body.get("search_type") == "dfs_query_then_fetch":
            # one idf over every searched index (ES's DfsPhase collects
            # over all the request's shards)
            gs = global_stats(seg for svc in svcs for s in svc.shards
                              for seg in s.segments)
        resp = search_shards(searchers, body, index_name=",".join(names),
                             global_stats=gs)
        if body.get("suggest"):
            resp["suggest"] = execute_suggest_multi(
                [(svc.shards, svc.analysis, svc.mappings) for svc in svcs],
                body["suggest"])
        return resp

    def msearch(self, pairs: List[Tuple[dict, dict]]) -> dict:
        """``_msearch`` over (header, body) pairs. When every header names
        the same expression and it resolves to one index, the eligible
        items run as one batch
        (``search/batch.py``: one device pass per segment); the rest run
        one by one through ``search``, and a typed error becomes that
        item's ES-shaped failure entry."""
        pre: List[Optional[dict]] = [None] * len(pairs)
        if len(pairs) >= 2:
            names = {h.get("index") if isinstance(h.get("index"), str)
                     else None for h, _ in pairs}
            if len(names) == 1 and None not in names:
                try:
                    resolved = self.resolve_indices(next(iter(names)))
                except ElasticsearchTpuException:
                    resolved = []
                # one concrete index batches; anything else runs through
                # the sequential search below
                svc = self.indices[resolved[0]] if len(resolved) == 1 \
                    else None
                out = None
                if svc is not None:
                    try:
                        out = try_batched_msearch(svc, [b for _, b in pairs])
                    except ElasticsearchTpuException:
                        # a typed refusal (a breaker denial): each item
                        # runs alone and reports its own error; a device
                        # fault is not typed and propagates
                        out = None
                if out is not None:
                    pre = out
        responses = []
        for (header, body), served in zip(pairs, pre):
            if served is not None:
                responses.append(served)
                continue
            try:
                responses.append(self.search(header.get("index"), body))
            except ElasticsearchTpuException as e:
                responses.append(msearch_error_entry(e))
        return {"responses": responses}

    def close(self):
        # the coalescer first: parked requests resolve before the indices
        # they search close
        self.serving.close()
        for svc in self.indices.values():
            svc.close()
        self.indices.clear()


def _validate_index_name(name: str):
    if not name or name != name.lower() or re.search(r'[\\/*?"<>| ,#]', name) \
            or name.startswith(("_", "-", "+")):
        raise IllegalArgumentException(f"Invalid index name [{name}]")
