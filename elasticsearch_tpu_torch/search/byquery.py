"""The scan-until-dry loop of delete-by-query and update-by-query.

Port of elasticsearch_tpu/search/byquery.py (reference: ES's
AbstractAsyncBulkByScrollAction, a scroll-driven scan feeding bulk
writes, rescanned because the writes shift the results). The caller's
``apply_fn`` does the per-document write (a delete or an update). The
REST handlers ``_delete_by_query`` and ``_update_by_query``
(``rest/server.py``) call it under a registered task, so ``POST
/_tasks/{id}/_cancel`` stops a run between docs. On a distributed
index each primary owner runs it over its own shards
(cluster/search_action.py::_on_by_query), as a child of the
coordinator's task.
"""
from __future__ import annotations

from typing import Callable, Optional, Set

from elasticsearch_tpu_torch.tracing.tasks import check_cancelled


def scan_ids(svc, query: Optional[dict], seen: Set[str]) -> list:
    """One scan round of unseen matching ids, each once (custom routing
    can place one id on several shards, so it can surface twice in one
    page)."""
    resp = svc.search({"query": query or {"match_all": {}},
                       "size": 10_000, "_source": False})
    out, new = [], set()
    for h in resp["hits"]["hits"]:
        if h["_id"] not in seen and h["_id"] not in new:
            new.add(h["_id"])
            out.append(h["_id"])
    return out


def run_by_query(svc, query: Optional[dict],
                 apply_fn: Callable[[str, object], None]) -> Set[str]:
    """Scan until dry, calling ``apply_fn(doc_id, loc)`` for every live
    copy of each matching doc (``loc`` carries the stored routing, type
    and parent; None when the location table has no entry), with a
    refresh between rounds so the writes shift the next scan. Returns the
    ids processed; the caller shapes counts and failures in ``apply_fn``.

    A checkpoint (``tracing/tasks.py::check_cancelled``) runs before
    every scan round and every doc: a cancelled task stops between docs,
    with what it applied so far kept."""
    seen: Set[str] = set()
    while True:
        check_cancelled()
        ids = scan_ids(svc, query, seen)
        if not ids:
            return seen
        for doc_id in ids:
            check_cancelled()
            seen.add(doc_id)
            for loc in (svc.find_doc_locations(doc_id) or [None]):
                apply_fn(doc_id, loc)
        svc.refresh()


def failure_entry(index: str, doc_id: str, e) -> dict:
    return {"index": index, "id": doc_id, "status": e.status,
            "cause": {"type": e.error_type, "reason": str(e)}}
