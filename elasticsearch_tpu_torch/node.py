"""Node: the top-level runtime holding indices.

Port of elasticsearch_tpu/node.py, slim: create an index, index / get /
delete documents, refresh, single-index search, close. The node owns the
device (``cuda`` unless the caller asks for ``cpu``), one breaker service
and one residency registry, and passes them down to every segment.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.resources.breakers import CircuitBreakerService
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.utils.device import resolve_device
from elasticsearch_tpu_torch.utils.errors import (IllegalArgumentException,
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

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        if name in self.indices:
            raise IndexAlreadyExistsException(name)
        _validate_index_name(name)
        body = body or {}
        self.indices[name] = IndexService(
            name, self.residency, settings=dict(body.get("settings", {})),
            mappings_json=dict(body.get("mappings", {})),
            data_path=self.data_path)
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

    def refresh(self, index: Optional[str] = None) -> dict:
        names = list(self.indices) if index is None else [index]
        for n in names:
            self.get_index(n).refresh()
        return {"_shards": {"total": sum(self.indices[n].num_shards
                                         for n in names),
                            "successful": sum(self.indices[n].num_shards
                                              for n in names),
                            "failed": 0}}

    def search(self, index: str, body: Optional[dict] = None) -> dict:
        return self.get_index(index).search(body or {})

    def close(self):
        for svc in self.indices.values():
            svc.close()
        self.indices.clear()


def _validate_index_name(name: str):
    if not name or name != name.lower() or re.search(r'[\\/*?"<>| ,#]', name) \
            or name.startswith(("_", "-", "+")):
        raise IllegalArgumentException(f"Invalid index name [{name}]")
