"""Carry index state across: build a port segment from host arrays.

For a search engine the index plays the part that weights play for a
model. ``segment_from_arrays`` builds a port ``TpuSegment`` from the numpy
host mirrors a reference segment keeps (or from arrays made directly, as
the product-sized smoke corpus is), so both packages score the same state.

``arrays`` layout::

    {"num_docs": int, "max_docs": int,
     "ids": [str] | None,          # default: str(local id)
     "sources": [dict | None] | None,
     "live": bool[max_docs] | None,
     "fields": {name: {            # inverted text/keyword fields
         "terms": [str], "vocab": {str: int} | None,
         "df": i32[V], "cf": i64[V], "offsets": i64[V+1],
         "doc_ids_host": i32[nnz], "tfnorm_host": f32[nnz],
         "tf_host": f32[nnz], "avg_len": float, "num_docs": int,
         "total_terms": int,
         "lengths": f32[max_docs] | None}},   # text fields only
     "keywords": {name: {"ords": i32[max_docs], "exists": bool[max_docs],
                         "host_values": [[str] | None]}},
     "numerics": {name: {"exact": i64|f64[max_docs],
                         "exists": bool[max_docs], "kind": str}}}
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from elasticsearch_tpu_torch.index.segment import (TpuSegment, make_inverted,
                                                   make_keyword_column,
                                                   make_numeric)
from elasticsearch_tpu_torch.resources.residency import Residency


def segment_from_arrays(arrays: Dict[str, Any],
                        residency: Residency) -> TpuSegment:
    """A port segment on ``residency``'s device holding exactly the state
    described by ``arrays`` (see the module doc)."""
    n = int(arrays["num_docs"])
    D = int(arrays["max_docs"])
    if D < n:
        raise ValueError(f"max_docs {D} < num_docs {n}")
    inverted, lengths = {}, {}
    for name, f in arrays.get("fields", {}).items():
        terms = list(f["terms"])
        vocab = f.get("vocab") or {t: i for i, t in enumerate(terms)}
        inverted[name] = make_inverted(
            name, vocab=vocab, terms=terms,
            df=np.asarray(f["df"], np.int32),
            cf=np.asarray(f["cf"], np.int64),
            offsets=np.asarray(f["offsets"], np.int64),
            doc_ids_host=np.asarray(f["doc_ids_host"], np.int32),
            tf_host=np.asarray(f["tf_host"], np.float32),
            tfnorm_host=np.asarray(f["tfnorm_host"], np.float32),
            num_docs=int(f["num_docs"]), total_terms=int(f["total_terms"]),
            avg_len=float(f["avg_len"]), max_docs=D, residency=residency)
        if f.get("lengths") is not None:
            lengths[name] = residency.device_put(
                np.asarray(f["lengths"], np.float32))
    keywords = {
        name: make_keyword_column(name, np.asarray(c["ords"], np.int32),
                                  np.asarray(c["exists"], bool),
                                  list(c["host_values"]), residency)
        for name, c in arrays.get("keywords", {}).items()}
    numerics = {
        name: make_numeric(name, c["kind"], np.asarray(c["exact"]),
                           np.asarray(c["exists"], bool), residency)
        for name, c in arrays.get("numerics", {}).items()}
    ids = arrays.get("ids")
    ids = [str(i) for i in range(n)] if ids is None else list(ids)
    sources = arrays.get("sources")
    sources = [None] * n if sources is None else list(sources)
    return TpuSegment(
        num_docs=n, max_docs=D, inverted=inverted, numerics=numerics,
        keywords=keywords, sources=sources, stored=[{}] * n, ids=ids,
        id_map={doc_id: i for i, doc_id in enumerate(ids)},
        field_lengths=lengths, residency=residency,
        live=arrays.get("live"))
