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
         "lengths": f32[max_docs] | None,     # text fields only
         "positions": i32[total positions] | None,  # text fields: the
         "pos_offsets": i64[nnz + 1] | None}},      # positional CSR
     "keywords": {name: {"ords": i32[max_docs], "exists": bool[max_docs],
                         "host_values": [[str] | None]}},
     "numerics": {name: {"exact": i64|f64[max_docs],
                         "exists": bool[max_docs], "kind": str}},
     "vectors": {name: {           # dense_vector fields
         "vecs": f32[max_docs, dims], "exists": bool[max_docs],
         "dims": int, "similarity": str,
         "ivf": {"centroids": f32[C, dims], "lists": i32[C, Lmax],
                 "list_lens": i32[C], "C": int, "Lmax": int,
                 "avg_len": float, "metric": str} | None,
         "pq": {"codebooks": f32[M, K, dsub], "codes": u8[max_docs, M],
                "M": int, "K": int, "dsub": int, "metric": str} | None}}}

A text field's positional CSR (positions aligned with the postings
order, ``pos_offsets`` per posting) is carried with its postings, so
phrase queries read the same positions in both packages.

A built IVF quantizer or PQ tier given under ``vectors`` is placed as it
is, so a carried-across segment answers from the same quantizer as the
reference's (no second k-means run has to agree with the first); without
one, the column builds its own on first use.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from elasticsearch_tpu_torch.index.segment import (TpuSegment, VectorColumn,
                                                   make_inverted,
                                                   make_keyword_column,
                                                   make_numeric,
                                                   make_vector_column)
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
            avg_len=float(f["avg_len"]), max_docs=D, residency=residency,
            pos_offsets=_opt(f.get("pos_offsets"), np.int64),
            positions=_opt(f.get("positions"), np.int32))
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
    vectors = {name: _vector_column(name, v, D, residency)
               for name, v in arrays.get("vectors", {}).items()}
    ids = arrays.get("ids")
    ids = [str(i) for i in range(n)] if ids is None else list(ids)
    sources = arrays.get("sources")
    sources = [None] * n if sources is None else list(sources)
    return TpuSegment(
        num_docs=n, max_docs=D, inverted=inverted, numerics=numerics,
        keywords=keywords, sources=sources, stored=[{}] * n, ids=ids,
        id_map={doc_id: i for i, doc_id in enumerate(ids)},
        field_lengths=lengths, residency=residency,
        live=arrays.get("live"), vectors=vectors)


def _opt(a, dtype):
    return None if a is None else np.asarray(a, dtype)


def _vector_column(name: str, v: Dict[str, Any], D: int,
                   residency: Residency) -> VectorColumn:
    from elasticsearch_tpu_torch.ops.ivf import IvfIndex
    from elasticsearch_tpu_torch.ops.pq import PqHostParts, place_pq

    vecs = np.asarray(v["vecs"], np.float32)
    if vecs.shape != (D, int(v["dims"])):
        raise ValueError(f"vectors [{name}]: slab {vecs.shape} is not "
                         f"[max_docs={D}, dims={v['dims']}]")
    vc = make_vector_column(name, vecs, np.asarray(v["exists"], bool),
                            v.get("similarity", "cosine"), residency)
    ivf = v.get("ivf")
    if ivf is not None:
        put = residency.device_put
        vc._ivf = IvfIndex(
            centroids=put(np.asarray(ivf["centroids"], np.float32)),
            lists=put(np.asarray(ivf["lists"], np.int32)),
            list_lens=put(np.asarray(ivf["list_lens"], np.int32)),
            C=int(ivf["C"]), Lmax=int(ivf["Lmax"]), sentinel=D,
            avg_len=float(ivf["avg_len"]),
            metric=ivf.get("metric", vc.similarity))
    pq = v.get("pq")
    if pq is not None:
        books = np.asarray(pq["codebooks"], np.float32)
        vc._pq_parts = PqHostParts(
            codebooks=books, codes=np.asarray(pq["codes"], np.uint8),
            M=int(pq["M"]), K=int(pq["K"]), dsub=int(pq["dsub"]),
            dims=vc.dims, metric=pq.get("metric", vc.similarity))
        placed = place_pq(vc._pq_parts, residency, label=f"pq[{name}]")
        if placed is not None:
            vc._pq, vc._pq_parts = placed, None
    return vc
