"""The on-disk blob forms: an inverted field, an IVF quantizer, a PQ tier.

Port of elasticsearch_tpu/index/store.py. Every blob is one frame

    [u32be header_len][header JSON][sections...]

whose header lists each section's name, byte length, CRC32 and value
count; sections are varints from the host codec (``native``) or raw
little-endian arrays. The bytes are the JAX package's: a blob either
package writes loads in the other (``tests/test_torch_store.py``).

- postings: offsets (delta), df, cf, doc ids (delta within each term's
  run), tf, position offsets (delta), positions;
- IVF: centroids (f32), lists and list lengths (varints);
- PQ: codebooks (f32) and codes (u8).

``read_ivf`` and ``read_pq`` return the port's own ``IvfIndex`` and
``PqHostParts``: the IVF tensors go through ``place`` (the Node's
residency), the PQ parts stay on the host, since placing their codes is
a breaker charge the caller may retry (``VectorColumn.get_pq``). A short
or damaged blob raises ``CorruptStoreException``.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.native import (crc32, delta_decode, delta_encode,
                                            vbyte_decode, vbyte_encode)
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException

_U32 = struct.Struct(">I")


class CorruptStoreException(ElasticsearchTpuException):
    status = 500
    error_type = "corrupt_index_exception"


def _frame(header: dict, sections: List[Tuple[str, bytes, int]]) -> bytes:
    header = dict(header, sections=[
        {"name": n, "len": len(b), "crc": crc32(b), "count": c}
        for n, b, c in sections])
    hraw = json.dumps(header, separators=(",", ":")).encode()
    return b"".join([_U32.pack(len(hraw)), hraw] + [b for _, b, _ in sections])


def _unframe(data: bytes, kind: str) -> Tuple[dict, Dict[str, Tuple[bytes,
                                                                      int]]]:
    """(header, {section: (raw bytes, count)}), every CRC checked."""
    if len(data) < 4:
        raise CorruptStoreException(f"{kind} blob truncated")
    (hlen,) = _U32.unpack(data[:4])
    if 4 + hlen > len(data):
        raise CorruptStoreException(f"{kind} header exceeds blob size")
    try:
        header = json.loads(data[4: 4 + hlen])
    except (ValueError, UnicodeDecodeError) as e:
        raise CorruptStoreException(f"{kind} header unreadable: {e}")
    cursor = 4 + hlen
    raws: Dict[str, Tuple[bytes, int]] = {}
    for sec in header["sections"]:
        raw = data[cursor: cursor + sec["len"]]
        if len(raw) != sec["len"] or crc32(raw) != sec["crc"]:
            raise CorruptStoreException(
                f"{kind} section [{sec['name']}] failed its checksum")
        cursor += sec["len"]
        raws[sec["name"]] = (raw, sec["count"])
    return header, raws


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _run_deltas(doc_ids: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Gaps within each term's postings run, absolute at run starts."""
    g = doc_ids.astype(np.int64).copy()
    if g.size > 1:
        g[1:] -= doc_ids[:-1].astype(np.int64)
    starts = offsets[1:-1].astype(np.int64)
    starts = starts[(starts > 0) & (starts < g.size)]
    g[starts] = doc_ids[starts]
    return g


def _run_undeltas(g: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    out = g.copy()
    for t in range(len(offsets) - 1):
        s, e = int(offsets[t]), int(offsets[t + 1])
        if e > s:
            out[s:e] = np.cumsum(out[s:e])
    return out


def write_postings(inv) -> bytes:
    """One InvertedField's durable blob."""
    offsets = np.asarray(inv.offsets, dtype=np.int64)
    doc_ids = (inv.doc_ids_host if inv.doc_ids_host is not None
               else np.zeros(0, np.int64)).astype(np.int64)[: inv.nnz]
    tf = (np.asarray(inv.tf_host[: inv.nnz], dtype=np.int64)
          if inv.tf_host is not None else np.ones(inv.nnz, dtype=np.int64))
    pos_off = (np.asarray(inv.pos_offsets, dtype=np.int64)
               if inv.pos_offsets is not None else np.zeros(1, np.int64))
    positions = (np.asarray(inv.positions, dtype=np.int64)
                 if inv.positions is not None else np.zeros(0, np.int64))
    return _frame({
        "field": inv.name,
        "stats": {"nnz": inv.nnz, "num_docs": inv.num_docs,
                  "total_terms": inv.total_terms, "avg_len": inv.avg_len,
                  "max_docs": inv.max_docs},
        "terms": inv.terms,
    }, [
        ("offsets", delta_encode(offsets), offsets.size),
        ("df", vbyte_encode(np.asarray(inv.df, dtype=np.int64)),
         int(inv.df.shape[0])),
        ("cf", vbyte_encode(np.asarray(inv.cf, dtype=np.int64)),
         int(inv.cf.shape[0])),
        ("doc_ids", vbyte_encode(_run_deltas(doc_ids, offsets)),
         doc_ids.size),
        ("tf", vbyte_encode(tf), tf.size),
        ("pos_offsets", delta_encode(pos_off), pos_off.size),
        ("positions", vbyte_encode(positions), positions.size),
    ])


def read_postings(data: bytes) -> Dict[str, Any]:
    """A postings blob back to host arrays."""
    header, raws = _unframe(data, "postings")
    arrays = {name: (delta_decode if name in ("offsets", "pos_offsets")
                     else vbyte_decode)(raw, count)
              for name, (raw, count) in raws.items()}
    arrays["doc_ids"] = _run_undeltas(arrays["doc_ids"], arrays["offsets"])
    return {"field": header["field"], "terms": header["terms"],
            "stats": header["stats"], **arrays}


def write_ivf(ivf) -> bytes:
    """An IvfIndex's blob (centroids f32, padded lists, list lengths)."""
    cents = _host(ivf.centroids).astype(np.float32)
    lists = _host(ivf.lists).astype(np.int64).reshape(-1)
    lens = _host(ivf.list_lens).astype(np.int64)
    return _frame({
        "kind": "ivf",
        "stats": {"C": ivf.C, "Lmax": ivf.Lmax, "sentinel": ivf.sentinel,
                  "avg_len": ivf.avg_len, "metric": ivf.metric,
                  "dims": int(cents.shape[1])},
    }, [
        ("centroids", cents.tobytes(), int(cents.size)),
        ("lists", vbyte_encode(lists), int(lists.size)),
        ("list_lens", vbyte_encode(lens), int(lens.size)),
    ])


def read_ivf(data: bytes, place: Optional[Callable] = None):
    """An IVF blob back to an IvfIndex; ``place`` (a host array -> tensor
    placement, the Node's ``residency.device_put``) puts its tensors where
    they live, on the CPU without one."""
    from elasticsearch_tpu_torch.ops.ivf import IvfIndex

    header, raws = _unframe(data, "ivf")
    st = header["stats"]
    cents = np.frombuffer(raws["centroids"][0], np.float32).reshape(
        st["C"], st["dims"]).copy()
    lists = vbyte_decode(*raws["lists"]).astype(np.int32).reshape(
        st["C"], st["Lmax"])
    lens = vbyte_decode(*raws["list_lens"]).astype(np.int32)
    put = place if place is not None else torch.from_numpy
    return IvfIndex(centroids=put(cents), lists=put(lists),
                    list_lens=put(lens), C=int(st["C"]),
                    Lmax=int(st["Lmax"]), sentinel=int(st["sentinel"]),
                    avg_len=float(st["avg_len"]),
                    metric=st.get("metric", "cosine"))


def write_pq(parts) -> bytes:
    """A PQ tier's blob (codebooks f32, codes u8)."""
    books = _host(parts.codebooks).astype(np.float32)
    codes = _host(parts.codes).astype(np.uint8)
    return _frame({
        "kind": "pq",
        "stats": {"M": parts.M, "K": parts.K, "dsub": parts.dsub,
                  "dims": parts.dims, "metric": parts.metric,
                  "rows": int(codes.shape[0])},
    }, [
        ("codebooks", books.tobytes(), int(books.size)),
        ("codes", codes.tobytes(), int(codes.size)),
    ])


def read_pq(data: bytes):
    """A PQ blob back to host PqHostParts (numpy arrays)."""
    from elasticsearch_tpu_torch.ops.pq import PqHostParts

    header, raws = _unframe(data, "pq")
    st = header["stats"]
    books = np.frombuffer(raws["codebooks"][0], np.float32).reshape(
        st["M"], st["K"], st["dsub"]).copy()
    codes = np.frombuffer(raws["codes"][0], np.uint8).reshape(
        st["rows"], st["M"]).copy()
    return PqHostParts(codebooks=books, codes=codes, M=int(st["M"]),
                       K=int(st["K"]), dsub=int(st["dsub"]),
                       dims=int(st["dims"]), metric=st["metric"])
