"""Segment: immutable, device-resident columnar index structures.

Port of elasticsearch_tpu/index/segment.py. A frozen segment keeps every
searchable structure as a padded tensor on the owning node's device:

- per indexed field a flattened CSR postings list (``doc_ids``, ``tf``,
  ``tfnorm`` with BM25 tf-normalization precomputed at freeze,
  ``term_ids``), padded to a power-of-two length with the ``max_docs``
  sentinel doc id, plus host ``offsets`` and the term dictionary;
- per doc-value field a dense column padded to ``max_docs`` (64-bit
  values keep an exact int32 (hi, lo) pair for range masks);
- per dense_vector field a ``[max_docs, dims]`` f32 slab with its exists
  mask, and per its ``index_options`` an IVF quantizer and a PQ tier,
  built at freeze on the slab's device;
- the live mask (host-authoritative, device copy refreshed lazily);
- ``_source``, ids and stored fields stay on the host.

``max_docs = pow2_bucket(n, minimum=64)`` and the postings padding follow
the reference exactly, so doc ids and shapes match it one for one.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field as dfield
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.index.doc_parser import ParsedDocument
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.ops.scoring import f64_order_keys
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.utils.shapes import pad_to, pow2_bucket

# BM25 constants (Lucene BM25Similarity defaults, k1=1.2 b=0.75)
K1 = 1.2
B = 0.75

#: most bytes one dense impact block may take on the device
DENSE_BUDGET_BYTES = 1 << 30


def split_i64(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split int64 into an order-preserving (hi, lo) int32 pair:
    (hi1, lo1) < (hi2, lo2) lexicographically iff v1 < v2."""
    v = v.astype(np.int64)
    hi = (v >> 32).astype(np.int32)
    lo = ((v & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)
    return hi, lo


def build_dense_impact(
    doc_ids_host: np.ndarray,
    tfnorm_host: np.ndarray,
    offsets: np.ndarray,
    df: np.ndarray,
    max_docs: int,
    *,
    df_threshold: Optional[int] = None,
    budget_bytes: int = DENSE_BUDGET_BYTES,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Dense impact block for frequent terms (hybrid dense/sparse scoring).

    Terms with df >= max(128, D/256) become rows of an ``impact[F_pad, D]``
    matrix (tfnorm at each posting, 0 elsewhere); the short tail stays CSR.
    The row cap comes from ``budget_bytes`` on the PADDED row count, rounded
    down to a power of two, keeping the highest-df terms.

    Returns (dense_rows int32[V] with -1 for sparse terms, impact
    f32[F_pad, D]) or None when no term qualifies.
    """
    V = df.shape[0]
    if V == 0:
        return None
    if df_threshold is None:
        df_threshold = max(128, max_docs // 256)
    cand = np.nonzero(df >= df_threshold)[0]
    if cand.size == 0:
        return None
    max_rows = int(budget_bytes // (4 * max_docs))
    if max_rows < 8:  # F_pad minimum is 8
        return None
    max_rows = 1 << (max_rows.bit_length() - 1)
    if cand.size > max_rows:
        cand = cand[np.argsort(-df[cand], kind="stable")[:max_rows]]
        cand.sort()
    F_pad = pow2_bucket(cand.size, minimum=8)
    dense_rows = np.full(V, -1, dtype=np.int32)
    dense_rows[cand] = np.arange(cand.size, dtype=np.int32)
    impact = np.zeros((F_pad, max_docs), dtype=np.float32)
    for row, tid in enumerate(cand):
        s, e = int(offsets[tid]), int(offsets[tid + 1])
        impact[row, doc_ids_host[s:e]] = tfnorm_host[s:e]
    return dense_rows, impact


@dataclass
class InvertedField:
    """Frozen inverted index for one field (text or keyword)."""

    name: str
    vocab: Dict[str, int]  # term -> term id (host)
    terms: List[str]  # term id -> term
    df: np.ndarray  # int32[V] doc freq
    cf: np.ndarray  # int64[V] collection (total term) freq
    offsets: np.ndarray  # int64[V+1] CSR offsets into postings (host)
    doc_ids: Any  # i32[nnz_pad] device, padded entries = max_docs sentinel
    tf: Any  # f32[nnz_pad] device
    tfnorm: Any  # f32[nnz_pad] device — tf*(k1+1)/(tf+k1*(1-b+b*len/avg))
    term_ids: Any  # i32[nnz_pad] device, padded = V sentinel
    nnz: int
    num_docs: int
    total_terms: int
    avg_len: float
    residency: Residency
    max_docs: int = 0
    # positions: host CSR aligned with postings order (phrase queries)
    pos_offsets: Optional[np.ndarray] = None
    positions: Optional[np.ndarray] = None
    # host mirrors (dense-impact build, conversion)
    doc_ids_host: Optional[np.ndarray] = None
    tfnorm_host: Optional[np.ndarray] = None
    tf_host: Optional[np.ndarray] = None
    # lazy dense block: None = not built yet (or budget denied, retry),
    # False = no qualifying term, else (dense_rows np.i32[V], impact tensor)
    _dense: Any = None
    # lazy sorted term dict for prefix/wildcard expansion
    _sorted_terms: Any = None
    # lazy positional CSR on the card (ops/positional.py::positional_device)
    # and its host doc-per-position expansion
    _pos_dev: Any = None
    _pos_host_dpp: Any = None
    _dense_lock: Any = dfield(default_factory=threading.Lock)

    def dense_block(self):
        """Lazy (dense_rows, device impact [F_pad, D]) or None.

        Built on the first search that touches the field and charged to
        the ``fielddata`` breaker as a best-effort structure: a denied
        charge leaves the field on the scatter path and a later query
        retries; only 'no qualifying terms' is remembered as a no."""
        d = self._dense
        if d is False:
            return None
        if d is not None:
            return d
        with self._dense_lock:
            if self._dense is False:
                return None
            if self._dense is not None:
                return self._dense
            if self.doc_ids_host is None or not self.max_docs:
                self._dense = False
                return None
            min_bytes = 8 * 4 * self.max_docs
            granted = min(DENSE_BUDGET_BYTES,
                          self.residency.breakers.breaker("fielddata")
                          .remaining())
            if granted < min_bytes:
                return None
            tfn = self.tfnorm_host
            if tfn is None:
                tfn = np.ones(self.nnz, dtype=np.float32)
            built = build_dense_impact(self.doc_ids_host, tfn, self.offsets,
                                       self.df, self.max_docs,
                                       budget_bytes=granted)
            if built is None:
                self._dense = False
                return None
            rows, impact = built
            dev = self.residency.put_array(
                impact, label=f"dense_impact:{self.name}", best_effort=True)
            if dev is None:
                return None  # budget tight: retry later
            self._dense = (rows, dev)
            return self._dense

    @property
    def nnz_pad(self) -> int:
        return int(self.doc_ids.shape[0])

    def term_id(self, term: str) -> int:
        return self.vocab.get(term, -1)

    def term_slice(self, term: str) -> Tuple[int, int]:
        """(start, length) of the term's postings run; (0, 0) if absent."""
        tid = self.vocab.get(term, -1)
        if tid < 0:
            return 0, 0
        return int(self.offsets[tid]), int(self.offsets[tid + 1] - self.offsets[tid])

    def idf(self, term: str, num_docs: Optional[int] = None, df: Optional[int] = None) -> float:
        """Lucene 5 BM25 idf: ln(1 + (N - df + 0.5)/(df + 0.5))."""
        n = self.num_docs if num_docs is None else num_docs
        d = (self.df[self.vocab[term]] if term in self.vocab else 0) if df is None else df
        return float(np.log(1.0 + (n - d + 0.5) / (d + 0.5)))


@dataclass
class NumericColumn:
    name: str
    values: Any  # f32[max_docs] device — arithmetic channel, value - offset
    exists: Any  # bool[max_docs] device
    hi: Any = None  # i32[max_docs] exact pair (device) for 64-bit kinds
    lo: Any = None
    exact: Optional[np.ndarray] = None  # host i64/f64 mirror
    exists_host: Optional[np.ndarray] = None
    kind: str = "double"
    # 64-bit kinds keep f32 = exact - offset (offset = segment min)
    offset: float = 0.0

    @property
    def has_pair(self) -> bool:
        return self.hi is not None


@dataclass
class KeywordColumn:
    """Ordinal doc values for keyword fields; ords are -1 where missing or
    multi-valued."""

    name: str
    ords: Any  # i32[max_docs] device
    exists: Any  # bool[max_docs] device
    host_values: List[Optional[List[str]]] = dfield(default_factory=list)
    ords_host: Optional[np.ndarray] = None
    exists_host: Optional[np.ndarray] = None


@dataclass
class SortKeys:
    """A doc-value field's sort mirror on the device: per doc an i64 key
    that ranks the value the fetch reports for the doc as its sort value
    (``search/service.py::_sort_value``) in ascending order, built once
    per (segment, field) and charged to the ``fielddata`` breaker."""

    key: Any  # i64[max_docs] device; 0 where the value is missing
    exists: Any  # bool[max_docs] device
    kind: str  # "int" (the value), "f64" (its order key), "rank"
    lo: int = 0  # the least and greatest key of a present value
    hi: int = 0
    terms: Optional[List[str]] = None  # "rank": the sorted terms


@dataclass
class VectorColumn:
    """A dense_vector field: the slab and, built once on first use (at
    freeze when the mapping asks for ANN), its IVF and PQ tiers."""

    name: str
    vecs: Any  # f32[max_docs, dims] device, charged to fielddata
    exists: Any  # bool[max_docs] device
    dims: int
    residency: Residency
    similarity: str = "cosine"
    # IVF: None = not built yet, False = declined (too few vectors)
    _ivf: Any = None
    # PQ: None = not built or placement denied (retry), False = declined,
    # else a PqIndex; the built parts are kept so a retry only places
    _pq: Any = None
    _pq_parts: Any = None

    def get_ivf(self, max_docs: int):
        """The IVF index over this immutable slab, built once."""
        if self._ivf is None:
            from elasticsearch_tpu_torch.ops.ivf import build_ivf

            idx = build_ivf(self.vecs, self.exists, max_docs,
                            metric=self.similarity,
                            place=self.residency.device_put)
            self._ivf = idx if idx is not None else False
        return self._ivf or None

    def get_pq(self, max_docs: int):
        """The PQ tier over this slab, built once; its placement is
        best-effort (None while the fielddata breaker denies it)."""
        if self._pq is False:
            return None
        if self._pq is not None:
            return self._pq
        from elasticsearch_tpu_torch.ops.pq import build_pq, place_pq

        if self._pq_parts is None:
            parts = build_pq(self.vecs, self.exists, self.similarity)
            if parts is None:
                self._pq = False  # too few vectors: permanent decline
                return None
            self._pq_parts = parts
        idx = place_pq(self._pq_parts, self.residency,
                       label=f"pq[{self.name}]")
        if idx is not None:
            self._pq = idx
            self._pq_parts = None
        return idx

    def resident_bytes(self) -> int:
        """Always-resident bytes of the IVF quantizer (the slab and the PQ
        codes are charged to the fielddata breaker when placed)."""
        return self._ivf.nbytes() if self._ivf else 0


_SEG_IDS = itertools.count(1)


class TpuSegment:
    """One immutable frozen segment (name kept from the reference)."""

    def __init__(
        self,
        num_docs: int,
        max_docs: int,
        inverted: Dict[str, InvertedField],
        numerics: Dict[str, NumericColumn],
        keywords: Dict[str, KeywordColumn],
        sources: List[Optional[dict]],
        stored: List[dict],
        ids: List[str],
        id_map: Dict[str, int],
        field_lengths: Dict[str, Any],
        residency: Residency,
        live: Optional[np.ndarray] = None,
        vectors: Optional[Dict[str, VectorColumn]] = None,
    ):
        self.seg_id = next(_SEG_IDS)
        self.num_docs = num_docs
        self.max_docs = max_docs  # pow2 padded
        self.inverted = inverted
        self.numerics = numerics
        self.keywords = keywords
        self.sources = sources
        self.stored = stored
        self.ids = ids
        self.id_map = id_map
        self.field_lengths = field_lengths  # field -> f32[max_docs] device
        self.vectors = vectors or {}
        self.residency = residency
        # deletion state: host-authoritative, device copy refreshed lazily
        if live is None:
            live = np.zeros(max_docs, dtype=bool)
            live[:num_docs] = True
        self._live_host = np.array(live, dtype=bool)
        self._live_dev = residency.device_put(self._live_host)
        self._live_dirty = False
        self.deleted_count = int(num_docs - self._live_host[:num_docs].sum())
        self._sort_keys: Dict[str, Optional[SortKeys]] = {}
        self._sort_lock = threading.Lock()

    @property
    def device(self):
        return self.residency.device

    def delete_local(self, local_id: int) -> bool:
        if 0 <= local_id < self.num_docs and self._live_host[local_id]:
            self._live_host[local_id] = False
            self._live_dirty = True
            self.deleted_count += 1
            return True
        return False

    @property
    def live(self):
        if self._live_dirty:
            self._live_dev = self.residency.device_put(self._live_host)
            self._live_dirty = False
        return self._live_dev

    @property
    def live_host(self) -> np.ndarray:
        return self._live_host

    @property
    def live_docs(self) -> int:
        return self.num_docs - self.deleted_count

    def sort_keys(self, field: str) -> Optional[SortKeys]:
        """The field's sort mirror (``SortKeys``), built on first use;
        None when the segment has no doc values for it."""
        with self._sort_lock:
            if field not in self._sort_keys:
                self._sort_keys[field] = _build_sort_keys(self, field)
            return self._sort_keys[field]

    def memory_bytes(self) -> int:
        """Always-resident device bytes (live mask, postings, IVF
        quantizers): the ``segments`` breaker charge at freeze. Vector
        slabs and PQ codes are charged to the ``fielddata`` breaker when
        placed, as doc-value columns are, and are not counted twice."""
        total = self.max_docs
        for inv in self.inverted.values():
            total += inv.nnz_pad * (4 + 4 + 4 + 4)
        for vc in self.vectors.values():
            total += vc.resident_bytes()
        return total

    def fielddata_bytes(self) -> int:
        """The bytes this segment has charged to the ``fielddata``
        breaker so far: its doc-value and keyword columns, vector slabs
        and placed PQ codes, the dense impact blocks, positional CSRs and
        sort mirrors built since. A merge releases them when it retires
        the segment, and the engine's close when the index closes."""
        ts = []
        for col in self.numerics.values():
            ts += [col.values, col.exists, col.hi, col.lo]
        for kw in self.keywords.values():
            ts += [kw.ords, kw.exists]
        for vc in self.vectors.values():
            ts += [vc.vecs, vc.exists, vc._pq.codes if vc._pq else None]
        for inv in self.inverted.values():
            if inv._dense:
                ts.append(inv._dense[1])
            if inv._pos_dev is not None:
                ts += list(inv._pos_dev)
        with self._sort_lock:
            ts += [m.key for m in self._sort_keys.values() if m is not None]
        return sum(int(t.numel()) * t.element_size() for t in ts
                   if t is not None)


def _build_sort_keys(seg: TpuSegment, field: str) -> Optional[SortKeys]:
    """A numeric column's keys are its exact values (integers) or their
    f64 order keys; a keyword's are the rank, among the segment's sorted
    terms, of a doc's first value (``host_values[i][0]``, the one the
    fetch reports, also for a multi-valued doc)."""
    col = seg.numerics.get(field)
    terms = None
    if col is not None:
        exists = np.asarray(col.exists_host, bool)
        exact = np.asarray(col.exact)
        if exact.dtype.kind == "i":
            kind, key = "int", exact.astype(np.int64)
        else:
            kind, key = "f64", f64_order_keys(exact.astype(np.float64))
        dev_exists = col.exists
    else:
        kw = seg.keywords.get(field)
        if kw is None:
            return None
        kind = "rank"
        exists = np.asarray(kw.exists_host, bool)
        inv = seg.inverted.get(field)
        ords = np.asarray(kw.ords_host)
        vals = kw.host_values
        names = list(inv.terms) if inv is not None else sorted(
            {v[0] for v in vals if v})
        order = sorted(range(len(names)), key=names.__getitem__)
        terms = [names[i] for i in order]
        rank = np.zeros(max(len(names), 1), np.int64)
        rank[order] = np.arange(len(names))
        single = ords >= 0
        key = np.where(single, rank[np.maximum(ords, 0)], 0)
        at = {t: i for i, t in enumerate(terms)}
        for i in np.nonzero(exists & ~single)[0].tolist():
            key[i] = at[vals[i][0]]  # a multi-valued doc: its first value
        dev_exists = kw.exists
    key = np.where(exists, key, 0).astype(np.int64)
    present = key[exists]
    return SortKeys(
        key=seg.residency.put_array(key, label=f"sort:{field}"),
        exists=dev_exists, kind=kind,
        lo=int(present.min()) if present.size else 0,
        hi=int(present.max()) if present.size else 0, terms=terms)


# -- constructors shared by SegmentBuilder.freeze and index/convert.py ------

def make_inverted(name: str, *, vocab: Dict[str, int], terms: List[str],
                  df: np.ndarray, cf: np.ndarray, offsets: np.ndarray,
                  doc_ids_host: np.ndarray, tf_host: np.ndarray,
                  tfnorm_host: np.ndarray, num_docs: int, total_terms: int,
                  avg_len: float, max_docs: int, residency: Residency,
                  pos_offsets: Optional[np.ndarray] = None,
                  positions: Optional[np.ndarray] = None) -> InvertedField:
    """Pad the host CSR like the reference (nnz_pad = pow2 >= 8, doc-id
    sentinel ``max_docs``, term-id sentinel V) and place it."""
    V = len(terms)
    nnz = int(doc_ids_host.shape[0])
    nnz_pad = pow2_bucket(max(nnz, 1), minimum=8)
    term_ids = np.repeat(np.arange(V, dtype=np.int32),
                         np.diff(offsets).astype(np.int64))
    put = residency.device_put
    return InvertedField(
        name=name, vocab=vocab, terms=terms, df=df, cf=cf, offsets=offsets,
        doc_ids=put(pad_to(doc_ids_host.astype(np.int32), nnz_pad, max_docs)),
        tf=put(pad_to(tf_host.astype(np.float32), nnz_pad, 0.0)),
        tfnorm=put(pad_to(tfnorm_host.astype(np.float32), nnz_pad, 0.0)),
        term_ids=put(pad_to(term_ids, nnz_pad, V)),
        nnz=nnz, num_docs=num_docs, total_terms=total_terms,
        avg_len=avg_len, residency=residency, max_docs=max_docs,
        pos_offsets=pos_offsets, positions=positions,
        doc_ids_host=doc_ids_host, tfnorm_host=tfnorm_host, tf_host=tf_host,
    )


def make_numeric(name: str, kind: str, exact: np.ndarray,
                 exists: np.ndarray, residency: Residency) -> NumericColumn:
    """Numeric doc-value column; 64-bit kinds get the exact (hi, lo) pair
    and a segment-relative f32 channel."""
    needs_exact = exact.dtype == np.int64
    offset = 0.0
    if needs_exact and exists.any():
        offset = float(exact[exists].min())
    values = np.where(exists, (exact - offset).astype(np.float32),
                      np.float32(0)).astype(np.float32)

    def put(a, what):
        return residency.put_array(a, label=f"column:{name}.{what}")

    col = NumericColumn(name=name, values=put(values, "values"),
                        exists=put(exists, "exists"), exact=exact,
                        exists_host=exists, kind=kind, offset=offset)
    if needs_exact:
        hi, lo = split_i64(exact)
        col.hi = put(hi, "hi")
        col.lo = put(lo, "lo")
    return col


def make_vector_column(name: str, vecs: np.ndarray, exists: np.ndarray,
                       similarity: str, residency: Residency) -> VectorColumn:
    """A dense_vector column: the f32 slab and its exists mask placed and
    charged to the ``fielddata`` breaker."""
    return VectorColumn(
        name=name,
        vecs=residency.put_array(np.asarray(vecs, np.float32),
                                 label=f"vectors:{name}.vecs"),
        exists=residency.put_array(np.asarray(exists, bool),
                                   label=f"vectors:{name}.exists"),
        dims=int(vecs.shape[1]), residency=residency, similarity=similarity)


def make_keyword_column(name: str, ords: np.ndarray, exists: np.ndarray,
                        host_values: List[Optional[List[str]]],
                        residency: Residency) -> KeywordColumn:
    return KeywordColumn(
        name=name,
        ords=residency.put_array(ords, label=f"column:{name}.ords"),
        exists=residency.put_array(exists, label=f"column:{name}.exists"),
        host_values=host_values, ords_host=ords, exists_host=exists)


class SegmentBuilder:
    """Mutable in-memory indexing buffer; freeze() emits a TpuSegment."""

    def __init__(self, mappings: Mappings, residency: Residency):
        self.mappings = mappings
        self.residency = residency
        self.docs: List[Optional[ParsedDocument]] = []

    def add(self, parsed: ParsedDocument) -> int:
        self.docs.append(parsed)
        return len(self.docs) - 1

    def __len__(self) -> int:
        return len(self.docs)

    @property
    def num_docs(self) -> int:
        return len(self.docs)

    def freeze(self) -> Optional[TpuSegment]:
        if not self.docs:
            return None
        res = self.residency
        n = len(self.docs)
        max_docs = pow2_bucket(n, minimum=64)

        text_fields: Dict[str, None] = {}
        kw_fields: Dict[str, None] = {}
        num_fields: Dict[str, str] = {}
        vec_fields: Dict[str, Tuple[int, str]] = {}
        for d in self.docs:
            for f in d.text_tokens:
                text_fields.setdefault(f)
            for f, vec in d.vectors.items():
                fm = self.mappings.get(f)
                vec_fields.setdefault(
                    f, (len(vec), fm.similarity if fm else "cosine"))
            for f, vals in d.doc_values.items():
                fm = self.mappings.get(f)
                kind = fm.type if fm else None
                if kind is None:
                    kind = "keyword" if isinstance(vals[0], str) else "double"
                if kind in ("keyword", "string_not_analyzed"):
                    kw_fields.setdefault(f)
                else:
                    num_fields[f] = kind

        inverted: Dict[str, InvertedField] = {}
        field_lengths: Dict[str, Any] = {}
        for fname in text_fields:
            inverted[fname] = self._build_inverted_text(fname, max_docs)
            lens = np.zeros(max_docs, dtype=np.float32)
            for i, d in enumerate(self.docs):
                lens[i] = d.field_length(fname)
            field_lengths[fname] = res.device_put(lens)

        keywords: Dict[str, KeywordColumn] = {}
        for fname in kw_fields:
            inv, kwcol = self._build_keyword(fname, max_docs)
            inverted[fname] = inv
            keywords[fname] = kwcol

        numerics: Dict[str, NumericColumn] = {}
        for fname, kind in num_fields.items():
            numerics[fname] = self._build_numeric(fname, kind, max_docs)

        vectors: Dict[str, VectorColumn] = {}
        for fname, (dims, sim) in vec_fields.items():
            vectors[fname] = self._build_vectors(fname, dims, sim, max_docs)

        ids = [d.doc_id for d in self.docs]
        seg = TpuSegment(
            num_docs=n, max_docs=max_docs, inverted=inverted,
            numerics=numerics, keywords=keywords,
            sources=[d.source for d in self.docs],
            stored=[d.stored for d in self.docs],
            ids=ids, id_map={doc_id: i for i, doc_id in enumerate(ids)},
            field_lengths=field_lengths, residency=res, vectors=vectors,
        )
        return seg

    def _build_vectors(self, fname: str, dims: int, sim: str,
                       max_docs: int) -> VectorColumn:
        mat = np.zeros((max_docs, dims), dtype=np.float32)
        exists = np.zeros(max_docs, dtype=bool)
        for i, d in enumerate(self.docs):
            v = d.vectors.get(fname)
            if v is not None:
                mat[i] = np.asarray(v, dtype=np.float32)
                exists[i] = True
        vc = make_vector_column(fname, mat, exists, sim, self.residency)
        fm = self.mappings.get(fname)
        opts = getattr(fm, "index_options", None) if fm is not None else None
        ann = opts.get("type") if isinstance(opts, dict) else None
        # index-time ANN build (as Lucene builds HNSW at flush): refreshes
        # pay the k-means, never the first query
        if ann in ("ivf", "ivf_flat", "ivf_pq"):
            vc.get_ivf(max_docs)
        if ann == "ivf_pq":
            vc.get_pq(max_docs)
        return vc

    def _build_inverted_text(self, fname: str, max_docs: int) -> InvertedField:
        """The field's postings CSR: terms in first-seen order, each term's
        postings by doc, each posting's positions in token order. The one
        Python pass maps tokens to term ids; one stable sort by term id
        then groups the (doc, position) stream into postings."""
        vocab: Dict[str, int] = {}
        lens = np.zeros(len(self.docs), dtype=np.int64)
        tids: List[int] = []
        poss: List[int] = []
        for i, d in enumerate(self.docs):
            toks = d.text_tokens.get(fname)
            if not toks:
                continue
            lens[i] = len(toks)
            ts, ps = zip(*toks)
            tids += [vocab.setdefault(t, len(vocab)) for t in ts]
            poss += ps
        terms = list(vocab)
        V = len(terms)
        tid = np.asarray(tids, dtype=np.int64)
        order = np.argsort(tid, kind="stable")
        st = tid[order]
        sd = np.repeat(np.arange(len(self.docs), dtype=np.int64), lens)[order]
        L = int(st.size)
        brk = np.ones(L, dtype=bool)
        brk[1:] = (st[1:] != st[:-1]) | (sd[1:] != sd[:-1])
        starts = np.nonzero(brk)[0]
        tf = np.diff(np.append(starts, L))
        doc_ids = sd[starts].astype(np.int32)
        tf_arr = tf.astype(np.float32)
        df = np.bincount(st[starts], minlength=V).astype(np.int32)
        cf = np.bincount(st, minlength=V).astype(np.int64)
        offsets = np.zeros(V + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(df)
        pos_offsets = np.zeros(starts.size + 1, dtype=np.int64)
        pos_offsets[1:] = np.cumsum(tf)
        positions = np.asarray(poss, dtype=np.int32)[order]
        total_terms = int(lens.sum())
        ndocs_with_field = int(np.count_nonzero(lens))
        avg_len = (total_terms / ndocs_with_field) if ndocs_with_field else 1.0

        # BM25 tf-normalization at index time; idf is applied at query time
        dl = lens[doc_ids].astype(np.float32)
        tfnorm = tf_arr * (K1 + 1.0) / (tf_arr + K1 * (1.0 - B + B * dl / max(avg_len, 1e-9)))
        return make_inverted(
            fname, vocab=vocab, terms=terms, df=df, cf=cf, offsets=offsets,
            doc_ids_host=doc_ids, tf_host=tf_arr,
            tfnorm_host=tfnorm.astype(np.float32),
            num_docs=ndocs_with_field, total_terms=total_terms,
            avg_len=avg_len, max_docs=max_docs, residency=self.residency,
            pos_offsets=pos_offsets, positions=positions)

    def _build_keyword(self, fname: str, max_docs: int):
        vocab: Dict[str, int] = {}
        terms: List[str] = []
        post: List[List[int]] = []
        ords = np.full(max_docs, -1, dtype=np.int32)
        exists = np.zeros(max_docs, dtype=bool)
        host_values: List[Optional[List[str]]] = [None] * max_docs
        for i, d in enumerate(self.docs):
            vals = d.doc_values.get(fname)
            if not vals:
                continue
            svals = [str(v) for v in vals]
            host_values[i] = svals
            exists[i] = True
            for v in svals:
                tid = vocab.get(v)
                if tid is None:
                    tid = len(terms)
                    vocab[v] = tid
                    terms.append(v)
                    post.append([])
                post[tid].append(i)
            if len(svals) == 1:
                ords[i] = vocab[svals[0]]

        V = len(terms)
        # lexicographic term order: deterministic ordinals
        order = sorted(range(V), key=lambda t: terms[t])
        remap = np.array([0] * V, dtype=np.int32)
        for new, old in enumerate(order):
            remap[old] = new
        terms2 = [terms[o] for o in order]
        post2 = [sorted(set(post[o])) for o in order]
        vocab2 = {t: i for i, t in enumerate(terms2)}
        if V:
            ords = np.where(ords >= 0, remap[np.maximum(ords, 0)], -1).astype(np.int32)

        df = np.array([len(p) for p in post2], dtype=np.int32) if V else np.zeros(0, np.int32)
        nnz = int(df.sum())
        doc_ids = np.zeros(nnz, dtype=np.int32)
        offsets = np.zeros(V + 1, dtype=np.int64)
        k = 0
        for tid in range(V):
            offsets[tid] = k
            for doc in post2[tid]:
                doc_ids[k] = doc
                k += 1
        offsets[V] = k
        ones = np.ones(nnz, dtype=np.float32)
        inv = make_inverted(
            fname, vocab=vocab2, terms=terms2, df=df, cf=df.astype(np.int64),
            offsets=offsets, doc_ids_host=doc_ids, tf_host=ones,
            tfnorm_host=ones, num_docs=int(exists.sum()), total_terms=nnz,
            avg_len=1.0, max_docs=max_docs, residency=self.residency)
        kwcol = make_keyword_column(fname, ords, exists, host_values,
                                    self.residency)
        return inv, kwcol

    def _build_numeric(self, fname: str, kind: str, max_docs: int) -> NumericColumn:
        exists = np.zeros(max_docs, dtype=bool)
        needs_exact = kind in ("long", "date", "ip", "murmur3", "token_count", "integer")
        exact = np.zeros(max_docs, dtype=np.int64) if needs_exact else np.zeros(max_docs, dtype=np.float64)
        for i, d in enumerate(self.docs):
            vals = d.doc_values.get(fname)
            if not vals:
                continue
            exists[i] = True
            exact[i] = vals[0]  # multi-valued numerics: first value in the column
        return make_numeric(fname, kind, exact, exists, self.residency)
