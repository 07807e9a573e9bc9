"""Segment: immutable columnar index structures on the device.

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
  loaded at freeze from the content-addressed blob cache
  (``index/ivf_cache.py``) or built on the slab's device and stored;
- the live mask (host-authoritative, device copy refreshed lazily);
- ``_source``, ids and stored fields stay on the host.

Postings, live masks, field lengths, block-join arrays and IVF
quantizers are always resident (the ``segments`` charge at freeze).
Fielddata is lazy and evictable, as in the reference: freeze keeps the
columns' and slabs' host arrays, and the first search that touches one
places it through ``_resident_field`` as a ``ResidentArray`` of the
node's residency registry (``resources/residency.py``), charged to the
``fielddata`` breaker. Under pressure the registry evicts the least
recently used copy and the next touch rehydrates it from the host
mirror. Dense impact blocks, PQ codes, sort mirrors and geo arrays are
such handles too.

``max_docs = pow2_bucket(n, minimum=64)`` and the postings padding follow
the reference exactly, so doc ids and shapes match it one for one.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field as dfield
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index import ivf_cache
from elasticsearch_tpu_torch.index.doc_parser import ParsedDocument
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.ops.scoring import f64_order_keys
from elasticsearch_tpu_torch.parallel import postings_shard
from elasticsearch_tpu_torch.resources.residency import (Residency,
                                                         ResidentArray)
from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException
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
    # False = no qualifying term, else (dense_rows np.i32[V], the impact
    # block's ResidentArray)
    _dense: Any = None
    # lazy sorted term dict for prefix/wildcard expansion
    _sorted_terms: Any = None
    # lazy positional CSR on the card (ops/positional.py::positional_device),
    # its pinned charges and its host doc-per-position expansion
    _pos_dev: Any = None
    _pos_tokens: Any = None
    _pos_host_dpp: Any = None
    _dense_lock: Any = dfield(default_factory=threading.Lock)
    # lazy term-range split of an oversized field's postings
    # (parallel/postings_shard.py): None = unchecked, False = declined
    _pshard: Any = None

    def wants_postings_shard(self) -> bool:
        """Whether the field's postings pass the split threshold (the
        mesh declines such an index to the host loop, which scores the
        field through its split)."""
        return self.nnz >= postings_shard.POSTINGS_SHARD_NNZ

    def postings_split(self, n_devices: Optional[int] = None):
        """The field's term-range split over the node's registries, built
        once, or None (under the threshold, one slot, or no host mirror).
        ``n_devices`` names the slot count of the first build
        (``build_split``; by default one a registry of the node)."""
        if self._pshard is False:
            return None
        if self._pshard is not None:
            return self._pshard
        if not self.wants_postings_shard():
            return None
        with self._dense_lock:
            if self._pshard is None:
                split = postings_shard.build_split(self, self.max_docs,
                                                   n_devices)
                self._pshard = split if split is not None else False
        return self._pshard or None

    @staticmethod
    def _dense_get(d):
        """(rows, device block) of a built block, rehydrating an evicted
        one; None when the rehydration is denied: the block only
        accelerates, so the field stays on the scatter path."""
        rows, handle = d
        try:
            return rows, handle.get()
        except CircuitBreakingException:
            return None

    def dense_block(self):
        """Lazy (dense_rows, device impact [F_pad, D]) or None.

        Built on the first search that touches the field and registered
        as a best-effort evictable handle of the ``fielddata`` tier that
        keeps its host mirror: a denied charge (after least recently used
        copies were evicted) leaves the field on the scatter path and a
        later query retries; only 'no qualifying terms' is remembered as
        a no. An evicted block rehydrates on the next touch."""
        d = self._dense
        if d is False:
            return None
        if d is not None:
            return self._dense_get(d)
        with self._dense_lock:
            if self._dense is False:
                return None
            if self._dense is not None:
                return self._dense_get(self._dense)
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
            handle = self.residency.put_array(
                impact, label=f"dense_impact:{self.name}", best_effort=True)
            if handle is None:
                return None  # budget tight: retry later
            self._dense = (rows, handle)
            return self._dense_get(self._dense)

    @property
    def nnz_pad(self) -> int:
        """The padded postings length, without placing an oversized
        field's postings."""
        return int(self._doc_ids_raw.shape[0])

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


def _lazy_device_field(name: str):
    """A lazy device accessor for one postings array (the reference's
    ``_lazy_device_field``). The freeze places an ordinary field's
    postings at once but keeps an oversized field's on the host: its
    scoring goes through the term-range split, and the whole copy on the
    device is made only when a path asks for it (phrases, terms aggs over
    the field), then kept. Attached after the class: a property in the
    dataclass body would read as a field default."""
    raw = f"_{name}_raw"

    def _get(self):
        v = self.__dict__[raw]
        if isinstance(v, np.ndarray):
            v = self.residency.device_put(v)
            self.__dict__[raw] = v
        return v

    def _set(self, v):
        self.__dict__[raw] = v

    return property(_get, _set)


for _pname in ("doc_ids", "tf", "tfnorm", "term_ids"):
    setattr(InvertedField, _pname, _lazy_device_field(_pname))
del _pname


def _resident_field(name: str):
    """A lazy, evictable device accessor for one fielddata array (the
    reference's ``_resident_field``).

    The builder stores the HOST array; the first read registers it with
    the owner's residency registry (charging ``fielddata``: the lazy
    column load that can trip ``indices.breaker.fielddata.limit``) and
    returns the device copy. The first touch is locked, so two searches
    do not both charge and place one column. Under pressure the registry
    evicts the copy and the next read rehydrates it from the host
    mirror. After the owner released its fielddata (``release_fielddata``)
    a read gets a transient copy charged to no one."""
    raw = f"_{name}_res"
    raw_lock = f"_{name}_res_lock"

    def _get(self):
        v = self.__dict__.get(raw)
        if isinstance(v, ResidentArray):
            return v.get()
        if not isinstance(v, np.ndarray):
            return v  # None
        if self.__dict__.get("_released"):
            return self.residency.device_put(v)
        lock = self.__dict__.setdefault(raw_lock, threading.Lock())
        with lock:
            v = self.__dict__.get(raw)
            if isinstance(v, np.ndarray):
                v = self.residency.put_array(
                    v, label=f"{self._label}:{self.name}.{name}")
                self.__dict__[raw] = v
        return v.get()

    def _set(self, v):
        self.__dict__[raw] = v

    return property(_get, _set)


def host_of(obj, name: str) -> Optional[np.ndarray]:
    """The host mirror of a resident field (never places it)."""
    v = obj.__dict__.get(f"_{name}_res")
    return v.host if isinstance(v, ResidentArray) else v


def peek_field(obj, name: str):
    """A resident field's device copy while it is resident, else its host
    mirror (never places it)."""
    v = obj.__dict__.get(f"_{name}_res")
    return v.peek() if isinstance(v, ResidentArray) else v


# set while the mesh executor copies segment data into a stacked round
_STACKING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "estpu-stacking", default=False)


@contextmanager
def stacking():
    """Scope in which ``stack_source`` reads host mirrors of evicted
    fields (``parallel/executor.py::_SlotData._stack``)."""
    tok = _STACKING.set(True)
    try:
        yield
    finally:
        _STACKING.reset(tok)


def stack_source(obj, name: str):
    """What the mesh reads of a resident field: inside ``stacking()`` (a
    copy into a stacked round) ``peek_field``, so building a round never
    rehydrates nor charges a column it only copies; elsewhere (a one-slot
    round's view of the segment's own tensor) the field itself."""
    if obj is None:
        return None
    if _STACKING.get() and f"_{name}_res" in obj.__dict__:
        return peek_field(obj, name)
    return getattr(obj, name)


def _handles(obj, names) -> List[ResidentArray]:
    return [h for h in (obj.__dict__.get(f"_{n}_res") for n in names)
            if isinstance(h, ResidentArray)]


@dataclass
class NumericColumn:
    name: str
    values: Any  # f32[max_docs] resident — arithmetic channel, value - offset
    exists: Any  # bool[max_docs] resident
    hi: Any = None  # i32[max_docs] resident exact pair for 64-bit kinds
    lo: Any = None
    exact: Optional[np.ndarray] = None  # host i64/f64 mirror
    exists_host: Optional[np.ndarray] = None
    kind: str = "double"
    # 64-bit kinds keep f32 = exact - offset (offset = segment min)
    offset: float = 0.0
    residency: Any = None

    _label = "column"
    RESIDENT = ("values", "exists", "hi", "lo")

    @property
    def has_pair(self) -> bool:
        return self.__dict__.get("_hi_res") is not None


@dataclass
class KeywordColumn:
    """Ordinal doc values for keyword fields; ords are -1 where missing or
    multi-valued."""

    name: str
    ords: Any  # i32[max_docs] resident
    exists: Any  # bool[max_docs] resident
    host_values: List[Optional[List[str]]] = dfield(default_factory=list)
    ords_host: Optional[np.ndarray] = None
    exists_host: Optional[np.ndarray] = None
    residency: Any = None

    _label = "column"
    RESIDENT = ("ords", "exists")


@dataclass
class SortKeys:
    """A doc-value field's sort mirror: per doc an i64 key that ranks the
    value the fetch reports for the doc as its sort value
    (``search/service.py::_sort_value``) in ascending order, built once
    per (segment, field) as an evictable ``fielddata`` handle; ``exists``
    is its column's."""

    name: str
    key: Any  # i64[max_docs] resident; 0 where the value is missing
    column: Any  # the NumericColumn or KeywordColumn keyed
    kind: str  # "int" (the value), "f64" (its order key), "rank"
    lo: int = 0  # the least and greatest key of a present value
    hi: int = 0
    terms: Optional[List[str]] = None  # "rank": the sorted terms
    residency: Any = None

    _label = "sort"
    RESIDENT = ("key",)

    @property
    def exists(self):
        return self.column.exists


@dataclass
class VectorColumn:
    """A dense_vector field: the slab and, built once on first use (at
    freeze when the mapping asks for ANN), its IVF and PQ tiers. A build
    first looks in the content-addressed blob cache
    (``index/ivf_cache.py``) and stores what it built there."""

    name: str
    vecs: Any  # f32[max_docs, dims] resident, charged to fielddata
    exists: Any  # bool[max_docs] resident
    dims: int
    residency: Residency
    similarity: str = "cosine"
    # IVF: None = not built yet, False = declined (too few vectors)
    _ivf: Any = None
    # PQ: None = not built or placement denied (retry), False = declined,
    # else a PqIndex; the built parts are kept so a retry only places
    _pq: Any = None
    _pq_parts: Any = None
    # the slab's content key, memoised for its max_docs (the slab is
    # immutable, and hashing it is host time)
    _ck: Any = None
    _ck_max: int = -1

    _label = "column"
    RESIDENT = ("vecs", "exists")

    def cache_key(self, max_docs: int, host=None) -> str:
        """The blob cache's key of this slab; ``host`` gives the slab's
        (vectors, exists) host arrays, else the host mirrors are read."""
        if self._ck is None or self._ck_max != max_docs:
            vh, eh = host if host is not None else (
                host_of(self, "vecs"), host_of(self, "exists"))
            self._ck = ivf_cache.content_key(vh, eh, self.similarity,
                                             max_docs)
            self._ck_max = max_docs
        return self._ck

    def _build_inputs(self):
        """(vecs, exists) on the device for an IVF or PQ build: the
        resident copies, else transient ones charged to no one, so an
        index-time build does not load the slab into fielddata."""
        out = []
        for nm in ("vecs", "exists"):
            v = peek_field(self, nm)
            out.append(v if isinstance(v, torch.Tensor)
                       else self.residency.device_put(v))
        return out

    def get_ivf(self, max_docs: int):
        """The IVF index over this immutable slab: a cached blob, else
        built once (and stored)."""
        if self._ivf is None:
            from elasticsearch_tpu_torch.ops.ivf import build_ivf

            key = self.cache_key(max_docs)
            idx = ivf_cache.load(key, place=self.residency.device_put)
            if idx is None:
                vecs, exists = self._build_inputs()
                idx = build_ivf(vecs, exists, max_docs,
                                metric=self.similarity,
                                place=self.residency.device_put)
                del vecs, exists
                if idx is not None:
                    kernels.record("ivf_build")
                    ivf_cache.store(key, idx, self.residency.blob_dir)
            self._ivf = idx if idx is not None else False
        return self._ivf or None

    def get_pq(self, max_docs: int):
        """The PQ tier over this slab: cached host parts, else trained
        and encoded once (and stored); its placement is best-effort (None
        while the fielddata breaker denies it)."""
        if self._pq is False:
            return None
        if self._pq is not None:
            return self._pq
        from elasticsearch_tpu_torch.ops.pq import build_pq, place_pq

        if self._pq_parts is None:
            key = self.cache_key(max_docs)
            parts = ivf_cache.load_pq(key)
            if parts is None:
                vecs, exists = self._build_inputs()
                parts = build_pq(vecs, exists, self.similarity)
                del vecs, exists
                if parts is None:
                    self._pq = False  # too few vectors: permanent decline
                    return None
                kernels.record("pq_build")
                ivf_cache.store_pq(key, parts, self.residency.blob_dir)
            self._pq_parts = parts
        idx = place_pq(self._pq_parts, self.residency,
                       label=f"pq[{self.name}]")
        if idx is not None:
            self._pq = idx
            self._pq_parts = None
        return idx

    def resident_bytes(self) -> int:
        """Always-resident bytes of the IVF quantizer (the slab and the PQ
        codes are evictable fielddata)."""
        return self._ivf.nbytes() if self._ivf else 0


# fielddata loads lazily into the evictable tier (``_resident_field``):
# builders store host arrays, the first read places them, pressure
# evicts them, the next read rehydrates
for _ccls in (NumericColumn, KeywordColumn, SortKeys, VectorColumn):
    for _f in _ccls.RESIDENT:
        setattr(_ccls, _f, _resident_field(_f))
del _ccls, _f


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
        # per geo_point field: (lat, lon) f64 handles and the lat column
        self._geo64: Dict[str, Optional[Tuple[Any, Any, Any]]] = {}
        # pinned fielddata charges of the suggesters' tables (PinnedToken)
        self._pinned: List[Any] = []
        # each doc's _type / _parent / routing meta (merges replay them)
        self.metas: List[dict] = []
        # the suggesters' per-field caches (search/suggest.py): bigram
        # tables, packed vocabularies and completion inputs cut to a
        # prefix length on the device, charged to fielddata; completion
        # inputs on the host
        self._bigrams: Dict[str, Optional[Tuple[Any, Any, int]]] = {}
        self._vocab_packed: Dict[str, Optional[tuple]] = {}
        self._completions: Dict[str, tuple] = {}
        self._completion_cuts: Dict[Tuple[str, int], tuple] = {}
        # guards every cache above and the sort mirrors: each is built
        # and charged once, and ``fielddata_bytes`` reads them whole
        self._cache_lock = threading.Lock()
        # block-join arrays (``set_blocks``); None: every doc is a root
        self.parent_id_host: Optional[np.ndarray] = None
        self.nested_code_host: Optional[np.ndarray] = None
        self.nested_ord_host: Optional[np.ndarray] = None
        self.nested_paths: Dict[str, int] = {}
        self.roots_host: Optional[np.ndarray] = None
        self.root_id_host: Optional[np.ndarray] = None
        self.ancestors_host: Dict[int, np.ndarray] = {}
        self.parent_id_dev: Any = None
        self.nested_code_dev: Any = None
        self.roots_dev: Any = None
        self.root_id_dev: Any = None
        self.ancestors_dev: Dict[int, Any] = {}

    @property
    def device(self):
        return self.residency.device

    @property
    def has_nested(self) -> bool:
        return self.parent_id_dev is not None

    def set_blocks(self, parent_id: np.ndarray, nested_paths: Dict[str, int],
                   nested_code: np.ndarray, nested_ord: np.ndarray) -> None:
        """Install the block-join arrays of a segment holding nested docs
        (blocks in Lucene order: descendants first, the root last) and
        derive the rest: the roots, each doc's root (``root_id``) and per
        nested level L each doc's ancestor-or-self at L (``ancestors[L]``,
        -1 where none), the join targets of nested queries and aggs. One
        vectorised step per level of depth walks every doc up at once.
        Every array goes to the device; ``memory_bytes`` counts them in
        the segment's ``segments`` charge."""
        D = self.max_docs
        parent_id = np.asarray(parent_id, np.int32)
        nested_code = np.asarray(nested_code, np.int32)
        roots = parent_id < 0
        roots[self.num_docs:] = False
        root_id = np.arange(D, dtype=np.int32)
        anc = {c: np.where(nested_code == c, root_id, -1).astype(np.int32)
               for c in nested_paths.values()}
        # walk every doc's chain: ``cur`` is its ancestor at this depth
        cur = parent_id.copy()
        while True:
            up = np.nonzero(cur >= 0)[0]
            if up.size == 0:
                break
            a = cur[up]
            root_id[up] = a
            code = nested_code[a]
            for c, arr in anc.items():
                hit = up[(code == c) & (arr[up] < 0)]
                arr[hit] = cur[hit]
            cur[up] = parent_id[a]
        self.parent_id_host = parent_id
        self.nested_code_host = nested_code
        self.nested_ord_host = np.asarray(nested_ord, np.int32)
        self.nested_paths = dict(nested_paths)
        self.roots_host = roots
        self.root_id_host = root_id
        self.ancestors_host = anc
        put = self.residency.device_put
        self.parent_id_dev = put(parent_id)
        self.nested_code_dev = put(nested_code)
        self.roots_dev = put(roots)
        self.root_id_dev = put(root_id)
        self.ancestors_dev = {c: put(a) for c, a in anc.items()}

    def block_bytes(self) -> int:
        """Device bytes of the block-join arrays (0 without nested docs)."""
        ts = [self.parent_id_dev, self.nested_code_dev, self.roots_dev,
              self.root_id_dev, *self.ancestors_dev.values()]
        return sum(int(t.numel()) * t.element_size() for t in ts
                   if t is not None)

    def delete_local(self, local_id: int) -> bool:
        """Delete a doc and its descendants: a root takes its block."""
        if 0 <= local_id < self.num_docs and self._live_host[local_id]:
            self._live_host[local_id] = False
            self._live_dirty = True
            self.deleted_count += 1
            if self.parent_id_host is not None:
                p = self.parent_id_host[: self.num_docs]
                frontier = np.array([local_id])
                while frontier.size:  # one level of descendants a step
                    kids = np.nonzero(np.isin(p, frontier))[0]
                    live = kids[self._live_host[kids]]
                    self._live_host[live] = False
                    self.deleted_count += int(live.size)
                    frontier = kids
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
        with self._cache_lock:
            if field not in self._sort_keys:
                self._sort_keys[field] = _build_sort_keys(self, field)
            return self._sort_keys[field]

    def geo_f64(self, field: str):
        """(lat f64, lon f64, exists) of a geo_point field on the device,
        the ``_geo_distance`` sort's exact coordinates: evictable
        ``fielddata`` handles built on first use; None when the segment
        has no points of the field."""
        with self._cache_lock:
            if field not in self._geo64:
                lat = self.numerics.get(f"{field}.lat")
                lon = self.numerics.get(f"{field}.lon")
                got = None
                if lat is not None and lon is not None:
                    hs = []
                    try:
                        for c in (lat, lon):
                            hs.append(self.residency.put_array(
                                np.asarray(c.exact, np.float64),
                                label=f"sort:{c.name}"))
                    except BaseException:
                        for h in hs:
                            h.close()
                        raise
                    got = (hs[0], hs[1], lat)
                self._geo64[field] = got
            got = self._geo64[field]
        if got is None:
            return None
        return got[0].get(), got[1].get(), got[2].exists

    def memory_bytes(self) -> int:
        """Always-resident device bytes (live mask, block-join arrays,
        postings, IVF quantizers): the ``segments`` breaker charge at
        freeze. Vector slabs and PQ codes are charged to the ``fielddata``
        breaker when placed, as doc-value columns are, and are not
        counted twice."""
        total = self.max_docs + self.block_bytes()
        for inv in self.inverted.values():
            total += inv.nnz_pad * (4 + 4 + 4 + 4)
        for vc in self.vectors.values():
            total += vc.resident_bytes()
        return total

    def _column_iter(self):
        """Every doc-value column and vector slab of the segment."""
        yield from self.numerics.values()
        yield from self.keywords.values()
        yield from self.vectors.values()

    def fielddata_handles(self) -> List[ResidentArray]:
        """Every evictable handle the segment owns: its columns' and
        slabs', the dense impact blocks, the postings splits' ranges (on
        the node's registries), PQ codes, sort mirrors and geo arrays."""
        out: List[ResidentArray] = []
        for col in self._column_iter():
            out += _handles(col, col.RESIDENT)
        for vc in self.vectors.values():
            if vc._pq and isinstance(vc._pq.codes, ResidentArray):
                out.append(vc._pq.codes)
        for inv in self.inverted.values():
            if isinstance(inv._dense, tuple):
                out.append(inv._dense[1])
            if inv._pshard:
                out += inv._pshard.handles()
        with self._cache_lock:
            for m in self._sort_keys.values():
                if m is not None:
                    out += _handles(m, m.RESIDENT)
            for g in self._geo64.values():
                if g is not None:
                    out += list(g[:2])
        return out

    def _pinned_tokens(self) -> list:
        toks = [t for inv in self.inverted.values()
                for t in (inv._pos_tokens or ())]
        with self._cache_lock:
            toks += list(self._pinned)
        return toks

    def fielddata_bytes(self) -> int:
        """The bytes this segment holds charged to the ``fielddata``
        breaker now: its resident handles (columns, slabs, PQ codes,
        dense impact blocks, sort mirrors, geo arrays) and its pinned
        positional CSRs and suggester tables. A merge releases them when
        it retires the segment, and the engine's close when the index
        closes (``release_fielddata``)."""
        return sum(h.nbytes for h in self.fielddata_handles()
                   if h.resident) + sum(t.nbytes
                                        for t in self._pinned_tokens())

    def fielddata_field_bytes(self) -> Dict[str, int]:
        """Per field, the doc-value bytes resident on the device now: the
        ``fielddata.fields`` map of the stats (reference:
        ShardFieldData's per-field map). Columns load lazily and evict,
        so this counts loaded bytes, not mapped ones; an analyzed text
        field's always-resident postings play fielddata's role and count
        in full (``term_ids``, ``doc_ids``, ``tf``), as in the
        reference."""
        out: Dict[str, int] = {}

        def add(name, b):
            if b:
                out[name] = out.get(name, 0) + b

        for col in self._column_iter():
            add(col.name, sum(h.nbytes for h in _handles(col, col.RESIDENT)
                              if h.resident))
        for name, inv in self.inverted.items():
            if name in self.keywords or name in self.numerics \
                    or name.startswith("_"):
                continue
            add(name, inv.nnz_pad * 12)
        return out

    def fielddata_evictions(self) -> Tuple[int, int]:
        """(evictions, rehydrations) over the segment's handles."""
        hs = self.fielddata_handles()
        return (sum(h.evictions for h in hs),
                sum(h.rehydrations for h in hs))

    def release_fielddata(self) -> None:
        """Give back every fielddata charge the segment holds: close its
        handles and pinned tokens (a merge retiring it, the index
        closing, the percolator's segment). A request still reading it
        gets transient copies."""
        for col in self._column_iter():
            col.__dict__["_released"] = True  # a later first touch: transient
        for h in self.fielddata_handles():
            h.close()
        for t in self._pinned_tokens():
            t.close()
        for inv in self.inverted.values():
            inv._pos_tokens = None
        with self._cache_lock:
            self._pinned = []


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
        column = col
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
        column = kw
    key = np.where(exists, key, 0).astype(np.int64)
    present = key[exists]
    return SortKeys(
        name=field, key=key, column=column, kind=kind,
        lo=int(present.min()) if present.size else 0,
        hi=int(present.max()) if present.size else 0, terms=terms,
        residency=seg.residency)


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
    # an oversized field's postings stay on the host (InvertedField's
    # lazy accessors place them on a first explicit use)
    put = ((lambda a: a) if nnz >= postings_shard.POSTINGS_SHARD_NNZ
           else residency.device_put)
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
    """Numeric doc-value column (host arrays, placed on first read);
    64-bit kinds get the exact (hi, lo) pair and a segment-relative f32
    channel."""
    needs_exact = exact.dtype == np.int64
    offset = 0.0
    if needs_exact and exists.any():
        offset = float(exact[exists].min())
    values = np.where(exists, (exact - offset).astype(np.float32),
                      np.float32(0)).astype(np.float32)
    exists = np.ascontiguousarray(exists, dtype=bool)
    col = NumericColumn(name=name, values=values, exists=exists, exact=exact,
                        exists_host=exists, kind=kind, offset=offset,
                        residency=residency)
    if needs_exact:
        col.hi, col.lo = split_i64(exact)
    return col


def make_vector_column(name: str, vecs: np.ndarray, exists: np.ndarray,
                       similarity: str, residency: Residency) -> VectorColumn:
    """A dense_vector column: the f32 slab and its exists mask, placed on
    first read and charged to the ``fielddata`` breaker."""
    return VectorColumn(
        name=name, vecs=np.ascontiguousarray(vecs, dtype=np.float32),
        exists=np.ascontiguousarray(exists, dtype=bool),
        dims=int(vecs.shape[1]), residency=residency, similarity=similarity)


def make_keyword_column(name: str, ords: np.ndarray, exists: np.ndarray,
                        host_values: List[Optional[List[str]]],
                        residency: Residency) -> KeywordColumn:
    ords = np.ascontiguousarray(ords, dtype=np.int32)
    exists = np.ascontiguousarray(exists, dtype=bool)
    return KeywordColumn(
        name=name, ords=ords, exists=exists, host_values=host_values,
        ords_host=ords, exists_host=exists, residency=residency)


class SegmentBuilder:
    """Mutable in-memory indexing buffer; freeze() emits a TpuSegment."""

    def __init__(self, mappings: Mappings, residency: Residency):
        self.mappings = mappings
        self.residency = residency
        self.docs: List[Optional[ParsedDocument]] = []
        # each doc's parent local id, -1 for a root (block order:
        # descendants first, the root last)
        self.parent_of: List[int] = []

    def add(self, parsed: ParsedDocument) -> int:
        """Append a doc's block (its nested docs first, depth first, then
        the doc); returns the doc's local id."""
        child_locals = [self.add(child) for child in parsed.children]
        local = len(self.docs)
        self.docs.append(parsed)
        self.parent_of.append(-1)
        for c in child_locals:
            self.parent_of[c] = local
        return local

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
        seg.metas = [d.meta for d in self.docs]
        if any(p >= 0 for p in self.parent_of):
            parent_id = np.full(max_docs, -1, dtype=np.int32)
            parent_id[:n] = self.parent_of
            nested_code = np.full(max_docs, -1, dtype=np.int32)
            nested_ord = np.full(max_docs, -1, dtype=np.int32)
            paths: Dict[str, int] = {}
            for i, d in enumerate(self.docs):
                if d.nested_path is not None:
                    nested_code[i] = paths.setdefault(d.nested_path,
                                                      len(paths))
                    nested_ord[i] = d.nested_ord
            seg.set_blocks(parent_id, paths, nested_code, nested_ord)
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
        # pay the k-means (or load its blob), never the first query
        if ann in ("ivf", "ivf_flat", "ivf_pq"):
            vc.cache_key(max_docs, host=(mat, exists))
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
