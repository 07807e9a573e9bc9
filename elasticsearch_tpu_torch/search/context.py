"""Per-segment execution context for query programs.

Mirrors the role of org/elasticsearch/search/internal/SearchContext.java +
Lucene's LeafReaderContext: one segment's arrays plus index-level services
(mappings, analysis) and optional global term statistics (dfs_query_then_fetch,
reference: org/elasticsearch/search/dfs/DfsSearchResult.java).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.segment import InvertedField, NumericColumn, TpuSegment
from elasticsearch_tpu_torch.ops.scoring import pack_dense_rows
from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

# cap on a single postings slice width; longer term runs are split into
# multiple chunks (keeps the [T, P] intermediate bounded)
P_MAX = 1 << 15


def split_runs(runs):
    """P_MAX-split raw (start, len, weight) postings runs.

    Returns (starts, lens, ws, max_len); max_len is the window width P the
    score program needs — a run split into full-width chunks forces P_MAX,
    not just its tail length.
    """
    starts, lens, ws = [], [], []
    max_len = 1
    for s, ln, w in runs:
        while ln > P_MAX:
            starts.append(s)
            lens.append(P_MAX)
            ws.append(w)
            s += P_MAX
            ln -= P_MAX
            max_len = P_MAX
        starts.append(s)
        lens.append(ln)
        ws.append(w)
        max_len = max(max_len, ln)
    return starts, lens, ws, max_len


@dataclass
class GlobalStats:
    """Cross-shard term statistics for consistent idf (dfs phase)."""

    num_docs: Dict[str, int]  # field -> total docs with field
    df: "SegmentDf"  # .get((field, term), 0) -> doc freq


class SegmentDf:
    """(field, term) → the term's doc freq summed over a set of segments,
    summed when first asked and kept: the dfs phase's ``df`` table
    without a pass over every term of every segment, since a request
    reads only its own terms."""

    def __init__(self, segments):
        self._segments = list(segments)
        self._memo: Dict[Tuple[str, str], int] = {}

    def get(self, key: Tuple[str, str], default: int = 0) -> int:
        n = self._memo.get(key)
        if n is None:
            field, term = key
            n = 0
            for seg in self._segments:
                inv = seg.inverted.get(field)
                tid = inv.vocab.get(term) if inv is not None else None
                if tid is not None:
                    n += int(inv.df[tid])
            self._memo[key] = n
        return n or default


def global_stats(segments) -> GlobalStats:
    """The dfs phase over ``segments`` (every shard of every searched
    index): per field the docs that hold it, per term its doc freq."""
    segments = list(segments)
    num_docs: Dict[str, int] = {}
    for seg in segments:
        for fname, inv in seg.inverted.items():
            num_docs[fname] = num_docs.get(fname, 0) + inv.num_docs
    return GlobalStats(num_docs=num_docs, df=SegmentDf(segments))


class SegmentContext:
    def __init__(
        self,
        segment: TpuSegment,
        mappings: Mappings,
        analysis: AnalysisRegistry,
        global_stats: Optional[GlobalStats] = None,
        index_name: str = "",
        all_segments: Optional[list] = None,
    ):
        self.segment = segment
        self.mappings = mappings
        self.analysis = analysis
        self.global_stats = global_stats
        self.index_name = index_name
        # the shard's segments: a join inside a filter agg prepares over
        # them (joins.prepare_tree)
        self.all_segments = all_segments if all_segments is not None \
            else [segment]

    @property
    def device(self):
        return self.segment.device

    @property
    def D(self) -> int:
        return self.segment.max_docs

    def inv(self, field: str) -> Optional[InvertedField]:
        return self.segment.inverted.get(field)

    def col(self, field: str) -> Optional[NumericColumn]:
        return self.segment.numerics.get(field)

    def idf(self, field: str, term: str) -> float:
        inv = self.inv(field)
        if self.global_stats is not None:
            n = self.global_stats.num_docs.get(field, inv.num_docs if inv else 0)
            df = self.global_stats.df.get((field, term), 0)
            return float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))
        if inv is None:
            return 0.0
        return inv.idf(term)

    def search_analyzer(self, field: str):
        fm = self.mappings.get(field)
        if fm is None or not fm.is_text:
            return None
        return self.analysis.get(fm.search_analyzer or fm.analyzer)

    def chunked_slices(self, inv: InvertedField, terms, weights):
        """Split (term -> postings run) into P-bucketed chunks.

        Returns (starts i32[Tb], lens i32[Tb], w f32[Tb], P, n_real_terms)
        where Tb is a pow2 bucket. Terms absent from the segment contribute
        (0, 0) chunks. n_real_terms counts distinct terms present.
        """
        runs = []
        n_present = 0
        for term, w in zip(terms, weights):
            s, ln = inv.term_slice(term)
            if ln > 0:
                n_present += 1
            runs.append((s, ln, w))
        starts, lens, ws, max_len = split_runs(runs)
        P = pow2_bucket(max_len)
        Tb = pow2_bucket(len(starts), minimum=1)
        starts += [0] * (Tb - len(starts))
        lens += [0] * (Tb - len(lens))
        ws += [0.0] * (Tb - len(ws))
        return (
            np.asarray(starts, np.int32),
            np.asarray(lens, np.int32),
            np.asarray(ws, np.float32),
            P,
            n_present,
        )

    def hybrid_slices(self, inv: InvertedField, terms, weights,
                      need_qw: bool = True):
        """Split query terms between the dense impact block and the CSR tail.

        Returns None when the field has no dense block OR no query term maps
        to a dense row (the caller uses the pure scatter path — paying an
        [F, D] matmul of zeros for an all-rare-term query would be far slower
        than scattering its short runs). Else returns (impact, qw f32[F],
        qind f32[F], starts, lens, ws, P, n_present, qrows i32[R],
        qrw f32[R]): frequent terms fold idf*boost into ``qw`` rows (for the
        batched matmul paths) AND into the compact (qrows, qrw) row list
        (-1/0 padded to a pow2 R) that single-query paths gather — reading
        R << F rows instead of the whole block. ``qind`` is the 1.0
        indicator of dense query terms, used for batched counts/masks.
        Single-query callers pass ``need_qw=False`` and get ``None`` for
        qw/qind — skipping the two O(F) fills on the per-request path.
        """
        block = inv.dense_block()
        if block is None:
            return None
        dense_rows, impact = block
        F = impact.shape[0]
        qw = np.zeros(F, np.float32) if need_qw else None
        qind = np.zeros(F, np.float32) if need_qw else None
        row_w: Dict[int, float] = {}
        runs = []
        n_present = 0
        for term, w in zip(terms, weights):
            tid = inv.term_id(term)
            if tid < 0:
                continue
            n_present += 1
            row = int(dense_rows[tid])
            if row >= 0:
                if need_qw:
                    qw[row] += w
                    qind[row] = 1.0
                row_w[row] = row_w.get(row, 0.0) + w
            else:
                runs.append((int(inv.offsets[tid]),
                             int(inv.offsets[tid + 1] - inv.offsets[tid]), w))
        if not row_w:
            return None
        starts, lens, ws, max_len = split_runs(runs) if runs else ([], [], [], 1)
        P = pow2_bucket(max_len)
        Tb = pow2_bucket(max(len(starts), 1), minimum=1)
        starts += [0] * (Tb - len(starts))
        lens += [0] * (Tb - len(lens))
        ws += [0.0] * (Tb - len(ws))
        qrows, qrw = pack_dense_rows(row_w)
        return (
            impact,
            qw,
            qind,
            np.asarray(starts, np.int32),
            np.asarray(lens, np.int32),
            np.asarray(ws, np.float32),
            P,
            n_present,
            qrows,
            qrw,
        )
