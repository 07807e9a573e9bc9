"""Merge policy: which segments to combine, and when.

Port of elasticsearch_tpu/index/merge.py (reference: ES 2.0's
TieredMergePolicyProvider wrapping Lucene's TieredMergePolicy): segments
are grouped into size tiers; when a tier holds ``segments_per_tier``
segments, the smallest ``max_merge_at_once`` of them merge into one.
Deletes add merge pressure through the reclaimable-doc ratio.

A segment's "size" is its live doc count (its device tensors derive from
its docs). The merge itself (``Engine.merge``) re-parses the live
sources into one new ``SegmentBuilder``: segments are pure functions of
(source, mappings, order), so the output equals a fresh segment of the
same docs.
"""
from __future__ import annotations

from typing import List, Optional


class TieredMergePolicy:
    def __init__(
        self,
        segments_per_tier: int = 8,
        max_merge_at_once: int = 8,
        deletes_pct_allowed: float = 25.0,
    ):
        self.segments_per_tier = max(2, segments_per_tier)
        self.max_merge_at_once = max(2, max_merge_at_once)
        self.deletes_pct_allowed = deletes_pct_allowed

    def find_merge(self, segments: List) -> Optional[List]:
        """Segments to merge now, or None.

        Two triggers, checked in order:
        1. delete reclaim: any segment whose deleted fraction exceeds
           ``deletes_pct_allowed`` merges (possibly alone — rewriting it
           drops the tombstoned docs' arrays).
        2. tier overflow: more segments than segments_per_tier in the same
           pow2 size tier → merge the smallest max_merge_at_once of them.
        """
        if not segments:
            return None
        for seg in segments:
            denom = max(1, seg.num_docs)
            if 100.0 * seg.deleted_count / denom > self.deletes_pct_allowed:
                # fold the deletion-heavy segment together with its tier
                # neighbours when possible, alone otherwise
                tier = self._tier_of(seg)
                mates = [s for s in segments
                         if s is not seg and self._tier_of(s) == tier]
                return ([seg] + mates)[: self.max_merge_at_once]
        tiers = {}
        for seg in segments:
            tiers.setdefault(self._tier_of(seg), []).append(seg)
        for tier_segs in tiers.values():
            if len(tier_segs) >= self.segments_per_tier:
                tier_segs.sort(key=lambda s: s.live_docs)
                return tier_segs[: self.max_merge_at_once]
        return None

    @staticmethod
    def _tier_of(seg) -> int:
        n = max(1, seg.live_docs)
        return n.bit_length()  # pow2 tier
