"""Aggregation framework.

Port of elasticsearch_tpu/search/aggregations/base.py. Reference:
org/elasticsearch/search/aggregations/ — AggregatorFactories.java parse
tree, Aggregator.java collect model, InternalAggregation.java reduce
phase. Execution model:

1. ``parse_aggs(dsl)`` builds a tree of Aggregator objects.
2. Per segment, ``agg.collect(ctx, mask)`` computes a *partial*: the
   reductions over docs run on the card (masked sums, an ``index_add_``
   histogram over ordinals) and come to the host as small values (bucket
   counts, sums, never per-doc rows).
3. ``agg.reduce(partials)`` merges the partials of every segment and
   shard into the ES-shaped response. Partials are mergeable (summable
   counters, HLL registers by max, min/max, sample lists), the role of
   ES's InternalAggregation.reduce.

Bucket aggregators compute sub-aggregations by narrowing the doc mask to
each selected bucket (shard_size-style top buckets per shard), mirroring
BucketsAggregator's per-bucket doc collection.

A value source is a ``field`` or a ``script`` (search/scripting.py).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from elasticsearch_tpu_torch.search.function_score import run_script
from elasticsearch_tpu_torch.search.scripting import (compile_script,
                                                      script_params,
                                                      script_source)
from elasticsearch_tpu_torch.utils.errors import SearchParseException

# registry: agg type name -> factory(name, body, sub_factories)
_REGISTRY: Dict[str, Any] = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


class Aggregator:
    """Base aggregator: one node of the agg tree."""

    def __init__(self, name: str, body: dict,
                 subs: Optional[List["Aggregator"]] = None):
        self.name = name
        self.body = body
        self.subs = subs or []

    def collect(self, ctx, mask) -> Any:
        """Compute this segment's partial for docs selected by ``mask``."""
        raise NotImplementedError

    def reduce(self, partials: List[Any]) -> dict:
        """Merge partials from all segments/shards into response JSON."""
        raise NotImplementedError

    # helper for bucket aggs
    def collect_subs(self, ctx, mask) -> Dict[str, Any]:
        return {s.name: s.collect(ctx, mask) for s in self.subs}

    def reduce_subs(self, partial_dicts: List[Dict[str, Any]]
                    ) -> Dict[str, Any]:
        out = {}
        for s in self.subs:
            out[s.name] = s.reduce([p[s.name] for p in partial_dicts
                                    if p is not None])
        return out


class ValueSourceAggregator(Aggregator):
    """An aggregator that reads ``resolve_values``: a ``field``'s doc
    values or a ``script``'s column."""


def parse_aggs(dsl: Optional[dict]) -> List[Aggregator]:
    """Parse {"name": {"<type>": {...}, "aggs": {...}}, ...} into a tree."""
    # imports register the factories
    from elasticsearch_tpu_torch.search.aggregations import \
        bucket as _b  # noqa: F401
    from elasticsearch_tpu_torch.search.aggregations import \
        metrics as _m  # noqa: F401

    if not dsl:
        return []
    out = []
    for name, spec in dsl.items():
        sub_spec = spec.get("aggs", spec.get("aggregations"))
        subs = parse_aggs(sub_spec)
        found = None
        for key, body in spec.items():
            if key in ("aggs", "aggregations", "meta"):
                continue
            cls = _REGISTRY.get(key)
            if cls is None:
                raise SearchParseException(f"unknown aggregation type [{key}]")
            found = cls(name, body or {}, subs)
            break
        if found is None:
            raise SearchParseException(f"aggregation [{name}] has no type")
        out.append(found)
    return out


def run_aggs(aggs: List[Aggregator], ctx, mask) -> Dict[str, Any]:
    return {a.name: a.collect(ctx, mask) for a in aggs}


def reduce_aggs(aggs: List[Aggregator], partial_dicts: List[Dict[str, Any]]
                ) -> Dict[str, Any]:
    out = {}
    for a in aggs:
        out[a.name] = a.reduce([p[a.name] for p in partial_dicts
                                if p is not None and a.name in p])
    return out


def resolve_values(ctx, body: dict):
    """The value source of an agg body: (values f32[D] on the card, the
    segment-relative channel of 64-bit kinds, exists bool[D], offset,
    the NumericColumn or None). Keyword fields give their ordinals; a
    ``script`` gives its f32 column over the segment, present for every
    doc."""
    script = body.get("script")
    if script is not None:
        vals = run_script(ctx, compile_script(script_source(script)),
                          script_params(script))
        return vals, torch.ones(ctx.D, dtype=torch.bool, device=ctx.device), \
            0.0, None
    field = body.get("field")
    if field is None:
        raise SearchParseException("aggregation requires [field] or [script]")
    col = ctx.col(field)
    if col is not None:
        return col.values, col.exists, col.offset, col
    kw = ctx.segment.keywords.get(field)
    if kw is not None:
        return kw.ords.to(torch.float32), kw.exists, 0.0, None
    zeros = torch.zeros(ctx.D, dtype=torch.float32, device=ctx.device)
    return zeros, torch.zeros(ctx.D, dtype=torch.bool, device=ctx.device), \
        0.0, None
