"""function_score query: score rewriting functions on the card.

Port of elasticsearch_tpu/search/function_score.py (reference:
org/elasticsearch/index/query/functionscore/ — FunctionScoreQueryBuilder,
weight, field_value_factor, script_score, random_score and the gauss, exp
and linear decays). Every function evaluates as a dense f32 column over
the segment's doc values and the functions combine per ``score_mode``
and ``boost_mode``.

The math of each function and of the combination lives in module
functions over (values, exists) tensors of any shape, so the host loop
(a segment's [D]) and the mesh (``parallel/compiler.py``, a round's
[S, D]) run the same ops on the same f32 inputs and answer byte for
byte. A numeric column's absolute value is ``f32(values) + f32(offset)``
(the segment-relative f32 channel plus the segment's offset), which for
a date near 1.7e12 ms rounds to a step of 131,072 ms, as in the
reference. A decay with no ``origin`` (or ``now``) on a date takes the
segment's greatest value, as the reference does, so its answer depends
on how the shard is split into segments (ROADMAP C8).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.search.scripting import (_DocField, as_column,
                                                      compile_script,
                                                      script_params,
                                                      script_source)
from elasticsearch_tpu_torch.utils.dates import interval_to_millis, parse_date
from elasticsearch_tpu_torch.utils.errors import QueryParsingException
from elasticsearch_tpu_torch.utils.hashing import hash32_device

MODIFIERS = ("none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
             "square", "sqrt", "reciprocal")
_DECAYS = ("gauss", "exp", "linear")


def absolute(col):
    """A numeric column's f32 value: the f32 channel plus the offset."""
    return col.values.to(torch.float32) + float(np.float32(col.offset))


def doc_resolver(ctx):
    """Resolve doc['field'] for scripts: a _DocField of the segment's
    columns on the card. Numeric columns give their absolute f32 value
    (``f32(values) + f32(offset)`` where the offset is non-zero), keyword
    fields their ordinals as f32, text fields their lengths."""

    def resolve(field: str):
        col = ctx.col(field)
        if col is not None:
            vals = col.values
            if col.offset:
                vals = absolute(col)
            return _DocField(vals, col.exists)
        kw = ctx.segment.keywords.get(field)
        if kw is not None:
            return _DocField(kw.ords.to(torch.float32), kw.exists)
        fl = ctx.segment.field_lengths.get(field)
        if fl is not None:
            return _DocField(fl, fl > 0)
        return _DocField(torch.zeros(ctx.D, dtype=torch.float32,
                                     device=ctx.device),
                         torch.zeros(ctx.D, dtype=torch.bool,
                                     device=ctx.device))

    return resolve


def run_script(ctx, script, params, score=None):
    """A compiled script over the segment: its value column f32[D]."""
    out = script.run(doc_resolver(ctx), score=score, params=params,
                     device=ctx.device)
    return as_column(out, ctx.D, ctx.device)


def field_value(values, exists, factor: float, modifier: str, missing):
    """field_value_factor over absolute values: ``missing`` (or 0) where
    a doc has no value, times ``factor``, through the modifier."""
    v = torch.where(exists, values, float(np.float32(
        missing if missing is not None else 0.0)))
    v = v * factor
    m = modifier
    if m in ("none", None):
        return v
    if m == "log":
        return torch.log10(torch.clamp(v, min=1e-9))
    if m == "log1p":
        return torch.log10(v + 1.0)
    if m == "log2p":
        return torch.log10(v + 2.0)
    if m == "ln":
        return torch.log(torch.clamp(v, min=1e-9))
    if m == "ln1p":
        return torch.log1p(v)
    if m == "ln2p":
        return torch.log(v + 2.0)
    if m == "square":
        return v * v
    if m == "sqrt":
        return torch.sqrt(torch.clamp(v, min=0.0))
    if m == "reciprocal":
        return 1.0 / torch.clamp(v, min=1e-9)
    raise QueryParsingException(f"unknown field_value_factor modifier [{m}]")


def decay_value(values, exists, kind: str, origin: float, scale: float,
                offset: float, decay: float):
    """gauss / exp / linear decay of absolute values around ``origin``
    in f32, the reference's order of operations; 1 where a doc has no
    value."""
    dev = values.device

    def f32(x):
        return torch.full((), x, dtype=torch.float32, device=dev)

    dist = torch.clamp(torch.abs(values - f32(origin)) - f32(offset),
                       min=0.0)
    decay_f = f32(decay)
    scale_f = f32(scale)
    if kind == "gauss":
        sigma2 = -(scale_f ** 2) / (2.0 * torch.log(decay_f))
        out = torch.exp(-(dist ** 2) / (2.0 * sigma2))
    elif kind == "exp":
        lam = torch.log(decay_f) / scale_f
        out = torch.exp(lam * dist)
    elif kind == "linear":
        s = scale_f / (1.0 - decay_f)
        out = torch.clamp((s - dist) / s, min=0.0)
    else:
        raise QueryParsingException(f"unknown decay [{kind}]")
    return torch.where(exists, out, 1.0)


def random_value(D: int, seed: int, device):
    """f32[D] in [0, 1): the 32-bit hash of each doc's slot plus the
    seed, over 2^32."""
    x = hash32_device(torch.arange(D, dtype=torch.int64, device=device)
                      + int(seed))
    return x.to(torch.float32) / float(2 ** 32)


def combine(scores, mask, pairs, score_mode: str, boost_mode: str,
            max_boost, min_score, boost: float):
    """The FunctionScoreQuery algebra over (value, match) pairs of the
    functions: docs a function's filter misses leave it out; docs no
    function matches take the neutral factor 1."""
    sm = score_mode
    any_match = pairs[0][1]
    for _, m in pairs[1:]:
        any_match = any_match | m
    shape, dev = mask.shape, mask.device
    if sm == "multiply":
        fv = torch.ones(shape, dtype=torch.float32, device=dev)
        for v, m in pairs:
            fv = fv * torch.where(m, v, 1.0)
    elif sm in ("sum", "avg"):
        fv = torch.zeros(shape, dtype=torch.float32, device=dev)
        nm = torch.zeros(shape, dtype=torch.float32, device=dev)
        for v, m in pairs:
            fv = fv + torch.where(m, v, 0.0)
            nm = nm + m.to(torch.float32)
        if sm == "avg":
            fv = fv / torch.clamp(nm, min=1.0)
    elif sm == "max":
        fv = torch.full(shape, -float("inf"), dtype=torch.float32,
                        device=dev)
        for v, m in pairs:
            fv = torch.maximum(fv, torch.where(m, v, -float("inf")))
    elif sm == "min":
        fv = torch.full(shape, float("inf"), dtype=torch.float32, device=dev)
        for v, m in pairs:
            fv = torch.minimum(fv, torch.where(m, v, float("inf")))
    elif sm == "first":
        fv = torch.ones(shape, dtype=torch.float32, device=dev)
        taken = torch.zeros(shape, dtype=torch.bool, device=dev)
        for v, m in pairs:
            use = m & ~taken
            fv = torch.where(use, v, fv)
            taken = taken | m
    else:
        raise QueryParsingException(f"unknown score_mode [{sm}]")
    # docs matching no function: neutral factor 1 (reference behavior)
    fv = torch.where(any_match, fv, 1.0)
    if max_boost is not None:
        fv = torch.clamp(fv, max=float(max_boost))
    bm = boost_mode
    if bm == "multiply":
        out = scores * fv
    elif bm == "replace":
        out = fv
    elif bm == "sum":
        out = scores + fv
    elif bm == "avg":
        out = (scores + fv) / 2.0
    elif bm == "max":
        out = torch.maximum(scores, fv)
    elif bm == "min":
        out = torch.minimum(scores, fv)
    else:
        raise QueryParsingException(f"unknown boost_mode [{bm}]")
    out = out * boost
    if min_score is not None:
        mask = mask & (out >= min_score)
    return out * mask, mask


class ScoreFunction:
    weight: float = 1.0
    filter = None

    def value(self, ctx, scores):
        raise NotImplementedError

    def weighted(self, ctx, scores):
        """(value f32[D], match bool[D]); docs where the function's
        filter doesn't match are left out of the combination."""
        v = self.value(ctx, scores) * self.weight
        if self.filter is not None:
            _, fm = self.filter.execute(ctx)
            return v, fm
        return v, torch.ones(ctx.D, dtype=torch.bool, device=ctx.device)


class WeightFunction(ScoreFunction):
    def __init__(self, weight: float):
        self.weight = weight

    def value(self, ctx, scores):
        return torch.ones(ctx.D, dtype=torch.float32, device=ctx.device)


class FieldValueFactorFunction(ScoreFunction):
    def __init__(self, field: str, factor: float = 1.0,
                 modifier: str = "none", missing: Optional[float] = None):
        self.field = field
        self.factor = factor
        self.modifier = modifier
        self.missing = missing

    def value(self, ctx, scores):
        col = ctx.col(self.field)
        if col is None:
            if self.missing is None:
                raise QueryParsingException(
                    f"field_value_factor field [{self.field}] has no doc "
                    f"values and no [missing]")
            values = torch.full((ctx.D,), float(np.float32(self.missing)),
                                dtype=torch.float32, device=ctx.device)
            exists = torch.ones(ctx.D, dtype=torch.bool, device=ctx.device)
        else:
            values, exists = absolute(col), col.exists
        return field_value(values, exists, self.factor, self.modifier,
                           self.missing)


class ScriptScoreFunction(ScoreFunction):
    def __init__(self, source: str, params: Optional[dict] = None):
        self.script = compile_script(source)
        self.params = params or {}

    def value(self, ctx, scores):
        return run_script(ctx, self.script, self.params, score=scores)


class RandomScoreFunction(ScoreFunction):
    """Deterministic per-doc hash in [0, 1) seeded like
    RandomScoreFunctionBuilder."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def value(self, ctx, scores):
        return random_value(ctx.D, self.seed, ctx.device)


def decay_params(fn, fm, col_max=None):
    """A decay's (origin, scale, offset) as floats: a date field's origin
    parsed by its format and its scale and offset as intervals; an origin
    that is absent or ``now`` on a date is ``col_max()``, the segment's
    greatest value."""
    if fm is not None and fm.type == "date":
        origin = parse_date(fn.origin, fm.fmt) \
            if fn.origin not in (None, "now") else None
        scale = interval_to_millis(fn.scale) if isinstance(fn.scale, str) \
            else float(fn.scale)
        offset = interval_to_millis(fn.offset) \
            if isinstance(fn.offset, str) else float(fn.offset)
        if origin is None:
            origin = col_max() if col_max is not None else 0.0
        return float(origin), float(scale), float(offset)
    return float(fn.origin), float(fn.scale), float(fn.offset or 0)


class DecayFunction(ScoreFunction):
    def __init__(self, kind: str, field: str, origin, scale, offset=0,
                 decay: float = 0.5):
        self.kind = kind
        self.field = field
        self.origin = origin
        self.scale = scale
        self.offset = offset
        self.decay = decay

    def value(self, ctx, scores):
        col = ctx.col(self.field)
        if col is None:
            return torch.ones(ctx.D, dtype=torch.float32, device=ctx.device)
        origin, scale, offset = decay_params(
            self, ctx.mappings.get(self.field),
            lambda: float(np.max(col.exact)) if col.exact is not None
            else 0.0)
        return decay_value(absolute(col), col.exists, self.kind, origin,
                           scale, offset, self.decay)


class FunctionScoreQuery:
    """Combines inner query scores with function values."""

    boost = 1.0

    def __init__(self, inner, functions: List[ScoreFunction],
                 score_mode: str = "multiply", boost_mode: str = "multiply",
                 max_boost: Optional[float] = None,
                 min_score: Optional[float] = None, boost: float = 1.0):
        self.inner = inner
        self.functions = functions
        self.score_mode = score_mode
        self.boost_mode = boost_mode
        self.max_boost = max_boost
        self.min_score = min_score
        self.boost = boost

    def score_or_mask(self, ctx):
        return self.execute(ctx)

    def execute(self, ctx):
        scores, mask = self.inner.score_or_mask(ctx)
        if not self.functions:
            return scores * self.boost, mask
        pairs = [f.weighted(ctx, scores) for f in self.functions]
        return combine(scores, mask, pairs, self.score_mode,
                       self.boost_mode, self.max_boost, self.min_score,
                       self.boost)


def _parse_one_function(spec: dict) -> ScoreFunction:
    from elasticsearch_tpu_torch.search.queries import parse_query

    fn: Optional[ScoreFunction] = None
    if "field_value_factor" in spec:
        c = spec["field_value_factor"]
        fn = FieldValueFactorFunction(
            c["field"], factor=float(c.get("factor", 1.0)),
            modifier=c.get("modifier", "none"), missing=c.get("missing"))
    elif "script_score" in spec:
        s = spec["script_score"]["script"]
        fn = ScriptScoreFunction(script_source(s),
                                 script_params(s) or None)
    elif "random_score" in spec:
        fn = RandomScoreFunction(seed=spec["random_score"].get("seed", 0))
    else:
        for d in _DECAYS:
            if d in spec:
                (field, c), = spec[d].items()
                fn = DecayFunction(d, field, c.get("origin"), c.get("scale"),
                                   offset=c.get("offset", 0),
                                   decay=float(c.get("decay", 0.5)))
                break
    if fn is None:
        fn = WeightFunction(float(spec.get("weight", 1.0)))
    elif "weight" in spec:
        fn.weight = float(spec["weight"])
    if "filter" in spec:
        fn.filter = parse_query(spec["filter"])
    return fn


def parse_function_score(body: dict) -> FunctionScoreQuery:
    from elasticsearch_tpu_torch.search.queries import (MatchAllQuery,
                                                        parse_query)

    inner = parse_query(body["query"]) if "query" in body \
        else MatchAllQuery()
    if "functions" in body:
        functions = [_parse_one_function(s) for s in body["functions"]]
    else:
        functions = [_parse_one_function(body)] if any(
            k in body for k in ("field_value_factor", "script_score",
                                "random_score", "weight") + _DECAYS
        ) else []
    return FunctionScoreQuery(
        inner, functions,
        score_mode=body.get("score_mode", "multiply"),
        boost_mode=body.get("boost_mode", "multiply"),
        max_boost=body.get("max_boost"),
        min_score=body.get("min_score"),
        boost=float(body.get("boost", 1.0)),
    )
