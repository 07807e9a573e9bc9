"""Metrics aggregations.

Port of elasticsearch_tpu/search/aggregations/metrics.py. Reference:
org/elasticsearch/search/aggregations/metrics/ — avg/AvgAggregator.java,
sum/, min/, max/, stats/, stats/extended/, valuecount/, cardinality/
(HyperLogLogPlusPlus.java), percentiles/ (t-digest), tophits/. Each
partial is a small mergeable host object; the per-doc math stays on the
card (masked reductions) and one small copy brings each result back.

Parity deviations of the reference, kept: percentiles samples up to 64k
masked values per segment (``np.random.default_rng(17)``, in doc order)
and computes exact quantiles on the merged sample instead of t-digest
sketches; cardinality is a dense 2^12-register HLL without the ++ sparse
encoding or bias tables, its rank the f32 formula
``31 - floor(log2(f32(rest)))``.

``scripted_metric`` is the reference's simplified one (a map script
summed). ``geo_bounds`` reads the f32 lat/lon channels of a geo_point.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from elasticsearch_tpu_torch.ops.scoring import bucket_count
from elasticsearch_tpu_torch.search.aggregations.base import (
    Aggregator, ValueSourceAggregator, register, resolve_values)
from elasticsearch_tpu_torch.search.function_score import run_script
from elasticsearch_tpu_torch.search.scripting import (compile_script,
                                                      script_source)
from elasticsearch_tpu_torch.utils.hashing import (HLL_BITS, HLL_M,
                                                   hash32_device,
                                                   hll_update_host,
                                                   murmur3_32)

INF = float("inf")


@register("value_count")
class ValueCountAggregator(ValueSourceAggregator):
    def collect(self, ctx, mask):
        _, exists, _, _ = resolve_values(ctx, self.body)
        return int((exists & mask).sum())

    def reduce(self, partials):
        return {"value": int(sum(partials))}


def _sum_count(ctx, body, mask):
    """(f32 sum of the selected values as a float, their count), one
    copy back. The count travels as an f64, exact below 2^53."""
    vals, exists, offset, _ = resolve_values(ctx, body)
    sel = exists & mask
    s, n = torch.stack([torch.where(sel, vals, 0.0).sum().double(),
                        sel.sum().double()]).tolist()
    return s, int(n), offset


@register("sum")
class SumAggregator(ValueSourceAggregator):
    def collect(self, ctx, mask):
        s, n, offset = _sum_count(ctx, self.body, mask)
        return s + offset * n

    def reduce(self, partials):
        return {"value": float(sum(partials))}


@register("avg")
class AvgAggregator(ValueSourceAggregator):
    def collect(self, ctx, mask):
        s, n, offset = _sum_count(ctx, self.body, mask)
        return (s + offset * n, n)

    def reduce(self, partials):
        total = sum(p[0] for p in partials)
        n = sum(p[1] for p in partials)
        return {"value": (total / n) if n else None}


def _extreme(ctx, body, mask, largest: bool):
    vals, exists, offset, _ = resolve_values(ctx, body)
    sel = exists & mask
    if largest:
        m = float(torch.where(sel, vals, -INF).max())
    else:
        m = float(torch.where(sel, vals, INF).min())
    return m + offset if math.isfinite(m) else None


@register("min")
class MinAggregator(ValueSourceAggregator):
    def collect(self, ctx, mask):
        return _extreme(ctx, self.body, mask, largest=False)

    def reduce(self, partials):
        vals = [p for p in partials if p is not None]
        return {"value": min(vals) if vals else None}


@register("max")
class MaxAggregator(ValueSourceAggregator):
    def collect(self, ctx, mask):
        return _extreme(ctx, self.body, mask, largest=True)

    def reduce(self, partials):
        vals = [p for p in partials if p is not None]
        return {"value": max(vals) if vals else None}


class _StatsMixin:
    def _collect_stats(self, ctx, mask, want_sq=False):
        vals, exists, offset, _ = resolve_values(ctx, self.body)
        sel = exists & mask
        v = torch.where(sel, vals, 0.0)
        parts = [sel.sum().double(), v.sum().double(),
                 torch.where(sel, vals, INF).min().double(),
                 torch.where(sel, vals, -INF).max().double()]
        if want_sq:
            parts.append((v * v).sum().double())
        # one copy back: f32 results and the count are exact in f64
        got = torch.stack(parts).tolist()
        n, s, mn, mx = int(got[0]), got[1], got[2], got[3]
        out = {
            "count": n,
            "sum": s + offset * n,
            "min": (mn + offset) if n else None,
            "max": (mx + offset) if n else None,
        }
        if want_sq:
            # E[(x+off)^2] = E[x^2] + 2 off E[x] + off^2
            out["sum_sq"] = got[4] + 2 * offset * s + offset * offset * n
        return out

    @staticmethod
    def _merge_stats(partials):
        n = sum(p["count"] for p in partials)
        s = sum(p["sum"] for p in partials)
        mns = [p["min"] for p in partials if p["min"] is not None]
        mxs = [p["max"] for p in partials if p["max"] is not None]
        return {
            "count": n,
            "sum": s,
            "min": min(mns) if mns else None,
            "max": max(mxs) if mxs else None,
            "avg": (s / n) if n else None,
        }


@register("stats")
class StatsAggregator(ValueSourceAggregator, _StatsMixin):
    def collect(self, ctx, mask):
        return self._collect_stats(ctx, mask)

    def reduce(self, partials):
        return self._merge_stats(partials)


@register("extended_stats")
class ExtendedStatsAggregator(ValueSourceAggregator, _StatsMixin):
    def collect(self, ctx, mask):
        return self._collect_stats(ctx, mask, want_sq=True)

    def reduce(self, partials):
        out = self._merge_stats(partials)
        sq = sum(p["sum_sq"] for p in partials)
        n = out["count"]
        out["sum_of_squares"] = sq
        if n:
            var = max(sq / n - (out["sum"] / n) ** 2, 0.0)
            out["variance"] = var
            out["std_deviation"] = math.sqrt(var)
            sigma = float(self.body.get("sigma", 2.0))
            out["std_deviation_bounds"] = {
                "upper": out["avg"] + sigma * out["std_deviation"],
                "lower": out["avg"] - sigma * out["std_deviation"],
            }
        else:
            out["sum_of_squares"] = 0.0
            out["variance"] = None
            out["std_deviation"] = None
        return out


def hll_rank(rest):
    """HLL rank of int64 tensors ``rest`` in [0, 2^32): count-leading-
    zeros + 1, capped, with the clz taken as ``31 - floor(log2(f32))``,
    the reference's formula (32 for 0). f32 rounding just below a power
    of two gives an off-by-one, and the platform's log2 decides which
    values take it (ROADMAP C lists where the port's and the reference's
    differ)."""
    lz = torch.where(
        rest > 0,
        31 - torch.floor(torch.log2(rest.to(torch.float32))).to(torch.int64),
        32)
    return torch.clamp(lz + 1, 1, 32 - HLL_BITS + 1)


def _value_bits(col, vals):
    """The 32 bits of each doc's value that HLL hashes: an integer
    column's exact value folded hi ^ lo, a double's f64 bit pattern
    folded likewise, else the f32 channel's bits."""
    if col is not None and col.exact is not None:
        bits = col.exact if col.exact.dtype.kind == "i" \
            else col.exact.view(np.int64)
        x = ((bits & 0xFFFFFFFF) ^ ((bits >> 32) & 0xFFFFFFFF)).astype(
            np.int64)
        return torch.from_numpy(x).to(vals.device)
    return vals.view(torch.int32)


@register("cardinality")
class CardinalityAggregator(ValueSourceAggregator):
    """HyperLogLog. Hashes must be *value*-consistent across segments (the
    partials merge by register max), so keyword fields hash term strings
    (murmur3, like ES's BytesRef hashing), never segment-local ordinals,
    and numeric fields hash exact 64-bit value bits."""

    def collect(self, ctx, mask):
        field = self.body.get("field")
        kw = ctx.segment.keywords.get(field) if field else None
        regs_host = np.zeros(HLL_M, dtype=np.int32)
        if kw is not None:
            # terms present among masked docs, via postings (multi-value
            # correct)
            inv = ctx.inv(field)
            V = len(inv.terms)
            if V == 0:
                return regs_host
            w = mask[inv.doc_ids.clamp(0, ctx.D - 1).to(torch.int64)] \
                & (inv.term_ids < V)
            counts = bucket_count(inv.term_ids, w,
                                  num_buckets=V + 1)[:V].cpu().numpy()
            present = np.nonzero(counts > 0)[0]
            hashes = np.array([murmur3_32(inv.terms[int(t)])
                               for t in present], dtype=np.uint32)
            return hll_update_host(regs_host, hashes)
        vals, exists, offset, col = resolve_values(ctx, self.body)
        sel = exists & mask
        h = hash32_device(_value_bits(col, vals))
        reg = h >> (32 - HLL_BITS)
        rank = hll_rank((h << HLL_BITS) & 0xFFFFFFFF)
        regs = torch.zeros(HLL_M + 1, dtype=torch.int64, device=h.device)
        regs.scatter_reduce_(0, torch.where(sel, reg, HLL_M),
                             torch.where(sel, rank, 0), reduce="amax")
        return regs[:HLL_M].to(torch.int32).cpu().numpy()

    def reduce(self, partials):
        regs = np.zeros(HLL_M, dtype=np.int32)
        for p in partials:
            regs = np.maximum(regs, p)
        m = HLL_M
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)))
        zeros = int(np.sum(regs == 0))
        if est <= 2.5 * m and zeros:
            est = m * math.log(m / zeros)  # linear counting for small cardinalities
        return {"value": int(round(est))}


@register("percentiles")
class PercentilesAggregator(ValueSourceAggregator):
    SAMPLE_CAP = 1 << 16

    def collect(self, ctx, mask):
        vals, exists, offset, col = resolve_values(ctx, self.body)
        idx = np.nonzero((exists & mask).cpu().numpy())[0]
        if col is not None and col.exact is not None:
            sample = col.exact[idx].astype(np.float64)
        else:
            sample = vals.cpu().numpy()[idx].astype(np.float64) + offset
        if sample.size > self.SAMPLE_CAP:
            rng = np.random.default_rng(17)
            sample = rng.choice(sample, self.SAMPLE_CAP, replace=False)
        return sample

    def reduce(self, partials):
        pcts = self.body.get("percents", [1, 5, 25, 50, 75, 95, 99])
        allv = np.concatenate([p for p in partials]) if partials \
            else np.array([])
        values = {}
        for p in pcts:
            values[f"{float(p)}"] = float(np.percentile(allv, p)) \
                if allv.size else None
        return {"values": values}


@register("percentile_ranks")
class PercentileRanksAggregator(PercentilesAggregator):
    def reduce(self, partials):
        targets = self.body.get("values", [])
        allv = np.concatenate([p for p in partials]) if partials \
            else np.array([])
        values = {}
        for t in targets:
            if allv.size:
                values[f"{float(t)}"] = float((allv <= t).mean() * 100.0)
            else:
                values[f"{float(t)}"] = None
        return {"values": values}


@register("top_hits")
class TopHitsAggregator(Aggregator):
    def collect(self, ctx, mask):
        size = int(self.body.get("size", 3))
        m = mask[: ctx.segment.num_docs].cpu().numpy()
        locs = np.nonzero(m)[0][:size]
        hits = []
        for loc in locs:
            hits.append({
                "_id": ctx.segment.ids[int(loc)],
                "_score": 1.0,
                "_source": ctx.segment.sources[int(loc)],
            })
        return {"hits": hits, "total": int(m.sum())}

    def reduce(self, partials):
        size = int(self.body.get("size", 3))
        hits = [h for p in partials for h in p["hits"]][:size]
        total = sum(p["total"] for p in partials)
        return {"hits": {"total": total, "hits": hits}}


@register("scripted_metric")
class ScriptedMetricAggregator(Aggregator):
    """The reference's simplified scripted_metric: the ``map_script``
    gives a value a doc, and the partials (each segment's f32 sum over
    the selected docs) add up. ES's init, combine and reduce scripts are
    not run, as in the reference."""

    def collect(self, ctx, mask):
        spec = self.body.get("map_script", "1")
        vals = run_script(ctx, compile_script(script_source(spec)),
                          self.body.get("params", {}))
        return float(torch.where(mask, vals, 0.0).sum())

    def reduce(self, partials):
        return {"value": float(sum(partials))}


@register("geo_bounds")
class GeoBoundsAggregator(Aggregator):
    def collect(self, ctx, mask):
        field = self.body["field"]
        lat = ctx.col(f"{field}.lat")
        lon = ctx.col(f"{field}.lon")
        if lat is None:
            return None
        sel = lat.exists & mask
        inf = float("inf")
        # the four extremes and the any-flag in one copy back
        got = torch.stack([
            torch.where(sel, lat.values, -inf).max(),
            torch.where(sel, lat.values, inf).min(),
            torch.where(sel, lon.values, inf).min(),
            torch.where(sel, lon.values, -inf).max(),
            sel.any().to(torch.float32)]).cpu().tolist()
        if not got[4]:
            return None
        return dict(zip(("top", "bottom", "left", "right"), got[:4]))

    def reduce(self, partials):
        ps = [p for p in partials if p]
        if not ps:
            return {"bounds": None}
        return {"bounds": {
            "top_left": {"lat": max(p["top"] for p in ps),
                         "lon": min(p["left"] for p in ps)},
            "bottom_right": {"lat": min(p["bottom"] for p in ps),
                             "lon": max(p["right"] for p in ps)}}}
