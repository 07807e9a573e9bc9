"""Bucket aggregations.

Port of elasticsearch_tpu/search/aggregations/bucket.py. Reference:
org/elasticsearch/search/aggregations/bucket/ — terms/
(GlobalOrdinalsStringTermsAggregator.java), histogram/HistogramAggregator.java,
histogram/DateHistogramParser.java, range/RangeAggregator.java, filter/,
filters/, global/, missing/, significant/ (JLH heuristics), sampler/.

On the card a bucket agg computes per-segment bucket counts with one
``index_add_`` over ordinals (keyword terms ride the postings' term ids,
so multi-valued fields count correctly), then narrows the doc mask per
selected bucket to run sub-aggregations, the shard_size pattern of the
reference's deferred collection.

Kept as the reference has them, each a difference from ES 2.0:
- terms: per shard the top ``shard_size`` buckets come from a stable
  argsort on ``-count`` (ties by ordinal ascending); at reduce, ties are
  broken by ``str(key)`` in the same direction as the order, so
  ``_count: desc`` breaks ties by key descending;
- histogram: bucket counts come from the exact host column (f64/i64),
  but a bucket's sub-aggregation mask compares the f32 channel, so a
  double within f32 rounding of a bucket edge is counted in one bucket
  and collected by a neighbour's sub-aggregations.

The join aggs: ``nested`` gathers the incoming mask onto each child of
a path through its root (or enclosing level) id, ``reverse_nested``
scatters a child mask back onto its targets, and ``children`` joins a
segment's selected parents to its children through the ``_parent``
ordinals (the reference's rule: parents and children of the same
segment). The geo aggs: ``geohash_grid`` makes one int64 cell id a doc
on the card and counts the selected ones with ``torch.unique``;
``geo_distance`` buckets an f32 haversine distance (search/geo.py).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from elasticsearch_tpu_torch.index.mappings import _parse_geo_point
from elasticsearch_tpu_torch.ops.scoring import bucket_count
from elasticsearch_tpu_torch.search.aggregations.base import (
    Aggregator, ValueSourceAggregator, register, resolve_values)
from elasticsearch_tpu_torch.search.geo import (_UNIT_M, _div,
                                                geohash_cell_device,
                                                geohash_encode_cell,
                                                haversine_device)
from elasticsearch_tpu_torch.search.joins import (_type_mask,
                                                  parent_locals,
                                                  prepare_tree)
from elasticsearch_tpu_torch.search.queries import (ExistsQuery, RangeQuery,
                                                    _terms_filter_mask,
                                                    parse_query)
from elasticsearch_tpu_torch.utils.dates import (format_date,
                                                 interval_to_millis,
                                                 parse_date)
from elasticsearch_tpu_torch.utils.errors import SearchParseException

DEFAULT_SIZE = 10
SHARD_SIZE_MULT = 3


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a float: compared with an f32 tensor it
    means what ``jnp.float32(x)`` means in the reference."""
    return float(np.float32(x))


def _counts(masks):
    """Each mask's doc count, in one copy back."""
    return torch.stack([m.sum() for m in masks]).cpu().numpy()


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------

@register("terms")
class TermsAggregator(Aggregator):
    def collect(self, ctx, mask):
        field = self.body.get("field")
        if field is None:
            raise SearchParseException("terms aggregation requires [field]")
        inv = ctx.inv(field)
        if inv is not None:
            # keyword OR analyzed text: postings-based count over terms
            # (multi-value correct; analyzed strings bucket by token, the
            # reference's fielddata-on-analyzed-string behavior)
            V = len(inv.terms)
            if V == 0:
                return {"buckets": {}, "doc_count_error_upper_bound": 0,
                        "sum_other_doc_count": 0}
            w = mask[inv.doc_ids.clamp(0, ctx.D - 1).to(torch.int64)] \
                & (inv.term_ids < V)
            counts = bucket_count(inv.term_ids, w,
                                  num_buckets=V + 1)[:V].cpu().numpy()
            keys = inv.terms
        else:
            col = ctx.col(field)
            if col is None:
                return {"buckets": {}, "doc_count_error_upper_bound": 0,
                        "sum_other_doc_count": 0}
            # numeric terms: host unique over exact values of selected docs
            sel = (mask & col.exists).cpu().numpy()
            uniq, cnt = np.unique(col.exact[np.nonzero(sel)[0]],
                                  return_counts=True)
            keys = uniq.tolist()
            counts = cnt.astype(np.int64)
        return self._partial(counts, keys, ctx=ctx, field=field, mask=mask)

    def partial_from_counts(self, counts, keys):
        """Shard partial from a precomputed per-ordinal count vector: the
        mesh round (parallel/executor.py) counts on the card; this applies
        the identical shard_size/min_doc_count selection."""
        return self._partial(np.asarray(counts, np.int64), keys)

    def _partial(self, counts, keys, ctx=None, field=None, mask=None):
        size = int(self.body.get("size", DEFAULT_SIZE)) or 2**31
        shard_size = int(self.body.get("shard_size", size * SHARD_SIZE_MULT))
        min_dc = int(self.body.get("min_doc_count", 1))
        order = self.body.get("order", {"_count": "desc"})

        nz = np.nonzero(counts >= max(min_dc, 1))[0]
        # select top shard_size buckets for sub-agg collection
        if len(nz) > shard_size:
            top = nz[np.argsort(-counts[nz], kind="stable")][:shard_size]
        else:
            top = nz
        buckets: Dict[Any, dict] = {}
        total = int(counts.sum())
        kept = 0
        for i in top:
            key = keys[int(i)]
            b = {"doc_count": int(counts[i])}
            kept += b["doc_count"]
            if self.subs and ctx is not None:
                bmask = self._bucket_mask(ctx, field, key, mask)
                b["subs"] = self.collect_subs(ctx, bmask)
            buckets[key] = b
        return {
            "buckets": buckets,
            "sum_other_doc_count": total - kept,
            "order": order,
            "doc_count_error_upper_bound": 0,
        }

    def _bucket_mask(self, ctx, field, key, mask):
        if ctx.inv(field) is not None:
            return mask & _terms_filter_mask(ctx, field, [str(key)])
        col = ctx.col(field)
        return mask & col.exists & (col.values == _f32(float(key)
                                                       - col.offset))

    def reduce(self, partials):
        merged: Dict[Any, dict] = {}
        other = 0
        sub_partials: Dict[Any, list] = {}
        for p in partials:
            other += p.get("sum_other_doc_count", 0)
            for key, b in p["buckets"].items():
                if key in merged:
                    merged[key]["doc_count"] += b["doc_count"]
                else:
                    merged[key] = {"doc_count": b["doc_count"]}
                if "subs" in b:
                    sub_partials.setdefault(key, []).append(b["subs"])
        size = int(self.body.get("size", DEFAULT_SIZE)) or 2**31
        min_dc = int(self.body.get("min_doc_count", 1))
        order = self.body.get("order", {"_count": "desc"})
        (okey, odir), = order.items() if isinstance(order, dict) \
            else [("_count", "desc")]
        reverse = odir == "desc"
        items = [(k, v) for k, v in merged.items() if v["doc_count"] >= min_dc]
        # materialize sub-agg reductions first: ordering may reference one
        sub_reduced: Dict[Any, dict] = {
            k: self.reduce_subs(sub_partials[k]) for k in sub_partials
        }
        sub_names = {s.name for s in self.subs}
        agg_path = okey.split(".")[0] \
            if okey not in ("_count", "_term", "_key") else None
        if okey in ("_term", "_key"):
            items.sort(key=lambda kv: kv[0], reverse=reverse)
        elif agg_path is not None and agg_path in sub_names:
            # order by sub-aggregation metric, e.g. {"max_price": "asc"} or
            # {"the_stats.avg": "desc"} (terms/InternalOrder.Aggregation)
            metric = okey.split(".")[1] if "." in okey else "value"

            def agg_val(kv):
                r = sub_reduced.get(kv[0], {}).get(agg_path, {})
                v = r.get(metric)
                return v if v is not None else float("-inf")

            items.sort(key=lambda kv: (agg_val(kv), str(kv[0])),
                       reverse=reverse)
        else:
            items.sort(key=lambda kv: (kv[1]["doc_count"], str(kv[0])),
                       reverse=reverse)
        dropped = items[size:]
        other += sum(v["doc_count"] for _, v in dropped)
        out_buckets = []
        for k, v in items[:size]:
            b = {"key": k, "doc_count": v["doc_count"]}
            if isinstance(k, (int, np.integer, float)):
                b["key"] = int(k) if float(k).is_integer() else float(k)
            if k in sub_reduced:
                b.update(sub_reduced[k])
            out_buckets.append(b)
        return {
            "doc_count_error_upper_bound": 0,
            "sum_other_doc_count": int(other),
            "buckets": out_buckets,
        }


# ---------------------------------------------------------------------------
# histogram / date_histogram
# ---------------------------------------------------------------------------

def _decimal_format(value: float, pattern: str) -> str:
    """Java DecimalFormat subset for agg `format` strings (reference:
    ValueFormatter.Number): literal prefix/suffix around a ##0.0-style
    number pattern — '0' digits are mandatory, '#' optional."""
    import re as _re

    m = _re.search(r"[#0][#0,]*(?:\.[#0]+)?", pattern)
    if not m:
        return pattern
    num = m.group(0)
    int_part, _, frac_part = num.partition(".")
    min_frac = frac_part.count("0")
    max_frac = len(frac_part)
    s = f"{float(value):.{max_frac}f}" if max_frac else str(int(round(value)))
    if max_frac > min_frac:
        whole, _, frac = s.partition(".")
        frac = frac.rstrip("0").ljust(min_frac, "0")
        s = f"{whole}.{frac}" if frac else whole
    min_int = int_part.replace(",", "").count("0")
    whole = s.split(".")[0].lstrip("-")
    if len(whole) < min_int:
        s = s.replace(whole, whole.zfill(min_int), 1)
    if "," in int_part:
        # grouping separator: Java groups by the distance from the LAST
        # comma to the pattern end (e.g. #,##0 -> groups of 3)
        group = len(int_part) - int_part.rfind(",") - 1
        whole, _, frac = s.lstrip("-").partition(".")
        sign = "-" if s.startswith("-") else ""
        parts = []
        while len(whole) > group:
            parts.insert(0, whole[-group:])
            whole = whole[:-group]
        parts.insert(0, whole)
        s = sign + ",".join(parts) + (f".{frac}" if frac else "")
    return pattern[:m.start()] + s + pattern[m.end():]


@register("histogram")
class HistogramAggregator(ValueSourceAggregator):
    date = False

    def _interval(self):
        iv = self.body.get("interval")
        if iv is None:
            raise SearchParseException("histogram requires [interval]")
        iv = float(iv)
        if iv <= 0:
            raise SearchParseException(f"[interval] must be > 0, got [{iv}]")
        return iv

    def collect(self, ctx, mask):
        vals, exists, offset, col = resolve_values(ctx, self.body)
        interval = self._interval()
        sel = exists & mask
        if col is not None and col.exact is not None:
            # bucket key = floor(v / interval) over the exact host column
            idx = np.nonzero(sel.cpu().numpy())[0]
            if idx.size == 0:
                return {"buckets": {}}
            exact = col.exact[idx]
            keys_exact = np.floor_divide(exact, int(interval)) \
                if float(interval).is_integer() \
                else np.floor(exact / interval)
            uniq, cnt = np.unique(keys_exact, return_counts=True)
            buckets: Dict[float, dict] = {}
            for k, c in zip(uniq.tolist(), cnt.tolist()):
                key = float(k) * interval
                b = {"doc_count": int(c)}
                if self.subs:
                    bmask = self._key_mask(col, vals, exists, key,
                                           interval) & mask
                    b["subs"] = self.collect_subs(ctx, bmask)
                buckets[key] = b
            return {"buckets": buckets}
        # keyword ordinals: bucketing of the f32 channel on the card
        rel = torch.floor((vals + _f32(offset)) / _f32(interval))
        host = torch.where(sel, rel, float("nan")).cpu().numpy()
        host = host[~np.isnan(host)]
        if host.size == 0:
            return {"buckets": {}}
        uniq, cnt = np.unique(host, return_counts=True)
        buckets = {}
        for k, c in zip(uniq.tolist(), cnt.tolist()):
            key = float(k) * interval
            b = {"doc_count": int(c)}
            if self.subs:
                bmask = (rel == _f32(k)) & sel
                b["subs"] = self.collect_subs(ctx, bmask)
            buckets[key] = b
        return {"buckets": buckets}

    @staticmethod
    def _key_mask(col, vals, exists, key, interval):
        """The bucket's sub-aggregation mask: the f32 channel against the
        bucket's edges rounded to f32 (the reference's rule)."""
        lo = key - col.offset
        hi = key + interval - col.offset
        return exists & (vals >= _f32(lo)) & (vals < _f32(hi))

    def _format_key(self, key):
        return key

    def reduce(self, partials):
        merged: Dict[float, int] = {}
        sub_partials: Dict[float, list] = {}
        for p in partials:
            for k, b in p["buckets"].items():
                merged[k] = merged.get(k, 0) + b["doc_count"]
                if "subs" in b:
                    sub_partials.setdefault(k, []).append(b["subs"])
        min_dc = int(self.body.get("min_doc_count", 0))
        keys = sorted(merged)
        out = []
        interval = self._interval()
        if keys and min_dc == 0:
            # ES fills empty buckets between the min and max keys
            full = []
            k = keys[0]
            while k <= keys[-1] + 1e-9:
                full.append(round(k / interval) * interval if interval else k)
                k += interval
            keys = full
        for k in keys:
            dc = merged.get(k, 0)
            if dc < min_dc:
                continue
            b = {"key": self._format_key(k), "doc_count": dc}
            if self.date:
                b["key_as_string"] = format_date(int(k))
                b["key"] = int(k)
            elif self.body.get("format"):
                b["key_as_string"] = _decimal_format(
                    k, str(self.body["format"]))
            if k in sub_partials:
                b.update(self.reduce_subs(sub_partials[k]))
            out.append(b)
        return {"buckets": out}


@register("date_histogram")
class DateHistogramAggregator(HistogramAggregator):
    date = True

    _CAL_MONTHS = {"month": 1, "1M": 1, "M": 1, "quarter": 3, "1q": 3,
                   "q": 3, "year": 12, "1y": 12, "y": 12}

    def _iv(self):
        iv = self.body.get("interval") or self.body.get("calendar_interval") \
            or self.body.get("fixed_interval")
        if iv is None:
            raise SearchParseException("date_histogram requires [interval]")
        return iv

    def _cal_months(self):
        """Months per bucket for calendar intervals, None for fixed: the
        one switch collect() and reduce() both consult, so they can never
        disagree on which keying the partials carry."""
        iv = self._iv()
        if interval_to_millis(iv) is not None:
            return None
        months = self._CAL_MONTHS.get(str(iv))
        if months is None:
            raise SearchParseException(f"unknown date interval [{iv}]")
        return months

    def _interval(self):
        ms = interval_to_millis(self._iv())
        if ms is None:
            # nominal width for the base class's gap-stepping; calendar
            # intervals never reach the base reduce (reduce() overrides)
            return self._cal_months() * 2_629_746_000.0
        return float(ms)

    def collect(self, ctx, mask):
        """Calendar intervals (month/quarter/year) bucket on exact
        calendar boundaries, month indices via numpy datetime64; fixed
        intervals take the base class's path. Reference:
        common/rounding/TimeZoneRounding.java (UTC case)."""
        months = self._cal_months()
        if months is None:
            return super().collect(ctx, mask)
        vals, exists, offset, col = resolve_values(ctx, self.body)
        idx = np.nonzero((exists & mask).cpu().numpy())[0]
        if idx.size == 0:
            return {"buckets": {}}
        if col is not None and col.exact is not None:
            millis = col.exact[idx].astype(np.int64)
        else:
            millis = (vals.cpu().numpy().astype(np.float64)[idx]
                      + float(offset)).astype(np.int64)
        stamps = millis.astype("datetime64[ms]")
        midx = stamps.astype("datetime64[M]").astype(np.int64)
        bucket_m = np.floor_divide(midx, months) * months
        keys = bucket_m.astype("datetime64[M]").astype(
            "datetime64[ms]").astype(np.int64)
        uniq, cnt = np.unique(keys, return_counts=True)
        buckets: Dict[float, dict] = {}
        for k, c in zip(uniq.tolist(), cnt.tolist()):
            b = {"doc_count": int(c)}
            if self.subs:
                dmask = np.zeros(ctx.D, bool)
                dmask[idx[keys == k]] = True
                b["subs"] = self.collect_subs(
                    ctx, torch.from_numpy(dmask).to(mask.device) & mask)
            buckets[float(k)] = b
        return {"buckets": buckets}

    def reduce(self, partials):
        """Calendar intervals gap-fill by stepping months, not a fixed
        width: the base reduce re-grids keys at interval multiples, which
        would clobber exact calendar keys with zero-count buckets."""
        months = self._cal_months()
        if months is None:
            return super().reduce(partials)
        merged: Dict[float, int] = {}
        sub_partials: Dict[float, list] = {}
        for p in partials:
            for k, b in p["buckets"].items():
                merged[k] = merged.get(k, 0) + b["doc_count"]
                if "subs" in b:
                    sub_partials.setdefault(k, []).append(b["subs"])
        min_dc = int(self.body.get("min_doc_count", 0))
        keys = sorted(merged)
        if keys and min_dc == 0:
            m0 = int(np.datetime64(int(keys[0]), "ms").astype(
                "datetime64[M]").astype(np.int64))
            m1 = int(np.datetime64(int(keys[-1]), "ms").astype(
                "datetime64[M]").astype(np.int64))
            keys = [float(np.datetime64(m, "M").astype(
                "datetime64[ms]").astype(np.int64))
                for m in range(m0, m1 + 1, months)]
        out = []
        for k in keys:
            dc = merged.get(k, 0)
            if dc < min_dc:
                continue
            b = {"key": int(k), "doc_count": dc,
                 "key_as_string": format_date(int(k))}
            if k in sub_partials:
                b.update(self.reduce_subs(sub_partials[k]))
            out.append(b)
        return {"buckets": out}


# ---------------------------------------------------------------------------
# range family
# ---------------------------------------------------------------------------

@register("range")
class RangeAggregator(Aggregator):
    date = False

    def _parse_bound(self, v, fm):
        if v is None:
            return None
        if self.date and isinstance(v, str):
            return parse_date(v, fm.fmt if fm
                              else "strict_date_optional_time||epoch_millis")
        return float(v)

    def collect(self, ctx, mask):
        field = self.body.get("field")
        fm = ctx.mappings.get(field) if field else None
        specs, bmasks = [], []
        for r in self.body.get("ranges", []):
            frm = self._parse_bound(r.get("from"), fm)
            to = self._parse_bound(r.get("to"), fm)
            key = r.get("key") or f"{r.get('from', '*')}-{r.get('to', '*')}"
            _, rmask = RangeQuery(field, gte=frm, lt=to).execute(ctx)
            specs.append((key, frm, to))
            bmasks.append(mask & rmask)
        if not specs:
            return {"buckets": {}}
        # one copy back for every bucket's count
        out: Dict[str, dict] = {}
        for (key, frm, to), cnt, bmask in zip(specs, _counts(bmasks), bmasks):
            b = {"doc_count": int(cnt), "from": frm, "to": to}
            if self.subs:
                b["subs"] = self.collect_subs(ctx, bmask)
            out[key] = b
        return {"buckets": out}

    def reduce(self, partials):
        merged: Dict[str, dict] = {}
        sub_partials: Dict[str, list] = {}
        for p in partials:
            for k, b in p["buckets"].items():
                if k in merged:
                    merged[k]["doc_count"] += b["doc_count"]
                else:
                    merged[k] = {"doc_count": b["doc_count"],
                                 "from": b["from"], "to": b["to"]}
                if "subs" in b:
                    sub_partials.setdefault(k, []).append(b["subs"])
        out = []
        for k, v in merged.items():
            b = {"key": k, "doc_count": v["doc_count"]}
            if v["from"] is not None:
                b["from"] = v["from"]
            if v["to"] is not None:
                b["to"] = v["to"]
            if k in sub_partials:
                b.update(self.reduce_subs(sub_partials[k]))
            out.append(b)
        return {"buckets": out}


@register("date_range")
class DateRangeAggregator(RangeAggregator):
    date = True


@register("ip_range")
class IpRangeAggregator(RangeAggregator):
    def _parse_bound(self, v, fm):
        if v is None:
            return None
        import ipaddress

        return float(int(ipaddress.ip_address(v)))


# ---------------------------------------------------------------------------
# filter / filters / global / missing / sampler / significant_terms
# ---------------------------------------------------------------------------

def _filter_query(body, ctx):
    """A filter's parsed query, its joins prepared over the shard."""
    q = parse_query(body)
    prepare_tree(q, ctx.all_segments, ctx.mappings, ctx.analysis)
    return q


@register("filter")
class FilterAggregator(Aggregator):
    def collect(self, ctx, mask):
        _, fmask = _filter_query(self.body, ctx).execute(ctx)
        bmask = mask & fmask
        # the count stays on the card; reduce sums and copies it once
        out = {"doc_count": bmask.sum()}
        if self.subs:
            out["subs"] = self.collect_subs(ctx, bmask)
        return out

    def reduce(self, partials):
        out = {"doc_count": int(sum(p["doc_count"] for p in partials))}
        subs = [p["subs"] for p in partials if "subs" in p]
        if subs:
            out.update(self.reduce_subs(subs))
        return out


@register("filters")
class FiltersAggregator(Aggregator):
    def collect(self, ctx, mask):
        specs = self.body.get("filters", {})
        items = list(specs.items() if isinstance(specs, dict)
                     else enumerate(specs))
        keys, bmasks = [], []
        for key, q in items:
            _, fmask = _filter_query(q, ctx).execute(ctx)
            keys.append(str(key))
            bmasks.append(mask & fmask)
        if not keys:
            return {"buckets": {}}
        out = {}
        for key, cnt, bmask in zip(keys, _counts(bmasks), bmasks):
            b = {"doc_count": int(cnt)}
            if self.subs:
                b["subs"] = self.collect_subs(ctx, bmask)
            out[key] = b
        return {"buckets": out}

    def reduce(self, partials):
        merged: Dict[str, int] = {}
        sub_partials: Dict[str, list] = {}
        for p in partials:
            for k, b in p["buckets"].items():
                merged[k] = merged.get(k, 0) + b["doc_count"]
                if "subs" in b:
                    sub_partials.setdefault(k, []).append(b["subs"])
        buckets = {}
        for k, dc in merged.items():
            b = {"doc_count": dc}
            if k in sub_partials:
                b.update(self.reduce_subs(sub_partials[k]))
            buckets[k] = b
        return {"buckets": buckets}


@register("global")
class GlobalAggregator(Aggregator):
    def collect(self, ctx, mask):
        gmask = (torch.arange(ctx.D, device=ctx.device)
                 < ctx.segment.num_docs) & ctx.segment.live
        out = {"doc_count": gmask.sum()}
        if self.subs:
            out["subs"] = self.collect_subs(ctx, gmask)
        return out

    reduce = FilterAggregator.reduce


@register("missing")
class MissingAggregator(Aggregator):
    def collect(self, ctx, mask):
        _, em = ExistsQuery(self.body["field"]).execute(ctx)
        bmask = mask & ~em
        out = {"doc_count": bmask.sum()}
        if self.subs:
            out["subs"] = self.collect_subs(ctx, bmask)
        return out

    reduce = FilterAggregator.reduce


@register("sampler")
class SamplerAggregator(Aggregator):
    """best-docs sampler: keeps the first shard_size masked docs (score
    ordering requires the query scores; the reference does not wire them
    through either)."""

    def collect(self, ctx, mask):
        shard_size = int(self.body.get("shard_size", 100))
        m = mask.cpu().numpy()
        locs = np.nonzero(m)[0][:shard_size]
        sm = np.zeros_like(m)
        sm[locs] = True
        out = {"doc_count": int(len(locs))}
        if self.subs:
            out["subs"] = self.collect_subs(
                ctx, torch.from_numpy(sm).to(mask.device))
        return out

    reduce = FilterAggregator.reduce


@register("significant_terms")
class SignificantTermsAggregator(TermsAggregator):
    """JLH-scored foreground vs background terms (significant/heuristics/
    JLHScore.java)."""

    def collect(self, ctx, mask):
        fg = super().collect(ctx, mask)
        inv = ctx.inv(self.body.get("field"))
        bg = {}
        if inv is not None:
            bg = {t: int(inv.df[i]) for t, i in inv.vocab.items()}
        fg["fg_total"] = int(mask.sum())
        fg["bg"] = bg
        fg["bg_total"] = ctx.segment.live_docs
        return fg

    def reduce(self, partials):
        fg_total = sum(p["fg_total"] for p in partials)
        bg_total = sum(p["bg_total"] for p in partials)
        bg: Dict[str, int] = {}
        merged: Dict[str, int] = {}
        for p in partials:
            for t, c in p["bg"].items():
                bg[t] = bg.get(t, 0) + c
            for k, b in p["buckets"].items():
                merged[k] = merged.get(k, 0) + b["doc_count"]
        size = int(self.body.get("size", DEFAULT_SIZE))
        out = []
        for t, fg_count in merged.items():
            bg_count = bg.get(t, fg_count)
            if not fg_total or not bg_total:
                continue
            fg_pct = fg_count / fg_total
            bg_pct = bg_count / bg_total
            if fg_pct <= bg_pct:
                continue
            score = (fg_pct - bg_pct) * (fg_pct / max(bg_pct, 1e-12))  # JLH
            out.append({"key": t, "doc_count": fg_count, "score": score,
                        "bg_count": bg_count})
        out.sort(key=lambda b: -b["score"])
        return {"doc_count": fg_total, "buckets": out[:size]}


@register("nested")
class NestedAggregator(Aggregator):
    """The children of a nested path whose enclosing doc (the root, or a
    doc of a prefix nested level for chained nested aggs) is in the
    incoming mask: one gather a level; the levels' doc spaces are
    disjoint, so at most one gather selects a child."""

    def collect(self, ctx, mask):
        seg = ctx.segment
        path = self.body.get("path")
        if not seg.has_nested or path not in seg.nested_paths:
            out = {"doc_count": 0}
            if self.subs:
                out["subs"] = self.collect_subs(
                    ctx, torch.zeros(ctx.D, dtype=torch.bool,
                                     device=ctx.device))
            return out
        parent_sel = mask[seg.root_id_dev.long()]
        parts = path.split(".")
        for i in range(1, len(parts)):
            pc = seg.nested_paths.get(".".join(parts[:i]))
            if pc is not None:
                anc = seg.ancestors_dev[pc]
                parent_sel = parent_sel | (
                    mask[torch.clamp(anc, min=0).long()] & (anc >= 0))
        child_mask = (seg.nested_code_dev == seg.nested_paths[path]) \
            & parent_sel & seg.live
        out = {"doc_count": child_mask.sum()}
        if self.subs:
            out["subs"] = self.collect_subs(ctx, child_mask)
        return out

    reduce = FilterAggregator.reduce


@register("reverse_nested")
class ReverseNestedAggregator(Aggregator):
    """From child docs back to their roots (or to the level ``path``
    names): the targets of the selected children, marked by one
    scatter."""

    def collect(self, ctx, mask):
        seg = ctx.segment
        if not seg.has_nested:
            out = {"doc_count": mask.sum()}
            if self.subs:
                out["subs"] = self.collect_subs(ctx, mask)
            return out
        D = ctx.D
        path = self.body.get("path")
        pc = seg.nested_paths.get(path) if path is not None else None
        target = seg.ancestors_dev[pc] if pc is not None \
            else seg.root_id_dev
        child_sel = mask & (seg.parent_id_dev >= 0) & (target >= 0)
        tgt = torch.where(child_sel, target, D).long()
        hit = torch.zeros(D + 1, dtype=torch.bool, device=ctx.device)
        hit[tgt] = True
        parent_mask = hit[:D] & seg.live
        out = {"doc_count": parent_mask.sum()}
        if self.subs:
            out["subs"] = self.collect_subs(ctx, parent_mask)
        return out

    reduce = FilterAggregator.reduce


@register("children")
class ChildrenAggregator(Aggregator):
    """The live children (of ``type``) of the selected parents, joined
    within the segment through the ``_parent`` ordinals, as the
    reference's collector joins them."""

    def collect(self, ctx, mask):
        seg = ctx.segment
        child_mask = np.zeros(seg.max_docs, dtype=bool)
        pcol = seg.keywords.get("_parent")
        if pcol is not None:
            # a parent ordinal is picked when its doc is in the mask
            sel = mask.cpu().numpy()
            sel[seg.num_docs:] = False
            at = parent_locals(seg, seg)
            picked = (at >= 0) & sel[np.maximum(at, 0)]
            ords = np.asarray(pcol.ords_host)
            child_mask = picked[np.where(ords >= 0, ords, at.size - 1)] \
                & seg.live_host & _type_mask(seg, self.body.get("type"))
        out = {"doc_count": int(child_mask.sum())}
        if self.subs:
            out["subs"] = self.collect_subs(
                ctx, torch.from_numpy(child_mask).to(ctx.device))
        return out

    reduce = FilterAggregator.reduce


@register("geohash_grid")
class GeohashGridAggregator(Aggregator):
    """One int64 cell id a doc on the card; the occupied cells and their
    counts by ``torch.unique``; the cells' geohashes on the host."""

    def collect(self, ctx, mask):
        field = self.body.get("field")
        if field is None:
            raise SearchParseException("geohash_grid requires [field]")
        precision = int(self.body.get("precision", 5))
        if not 1 <= precision <= 12:
            raise SearchParseException(
                f"geohash_grid precision must be in [1, 12], got "
                f"{precision}")
        lat = ctx.col(f"{field}.lat")
        lon = ctx.col(f"{field}.lon")
        if lat is None or lon is None:
            return {"cells": {}, "precision": precision}
        cells = geohash_cell_device(lat.values + lat.offset,
                                    lon.values + lon.offset, precision)
        sel = mask & lat.exists
        uniq, cnt = torch.unique(cells[sel], return_counts=True)
        out: Dict[int, dict] = {}
        for cell, c in zip(uniq.tolist(), cnt.tolist()):
            b = {"doc_count": int(c)}
            if self.subs:
                b["subs"] = self.collect_subs(ctx, sel & (cells == cell))
            out[int(cell)] = b
        return {"cells": out, "precision": precision}

    def reduce(self, partials):
        merged: Dict[int, int] = {}
        sub_partials: Dict[int, list] = {}
        precision = 5
        for p in partials:
            precision = p.get("precision", precision)
            for cell, b in p.get("cells", {}).items():
                merged[cell] = merged.get(cell, 0) + b["doc_count"]
                if "subs" in b:
                    sub_partials.setdefault(cell, []).append(b["subs"])
        size = int(self.body.get("size", 10_000)) or 10_000
        buckets = []
        for cell, count in sorted(merged.items(),
                                  key=lambda kv: (-kv[1], kv[0]))[:size]:
            b = {"key": geohash_encode_cell(cell, precision),
                 "doc_count": count}
            if cell in sub_partials:
                b.update(self.reduce_subs(sub_partials[cell]))
            buckets.append(b)
        return {"buckets": buckets}


@register("geo_distance")
class GeoDistanceAggregator(Aggregator):
    """Range buckets over the f32 haversine distance from an origin: one
    distance tensor, the buckets' counts in one copy."""

    def collect(self, ctx, mask):
        field = self.body.get("field")
        origin = self.body.get("origin") or self.body.get("point") \
            or self.body.get("center")
        if field is None or origin is None:
            raise SearchParseException(
                "geo_distance requires [field] and [origin]")
        lat0, lon0 = _parse_geo_point(origin)
        unit = self.body.get("unit", "m")
        unit_m = _UNIT_M.get(unit)
        if unit_m is None:
            raise SearchParseException(f"unknown distance unit [{unit}]")
        lat = ctx.col(f"{field}.lat")
        lon = ctx.col(f"{field}.lon")
        dist_u = None
        if lat is not None and lon is not None:
            dist_u = _div(haversine_device(lat.values + lat.offset,
                                           lon.values + lon.offset,
                                           lat0, lon0), unit_m)
        specs, bmasks = [], []
        for r in self.body.get("ranges", []):
            frm = float(r["from"]) if r.get("from") is not None else None
            to = float(r["to"]) if r.get("to") is not None else None
            key = r.get("key") or (f"{'*' if frm is None else frm}-"
                                   f"{'*' if to is None else to}")
            if dist_u is None:
                bmask = torch.zeros(ctx.D, dtype=torch.bool,
                                    device=ctx.device)
            else:
                bmask = mask & lat.exists
                if frm is not None:
                    bmask = bmask & (dist_u >= frm)
                if to is not None:
                    bmask = bmask & (dist_u < to)
            specs.append((key, frm, to))
            bmasks.append(bmask)
        if not specs:
            return {"buckets": {}}
        out: Dict[str, dict] = {}
        for (key, frm, to), cnt, bmask in zip(specs, _counts(bmasks),
                                              bmasks):
            b = {"doc_count": int(cnt), "from": frm, "to": to}
            if self.subs:
                b["subs"] = self.collect_subs(ctx, bmask)
            out[key] = b
        return {"buckets": out}

    reduce = RangeAggregator.reduce
