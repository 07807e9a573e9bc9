"""Continuous metrics substrate: counters, gauges, log-bucketed histograms.

Reference: there is no metrics registry in ES 2.x — the closest ancestors
are the per-section counters NodeStats/ClusterStats aggregate on demand
and the community prometheus-exporter plugin that scraped them. This
module is the continuous view the per-request tracer lacks:
every request updates cheap in-process counters/histograms, and
`GET /_prometheus/metrics` exposes them in text exposition format 0.0.4
(stdlib only), so latency percentiles, cache hit rates, breaker pressure
and compile counts are visible *between* bench rounds, not only when
someone passes ``?profile=true``.

Design constraints, in order:

- **Lock-cheap record.** ``Counter.inc`` / ``Histogram.observe`` take one
  short per-child lock around integer adds; bucket search is a bisect
  over a ~20-entry tuple. No allocation on the steady path (children are
  memoized per label-set).
- **Bounded label cardinality.** Each family caps its label-sets
  (``max_series``); overflow collapses into a reserved ``_other_``
  series instead of growing without bound OR silently dropping counts.
- **Device discipline.** Recording a metric must never touch a device
  value: no device-tensor arguments — pull the scalar to the host
  first, then record the plain float (a ``.item()`` here would
  synchronise the stream on every request).
- **Percentiles from buckets.** Histograms are log-bucketed
  (factor-2 bounds, 100µs … ~100s for latency); p50/p90/p99 are
  estimated by linear interpolation within the covering bucket, and the
  exact observed ``max`` is kept alongside so the estimate's ceiling is
  honest.

Node scoping: each ``Node`` owns a ``MetricsRegistry`` (REST latency,
span histograms, indexing) so in-process multi-node harnesses keep
per-node numbers per-node — the slowlog/translog_recovery discipline.
Subsystems with no node affinity (translog fsync, executor caches via
monitor/kernels) record into the process-shared ``SHARED`` registry,
which every node's exposition includes — the same "the device is
process-shared too" rule residency.py follows.

Clock discipline: durations observed here must come from
``time.perf_counter()`` at the call site; this module never reads a
clock itself.

Port of elasticsearch_tpu/monitor/metrics.py. The registry, the families
and the exposition are the reference's. ``process_counters`` reads the
port's kernel counters, its first-touch count (``jit.traces_total``,
tracing/retrace.py), the kernel-library blob tier's ledger
(monitor/compile_cache.py), the program registry's per-key counters,
the watchdog's trip and incident counters and, since the port's
breakers and residency registry belong to each node, the given node's.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# factor-2 log buckets, 100µs .. ~104s — wide enough for a device-compile
# outlier, fine enough that p50 interpolation on a ~ms latency is useful
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * (2.0 ** i) for i in range(21))

# the reserved label value absorbing overflow past a family's series cap:
# counts are never lost, they just lose per-label attribution
OVERFLOW_LABEL = "_other_"


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr
    (exposition format accepts scientific notation)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def escape_label_value(v: str) -> str:
    """Text-format label escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{escape_label_value(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class Counter:
    """One monotonically-increasing series."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """One settable series (current value, not a rate)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n


class Histogram:
    """One log-bucketed series: cumulative-on-render bucket counts, sum,
    count, and the exact max (estimation honesty: a percentile clamped
    to a bucket bound can overshoot reality; ``max`` bounds it)."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count", "max")

    def __init__(self, bounds: Sequence[float]):
        self._lock = threading.Lock()
        self.bounds: Tuple[float, ...] = tuple(bounds)
        # one slot per finite bound + the +Inf overflow slot
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if v > self.max:
                self.max = v

    def percentile(self, p: float) -> float:
        """Estimate the p-th percentile (0..100) from the buckets:
        linear interpolation within the covering bucket, clamped to the
        exact observed max so a sparse top bucket can't overshoot."""
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            rank = (p / 100.0) * total
            cum = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                prev = cum
                cum += c
                if cum >= rank:
                    frac = (rank - prev) / c
                    est = lo + (max(hi, lo) - lo) * frac
                    # unconditional: with count > 0 the exact max is
                    # valid even at 0.0 (all-zero observations must not
                    # interpolate past it)
                    return min(est, self.max)
            return self.max

    def summary(self) -> dict:
        with self._lock:
            count, total, mx = self.count, self.sum, self.max
        return {
            "count": count,
            "sum_seconds": round(total, 6),
            "p50_seconds": round(self.percentile(50), 6),
            "p90_seconds": round(self.percentile(90), 6),
            "p99_seconds": round(self.percentile(99), 6),
            "max_seconds": round(mx, 6),
        }


class _Family:
    """One named metric with a fixed label-name tuple and memoized
    per-label-set children."""

    def __init__(self, name: str, help_: str, labelnames: Sequence[str],
                 kind: str, child_factory: Callable[[], Any],
                 max_series: int):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self._factory = child_factory
        self._max_series = max_series
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            self._children[()] = child_factory()

    def labels(self, *values: Any):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {key}")
        child = self._children.get(key)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self._max_series:
                    # cardinality cap: collapse, never grow unbounded
                    key = tuple(OVERFLOW_LABEL for _ in key)
                    child = self._children.get(key)
                    if child is not None:
                        return child
                child = self._factory()
                self._children[key] = child
        return child

    # unlabeled-family conveniences
    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def series(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())


class _CallbackFamily:
    """A family whose values are computed at scrape time (queue depths,
    breaker bytes, trace-audit totals): ``collect()`` returns
    ``[(labelvalues_tuple, value), ...]``. ``kind`` may be "counter" for
    monotonic sources owned elsewhere (threadpool rejected totals)."""

    def __init__(self, name: str, help_: str, labelnames: Sequence[str],
                 kind: str, collect: Callable[[], Iterable[Tuple[Tuple, float]]]):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.kind = kind
        self._collect = collect

    def series(self) -> List[Tuple[Tuple[str, ...], float]]:
        try:
            return [(tuple(str(x) for x in k), float(v))
                    for k, v in self._collect()]
        except Exception:
            # a scrape must degrade to a missing section, never a 500
            return []


class MetricsRegistry:
    """Node-wide registry: named families, text exposition, summaries.

    ``include_shared`` folds the process-wide ``SHARED`` registry's
    families into this registry's exposition/summaries (node registries
    do; SHARED itself must not recurse).
    """

    def __init__(self, include_shared: bool = False):
        self._lock = threading.Lock()
        self._families: Dict[str, Any] = {}
        self._include_shared = include_shared

    # -- family constructors (get-or-create; idempotent by name) ------------

    def _family(self, name: str, help_: str, labelnames, kind, factory,
                max_series: int):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, help_, labelnames, kind, factory,
                              max_series)
                self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = (),
                max_series: int = 256) -> _Family:
        return self._family(name, help_, labelnames, "counter", Counter,
                            max_series)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = (),
              max_series: int = 256) -> _Family:
        return self._family(name, help_, labelnames, "gauge", Gauge,
                            max_series)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  max_series: int = 128) -> _Family:
        bounds = tuple(buckets)
        return self._family(name, help_, labelnames, "histogram",
                            lambda: Histogram(bounds), max_series)

    def collector(self, name: str, help_: str, labelnames: Sequence[str],
                  collect: Callable[[], Iterable[Tuple[Tuple, float]]],
                  kind: str = "gauge") -> None:
        """Register a scrape-time family (breaker bytes, queue depths —
        values already counted elsewhere; re-counting them on record
        would double-lock the hot path for no benefit)."""
        with self._lock:
            self._families[name] = _CallbackFamily(name, help_, labelnames,
                                                   kind, collect)

    # -- render --------------------------------------------------------------

    def _all_families(self) -> List[Any]:
        with self._lock:
            fams = list(self._families.values())
        if self._include_shared and self is not SHARED:
            with SHARED._lock:
                fams.extend(SHARED._families.values())
        return sorted(fams, key=lambda f: f.name)

    def expose(self) -> str:
        """Text exposition format 0.0.4 (the format every Prometheus
        scraper and promtool reads)."""
        out: List[str] = []
        for fam in self._all_families():
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            if fam.kind == "histogram":
                for lv, h in fam.series():
                    base = list(zip(fam.labelnames, lv))
                    cum = 0
                    with h._lock:
                        counts = list(h.counts)
                        hsum, hcount = h.sum, h.count
                    for bound, c in zip(h.bounds, counts):
                        cum += c
                        ls = _label_str(
                            [n for n, _ in base] + ["le"],
                            [v for _, v in base] + [_fmt(bound)])
                        out.append(f"{fam.name}_bucket{ls} {cum}")
                    ls = _label_str([n for n, _ in base] + ["le"],
                                    [v for _, v in base] + ["+Inf"])
                    out.append(f"{fam.name}_bucket{ls} {hcount}")
                    ls = _label_str(fam.labelnames, lv)
                    out.append(f"{fam.name}_sum{ls} {_fmt(hsum)}")
                    out.append(f"{fam.name}_count{ls} {hcount}")
            else:
                for lv, child in fam.series():
                    v = child.value if hasattr(child, "value") else child
                    ls = _label_str(fam.labelnames, lv)
                    out.append(f"{fam.name}{ls} {_fmt(v)}")
        return "\n".join(out) + "\n"

    def summaries(self) -> dict:
        """Histogram percentile summaries + counter totals for the
        ``metrics`` section of ``/_nodes/stats`` — the JSON view of the
        same numbers the exposition carries."""
        out: Dict[str, Any] = {}
        for fam in self._all_families():
            if fam.kind == "histogram":
                out[fam.name] = [
                    {"labels": dict(zip(fam.labelnames, lv)), **h.summary()}
                    for lv, h in fam.series()]
            elif isinstance(fam, _Family):
                out[fam.name] = [
                    {"labels": dict(zip(fam.labelnames, lv)),
                     "value": child.value}
                    for lv, child in fam.series()]
        return out

    def counter_values(self) -> Dict[str, float]:
        """Flat ``name{a=b}`` → value map of counter families (the bench
        before/after delta reads this)."""
        out: Dict[str, float] = {}
        for fam in self._all_families():
            if fam.kind != "counter" or not isinstance(fam, _Family):
                continue
            for lv, child in fam.series():
                out[fam.name + _label_str(fam.labelnames, lv)] = child.value
        return out


#: process-shared registry for subsystems with no node affinity
#: (translog fsync, transport frames from non-bootstrap embedders);
#: node registries fold it into their exposition
SHARED = MetricsRegistry(include_shared=False)


def span_sink(registry: MetricsRegistry) -> Callable[[Any], None]:
    """Tracer-sink adapter: every finished span lands in a latency
    histogram labeled by span name (bounded: span names are
    instrumentation-defined, not data-derived), plus an error counter —
    the whole span substrate becomes time-series without re-instrumenting
    a single call site. Install via ``Tracer.set_sink``."""
    hist = registry.histogram(
        "estpu_span_duration_seconds",
        "Latency of every finished tracer span, by span name",
        ("span",))
    errs = registry.counter(
        "estpu_span_errors_total",
        "Spans that finished with an error, by span name", ("span",))

    def sink(span) -> None:
        hist.labels(span.name).observe(span.duration)
        if span.error:
            errs.labels(span.name).inc()

    return sink


# -- process-wide counter snapshot (bench before/after delta) ---------------

def process_counters(node) -> Dict[str, float]:
    """One flat map of the monotonic counters a bench run moves: kernel
    launches and dispatch decisions (monitor/kernels.py), ``node``'s
    residency evictions/rehydrations and breaker trips (the port's
    breakers and residency registry belong to a node, ROADMAP C20) and
    the SHARED registry's counters, and the watchdog's trips and
    incidents of the process (``watchdog.trips[.<detector>]``,
    ``watchdog.incidents``), the first-touch count (``jit.traces_total``),
    the blob tier's ``compile_cache.*`` ledger and the program registry's
    ``programs.<program>|<shapes>.*`` counters. A bench snapshots this
    before and after a run and reports the delta."""
    out: Dict[str, float] = {}
    from elasticsearch_tpu_torch.monitor import compile_cache, kernels
    from elasticsearch_tpu_torch.monitor import programs as _programs
    from elasticsearch_tpu_torch.tracing import retrace

    for k, v in kernels.snapshot().items():
        out[f"kernels.{k}"] = float(v)
    out["jit.traces_total"] = float(retrace.auditor().total())
    out.update(compile_cache.counter_values())
    out.update(_programs.REGISTRY.counter_values())
    st = node.residency.stats()
    ev = rh = 0
    for t in st.get("tiers", {}).values():
        ev += t.get("evictions", 0)
        rh += t.get("rehydrations", 0)
    out["residency.evictions"] = float(ev)
    out["residency.rehydrations"] = float(rh)
    for name, br in node.breakers.stats().items():
        out[f"breakers.{name}.tripped"] = float(br.get("tripped", 0))
    from elasticsearch_tpu_torch.monitor import flight

    out.update(flight.trip_counters())
    out.update(SHARED.counter_values())
    return out


def counters_delta(before: Dict[str, float],
                   after: Dict[str, float]) -> Dict[str, Optional[float]]:
    """after - before, keeping every key either side saw. A counter that
    was UNKNOWN on either side (a -1 snapshot sentinel, or an explicit
    None) deltas to ``None`` — the typed absence JSON
    renders as null, so consumers can't mix it into arithmetic the way
    the old -1 leaked into sums (never a fake 0 either)."""
    out: Dict[str, Optional[float]] = {}
    for k in sorted(set(before) | set(after)):
        b, a = before.get(k, 0.0), after.get(k, 0.0)
        if b is None or a is None or b < 0 or a < 0:
            out[k] = None
        else:
            v = a - b
            out[k] = int(v) if v == int(v) else v
    return out
