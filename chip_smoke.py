#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (elasticsearch_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device   the card's name, power limit and compute capability;
2. build    every CUDA kernel, from the sources in the checkout (nvcc,
            sm_90a, one process per source, all started together), with
            each kernel's registers and spill bytes;
3. kernels  each kernel against its plain PyTorch twin on the card, bit
            for bit: B1 bm25_dense_topk (all-rows and rows forms: rows of
            a whole 256-row block with pads and repeats, R 1 to 256, the
            hit count exact, f32 subnormals that round to bf16 zero, k up
            to 1000, ragged D, ties, Q=9, the batched form, and at
            Q=2048 with the count, _msearch's tier 1), B2 knn_topk
            (three metrics, both precisions, k up to 1000, ragged D, ties,
            a 90% mask, D under one chunk, Q=9, Q=32 and Q=64 at k=100
            (_msearch's kNN and MaxSim batches), 768 to 40,000 dims
            (narrow ring stages, no staging), an unaligned slab, zero
            rows), B3 adc_scores (the table-sum, and the fused form over a
            whole code table: IVF-shaped slots with pads, filters at 10%
            and 0%, all padded, W=1, unaligned codes, M 8 to 64) and B4
            maxsim_adc (W 1 to 81,920, M 1-64, K 64-256, T 1-100, negative
            tables, a NaN in a later token group, unaligned codes);
4. write    the write path through ``Node``: index, refresh, search,
            delete, checked against the same Node on the CPU;
5. read     the BM25 read path: a 2^20-doc MS-MARCO-shaped corpus loaded
            with ``segment_from_arrays``, 32 Zipfian ``match`` queries
            through ``Node.search`` (B1's launch counts are taken over
            exactly this run), hits held against the plain twin and an
            exact numpy scorer; one fused query must run B1's two
            kernels and one copy each way, nothing else, through the
            mesh path (one slot);
5b. vectors the kNN read path: 1,000,000 SIFT-shaped 128-d vectors
            (``bench.py::make_sift_node``'s recipe) padded to 2^20, IVF
            (C = 4000) and PQ (M = 32, K = 256) built twice on the card
            and required identical, then brute-force, filtered, MaxSim,
            IVF-PQ and filtered IVF-PQ ``knn`` queries through
            ``Node.search`` (B2's and B3's launch counts are taken over
            exactly this run), hits held against the plain twins and an
            exact f64 numpy oracle; one IVF-PQ query must launch B3 once;
5c. hybrid  the hybrid read path: one 2^20-doc segment holding phase 5's
            text field and phase 5b's slab (its IVF and PQ carried
            across), 56 ``hybrid`` queries through ``Node.search`` (RRF,
            linear, an IVF-PQ knn side, a filtered knn side, MaxSim
            re-ranks of a 100-doc window over the slab and over the PQ
            codes; the launches of B2, B3 and B4 are taken over exactly
            this run, per query), hits held against the plain twins, a
            numpy fusion of the engines' own rows and f64 MaxSim;
5d. mesh    phase 5's corpus and 5b's slab split over five shards by
            ``shard_id_for`` (ES 2.0's default shard count), one segment
            a shard: phase 5's 32 queries and 8 brute-force knn queries
            on the default mesh path and on the host loop (the same hits,
            totals exact against the f64 scorer; p50, device time, busy
            share, kernels and copies per query of both),
            ``search_knn`` at Q = 8 against the B2 twin and the oracle,
            and cProfile's top 10 of one match query on each path;
5e. msearch ``Node.msearch`` and the serving coalescer, with bench.py's
            recipes: (a) 2048 pure-dense bodies on phase 5's index, one
            B1 launch over all rows with the count, held against
            sequential ``Node.search`` and bit for bit against a rerun on
            the B1 twin; (b) 2048 mixed Zipfian bodies (tier 2: the f32
            product and the tails' scatters); (c) 256 mixed bodies on
            phase 5d's five shards through the mesh's batched round,
            against the host tiers and sequential searches; (d) 32
            brute-force kNN and 8 MaxSim bodies on phase 5b's slab, one
            B2 launch each, against sequential searches and the f64
            oracle; (e) (a)'s bodies as single searches from 64 threads
            through the coalescer, equal to (a)'s; queries per second,
            device time, kernels and copies, busy share;
5f. aggs    aggregations on a stand-in for Elastic Rally's ``nyc_taxis``
            track: 4,194,304 generated trips in four shards of one
            2^20-doc segment, the track's aggregation bodies (histogram
            with stats, date_histogram, keyword terms on the mesh's
            device route, terms with an avg, cardinality, percentiles,
            extended_stats, range, missing, filters) on the mesh path and
            the host loop, byte-identical and held against numpy (HLL
            registers against a numpy build of the same hash); p50, p99,
            device time, kernels, copies and busy share per body and
            route;
5g. sort    field sort and the request tail on phase 5f's node: Rally's
            ``desc_sort_*`` form (total_amount desc), 10 pages of 100 by
            ``search_after`` on pickup_datetime, vendor_id then
            trip_distance desc (3 values over 2^20 docs a shard),
            tip_amount with ``missing`` last and first (card trips have
            no tip), a score-ordered ``scroll`` of 25 pages of 1000 and a
            ``scan`` (geonames' scroll), ``min_score``,
            ``terminate_after`` and ``timeout``, ``profile``, and
            ``highlight`` on a small text index written through
            ``Node.index``; every body on each route it takes, held
            against numpy (``np.lexsort``, exact totals); p50, p99,
            device time, kernels, copies and busy share per body and
            route;
5h. writes  the write path and merges (``phase_writepath``): 65,536
            generated log docs (Zipf(1.1) bodies of 20-80 tokens over
            phase 5's vocabulary, a keyword, a long, a date) through
            ``Node.index`` into five shards with 32 refreshes, so the
            tiered policy folds ~32 fresh segments a shard into ~4, and a
            second index of a tenth as many; the mesh's full deep page
            past a round's padded width (C1), B1 on merged segments,
            responses after ``force_merge(1)`` and after a delete-reclaim
            merge byte-identical to one-refresh rebuilds of the live docs
            (C2), no retired segment in the executors and the breakers at
            the live segments' bytes, dfs on both routes and over two
            indices against an f64 scorer, multi-index search with
            ``indices_boost`` and ``fields`` against a CPU Node, the
            request cache; the ingest rate, refresh and merge times,
            breaker bytes and read p50/p99s;
5i. text    the full-text DSL (``phase_fulltext``): phase 5's 2^20-doc
            corpus again with each token's position kept (~63M positions
            in a term-major, doc-ascending positional CSR, one stable
            sort) and a title field of each doc's first 10 tokens,
            loaded through ``segment_from_arrays``; groups of bodies
            drawn from the corpus (match_phrase of 2-3 consecutive tokens
            at slop 0 and 2, Rally pmc's ``phrase`` shape; multi_match
            best_fields over title and body; prefix; wildcard; fuzzy;
            match with fuzziness; dis_max; boosting; query_string with a
            quoted phrase, a prefix and AND; common), each on the mesh
            path and the host loop for about a second: responses
            byte-identical across the routes, every doc's phrase
            frequency against an f64 numpy oracle over the host positions
            (exact at slop 0), totals and top hits against the oracle's
            scores, every body against a CPU Node of the port on a
            2^14-doc prefix, and the CSR's bytes released when the node
            closes; p50, p99, device time, kernels, copies and busy share
            per group and route;
6. timing   each kernel, its plain twin, a library yardstick and the
            card's bound at the main path's shape (B1 and B3 also at
            their earlier shapes, B2 at phase 5e's batch shapes), by CUDA
            events and by the profiler's device time ("not measured"
            where it records none twice).

Each corpus is generated once and shared by the phases that read it.

The last three lines of standard output are the ``{"kernels": [...]}``
record, the card's name and power limit (as ``nvidia-smi`` gives them),
and ``{"ok": true, "device": {...}}``. The script needs a CUDA card and
the repository around it; without either it fails.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores

N_DOCS = 1 << 20          # product bench size (bench.py --docs default)
VOCAB = 30_000
N_QUERIES = 32
SEED = 0

N_VECS = 1_000_000        # SIFT1M (BASELINE.json configs[2])
DIMS = 128
IVF_LISTS = 4000
PQ_CANDIDATES = 10_000     # num_candidates of the IVF-PQ queries


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def check_topk(v, i, pv, pi, what: str, rtol: float = 1e-5) -> float:
    """Kernel (v, i) against the plain twin (pv, pi), rows of [Q, k+1]
    for the twin where k < D: values at rtol; ids equal wherever a value
    is more than rtol away from its neighbours (ties may permute).
    Returns the max abs error over finite values."""
    import numpy as np

    k = v.shape[1]
    both = np.isfinite(pv[:, :k])
    if not np.array_equal(np.isfinite(v), both) or not np.allclose(
            np.where(both, v, 0), np.where(both, pv[:, :k], 0), rtol=rtol,
            atol=0):
        raise AssertionError(f"{what}: values disagree with the plain twin")
    for q in range(v.shape[0]):
        row = pv[q]
        for j in range(k):
            near = lambda a, b: a == b or (np.isfinite(a) and np.isfinite(b)
                                           and abs(a - b) <= rtol * abs(b))
            tied = (j > 0 and near(row[j - 1], row[j])) or (
                j + 1 < row.shape[0] and near(row[j], row[j + 1]))
            if not tied and i[q, j] != pi[q, j]:
                raise AssertionError(
                    f"{what}: id at row {q} rank {j} is {i[q, j]}, plain "
                    f"twin has {pi[q, j]}")
    return float(np.max(np.abs(np.where(both, v - pv[:, :k], 0)),
                        initial=0.0))


def check_hits(got: dict, want: dict, what: str, rtol: float = 1e-5):
    """Two search responses: same total, scores at rtol, ids equal
    outside groups of near-equal scores."""
    import numpy as np

    if got["hits"]["total"] != want["hits"]["total"]:
        raise AssertionError(f"{what}: total {got['hits']['total']} != "
                             f"{want['hits']['total']}")
    g, w = got["hits"]["hits"], want["hits"]["hits"]
    if len(g) != len(w):
        raise AssertionError(f"{what}: {len(g)} hits != {len(w)}")
    if not g:
        return
    gv = np.array([[h["_score"] for h in g]], np.float64)
    wv = np.array([[h["_score"] for h in w] + [-np.inf]], np.float64)
    ids = {h["_id"]: n for n, h in enumerate(w + g)}
    gi = np.array([[ids[h["_id"]] for h in g]])
    wi = np.array([[ids[h["_id"]] for h in w] + [-1]])
    check_topk(gv, gi, wv, wi, what, rtol=rtol)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    from elasticsearch_tpu_torch.utils.device import is_hopper, resolve_device

    dev = resolve_device()
    line = card_line()
    cap = torch.cuda.get_device_capability(dev)
    log(f"[device] {line}; capability {cap[0]}.{cap[1]}; hopper "
        f"{is_hopper(dev)}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    return dev, line


def ptxas_usage(text: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] of each
    entry function in ``nvcc -Xptxas -v`` output, names demangled where
    ``c++filt`` exists."""
    rows, name, spill = [], None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.split("\n")
        for r, n in zip(rows, names):
            # knn_chunk_topk<8, 0>: the name and template arguments only
            r[0] = re.sub(r"\(anonymous namespace\)::", "", n).split("(")[0]
    return [tuple(r) for r in rows]


def phase_build():
    from elasticsearch_tpu_torch.ops import build

    t0 = time.perf_counter()
    out = build.build_all()
    spilled = []
    for name, text in out.items():
        usage = ptxas_usage(text)
        log(f"[build] {name}: " + (" | ".join(
            f"{fn} {regs} registers, spill {st}/{ld} bytes"
            for fn, regs, st, ld in usage) or "cached"))
        spilled += [f"{name} {fn} ({st}/{ld} bytes)"
                    for fn, _, st, ld in usage if st or ld]
    if any(out.values()):  # a cached library prints nothing
        log("[build] spill stores/loads: " + (", ".join(spilled) or "none"))
    log(f"[build] {len(out)} libraries in {time.perf_counter() - t0:.1f} s")


def _b1_inputs(torch, dev, Q, F, D, seed, quant=None, prefix=0):
    """Seeded qw f32[Q, F] (idf-like), impact f32[F, D] (tfnorm-like,
    sparse), mask bool[D]; ``quant`` quantizes the impacts into heavy
    ties, ``prefix`` masks the first docs out."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qw = torch.rand(Q, F, generator=g, device=dev) * 3
    if quant is not None:
        impact = torch.round(torch.rand(F, D, generator=g, device=dev)
                             / quant) * quant
    else:
        keep = torch.rand(F, D, generator=g, device=dev) < 0.2
        impact = keep * torch.rand(F, D, generator=g, device=dev) * 2.2
    mask = torch.rand(D, generator=g, device=dev) > 0.2
    mask[:prefix] = False
    return qw.contiguous(), impact.contiguous(), mask.contiguous()


def phase_kernels(torch, dev) -> dict:
    """Max abs error of each kernel against its twin, by kernel name."""
    return {"bm25_dense_topk": _kernels_b1(torch, dev),
            "knn_topk": _kernels_b2(torch, dev),
            "adc_scores": _kernels_b3(torch, dev),
            "maxsim_adc": _kernels_b4(torch, dev)}


def _kernels_b1(torch, dev) -> float:
    """B1 against its twin, bit for bit with exact counts (the bf16
    products are exact in f32 and both sides add them in increasing row
    order; ties go to the lower doc id on both sides): the all-rows form
    and the rows form (rows of a whole 256-row block, pads at -1,
    repeated rows) with the hit count."""
    from elasticsearch_tpu_torch.ops.bm25_topk import bm25_dense_topk

    def check(name, qw, impact, mask, k, rows=None, count=None):
        count = rows is not None if count is None else count
        got = bm25_dense_topk(qw, impact, mask, k=k, rows=rows, count=count)
        torch.cuda.synchronize()
        want = bm25_dense_topk(qw, impact, mask, k=k, rows=rows,
                               count=count, plain=True)
        what = (f"bm25_dense_topk {name} Q={qw.shape[0]} R={qw.shape[1]} "
                f"D={impact.shape[1]} k={k}")
        check_exact(got[0].cpu().numpy(), got[1].cpu().numpy(),
                    want[0].cpu().numpy(), want[1].cpu().numpy(), what)
        if count and not torch.equal(got[2], want[2]):
            raise AssertionError(f"{what}: hit counts {got[2].tolist()} vs "
                                 f"the twin's {want[2].tolist()}")
        log(f"[kernels] {what}: bit-equal to the plain twin"
            + (f", counts equal ({got[2].tolist()[:3]})" if count else ""))
        return got

    cases = [  # (name, Q, F, D, k, quant, masked prefix)
        ("single query", 1, 8, 1 << 20, 10, None, 0),
        ("k=1000", 1, 8, 1 << 20, 1000, None, 0),
        ("quantized ties, masked prefix", 16, 16, 4096, 10, 1.0, 600),
        ("batched", 256, 256, 1 << 20, 10, None, 0),
        # both sides of the running list (k <= 128), ragged D
        ("k=1", 1, 8, 70_001, 1, None, 0),
        ("k=32", 3, 8, 1_000_003, 32, None, 0),
        ("k=33", 1, 16, 1 << 20, 33, 0.5, 0),
        ("k=129", 2, 8, 300_000, 129, None, 0),
    ]
    for n, (name, Q, F, D, k, quant, prefix) in enumerate(cases):
        qw, impact, mask = _b1_inputs(torch, dev, Q, F, D, 100 + n, quant,
                                      prefix)
        check(name, qw, impact, mask, k)
        del qw, impact, mask
    # _msearch tier 1's shape: 2048 queries over all rows with the count,
    # weights on a few rows a query (D cut so the twin's [Q, D] fits)
    qw, impact, mask = _b1_inputs(torch, dev, 2048, 256, 1 << 16, 118)
    keep = torch.rand(qw.shape, generator=torch.Generator(
        device=dev).manual_seed(119), device=dev) < 4 / 256
    check("batched, msearch tier 1", (qw * keep).contiguous(), impact, mask,
          10, count=True)
    del qw, impact, mask, keep
    # one query row past a launch's 65,535: two launches whose rows stack
    # (D cut so the twin's [Q, D] fits)
    qw, impact, mask = _b1_inputs(torch, dev, 65_536, 16, 4096, 120)
    check("batched, past one launch (two launches)", qw, impact, mask, 10,
          count=True)
    del qw, impact, mask

    # the rows form over one whole block of 256 rows, as a segment holds
    _, block, mask = _b1_inputs(torch, dev, 1, 256, 1 << 20, 121)

    def pick(R, Q=1, pads=0, repeat=False, seed=0):
        gg = torch.Generator(device=dev).manual_seed(130 + seed)
        rows = torch.randperm(256, generator=gg, device=dev)[:R]
        if repeat:
            rows[R // 2:] = rows[:R - R // 2]
        rows = rows.to(torch.int32)
        if pads:  # pads at -1 and outside the block, anywhere in the list
            at = torch.randperm(R, generator=gg, device=dev)[:pads]
            rows[at] = torch.tensor([(-1, 256, -7, 1000)[i % 4]
                                     for i in range(pads)],
                                    dtype=torch.int32, device=dev)
        qw = torch.rand(Q, R, generator=gg, device=dev) * 3
        return qw.contiguous(), rows.contiguous()

    for n, (R, Q, pads, repeat, k) in enumerate((
            (1, 1, 0, False, 10), (3, 1, 1, False, 10), (8, 1, 0, False, 10),
            (8, 1, 3, False, 10), (16, 1, 4, True, 10), (16, 1, 0, False, 100),
            (5, 1, 2, False, 1000), (16, 9, 3, False, 10),
            (256, 1, 0, False, 10))):
        qw, rows = pick(R, Q, pads, repeat, n)
        check(f"rows form ({pads} pads{', repeated rows' if repeat else ''})",
              qw, block, mask, k, rows)
    del block
    # ragged D (the scalar loads) and quantized ties, in the rows form
    qw, impact, mask = _b1_inputs(torch, dev, 2, 12, 1_000_003, 140, 0.5, 77)
    rows = torch.tensor([3, -1, 0, 11, 5, 5], dtype=torch.int32, device=dev)
    check("rows form, ragged D, quantized ties", qw[:, :6].contiguous(),
          impact, mask, 10, rows)
    # f32 subnormals: their bf16 rounding is 0, their hits still count
    impact = torch.zeros(4, 1 << 16, device=dev)
    impact[1, ::7] = 2.0 ** -140
    impact[2, ::5] = 1.5
    mask = torch.ones(1 << 16, dtype=torch.bool, device=dev)
    qw = torch.ones(1, 3, device=dev)
    rows = torch.tensor([1, -1, 2], dtype=torch.int32, device=dev)
    got = check("subnormal impacts", qw, impact, mask, 10, rows)
    want = len(set(range(0, 1 << 16, 7)) | set(range(0, 1 << 16, 5)))
    if int(got[2][0]) != want:
        raise AssertionError(f"bm25_dense_topk subnormal hits: "
                             f"{int(got[2][0])} counted, {want} expected")
    del qw, impact, mask
    torch.cuda.empty_cache()
    return 0.0


def check_exact(v, i, pv, pi, what: str) -> float:
    """Kernel (v, i) against its twin (pv, pi): the same bits and (unless
    the ids are None) the same ids in every slot. Returns the max abs
    error (0)."""
    import numpy as np

    if v.shape != pv.shape:
        raise AssertionError(f"{what}: shape {v.shape} != {pv.shape}")
    if not np.array_equal(v.view(np.uint32), pv.view(np.uint32)):
        bad = np.argwhere(v.view(np.uint32) != pv.view(np.uint32))
        raise AssertionError(f"{what}: values differ from the plain twin at "
                             f"{bad[:3].tolist()}: {v[tuple(bad[0])]} vs "
                             f"{pv[tuple(bad[0])]}")
    if i is not None and not np.array_equal(i, pi):
        bad = np.argwhere(i != pi)
        raise AssertionError(f"{what}: ids differ from the plain twin at "
                             f"{bad[:3].tolist()}")
    return 0.0


def _b2_inputs(torch, dev, Q, D, dims, seed, live=0.9, quant=None):
    """Seeded queries f32[Q, dims], slab f32[D, dims], mask bool[D];
    ``quant`` rounds the vectors to multiples of it (heavy ties)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(Q, dims, generator=g, device=dev)
    v = torch.randn(D, dims, generator=g, device=dev)
    if quant is not None:
        q = torch.round(q / quant) * quant
        v = torch.round(v / quant) * quant
    mask = torch.rand(D, generator=g, device=dev) < live
    return q.contiguous(), v.contiguous(), mask.contiguous()


def _kernels_b2(torch, dev) -> float:
    """B2 against its twin, bit for bit in both precisions: each sum runs
    in increasing dims with one rounding per operation on both sides."""
    from elasticsearch_tpu_torch.ops.knn_topk import knn_topk
    from elasticsearch_tpu_torch.utils import shapes

    ks = (1, 10, 100, 1000)
    cases = []  # (name, Q, D, dims, k, metric, precise, live, quant)
    for c, (metric, precise) in enumerate(
            (m, p) for m in ("cosine", "dot_product", "l2_norm")
            for p in (False, True)):
        for j, k in enumerate(ks):
            cases.append((f"{metric} {'f32' if precise else 'bf16'}",
                          (1, 8)[j % 2], (1 << 20, 1_000_003)[(j + c) % 2],
                          (128, 100)[(j // 2) % 2], k, metric, precise, 0.9,
                          None))
    cases += [("quantized ties", 8, 1 << 20, 128, 100, "dot_product", True,
               0.9, 0.5),
              ("4-byte staging (dims % 4 != 0)", 1, 1 << 20, 37, 10,
               "l2_norm", True, 0.9, None),
              ("90% masked", 1, 1 << 20, 128, 100, "cosine", False, 0.1,
               None)]
    # the staging plan's edges: each bit-equal too
    cases += [("D smaller than one chunk", 3, 1000, 128, 10, "cosine", True,
               0.9, None),
              ("Q=9, a partial group of 8", 9, 1 << 20, 128, 100, "cosine",
               True, 0.9, None),
              # _msearch's kNN and MaxSim batches: Q * T rows at k = 100
              ("msearch kNN batch", 32, 1 << 20, 128, 100, "cosine", True,
               1.0, None),
              ("msearch MaxSim batch", 64, 1 << 20, 128, 100, "cosine",
               True, 1.0, None),
              # 2048 MaxSim bodies of 32 tokens: one row past a launch's
              # 65,535, two launches (D cut so the twin's [Q, D] fits)
              ("msearch MaxSim batch past one launch (two launches)",
               65_536, 4096, 128, 100, "cosine", True, 1.0, None),
              # key lists past the scratch budget: launches of 24 rows
              ("msearch MaxSim batch on a 24-row scratch budget (three "
               "launches)", 64, 1 << 20, 128, 100, "cosine", True, 1.0,
               "budget"),
              ("wide rows, 8 per stage", 8, 100_003, 1024, 100,
               "dot_product", False, 0.9, None),
              # rings of fewer than 32 rows: groups that share a warp
              # wait on each other's stages (blocks walk two chunks at 768)
              ("wide rows, 4 per stage", 1, 600_000, 768, 100, "cosine",
               True, 0.9, None),
              ("wide rows, 4 per stage", 1, 50_000, 1024, 10, "l2_norm",
               True, 0.9, None),
              ("wide rows, 2 per stage", 1, 50_000, 1536, 100, "cosine",
               False, 0.9, None),
              ("wide rows, 4 per stage", 8, 300_000, 2048, 100, "cosine",
               True, 0.9, None),
              ("wide rows, 2 per stage", 8, 40_000, 4096, 10,
               "dot_product", True, 0.9, None),
              ("rows too wide to stage", 2, 3000, 40_000, 10, "l2_norm",
               True, 0.9, None),
              ("slab one float off 16-byte alignment", 1, 1 << 20, 128, 100,
               "cosine", True, 0.9, "offset"),
              ("zero rows (the 1e-12 clamp)", 1, 65_536, 128, 100, "cosine",
               True, 0.9, "zero")]
    for n, (name, Q, D, dims, k, metric, precise, live, quant) in \
            enumerate(cases):
        tweak = quant if isinstance(quant, str) else None
        q, v, mask = _b2_inputs(torch, dev, Q, D, dims, 200 + n, live,
                                None if tweak else quant)
        if tweak == "offset":  # a contiguous view one float into its buffer
            buf = torch.empty(D * dims + 1, device=dev)
            buf[1:] = v.reshape(-1)
            v = buf[1:].view(D, dims)
        elif tweak == "zero":  # every score below 0.5 but the zero rows'
            q, v = q.abs(), -v.abs()
            v[::97] = 0.0
        budget = shapes.TOPK_SCRATCH_BYTES
        if tweak == "budget":  # two u64 buffers of D / 2048 lists of k
            shapes.TOPK_SCRATCH_BYTES = 24 * 16 * (D // 2048) * k
        try:
            want = (3 if tweak == "budget"
                    else -(-Q // shapes.MAX_QUERY_ROWS))
            if len(shapes.query_slices(Q, D, k)) != want:
                raise AssertionError(f"knn_topk {name}: launches "
                                     f"{shapes.query_slices(Q, D, k)}")
            kv, ki = knn_topk(q, v, mask, k=k, metric=metric,
                              precise=precise)
            torch.cuda.synchronize()
        finally:
            shapes.TOPK_SCRATCH_BYTES = budget
        pv, pi = knn_topk(q, v, mask, k=k, metric=metric, precise=precise,
                          plain=True)
        check_exact(kv.cpu().numpy(), ki.cpu().numpy(), pv.cpu().numpy(),
                    pi.cpu().numpy(), f"knn_topk {name} Q={Q} D={D} "
                                      f"dims={dims} k={k}")
        log(f"[kernels] knn_topk {name} Q={Q} D={D} dims={dims} k={k}: "
            f"bit-equal to the plain twin")
        del q, v, mask, kv, ki, pv, pi
    torch.cuda.empty_cache()
    return 0.0


def _kernels_b3(torch, dev) -> float:
    """B3 against its twin, bit for bit (one f32 add per m, in order): the
    table-sum form, and the fused form over a whole code table with
    probed candidates (pads, filters, tables off 16-byte alignment,
    byte-path widths)."""
    from elasticsearch_tpu_torch.ops.adc import adc_scores
    from elasticsearch_tpu_torch.ops.bitvec import pack_mask

    def check(what, codes, lut, cand=None, words=None):
        out = adc_scores(codes, lut, cand=cand, filter_words=words)
        torch.cuda.synchronize()
        want = adc_scores(codes, lut, cand=cand, filter_words=words,
                          plain=True)
        check_exact(out.cpu().numpy(), None, want.cpu().numpy(), None,
                    f"adc_scores {what}")
        log(f"[kernels] adc_scores {what}: bit-equal to the plain twin"
            + ("" if cand is None else
               f" ({int(torch.isfinite(out).sum())} of {out.numel()} "
               f"slots live)"))

    def table(n, N, M, K, misalign=False):
        g = torch.Generator(device=dev).manual_seed(300 + n)
        codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                              dtype=torch.int64).to(torch.uint8)
        if misalign:  # a contiguous view one byte into its buffer
            buf = torch.empty(N * M + 1, dtype=torch.uint8, device=dev)
            buf[1:] = codes.reshape(-1)
            codes = buf[1:].view(N, M)
        return codes, torch.randn(M, K, generator=g, device=dev), g

    n = 0
    for W in (1000, 65_536, 1 << 20):
        for M in (8, 32):
            for K in (16, 256):
                codes, lut, _ = table(n, W, M, K)
                check(f"W={W} M={M} K={K}", codes, lut)
                n += 1

    def probed(g, N, W, live):
        """W slots of IVF-shaped lists: runs of ids, the rest pads."""
        cand = torch.full((W,), N, dtype=torch.int32, device=dev)
        real = torch.rand(W, generator=g, device=dev) < live
        cand[real] = torch.randint(0, N, (int(real.sum()),), generator=g,
                                   device=dev, dtype=torch.int32)
        return cand

    N = 1 << 20
    for what, M, K, W, live, filt, mis in (
            ("IVF-PQ slots, 12% live", 32, 256, 81_920, 0.12, None, False),
            ("filter at 10%", 32, 256, 81_920, 0.12, 0.1, False),
            ("filter at 0%", 32, 256, 81_920, 0.12, 0.0, False),
            ("every slot padded", 32, 256, 81_920, 0.0, None, False),
            ("W=1", 32, 256, 1, 1.0, None, False),
            ("codes off 16-byte alignment", 32, 256, 81_920, 0.12, 0.5, True),
            ("M=20 (byte path)", 20, 256, 40_000, 0.5, 0.5, False),
            ("M=64", 64, 256, 40_000, 0.5, None, False),
            ("M=8 K=16", 8, 16, 40_000, 0.5, 0.3, False)):
        codes, lut, g = table(n, N, M, K, mis)
        cand = probed(g, N, W, live)
        words = None
        if filt is not None:
            words = pack_mask(torch.rand(N, generator=g, device=dev) < filt)
        check(f"fused, {what} N={N} W={W} M={M} K={K}", codes, lut, cand,
              words)
        n += 1
    # ids below 0 are pads too; a filter without candidates
    codes, lut, g = table(n, 4096, 32, 256)
    cand = torch.randint(-50, 4200, (3000,), generator=g, device=dev,
                         dtype=torch.int32)
    check("fused, ids outside [0, N)", codes, lut, cand)
    check("filter without candidates", codes, lut, None,
          pack_mask(torch.rand(4096, generator=g, device=dev) < 0.5))
    del codes, lut, cand
    torch.cuda.empty_cache()
    return 0.0


def check_exact_nan(v, pv, what: str) -> float:
    """Kernel values against the twin's: NaN in the same places, the same
    bits everywhere else (a NaN's payload may differ). Returns 0."""
    import numpy as np

    nan = np.isnan(v)
    if v.shape != pv.shape or not np.array_equal(nan, np.isnan(pv)):
        raise AssertionError(f"{what}: NaN places differ from the plain twin")
    return check_exact(v[~nan], None, pv[~nan], None, what)


def _kernels_b4(torch, dev) -> float:
    """B4 against its twin, bit for bit (per token one f32 add per m in
    order, then the max with torch.maximum's NaN rule), over the
    re-rank's shapes, LUTs that lean negative (the l2 form), a NaN, a
    code array off 16-byte alignment and rows wider than 32 codes."""
    from elasticsearch_tpu_torch.ops.maxsim_adc import maxsim_adc

    def run(n, W, M, K, T, what, nan=False, misalign=False):
        g = torch.Generator(device=dev).manual_seed(400 + n)
        codes = torch.randint(0, K, (W, M), generator=g, device=dev,
                              dtype=torch.int64).to(torch.uint8)
        if misalign:  # a contiguous view one byte into its buffer
            buf = torch.empty(W * M + 1, dtype=torch.uint8, device=dev)
            buf[1:] = codes.reshape(-1)
            codes = buf[1:].view(W, M)
        luts = torch.randn(T, M, K, generator=g, device=dev) - 1.5
        if nan:
            luts[T // 2, M // 2, codes[W // 2, M // 2].long()] = float("nan")
        out = maxsim_adc(codes, luts)
        torch.cuda.synchronize()
        want = maxsim_adc(codes, luts, plain=True)
        check_exact_nan(out.cpu().numpy(), want.cpu().numpy(),
                        f"maxsim_adc {what} W={W} M={M} K={K} T={T}")
        if nan and not bool(torch.isnan(out).any()):
            raise AssertionError("maxsim_adc dropped the NaN sum")

    n = 0
    for W in (1, 100, 4097, 10_000, 81_920):
        for M in (32, 16, 1):
            for K in (256, 64):
                for T in (1, 8, 32, 64, 100):
                    run(n, W, M, K, T, "grid")
                    n += 1
        log(f"[kernels] maxsim_adc W={W}, M in (32, 16, 1), K in (256, 64),"
            f" T in (1, 8, 32, 64, 100): bit-equal to the plain twin")
    extra = [(4097, 32, 256, 32, "NaN in one token's table", True, False),
             (10_000, 32, 256, 32, "codes off 16-byte alignment", False,
              True),
             (4097, 64, 256, 8, "rows of 64 codes", False, False),
             (100, 33, 64, 5, "rows of 33 codes", False, False),
             (300, 3, 255, 7, "tables of an odd width", False, False),
             # the token groups' edges
             (1, 32, 256, 32, "a single candidate", False, False),
             (100, 32, 256, 33, "NaN in a token of a later group", True,
              False),
             (4097, 32, 255, 32, "K=255 with M=32", False, False)]
    for W, M, K, T, what, nan, mis in extra:
        run(n, W, M, K, T, what, nan, mis)
        n += 1
        log(f"[kernels] maxsim_adc {what} W={W} M={M} K={K} T={T}: "
            f"bit-equal to the plain twin")
    return 0.0


WRITE_MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
}}


def _write_docs(np):
    rng = np.random.default_rng(SEED)
    words = ("quick brown fox jumps over lazy dog river mountain valley "
             "ocean forest desert island search engine index query shard "
             "segment score token running runner alpha bravo charlie "
             "delta echo golf hotel kilo lima").split()
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()
    return [(f"w{i}", {"body": " ".join(rng.choice(words, int(
        rng.integers(5, 20)), p=p)), "tag": f"t{i % 9}",
        "n": int(rng.integers(0, 10_000))}) for i in range(2000)]


def phase_write(torch, np, dev):
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.search import queries

    docs = _write_docs(np)
    nodes = [Node(name="card", device=dev), Node(name="host", device="cpu")]
    for node in nodes:
        node.create_index("w", {"settings": {"number_of_shards": 2},
                                "mappings": WRITE_MAPPING})
        for doc_id, src in docs:
            node.index("w", doc_id, src)
        node.refresh("w")
    bodies = {
        "match": {"query": {"match": {"body": "quick brown fox"}}},
        "match_tail": {"query": {"match": {"body": "kilo lima echo"}}},
        "term": {"query": {"term": {"tag": "t3"}}, "size": 5},
        "bool_range": {"query": {"bool": {
            "must": [{"match": {"body": "river ocean"}}],
            "filter": [{"range": {"n": {"gte": 1000, "lt": 6000}}}]}}},
        "paged": {"query": {"match": {"body": "lazy dog jumps"}},
                  "from": 10, "size": 10},
    }
    fused0 = queries.FUSED_CALLS
    for name, body in bodies.items():
        card, host = (n.search("w", dict(body)) for n in nodes)
        if not card["hits"]["hits"]:
            raise AssertionError(f"write path {name}: no hits")
        check_hits(card, host, f"write path {name}")
    if queries.FUSED_CALLS == fused0:
        raise AssertionError("write path: no query took the fused path")
    body = {"query": {"match": {"body": "kilo lima echo"}}, "size": 3}
    victim = nodes[0].search("w", body)["hits"]["hits"][0]["_id"]
    for node in nodes:
        node.delete("w", victim)
        node.refresh("w")
    card, host = (n.search("w", dict(body)) for n in nodes)
    if victim in [h["_id"] for h in card["hits"]["hits"]] \
            or nodes[0].get("w", victim)["found"]:
        raise AssertionError("deleted doc still found")
    check_hits(card, host, "write path after delete")
    for node in nodes:
        node.close()
    log(f"[write] 2000 docs, 2 shards: {len(bodies)} bodies agree with the "
        f"CPU node, fused path taken, delete vanishes")


def corpus_tokens(np, n_docs, vocab, seed):
    """bench.py::build_corpus's token stream: (doc lengths, ~60 each, and
    every doc's Zipf(1.15) term ids in order)."""
    rng = np.random.default_rng(seed)
    doc_len = np.clip(rng.normal(60, 15, n_docs), 20, 120).astype(np.int64)
    nnz_tok = int(doc_len.sum())
    terms = rng.zipf(1.15, nnz_tok).astype(np.int64)
    terms = np.where(terms >= vocab, rng.integers(1, vocab, nnz_tok), terms)
    return doc_len, terms


def build_corpus(np, n_docs, vocab, seed):
    """bench.py::build_corpus's recipe: ~60-token passages, Zipf(1.15)
    vocabulary, term-major postings CSR with BM25 tf-normalization."""
    k1, b = 1.2, 0.75
    doc_len, terms = corpus_tokens(np, n_docs, vocab, seed)
    docs = np.repeat(np.arange(n_docs, dtype=np.int64), doc_len)
    uniq, tf = np.unique(terms * n_docs + docs, return_counts=True)
    u_term = (uniq // n_docs).astype(np.int32)
    u_doc = (uniq % n_docs).astype(np.int32)
    df = np.bincount(u_term, minlength=vocab).astype(np.int32)
    cf = np.bincount(u_term, weights=tf, minlength=vocab).astype(np.int64)
    offsets = np.zeros(vocab + 1, np.int64)
    offsets[1:] = np.cumsum(df)
    avg = doc_len.mean()
    tfn = (tf * (k1 + 1) / (tf + k1 * (1 - b + b * doc_len[u_doc] / avg))
           ).astype(np.float32)
    return u_doc, tf.astype(np.float32), tfn, offsets, df, cf, doc_len


def make_queries(np, n_q, vocab, df, seed, terms_per_q=4, dense_only=None):
    """bench.py::make_queries's recipe: 2-4 Zipf(1.3) term ids each; with
    ``dense_only`` (bool[vocab]) drawn from those terms instead."""
    rng = np.random.default_rng(seed + 1)
    qs = []
    pool = np.nonzero(dense_only)[0] if dense_only is not None else None
    for _ in range(n_q):
        npick = rng.integers(2, terms_per_q + 1)
        if pool is not None:
            t = rng.choice(pool, size=npick, replace=False)
        else:
            t = rng.zipf(1.3, npick).astype(np.int64)
            t = np.where((t >= vocab) | (df[np.clip(t, 0, vocab - 1)] == 0),
                         rng.integers(1, vocab, npick), t)
        qs.append(np.unique(t))
    return qs


def exact_top10(np, q, u_doc, tfn, offsets, df, n_docs, D):
    """Independent f64 BM25 over the CSR: (ids, scores, total)."""
    s = np.zeros(D)
    hit = np.zeros(D, bool)
    for t in q:
        lo, hi = offsets[t], offsets[t + 1]
        idf = np.log(1.0 + (n_docs - df[t] + 0.5) / (df[t] + 0.5))
        s += np.bincount(u_doc[lo:hi], weights=tfn[lo:hi] * idf,
                         minlength=D)
        hit[u_doc[lo:hi]] = True
    total = int(hit.sum())
    order = np.lexsort((np.arange(D), -np.where(hit, s, -np.inf)))
    order = order[:min(10, total)]
    return order, s[order], total


def text_field(np, corpus):
    """``segment_from_arrays``'s entry for the corpus's text field."""
    u_doc, tf, tfn, offsets, df, cf, doc_len = corpus
    return {"terms": [f"t{t}" for t in range(VOCAB)], "df": df, "cf": cf,
            "offsets": offsets, "doc_ids_host": u_doc, "tfnorm_host": tfn,
            "tf_host": tf, "avg_len": float(doc_len.mean()),
            "num_docs": N_DOCS, "total_terms": int(doc_len.sum()),
            "lengths": doc_len.astype(np.float32)}


def phase_read(torch, np, dev, card, corpus):
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import bm25_topk
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    u_doc, tf, tfn, offsets, df, cf, doc_len = corpus
    D = N_DOCS  # pow2_bucket(2^20) == 2^20
    arrays = {"num_docs": N_DOCS, "max_docs": D,
              "fields": {"body": text_field(np, corpus)}}
    node = Node(name="msmarco", device=dev)
    node.create_index("msmarco", {
        "settings": {"number_of_shards": 1},
        "mappings": {"properties": {"body": {"type": "text"}}}})
    seg = segment_from_arrays(arrays, node.residency)
    node.get_index("msmarco").shards[0].engine.add_segment(seg)
    rows, impact = seg.inverted["body"].dense_block()
    torch.cuda.synchronize()
    log(f"[read] corpus {N_DOCS} docs, vocab {VOCAB}, {u_doc.size} "
        f"postings; dense block {tuple(impact.shape)} f32 = "
        f"{impact.numel() * 4 / 2**20:.0f} MiB ({int((rows >= 0).sum())} "
        f"terms); set-up {time.perf_counter() - t0:.1f} s")

    qs = make_queries(np, N_QUERIES, VOCAB, df, SEED)
    bodies = [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
               "size": 10} for q in qs]
    node.search("msmarco", dict(bodies[0]))  # first-use set-up, untimed

    bm25_topk.LAUNCHES = 0
    fused0 = queries.FUSED_CALLS
    times, got, took_fused = [], [], []
    for body in bodies:
        f = queries.FUSED_CALLS
        t = time.perf_counter()
        got.append(node.search("msmarco", dict(body)))
        times.append(time.perf_counter() - t)
        took_fused.append(queries.FUSED_CALLS > f)
    launches = bm25_topk.LAUNCHES
    fused = queries.FUSED_CALLS - fused0
    if launches == 0:
        raise AssertionError("the main path launched no bm25_dense_topk")

    # the same searches with the kernel swapped for its plain twin
    real = queries.bm25_dense_topk
    queries.bm25_dense_topk = functools.partial(real, plain=True)
    try:
        for n, body in enumerate(bodies):
            check_hits(got[n], node.search("msmarco", dict(body)),
                       f"read query {n} vs plain twin")
    finally:
        queries.bm25_dense_topk = real
    # and against an exact f64 scorer: the fused path rounds both factors
    # of each product to bf16 (8 significant bits, each rounding within
    # 2^-8 relative), so a sum of positive products is within 2^-7
    recalls = []
    for n, q in enumerate(qs):
        ids, sc, total = exact_top10(np, q, u_doc, tfn, offsets, df,
                                     N_DOCS, D)
        hits = got[n]["hits"]["hits"]
        if got[n]["hits"]["total"] != total or len(hits) != len(ids):
            raise AssertionError(f"read query {n}: total/size disagree "
                                 f"with the exact scorer")
        s = np.array([h["_score"] for h in hits])
        if not (np.all(np.isfinite(s)) and np.all(np.diff(s) <= 0)
                and np.allclose(s, sc, rtol=2.0 ** -7, atol=0)):
            raise AssertionError(f"read query {n}: scores off the exact "
                                 f"scorer: {s} vs {sc}")
        recall = len({int(h["_id"]) for h in hits} & set(ids.tolist())) \
            / len(ids)
        recalls.append(recall)
    # the reference's bar for its kernel: mean recall@k >= 0.95
    if np.mean(recalls) < 0.95:
        raise AssertionError(f"read path mean recall@10 {np.mean(recalls)}"
                             f" < 0.95")
    ms = np.array(times) * 1e3
    fz = np.array(took_fused)
    log(f"[read] {N_QUERIES} match queries through Node.search on {card}: "
        f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
        f"{np.percentile(ms, 99):.3f} ms (fused path {fused} of "
        f"{N_QUERIES}: p50 {_p50(np, ms[fz])}; generic: p50 "
        f"{_p50(np, ms[~fz])}); bm25_dense_topk "
        f"launches {launches}; hits equal the plain twin's; recall@10 vs "
        f"exact f64: mean {np.mean(recalls)}, min {min(recalls)}")
    profile_read(torch, node, "msmarco", bodies, float(ms.sum()), "read")
    # one fused query's device work through Node.search (the mesh path,
    # S = 1): one copy in, B1's two launches, one copy back. "from": 0
    # makes the body new to the prepared-query memo, so its tables are
    # built and copied as a first request's are
    fresh = dict(bodies[took_fused.index(True)], **{"from": 0})
    ops = device_ops(torch, lambda: node.search("msmarco", dict(fresh)))
    if ops is None:
        log("[read] a fused query's device ops: not measured (the profiler "
            "recorded none)")
    else:
        kernels = {k: c for k, c in ops.items()
                   if not k.startswith(("Memcpy", "Memset"))}
        if sorted(c for k, c in kernels.items() if "bm25_" in k) != [1, 1] \
                or len(kernels) != 2 \
                or sum(c for k, c in ops.items() if "HtoD" in k) != 1 \
                or sum(c for k, c in ops.items() if "DtoH" in k) != 1:
            raise AssertionError(f"a fused query ran {ops}, where one copy "
                                 f"in, B1's two launches and one copy back "
                                 f"were expected")
        log(f"[read] one fused query's device ops through the mesh path: "
            + "; ".join(f"{k[:48]} x{c}" for k, c in ops.items()))
    return launches, node  # phase 5e reads the same index


# ---------------------------------------------------------------------------
# phase 5b: the kNN read path
# ---------------------------------------------------------------------------

def make_sift(np, n_vecs, dims, seed):
    """bench.py::make_sift_node's recipe (256 Gaussian clusters plus unit
    noise, f32, from ``seed + 7``), padded to a power of two, with an
    integer ``bucket`` column 0-99 for filters, and bench.py's queries
    (corpus points plus 0.1 noise, from ``seed + 3``)."""
    rng = np.random.default_rng(seed + 7)
    cents = rng.standard_normal((256, dims)).astype(np.float32)
    assign = rng.integers(0, 256, n_vecs)
    vecs = cents[assign] + rng.standard_normal((n_vecs, dims)).astype(
        np.float32)
    D = 1 << max(6, (n_vecs - 1).bit_length())
    vpad = np.zeros((D, dims), np.float32)
    vpad[:n_vecs] = vecs
    exists = np.zeros(D, bool)
    exists[:n_vecs] = True
    bucket = np.zeros(D, np.int64)
    bucket[:n_vecs] = np.random.default_rng(seed + 11).integers(0, 100,
                                                                n_vecs)
    qrng = np.random.default_rng(seed + 3)

    def queries(n):
        idx = qrng.integers(0, n_vecs, n)
        return vecs[idx] + 0.1 * qrng.standard_normal((n, dims)).astype(
            np.float32)

    return vpad, exists, bucket, D, queries


def exact_cosine_top(np, vpad, admitted, qs, k):
    """Exact f64 cosine oracle, one pass over the slab for all queries:
    (ids [n, k], scores [n, k] as (1 + cos) / 2, full f64 score of any
    doc via the returned function)."""
    qn = qs.astype(np.float64)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-12)
    D = vpad.shape[0]
    s = np.empty((qs.shape[0], D), np.float64)
    step = 1 << 17
    for a in range(0, D, step):
        x = vpad[a:a + step].astype(np.float64)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        s[:, a:a + step] = (1.0 + qn @ x.T) / 2.0
    s[:, ~admitted] = -np.inf
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(s, ids, axis=1), s


def check_oracle(np, got, ids, sc, full, what):
    """Hits against the exact oracle: a hit may differ from the oracle's
    only where both are within 1e-6 of the oracle's last score; every
    score within 1e-5 relative of the doc's exact score."""
    hits = got["hits"]["hits"]
    gid = np.array([int(h["_id"]) for h in hits])
    gs = np.array([h["_score"] for h in hits])
    if len(gid) != len(ids):
        raise AssertionError(f"{what}: {len(gid)} hits, oracle {len(ids)}")
    if not np.allclose(gs, full[gid], rtol=1e-5, atol=0):
        raise AssertionError(f"{what}: scores off the exact oracle: {gs} vs "
                             f"{full[gid]}")
    edge = sc[-1]
    for a, b in zip(gid, ids):
        if a != b and not (abs(full[a] - edge) <= 1e-6
                           and abs(full[b] - edge) <= 1e-6):
            raise AssertionError(f"{what}: hit {a} where the oracle has {b}")


VEC_MAPPING = {"properties": {
    "emb": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine",
            "index_options": {"type": "ivf_pq"}},
    "bucket": {"type": "long"},
}}


def phase_vectors(torch, np, dev, card, sift):
    """The kNN read path; returns (B2 launches, B3 launches, B3's inputs
    in one IVF-PQ query, the built IVF index and PQ parts)."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import adc, ivf, knn_topk
    from elasticsearch_tpu_torch.ops.ivf import build_ivf
    from elasticsearch_tpu_torch.ops.pq import build_pq, place_pq
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    vpad, exists, bucket, D, make_q = sift
    node = Node(name="sift", device=dev)
    node.create_index("sift", {"settings": {"number_of_shards": 1},
                               "mappings": VEC_MAPPING})
    seg = segment_from_arrays({
        "num_docs": N_VECS, "max_docs": D,
        "numerics": {"bucket": {"exact": bucket, "exists": exists,
                                "kind": "long"}},
        "vectors": {"emb": {"vecs": vpad, "exists": exists, "dims": DIMS,
                            "similarity": "cosine"}}}, node.residency)
    node.get_index("sift").shards[0].engine.add_segment(seg)
    vc = seg.vectors["emb"]
    torch.cuda.synchronize()
    log(f"[vectors] {N_VECS} x {DIMS} f32 SIFT-shaped slab, padded to {D}; "
        f"set-up {time.perf_counter() - t0:.1f} s")

    builds = []
    for _ in range(2):
        t = time.perf_counter()
        index = build_ivf(vc.vecs, vc.exists, D, C=IVF_LISTS,
                          metric=vc.similarity, place=node.residency.device_put)
        torch.cuda.synchronize()
        t_ivf = time.perf_counter() - t
        t = time.perf_counter()
        parts = build_pq(vc.vecs, vc.exists, vc.similarity)
        torch.cuda.synchronize()
        builds.append((index, parts, t_ivf, time.perf_counter() - t))
    (i1, p1, ti1, tp1), (i2, p2, ti2, tp2) = builds
    if not (torch.equal(i1.lists, i2.lists)
            and torch.equal(i1.centroids, i2.centroids)
            and torch.equal(p1.codes, p2.codes)
            and torch.equal(p1.codebooks, p2.codebooks)):
        raise AssertionError("vector builds are not deterministic")
    vc._ivf = i1
    vc._pq = place_pq(p1, node.residency, label="pq[emb]")
    if vc._pq is None:
        raise AssertionError("the PQ codes were denied placement")
    del builds, i2, p2
    lens = i1.list_lens.cpu().numpy()
    nprobe = i1.nprobe_for(PQ_CANDIDATES)
    W = nprobe * i1.Lmax
    log(f"[vectors] IVF C={i1.C} Lmax={i1.Lmax} (lists {lens.min()}-"
        f"{lens.max()}, mean {lens.mean():.1f}) built in {ti1:.2f} s and "
        f"{ti2:.2f} s; PQ M={p1.M} K={p1.K} dsub={p1.dsub} built in "
        f"{tp1:.2f} s and {tp2:.2f} s; both builds bit-identical; IVF-PQ "
        f"probes {nprobe} lists, W={W} codes per query")

    flt = {"range": {"bucket": {"lt": 10}}}
    qv = make_q(32 + 8 + 8 * 8 + 32 + 8)
    rows = iter(range(qv.shape[0]))

    def vec():
        return [float(a) for a in qv[next(rows)]]

    mix = []  # (branch, body)
    mix += [("brute", {"knn": {"field": "emb", "query_vector": vec(),
                               "ann": False}}) for _ in range(32)]
    mix += [("brute_filter", {"knn": {"field": "emb", "query_vector": vec(),
                                      "ann": False, "filter": flt}})
            for _ in range(8)]
    mix += [("maxsim", {"knn": {"field": "emb", "query_vectors": [
        vec() for _ in range(8)]}}) for _ in range(8)]
    mix += [("ivf_pq", {"knn": {"field": "emb", "query_vector": vec(),
                                "num_candidates": PQ_CANDIDATES}})
            for _ in range(32)]
    mix += [("ivf_pq_filter", {"knn": {"field": "emb", "query_vector": vec(),
                                       "num_candidates": PQ_CANDIDATES,
                                       "filter": flt}}) for _ in range(8)]
    bodies = [{"query": q, "size": 10} for _, q in mix]
    node.search("sift", copy.deepcopy(bodies[0]))  # first-use set-up
    node.search("sift", copy.deepcopy(bodies[-1]))

    knn_topk.LAUNCHES = 0
    adc.LAUNCHES = 0
    times, got, per_query = [], [], []
    for body in bodies:
        b2, b3 = knn_topk.LAUNCHES, adc.LAUNCHES
        body = copy.deepcopy(body)  # the search may mutate it; not timed
        t = time.perf_counter()
        got.append(node.search("sift", body))
        times.append(time.perf_counter() - t)
        per_query.append((knn_topk.LAUNCHES - b2, adc.LAUNCHES - b3))
    b2_launches, b3_launches = knn_topk.LAUNCHES, adc.LAUNCHES
    if b2_launches == 0 or b3_launches == 0:
        raise AssertionError(f"the kNN path launched knn_topk "
                             f"{b2_launches} and adc_scores {b3_launches} "
                             f"times")
    starved = 0
    for (branch, _), (n2, n3) in zip(mix, per_query):
        want = (0, 1) if branch.startswith("ivf_pq") else (1, 0)
        if branch.startswith("ivf_pq") and (n2, n3) == (1, 1):
            starved += 1  # a filter starved the probes: brute force ran
        elif (n2, n3) != want:
            raise AssertionError(f"{branch}: launched knn_topk {n2} and "
                                 f"adc_scores {n3} times, expected {want}")

    # the same searches with the kernels swapped for their plain twins
    real_b2, real_b3 = queries.knn_topk, ivf.adc_scores
    queries.knn_topk = functools.partial(real_b2, plain=True)
    ivf.adc_scores = functools.partial(real_b3, plain=True)
    try:
        for n, body in enumerate(bodies):
            check_hits(got[n], node.search("sift", copy.deepcopy(body)),
                       f"{mix[n][0]} query {n} vs plain twins")
    finally:
        queries.knn_topk, ivf.adc_scores = real_b2, real_b3

    # brute force (plain and filtered) against the exact f64 oracle, and
    # the IVF-PQ recall@10 against it
    live = exists.copy()
    sel = live & (bucket < 10)
    for branch, admitted in (("brute", live), ("brute_filter", sel)):
        idx = [n for n, (b, _) in enumerate(mix) if b == branch]
        qs = np.stack([np.array(mix[n][1]["knn"]["query_vector"],
                                np.float32) for n in idx])
        ids, sc, full = exact_cosine_top(np, vpad, admitted, qs, 10)
        for r, n in enumerate(idx):
            if got[n]["hits"]["total"] != min(100, int(admitted.sum())):
                raise AssertionError(f"{branch} query {n}: total "
                                     f"{got[n]['hits']['total']}")
            check_oracle(np, got[n], ids[r], sc[r], full[r],
                         f"{branch} query {n}")
    recalls = {}
    for branch, admitted in (("ivf_pq", live), ("ivf_pq_filter", sel)):
        idx = [n for n, (b, _) in enumerate(mix) if b == branch]
        qs = np.stack([np.array(mix[n][1]["knn"]["query_vector"],
                                np.float32) for n in idx])
        ids, _sc, _full = exact_cosine_top(np, vpad, admitted, qs, 10)
        recalls[branch] = float(np.mean([
            len({int(h["_id"]) for h in got[n]["hits"]["hits"]}
                & set(ids[r].tolist())) / 10 for r, n in enumerate(idx)]))

    ms = np.array(times) * 1e3
    per_branch = "; ".join(
        f"{b} x{sum(1 for m, _ in mix if m == b)}: p50 "
        f"{np.percentile(ms[[m == b for m, _ in mix]], 50):.3f} ms, p99 "
        f"{np.percentile(ms[[m == b for m, _ in mix]], 99):.3f} ms"
        for b in dict.fromkeys(m for m, _ in mix))
    log(f"[vectors] {len(bodies)} knn queries through Node.search on {card}:"
        f" {per_branch}; knn_topk launches {b2_launches}, adc_scores "
        f"launches {b3_launches} ({starved} filtered IVF-PQ queries starved "
        f"into brute force); hits equal the plain twins'; brute-force hits "
        f"match the exact f64 oracle; IVF-PQ recall@10 vs exact: "
        f"{recalls['ivf_pq']} (filtered {recalls['ivf_pq_filter']})")
    profile_read(torch, node, "sift", bodies, float(ms.sum()), "vectors")
    body = next(b for m, b in zip(mix, bodies) if m[0] == "ivf_pq")
    ops = device_ops(torch, lambda: node.search("sift", copy.deepcopy(body)))
    if ops is None:
        log("[vectors] an IVF-PQ query's device ops: not measured (the "
            "profiler recorded none)")
    else:
        b3 = sum(c for k, c in ops.items() if "adc_table_sum" in k)
        if b3 != 1:
            raise AssertionError(f"an IVF-PQ query launched adc_scores {b3} "
                                 f"times: {ops}")
        kernels = sum(c for k, c in ops.items()
                      if not k.startswith(("Memcpy", "Memset")))
        log(f"[vectors] one IVF-PQ query's device ops: {kernels} kernels, "
            f"adc_scores once; " + "; ".join(f"{k[:40]} x{c}"
                                            for k, c in ops.items()))
    b3_case = b3_query_case(torch, np, seg, vc, i1, nprobe, next(
        body for m, body in mix if m == "ivf_pq")["knn"]["query_vector"])
    node.close()
    return b2_launches, b3_launches, b3_case, i1, p1


def b3_query_case(torch, np, seg, vc, index, nprobe, query):
    """B3's inputs in one unfiltered IVF-PQ query of the segment, as
    ``ivf_pq_search`` gives them to it: the whole code table, the probed
    slots, the LUT and the packed liveness words."""
    from elasticsearch_tpu_torch.ops import ivf
    from elasticsearch_tpu_torch.ops.bitvec import pack_mask
    from elasticsearch_tpu_torch.ops.pq import adc_lut

    q = torch.as_tensor(np.asarray(query, np.float32), device=vc.vecs.device)
    return {"codes": vc._pq.codes, "cand": ivf._probe(index, q, nprobe),
            "words": pack_mask(vc.exists & seg.live),
            "lut": adc_lut(q, vc._pq.codebooks, vc._pq.metric)}


# ---------------------------------------------------------------------------
# phase 5c: the hybrid read path
# ---------------------------------------------------------------------------

HYB_MAPPING = {"properties": {"body": {"type": "text"},
                              **VEC_MAPPING["properties"]}}
RERANK_TOKENS = 32
RERANK_WINDOW = 100


def _rrf_np(np, scores, mask, rank_constant, weight):
    """tests/unit/test_hybrid.py::_rrf_ref: numpy RRF contribution."""
    key = np.where(mask, scores, -np.inf).astype(np.float32)
    rank = np.empty(key.size, np.int64)
    rank[np.argsort(-key, kind="stable")] = np.arange(key.size)
    contrib = np.where(
        mask, np.float32(1.0) / (np.float32(rank_constant) + np.float32(1.0)
                                 + rank.astype(np.float32)),
        np.float32(0.0)).astype(np.float32)
    return (np.float32(weight) * contrib).astype(np.float32)


def fuse_np(np, ls, lm, vs, vm, method, weights, rank_constant):
    """tests/unit/test_hybrid.py::_fuse_ref: the numpy fusion."""
    if method == "linear":
        fused = (np.float32(weights[0]) * np.where(lm, ls, np.float32(0))
                 + np.float32(weights[1]) * np.where(vm, vs, np.float32(0)))
    else:
        fused = (_rrf_np(np, ls, lm, rank_constant, weights[0])
                 + _rrf_np(np, vs, vm, rank_constant, weights[1]))
    return fused.astype(np.float32), lm | vm


def phase_hybrid(torch, np, dev, card, corpus, sift, ivf_index, pq_parts):
    """The hybrid read path over one 2^20-doc segment holding phase 5's
    text field and phase 5b's vector slab, with phase 5b's IVF and PQ.
    Returns the launches of B2, B3 and B4 over the query mix."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import adc, ivf, knn_topk, maxsim_adc
    from elasticsearch_tpu_torch.ops.pq import place_pq
    from elasticsearch_tpu_torch.search import hybrid, queries
    from elasticsearch_tpu_torch.search.context import SegmentContext

    t0 = time.perf_counter()
    vpad, exists, bucket, D, make_q = sift
    if D != N_DOCS:
        raise AssertionError(f"slab of {D} rows, text of {N_DOCS} docs")
    df = corpus[4]
    node = Node(name="hybrid", device=dev)
    node.create_index("hybrid", {"settings": {"number_of_shards": 1},
                                 "mappings": HYB_MAPPING})
    seg = segment_from_arrays({
        "num_docs": N_DOCS, "max_docs": D,
        "fields": {"body": text_field(np, corpus)},
        "numerics": {"bucket": {"exact": bucket, "exists": exists,
                                "kind": "long"}},
        "vectors": {"emb": {"vecs": vpad, "exists": exists, "dims": DIMS,
                            "similarity": "cosine"}}}, node.residency)
    vc = seg.vectors["emb"]
    vc._ivf = ivf_index
    vc._pq = place_pq(pq_parts, node.residency, label="pq[emb]")
    if vc._pq is None:
        raise AssertionError("the PQ codes were denied placement")
    svc = node.get_index("hybrid")
    svc.shards[0].engine.add_segment(seg)
    torch.cuda.synchronize()
    log(f"[hybrid] one segment of {N_DOCS} docs: phase 5's text field and "
        f"phase 5b's {N_VECS} x {DIMS} slab (IVF C={ivf_index.C}, PQ "
        f"M={pq_parts.M} K={pq_parts.K} carried across); set-up "
        f"{time.perf_counter() - t0:.1f} s")

    lex = make_queries(np, 56, VOCAB, df, SEED + 5)
    qv = make_q(56)
    pool = make_q(16 * (RERANK_TOKENS - 1))
    flt = {"range": {"bucket": {"lt": 10}}}

    def vec(a):
        return [float(x) for x in a]

    def hyb(i, method="rrf", weights=(1.0, 1.0), **knn):
        return {"hybrid": {
            "query": {"match": {"body": " ".join(f"t{t}" for t in lex[i])}},
            "knn": dict({"field": "emb", "query_vector": vec(qv[i])}, **knn),
            "fusion": {"method": method, "weights": list(weights),
                       "rank_constant": 60}}}

    mix = []  # (branch, body)
    for i in range(56):
        if i < 16:
            mix.append(("rrf", {"query": hyb(i, ann=False,
                                             num_candidates=100)}))
        elif i < 24:
            mix.append(("linear", {"query": hyb(i, "linear", (0.3, 2.0),
                                                ann=False, boost=1.7)}))
        elif i < 32:
            mix.append(("rrf_ivf_pq", {"query": hyb(
                i, num_candidates=PQ_CANDIDATES)}))
        elif i < 40:
            mix.append(("rrf_filter", {"query": hyb(i, ann=False,
                                                    filter=flt)}))
        else:
            j = i - 40
            q = hyb(i, ann=False, num_candidates=100)
            q["hybrid"]["rerank"] = {
                "query_vectors": [vec(qv[i])] + [
                    vec(t) for t in pool[j * (RERANK_TOKENS - 1):
                                         (j + 1) * (RERANK_TOKENS - 1)]],
                "window_size": RERANK_WINDOW, "pq": i >= 48}
            mix.append(("rerank_pq" if i >= 48 else "rerank_exact",
                        {"query": q, "size": RERANK_WINDOW}))
    for _, body in mix:
        body.setdefault("size", 10)
    for b in ("rrf", "rrf_ivf_pq", "rerank_exact", "rerank_pq"):
        node.search("hybrid", copy.deepcopy(  # first-use set-up, untimed
            next(body for m, body in mix if m == b)))

    knn_topk.LAUNCHES = adc.LAUNCHES = maxsim_adc.LAUNCHES = 0
    times, got, per_query = [], [], []
    for _, body in mix:
        before = (knn_topk.LAUNCHES, adc.LAUNCHES, maxsim_adc.LAUNCHES)
        body = copy.deepcopy(body)  # the search may mutate it; not timed
        t = time.perf_counter()
        got.append(node.search("hybrid", body))
        times.append(time.perf_counter() - t)
        per_query.append((knn_topk.LAUNCHES - before[0],
                          adc.LAUNCHES - before[1],
                          maxsim_adc.LAUNCHES - before[2]))
    launches = {"knn_topk": knn_topk.LAUNCHES, "adc_scores": adc.LAUNCHES,
                "maxsim_adc": maxsim_adc.LAUNCHES}
    starved = 0
    for (branch, _), n in zip(mix, per_query):
        want = {"rrf_ivf_pq": (0, 1, 0),
                "rerank_pq": (1, 0, 1)}.get(branch, (1, 0, 0))
        if branch == "rrf_ivf_pq" and n == (1, 1, 0):
            starved += 1  # the probes starved: brute force ran
        elif n != want:
            raise AssertionError(f"{branch}: launched (knn_topk, adc_scores,"
                                 f" maxsim_adc) {n} times, expected {want}")
    if launches["maxsim_adc"] != 8:
        raise AssertionError(f"maxsim_adc launched {launches['maxsim_adc']}"
                             f" times over 8 PQ re-ranks")

    # the same searches with the kernels swapped for their plain twins
    real = queries.knn_topk, ivf.adc_scores, hybrid.maxsim_adc
    queries.knn_topk = functools.partial(real[0], plain=True)
    ivf.adc_scores = functools.partial(real[1], plain=True)
    hybrid.maxsim_adc = functools.partial(real[2], plain=True)
    try:
        for n, (branch, body) in enumerate(mix):
            twin = node.search("hybrid", copy.deepcopy(body))
            check_hits(got[n], twin, f"{branch} query {n} vs plain twins")
            if got[n].get("hybrid") != twin.get("hybrid"):
                raise AssertionError(f"{branch} query {n}: hybrid section "
                                     f"{got[n].get('hybrid')} vs twins' "
                                     f"{twin.get('hybrid')}")
    finally:
        queries.knn_topk, ivf.adc_scores, hybrid.maxsim_adc = real

    # stage 1 against a numpy fusion of the port's own per-engine rows
    live = seg.live.cpu().numpy()
    fused_checked = 0
    for n in (0, 1, 2, 3, 16, 17, 24, 32):
        q = queries.parse_query(mix[n][1]["query"])
        ctx = SegmentContext(seg, svc.mappings, svc.analysis)
        ls, lm = q.lexical.score_or_mask(ctx)
        vs, vm = q.knn.score_or_mask(ctx)
        ls, lm, vs, vm = (x.cpu().numpy() for x in (ls, lm, vs, vm))
        fused, mask = fuse_np(np, ls, lm & live, vs, vm & live, q.method,
                              q.weights, q.rank_constant)
        eff = np.where(mask, fused, -np.inf)
        top = np.lexsort((np.arange(eff.size), -eff))[:10]
        want = [(str(i), float(fused[i])) for i in top if np.isfinite(eff[i])]
        have = [(h["_id"], h["_score"]) for h in got[n]["hits"]["hits"]]
        if have != want or got[n]["hits"]["total"] != int(mask.sum()):
            raise AssertionError(f"{mix[n][0]} query {n}: hits differ from "
                                 f"the numpy fusion: {have[:3]} vs "
                                 f"{want[:3]}")
        fused_checked += 1

    # stage 2: the windows against f64 MaxSim, exact and over the codes
    codes = pq_parts.codes.cpu().numpy()
    books = pq_parts.codebooks.cpu().numpy().astype(np.float64)
    M, K, dsub = books.shape
    for n, (branch, body) in enumerate(mix):
        if not branch.startswith("rerank"):
            continue
        if got[n].get("hybrid") != {"rerank": "applied",
                                    "window": RERANK_WINDOW}:
            raise AssertionError(f"{branch} query {n}: hybrid section "
                                 f"{got[n].get('hybrid')}")
        toks = np.array(body["query"]["hybrid"]["rerank"]["query_vectors"],
                        np.float64)
        toks /= np.maximum(np.linalg.norm(toks, axis=1, keepdims=True),
                           1e-12)
        plain = copy.deepcopy(body)
        del plain["query"]["hybrid"]["rerank"]
        stage1 = {h["_id"]: h["_score"] for h in node.search(
            "hybrid", plain)["hits"]["hits"]}
        hits = got[n]["hits"]["hits"]
        if sorted(stage1) != sorted(h["_id"] for h in hits):
            raise AssertionError(f"{branch} query {n}: the window is not "
                                 f"stage 1's top {RERANK_WINDOW}")
        ids = np.array([int(h["_id"]) for h in hits])
        gs = np.array([h["_score"] for h in hits])
        has = exists[ids]
        if branch == "rerank_exact":
            x = vpad[ids].astype(np.float64)
            x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            ms = ((1.0 + toks @ x.T) * 0.5).max(axis=0)
        else:
            luts = np.einsum("tmd,mkd->tmk", toks.reshape(-1, M, dsub), books)
            ms = luts[:, np.arange(M)[None, :], codes[ids]].sum(2).max(0)
        s1 = np.array([stage1[h["_id"]] for h in hits])
        if not (np.allclose(gs[has], ms[has], rtol=1e-5, atol=0)
                and np.array_equal(gs[~has], s1[~has])
                and np.all(np.diff(gs) <= 0)):
            raise AssertionError(f"{branch} query {n}: window scores off "
                                 f"the f64 MaxSim: {gs[:4]} vs {ms[:4]}")

    ms = np.array(times) * 1e3
    per_branch = "; ".join(
        f"{b} x{sum(1 for m, _ in mix if m == b)}: p50 "
        f"{np.percentile(ms[[m == b for m, _ in mix]], 50):.3f} ms, p99 "
        f"{np.percentile(ms[[m == b for m, _ in mix]], 99):.3f} ms"
        for b in dict.fromkeys(m for m, _ in mix))
    log(f"[hybrid] {len(mix)} hybrid queries through Node.search on {card}:"
        f" {per_branch}; launches knn_topk {launches['knn_topk']}, "
        f"adc_scores {launches['adc_scores']}, maxsim_adc "
        f"{launches['maxsim_adc']} ({starved} IVF-PQ knn sides starved into "
        f"brute force); hits and hybrid sections equal the plain twins'; "
        f"{fused_checked} stage-1 queries equal a numpy fusion of the "
        f"engines' rows; 16 re-rank windows match f64 MaxSim (exact and "
        f"over the PQ codes) at rtol 1e-5")
    profile_read(torch, node, "hybrid", [b for _, b in mix],
                 float(ms.sum()), "hybrid")
    node.close()
    return launches


# ---------------------------------------------------------------------------
# phase 5d: the mesh path over five shards
# ---------------------------------------------------------------------------

MESH_SHARDS = 5  # ES 2.0's default index.number_of_shards
MESH_MAPPING = {"properties": {
    "body": {"type": "text"},
    "emb": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
}}


def shard_arrays(np, corpus, u_term, sift, shard_of, s):
    """``segment_from_arrays``'s arrays for shard s: its docs (ids are the
    global doc numbers, local ids in their order), the text field's CSR
    restricted to them with BM25 tf-normalization at the shard's own
    average length, and their rows of the slab."""
    from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

    k1, b = 1.2, 0.75
    u_doc, tf, _tfn, _offsets, _df, _cf, doc_len = corpus
    vpad, exists = sift[0], sift[1]
    docs = np.nonzero(shard_of == s)[0]
    n = int(docs.size)
    D = pow2_bucket(n, minimum=64)
    local = np.full(shard_of.size, -1, np.int32)
    local[docs] = np.arange(n, dtype=np.int32)
    keep = shard_of[u_doc] == s
    t, d, tf_s = u_term[keep], u_doc[keep], tf[keep]
    avg = float(doc_len[docs].mean())
    tfn_s = (tf_s * (k1 + 1) / (tf_s + k1 * (1 - b + b * doc_len[d] / avg))
             ).astype(np.float32)
    df_s = np.bincount(t, minlength=VOCAB).astype(np.int32)
    offsets = np.zeros(VOCAB + 1, np.int64)
    offsets[1:] = np.cumsum(df_s)
    lengths = np.zeros(D, np.float32)
    lengths[:n] = doc_len[docs]
    vecs = np.zeros((D, DIMS), np.float32)
    vecs[:n] = vpad[docs]
    ex = np.zeros(D, bool)
    ex[:n] = exists[docs]
    return {"num_docs": n, "max_docs": D, "ids": [str(x) for x in docs],
            "fields": {"body": {
                "terms": [f"t{x}" for x in range(VOCAB)], "df": df_s,
                "cf": np.bincount(t, weights=tf_s,
                                  minlength=VOCAB).astype(np.int64),
                "offsets": offsets, "doc_ids_host": local[d],
                "tfnorm_host": tfn_s, "tf_host": tf_s, "avg_len": avg,
                "num_docs": n, "total_terms": int(doc_len[docs].sum()),
                "lengths": lengths}},
            "vectors": {"emb": {"vecs": vecs, "exists": ex, "dims": DIMS,
                                "similarity": "cosine"}}}


def profile_path(torch, run):
    """(device ms, kernels, copies in, copies back, the top four device
    items as "name ms xcount") of ``run()`` under torch.profiler; None
    when a second session records nothing too."""
    for _ in range(2):
        with _profiled(torch) as prof:
            run()
        ev = _device_rows(prof)
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        if busy > 0:
            top = sorted(ev, key=lambda e: -e.self_device_time_total)[:4]
            return (busy, sum(e.count for e in ev if not e.key.startswith(
                ("Memcpy", "Memset"))),
                sum(e.count for e in ev if "HtoD" in e.key),
                sum(e.count for e in ev if "DtoH" in e.key),
                [f"{e.key[:36]} {e.self_device_time_total / 1e3:.3f} ms "
                 f"x{e.count}" for e in top])
    return None


def phase_mesh(torch, np, dev, card, corpus, sift):
    """Phase 5d: phase 5's corpus and phase 5b's slab split over five
    shards by document routing, one segment a shard; phase 5's queries
    and brute-force knn on the mesh path and on the host loop, and
    ``search_knn`` at Q = 8. Returns the mesh run's (B1, B2) launches."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.cluster.routing import shard_id_for
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk, knn_topk
    from elasticsearch_tpu_torch.parallel import executor as mesh_exec
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    u_doc, tf, tfn, offsets, df, cf, doc_len = corpus
    shard_of = np.fromiter((shard_id_for(str(x), MESH_SHARDS)
                            for x in range(N_DOCS)), np.int32, N_DOCS)
    u_term = np.repeat(np.arange(VOCAB, dtype=np.int32), df)
    node = Node(name="mesh", device=dev)
    node.create_index("mesh5", {
        "settings": {"number_of_shards": MESH_SHARDS},
        "mappings": MESH_MAPPING})
    svc = node.get_index("mesh5")
    qs = make_queries(np, N_QUERIES, VOCAB, df, SEED)
    # the exact f64 scorer on each shard's own arrays (per-shard idf and
    # average length, as the engine scores a shard): (score, shard, local,
    # doc) of each shard's top 10, and the hit counts
    exact_cands = [[] for _ in qs]
    exact_totals = [0] * len(qs)
    shard_text = []  # each shard's text CSR and doc numbers, for 5e
    for s in range(MESH_SHARDS):
        arrays = shard_arrays(np, corpus, u_term, sift, shard_of, s)
        fb = arrays["fields"]["body"]
        docs = np.asarray(arrays["ids"], np.int64)
        shard_text.append(((fb["doc_ids_host"], fb["tfnorm_host"],
                            fb["offsets"], fb["df"], arrays["num_docs"],
                            arrays["max_docs"]), docs))
        for n, q in enumerate(qs):
            ids, sc, total = exact_top10(
                np, q, fb["doc_ids_host"], fb["tfnorm_host"], fb["offsets"],
                fb["df"], arrays["num_docs"], arrays["max_docs"])
            exact_cands[n] += [(float(v), s, int(i), int(docs[i]))
                               for v, i in zip(sc, ids)]
            exact_totals[n] += total
        svc.shards[s].engine.add_segment(segment_from_arrays(
            arrays, node.residency))
        del arrays, fb
    del u_term
    sizes = np.bincount(shard_of, minlength=MESH_SHARDS)
    torch.cuda.synchronize()
    log(f"[mesh] {N_DOCS} docs over {MESH_SHARDS} shards by "
        f"shard_id_for ({', '.join(map(str, sizes))} docs), one segment "
        f"each with its text postings and slab rows; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    def on_mesh(flag):
        svc.settings["search"] = {"mesh": flag}

    def run(bodies):
        times, got = [], []
        for body in bodies:
            t = time.perf_counter()
            got.append(node.search("mesh5", copy.deepcopy(body)))
            times.append(time.perf_counter() - t)
        return np.array(times) * 1e3, got

    bodies = [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
               "size": 10} for q in qs]
    warm = {"query": {"match": {"body": "t1 t2 t3"}}, "size": 10}
    qv = sift[4](16)
    knn_bodies = [{"query": {"knn": {"field": "emb", "ann": False,
                                     "query_vector": [float(a) for a in v]}},
                   "size": 10} for v in qv[:8]]
    results = {}
    for path in (True, False):
        on_mesh(path)
        # first-use set-up (dense blocks, stacked postings), untimed
        node.search("mesh5", dict(warm))
        node.search("mesh5", copy.deepcopy(knn_bodies[0]))
        counters.reset()
        bm25_topk.LAUNCHES = knn_topk.LAUNCHES = 0
        ms, got = run(bodies)
        b1 = bm25_topk.LAUNCHES
        kms, kgot = run(knn_bodies)
        b2 = knn_topk.LAUNCHES
        snap = counters.snapshot()
        # a repeat of the same requests: the mesh's prepared-query memo
        # serves them without a build or a copy in
        ms2, _ = run(bodies)
        # the device's view of first requests ("from": 0 makes each body
        # new to the memo; the stacked segment data stays cached)
        prof = profile_path(torch, lambda: run(
            [dict(b, **{"from": 0}) for b in bodies]))
        kprof = profile_path(torch, lambda: run(
            [dict(b, **{"from": 0}) for b in knn_bodies]))
        results[path] = (ms, got, b1, kms, kgot, b2, snap, ms2, prof, kprof)
    on_mesh(True)
    (ms, got, b1, kms, kgot, b2, snap, ms2, prof, kprof) = results[True]
    if snap.get("mesh_search") != len(bodies) + len(knn_bodies) \
            or snap.get("mesh_fallback_total"):
        raise AssertionError(f"phase 5d: the mesh path did not serve every "
                             f"request: {snap}")
    if b1 == 0 or b2 == 0:
        raise AssertionError(f"phase 5d: the mesh path launched B1 {b1} "
                             f"and B2 {b2} times")
    h = results[False]
    identical = 0
    for n, body in enumerate(bodies + knn_bodies):
        a = (got + kgot)[n]
        want = (h[1] + h[4])[n]
        if [x["_id"] for x in a["hits"]["hits"]] != \
                [x["_id"] for x in want["hits"]["hits"]]:
            raise AssertionError(f"phase 5d query {n}: the mesh's hits "
                                 f"differ from the host loop's")
        check_hits(a, want, f"phase 5d query {n}, mesh vs host loop")
        identical += a["hits"] == want["hits"]
    # the same requests on the mesh path with B1 and B2 swapped for their
    # twins: the same hits; scores bit for bit where no round took the
    # generic route (whose index_add_ adds in no fixed order on the card),
    # else at 1e-5
    real = (queries.bm25_dense_topk, queries.knn_topk)
    queries.bm25_dense_topk = functools.partial(real[0], plain=True)
    queries.knn_topk = functools.partial(real[1], plain=True)
    try:
        for n, body in enumerate(bodies + knn_bodies):
            before = counters.snapshot()
            twin = node.search("mesh5", copy.deepcopy(body))
            after = counters.snapshot()
            generic = any(after.get(c, 0) != before.get(c, 0)
                          for c in ("bm25_hybrid", "bm25_scatter"))
            a = (got + kgot)[n]
            if [x["_id"] for x in a["hits"]["hits"]] != \
                    [x["_id"] for x in twin["hits"]["hits"]] \
                    or (not generic and a["hits"] != twin["hits"]):
                raise AssertionError(f"phase 5d query {n}: the mesh's hits "
                                     f"differ from the plain twins'")
            check_hits(a, twin, f"phase 5d query {n}, mesh vs plain twins")
    finally:
        queries.bm25_dense_topk, queries.knn_topk = real
    # match queries against the exact f64 scorer: totals exact; scores
    # within 2^-7 (phase 5's bar for B1's bf16 products), recall@10
    recalls = []
    for n in range(len(qs)):
        want = sorted(exact_cands[n], key=lambda c: (-c[0], c[1], c[2]))
        want = want[:10]
        hits = got[n]["hits"]["hits"]
        if got[n]["hits"]["total"] != exact_totals[n] \
                or len(hits) != len(want):
            raise AssertionError(f"phase 5d query {n}: total "
                                 f"{got[n]['hits']['total']} and {len(hits)} "
                                 f"hits, exact {exact_totals[n]} and "
                                 f"{len(want)}")
        sc = np.array([c[0] for c in want])
        s_ = np.array([h["_score"] for h in hits])
        if not (np.all(np.isfinite(s_)) and np.all(np.diff(s_) <= 0)
                and np.allclose(s_, sc, rtol=2.0 ** -7, atol=0)):
            raise AssertionError(f"phase 5d query {n}: scores off the exact "
                                 f"scorer: {s_} vs {sc}")
        recalls.append(len({int(h["_id"]) for h in hits}
                           & {c[3] for c in want}) / len(want))
    if np.mean(recalls) < 0.95:
        raise AssertionError(f"phase 5d mean recall@10 {np.mean(recalls)} "
                             f"< 0.95")
    # knn queries against the exact f64 cosine oracle (one pass for
    # these and search_knn's queries)
    o_ids, o_sc, o_full = exact_cosine_top(np, sift[0], sift[1], qv, 10)
    for r in range(len(knn_bodies)):
        check_oracle(np, kgot[r], o_ids[r], o_sc[r], o_full[r],
                     f"phase 5d knn query {r}")

    def fmt(ms_, prof_, launches, nq, kernel):
        if prof_ is None:
            dev_txt = "device time not measured"
        else:
            busy, kern, hd, dh, _top = prof_
            dev_txt = (f"device {busy:.3f} ms ({100 * busy / ms_.sum():.1f}"
                       f"% busy), {kern / nq:.1f} kernels, {hd / nq:.2f} "
                       f"copies in and {dh / nq:.2f} back per query")
        return (f"p50 {np.percentile(ms_, 50):.3f} ms, p99 "
                f"{np.percentile(ms_, 99):.3f} ms, {dev_txt}, {kernel} "
                f"{launches / nq:.2f} per query")

    nb, nk = len(bodies), len(knn_bodies)
    log(f"[mesh] {nb} match queries on {card}: mesh path "
        f"{fmt(ms, prof, b1, nb, 'B1')}, repeated (memo) p50 "
        f"{np.percentile(ms2, 50):.3f} ms; host loop "
        f"{fmt(h[0], h[8], h[2], nb, 'B1')}, repeated p50 "
        f"{np.percentile(h[7], 50):.3f} ms; hits equal on both paths "
        f"({identical} of {nb + nk} responses bit-identical) and to the "
        f"plain twins'; totals exact and scores within 2^-7 of the f64 "
        f"scorer, recall@10 mean {np.mean(recalls)}, min {min(recalls)}; "
        f"knn hits match the f64 oracle")
    log(f"[mesh] {nk} brute-force knn queries: mesh path "
        f"{fmt(kms, kprof, b2, nk, 'B2')}; host loop "
        f"{fmt(h[3], h[9], h[5], nk, 'B2')}")

    # search_knn at Q = 8: B2 per slot at 4k in bf16, the f32 re-rank,
    # the merge; held against the same call on the B2 twin and against
    # the exact f64 oracle
    mesh_host_profile(node, on_mesh, bodies)
    ex = svc.mesh_executor()
    qk = qv[8:16]
    knn_topk.LAUNCHES = 0
    got_k = ex.search_knn("emb", qk, k=10)
    b2_knn = knn_topk.LAUNCHES
    t = time.perf_counter()
    for _ in range(5):
        ex.search_knn("emb", qk, k=10)
    knn_ms = (time.perf_counter() - t) / 5 * 1e3
    real = mesh_exec.knn_topk
    mesh_exec.knn_topk = functools.partial(real, plain=True)
    try:
        twin = ex.search_knn("emb", qk, k=10)
    finally:
        mesh_exec.knn_topk = real
    for a, w, what in zip(got_k[:4], twin[:4],
                          ("values", "shards", "locals", "segments")):
        if not np.array_equal(a, w):
            raise AssertionError(f"search_knn: {what} differ from the B2 "
                                 f"twin's")
    vals, shard, local, seg_ord, _ = got_k
    gid = np.array([[int(svc.shards[s].segments[o].ids[lc])
                     for s, o, lc in zip(*r)]
                    for r in zip(shard, seg_ord, local)])
    for r in range(qk.shape[0]):
        o = r + 8  # qk is qv[8:16]
        check_oracle(np, {"hits": {"hits": [
            {"_id": str(i), "_score": float(v)}
            for i, v in zip(gid[r], vals[r])]}}, o_ids[o], o_sc[o],
            o_full[o], f"search_knn query {r}")
    log(f"[mesh] search_knn Q=8 k=10 over {MESH_SHARDS} slots: "
        f"{knn_ms:.3f} ms a call, B2 launches {b2_knn}; equal to the B2 "
        f"twin's, hits match the exact f64 oracle")
    return b1, b2 + b2_knn, node, shard_text  # phase 5e reads them


# ---------------------------------------------------------------------------
# phase 5e: batched _msearch and the serving coalescer
# ---------------------------------------------------------------------------

MSEARCH_BATCH = 2048       # bench.py --batch-queries
MSEARCH_MESH_BATCH = 256
COALESCE_THREADS = 64      # bench.py::coalesced_qps


def _median_ms(np, fn, args):
    """Median wall ms of ``fn(a)`` over ``args[1:]`` after a warm call on
    ``args[0]``, and the last result."""
    fn(args[0])
    ms, out = [], None
    for a in args[1:]:
        t = time.perf_counter()
        out = fn(a)
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ms)), out


def _sequential(node, index, bodies):
    """Each body through ``Node.search`` alone, with whether kernel B1
    served any of its segments (B1 rounds to bf16 where a batch's tier 2
    and the mesh round sum in f32)."""
    from elasticsearch_tpu_torch.search import queries

    out = []
    for b in bodies:
        f = queries.FUSED_CALLS
        r = node.search(index, copy.deepcopy(b))
        out.append((r, queries.FUSED_CALLS > f))
    return out


#: B1's bf16 products against f32 sums: each of its two roundings is
#: within 2^-8 relative, so a sum of positive products is within 2^-7
BF16_BAND = 2.0 ** -7


def _fused_bar(np, got, want, what) -> float:
    """One side scored in f32, the other by B1's bf16 products: exact
    total, as many hits, scores within ``BF16_BAND`` rank by rank (phase
    5's bar against the exact scorer), and an id on one side only scoring
    within two bands of that side's last score: a near-tie at the cut
    that the roundings can swap. Returns the recall of ``got``'s ids in
    ``want``'s."""
    g, w = got["hits"]["hits"], want["hits"]["hits"]
    if got["hits"]["total"] != want["hits"]["total"] or len(g) != len(w):
        raise AssertionError(f"{what}: total {got['hits']['total']} and "
                             f"{len(g)} hits, sequential "
                             f"{want['hits']['total']} and {len(w)}")
    gs = np.array([h["_score"] for h in g])
    ws = np.array([h["_score"] for h in w])
    if not np.allclose(gs, ws, rtol=BF16_BAND, atol=0):
        raise AssertionError(f"{what}: scores {gs} vs sequential {ws}")
    gi, wi = [h["_id"] for h in g], [h["_id"] for h in w]
    for ids, other, sc in ((gi, set(wi), gs), (wi, set(gi), ws)):
        for d, v in zip(ids, sc):
            if d not in other and v > sc[-1] * (1 + 2 * BF16_BAND):
                raise AssertionError(f"{what}: doc {d} at {v} is missing on "
                                     f"the other side, above the cut's "
                                     f"rounding band ({sc[-1]})")
    return len(set(gi) & set(wi)) / max(len(wi), 1)


def _hold_mixed(np, got, seq, what):
    """A mixed batch against its sequential answers: where B1 served the
    sequential search, ``_fused_bar``; else ``check_hits`` at 1e-5.
    Returns (how many took the fused bar, their mean recall)."""
    recalls = []
    for n, (g, (w, b1)) in enumerate(zip(got, seq)):
        if b1:
            recalls.append(_fused_bar(np, g, w, f"{what} body {n}"))
        else:
            check_hits(g, w, f"{what} body {n} vs sequential", rtol=1e-5)
    return len(recalls), float(np.mean(recalls)) if recalls else 1.0


def exact_top10_card(torch, np, dev, qs, csr, chunk=64):
    """``exact_top10`` of many queries, in f64 on the card: the same
    arithmetic (each term's postings add tfn * idf, idf in f64, per doc
    in term order), so the same bits. Per query (ids, scores, total)."""
    u_doc, tfn, offsets, df, n_docs, D = csr
    docs = torch.from_numpy(np.asarray(u_doc, np.int64)).to(dev)
    w = torch.from_numpy(np.asarray(tfn, np.float64)).to(dev)
    out = []
    for c0 in range(0, len(qs), chunk):
        part = qs[c0: c0 + chunk]
        s = torch.zeros(len(part) * D, dtype=torch.float64, device=dev)
        hit = torch.zeros(len(part) * D, dtype=torch.bool, device=dev)
        for i, q in enumerate(part):
            for t in q:
                lo, hi = int(offsets[t]), int(offsets[t + 1])
                idf = float(np.log(1.0 + (n_docs - df[t] + 0.5)
                                   / (df[t] + 0.5)))
                s.index_add_(0, docs[lo:hi] + i * D, w[lo:hi] * idf)
                hit[docs[lo:hi] + i * D] = True
        s = torch.where(hit, s, float("-inf")).view(len(part), D)
        totals = hit.view(len(part), D).sum(1).cpu().numpy()
        v, idx = torch.topk(s, min(42, D), dim=1)
        v, idx = v.cpu().numpy(), idx.cpu().numpy()
        for r in range(len(part)):  # ties by doc id among the candidates
            o = np.lexsort((idx[r], -v[r]))[:min(10, int(totals[r]))]
            out.append((idx[r][o], v[r][o], int(totals[r])))
    return out


def exact_mesh_card(torch, np, dev, qs, shard_text):
    """The f64 scorer over the five shards, each with its own idf and
    average length, merged as the engine merges shards: (-score, shard,
    local) order. Per query (global doc ids, scores, total)."""
    per = [exact_top10_card(torch, np, dev, qs, csr, chunk=256)
           for csr, _docs in shard_text]
    out = []
    for n in range(len(qs)):
        cands = [(float(v), sh, int(i), int(shard_text[sh][1][i]))
                 for sh in range(len(per))
                 for i, v in zip(per[sh][n][0], per[sh][n][1])]
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        top = cands[:10]
        out.append((np.array([c[3] for c in top], np.int64),
                    np.array([c[0] for c in top]),
                    sum(per[sh][n][2] for sh in range(len(per)))))
    return out


def _hold_exact(np, resp, exact, band, what) -> float:
    """A response against the f64 scorer's (ids, scores, total): exact
    total, as many hits, scores within ``band`` of the exact ones rank by
    rank, and a doc outside the exact top only within two bands of its
    cut (a near-tie that the side's rounding can swap). Returns its
    recall of the exact top."""
    ids, sc, total = exact
    hits = resp["hits"]["hits"]
    if resp["hits"]["total"] != total or len(hits) != len(ids):
        raise AssertionError(f"{what}: total {resp['hits']['total']} and "
                             f"{len(hits)} hits, exact {total} and "
                             f"{len(ids)}")
    s = np.array([h["_score"] for h in hits])
    if not np.allclose(s, sc, rtol=band, atol=0):
        raise AssertionError(f"{what}: scores {s} vs exact {sc}")
    want = set(ids.tolist())
    got = [int(h["_id"]) for h in hits]
    for d, v in zip(got, s):
        if d not in want and v > sc[-1] * (1 + 2 * band):
            raise AssertionError(f"{what}: doc {d} at {v} is not in the "
                                 f"exact top, above the cut's band "
                                 f"({sc[-1]})")
    return len(set(got) & want) / max(len(ids), 1)


#: f32 sums of a few positive f32 products of f32-rounded weights: well
#: within 1e-5 relative of the f64 scores
F32_BAND = 1e-5


def _hold_fused_exact(np, got, seq, exact, what):
    """The members of a mixed batch whose sequential search took B1, each
    side against the f64 scorer within its own rounding: the batch's f32
    sums within ``F32_BAND``, the sequential B1 answer within
    ``BF16_BAND``. Returns (their count, mean recall of each side)."""
    rb, rs = [], []
    for n, (g, (w, b1)) in enumerate(zip(got, seq)):
        if b1:  # exact: {body number: (ids, scores, total)}
            rb.append(_hold_exact(np, g, exact[n], F32_BAND,
                                  f"{what} body {n}, batch vs f64"))
            rs.append(_hold_exact(np, w, exact[n], BF16_BAND,
                                  f"{what} body {n}, sequential vs f64"))
    return len(rb), float(np.mean(rb or [1.0])), float(np.mean(rs or [1.0]))


def _fmt_prof(prof, wall_ms, per="msearch") -> str:
    if prof is None:
        return "device time not measured"
    busy, kern, hd, dh, top = prof
    return (f"device {busy:.3f} ms ({100 * busy / wall_ms:.1f}% busy), "
            f"{kern} kernels, {hd} copies in and {dh} back a {per} (top: "
            + "; ".join(top) + ")")


def phase_msearch(torch, np, dev, card, corpus, sift, read_node, mesh_node,
                  shard_text):
    """Phase 5e: ``Node.msearch`` and the serving coalescer on phase 5's
    index (one 2^20-doc segment), phase 5d's five shards and phase 5b's
    slab, with ``bench.py``'s recipes (``make_queries``, pure-dense and
    mixed; ``batched_msearch_qps``; ``coalesced_qps``). Returns its (B1,
    B2) launches, counted in its single-threaded runs."""
    import itertools
    import threading

    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk, knn_topk
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    df = corpus[4]
    node = read_node
    seg = node.get_index("msmarco").shards[0].segments[0]
    dense_rows = seg.inverted["body"].dense_block()[0]
    dense = np.asarray(dense_rows[:VOCAB]) >= 0

    def bodies_of(qs):
        return [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
                 "size": 10} for q in qs]

    def pairs_of(index, bodies):
        return [({"index": index}, copy.deepcopy(b)) for b in bodies]

    def msearch(nd, index):
        return lambda pairs: nd.msearch(pairs)["responses"]

    # (a) pure-dense msearch: tier 1, B1's batched form
    bodies_a = bodies_of(make_queries(np, MSEARCH_BATCH, VOCAB, df, SEED,
                                      dense_only=dense))
    run_a = msearch(node, "msmarco")
    run_a(pairs_of("msmarco", bodies_a))  # first use, untimed
    counters.reset()
    bm25_topk.LAUNCHES = 0
    got_a = run_a(pairs_of("msmarco", bodies_a))
    b1_a, snap = bm25_topk.LAUNCHES, counters.snapshot()
    if b1_a != 1 or snap.get("bm25_fused_topk") != MSEARCH_BATCH \
            or snap.get("bm25_hybrid") or snap.get("bm25_scatter"):
        raise AssertionError(f"5e(a): {b1_a} B1 launches, counters {snap}; "
                             f"one launch for the one segment expected")
    wall_a, _ = _median_ms(np, run_a, [pairs_of("msmarco", bodies_a)
                                       for _ in range(4)])
    prof_a = profile_path(torch, lambda: run_a(pairs_of("msmarco",
                                                        bodies_a)))
    seq_a = _sequential(node, "msmarco", bodies_a)
    same_a = 0
    for n, (w, b1) in enumerate(seq_a):
        if not b1:
            raise AssertionError(f"5e(a) body {n}: B1 did not serve it alone")
        check_hits(got_a[n], w, f"5e(a) body {n} vs sequential", rtol=1e-6)
        same_a += got_a[n]["hits"] == w["hits"]
    real = queries.bm25_dense_topk
    queries.bm25_dense_topk = functools.partial(real, plain=True)
    try:  # the twin at 256 queries a call: its [Q, D] rows and sort fit
        twin = []
        for a in range(0, MSEARCH_BATCH, 256):
            twin += run_a(pairs_of("msmarco", bodies_a[a: a + 256]))
    finally:
        queries.bm25_dense_topk = real
    for n in range(MSEARCH_BATCH):
        if got_a[n]["hits"] != twin[n]["hits"]:
            raise AssertionError(f"5e(a) body {n}: hits differ from the B1 "
                                 f"twin's")
    qps_a = MSEARCH_BATCH / wall_a * 1e3
    log(f"[msearch] (a) {MSEARCH_BATCH} pure-dense bodies in one "
        f"Node.msearch on {card}: {qps_a:.1f} queries/s (median "
        f"{wall_a:.3f} ms a call of 3 after a warm one), "
        f"{_fmt_prof(prof_a, wall_a)}; B1 launches {b1_a} (one segment), "
        f"no generic BM25; equal to sequential Node.search "
        f"({same_a} of {MSEARCH_BATCH} bit-identical), bit for bit the B1 "
        f"twin's")

    # (b) mixed Zipfian msearch: tier 2, the f32 product and the tails
    qs_b = make_queries(np, MSEARCH_BATCH, VOCAB, df, SEED + 9)
    bodies_b = bodies_of(qs_b)
    run_b = msearch(node, "msmarco")
    run_b(pairs_of("msmarco", bodies_b))
    counters.reset()
    bm25_topk.LAUNCHES = 0
    got_b = run_b(pairs_of("msmarco", bodies_b))
    snap = counters.snapshot()
    if bm25_topk.LAUNCHES or snap.get("bm25_hybrid") != MSEARCH_BATCH:
        raise AssertionError(f"5e(b): {bm25_topk.LAUNCHES} B1 launches, "
                             f"counters {snap}; tier 2 for every body "
                             f"expected")
    wall_b, _ = _median_ms(np, run_b, [pairs_of("msmarco", bodies_b)
                                       for _ in range(4)])
    prof_b = profile_path(torch, lambda: run_b(pairs_of("msmarco",
                                                        bodies_b)))
    seq_b = _sequential(node, "msmarco", bodies_b)
    n_fused, rec_b = _hold_mixed(np, got_b, seq_b, "5e(b)")
    # the pure-dense members, each side against the f64 scorer (phase 5's,
    # on the card; its first four checked against the numpy one)
    csr = (corpus[0], corpus[2], corpus[3], df, N_DOCS, N_DOCS)
    at = [n for n, (_, b1) in enumerate(seq_b) if b1]
    exact = dict(zip(at, exact_top10_card(torch, np, dev,
                                          [qs_b[n] for n in at], csr)))
    for n in at[:4]:
        ids, sc, total = exact_top10(np, qs_b[n], corpus[0], corpus[2],
                                     corpus[3], df, N_DOCS, N_DOCS)
        if not (np.array_equal(ids, exact[n][0]) and total == exact[n][2]
                and np.array_equal(sc, exact[n][1])):
            raise AssertionError(f"5e(b) body {n}: the card's f64 scorer "
                                 f"differs from the numpy one")
    _, xb_b, xs_b = _hold_fused_exact(np, got_b, seq_b, exact, "5e(b)")
    log(f"[msearch] (b) {MSEARCH_BATCH} mixed Zipfian bodies in one "
        f"Node.msearch: {MSEARCH_BATCH / wall_b * 1e3:.1f} queries/s "
        f"(median {wall_b:.3f} ms), {_fmt_prof(prof_b, wall_b)}; tier 2 "
        f"for all, no B1 launch; equal to sequential Node.search ("
        f"{MSEARCH_BATCH - n_fused} at 1e-5, {n_fused} pure-dense within "
        f"B1's rounding band, recall@10 of those {rec_b:.4f}); those "
        f"{n_fused} against the f64 scorer: the batch within {F32_BAND} "
        f"(recall@10 {xb_b:.4f}), sequential within 2^-7 (recall@10 "
        f"{xs_b:.4f})")

    # (c) five shards: the mesh's batched round against the host tiers
    svc = mesh_node.get_index("mesh5")
    bodies_c = bodies_b[:MSEARCH_MESH_BATCH]
    run_c = msearch(mesh_node, "mesh5")
    run_c(pairs_of("mesh5", bodies_c))
    counters.reset()
    bm25_topk.LAUNCHES = 0
    got_c = run_c(pairs_of("mesh5", bodies_c))
    snap = counters.snapshot()
    if snap.get("mesh_msearch") != 1 or snap.get("mesh_msearch_fallback") \
            or bm25_topk.LAUNCHES:
        raise AssertionError(f"5e(c): counters {snap}, B1 launches "
                             f"{bm25_topk.LAUNCHES}; one mesh round and no "
                             f"B1 expected")
    wall_c, _ = _median_ms(np, run_c, [pairs_of("mesh5", bodies_c)
                                       for _ in range(4)])
    prof_c = profile_path(torch, lambda: run_c(pairs_of("mesh5", bodies_c)))
    svc.settings["search"] = {"mesh": False}
    try:
        run_c(pairs_of("mesh5", bodies_c))
        counters.reset()
        t = time.perf_counter()
        host_c = run_c(pairs_of("mesh5", bodies_c))
        host_ms = (time.perf_counter() - t) * 1e3
        if counters.snapshot().get("mesh_msearch"):
            raise AssertionError("5e(c): the host tiers took the mesh")
    finally:
        svc.settings["search"] = {"mesh": True}
    for n in range(MSEARCH_MESH_BATCH):
        check_hits(got_c[n], host_c[n], f"5e(c) body {n}, mesh vs host "
                                        f"tiers", rtol=1e-5)
    seq_c = _sequential(mesh_node, "mesh5", bodies_c)
    n_fused, rec_c = _hold_mixed(np, got_c, seq_c, "5e(c)")
    at = [n for n, (_, b1) in enumerate(seq_c) if b1]
    exact = dict(zip(at, exact_mesh_card(torch, np, dev,
                                         [qs_b[n] for n in at], shard_text)))
    _, xb_c, xs_c = _hold_fused_exact(np, got_c, seq_c, exact, "5e(c)")
    log(f"[msearch] (c) {MSEARCH_MESH_BATCH} mixed bodies over "
        f"{MESH_SHARDS} shards: mesh round "
        f"{MSEARCH_MESH_BATCH / wall_c * 1e3:.1f} queries/s (median "
        f"{wall_c:.3f} ms), {_fmt_prof(prof_c, wall_c)}; host tiers "
        f"{host_ms:.3f} ms a call; mesh_msearch once, no B1; equal to the "
        f"host tiers at 1e-5 and to sequential Node.search "
        f"({MSEARCH_MESH_BATCH - n_fused} at 1e-5, {n_fused} with a "
        f"pure-dense shard within B1's rounding band, recall@10 of those "
        f"{rec_c:.4f}; against the f64 scorer: the mesh round within "
        f"{F32_BAND} (recall@10 {xb_c:.4f}), sequential within 2^-7 "
        f"(recall@10 {xs_c:.4f}))")

    # (d) brute-force kNN and MaxSim msearch on phase 5b's slab
    vpad, exists, bucket, D, make_q = sift
    vnode = Node(name="msearch-vec", device=dev)
    vnode.create_index("sift", {"settings": {"number_of_shards": 1},
                                "mappings": VEC_MAPPING})
    vnode.get_index("sift").shards[0].engine.add_segment(segment_from_arrays({
        "num_docs": N_VECS, "max_docs": D,
        "numerics": {"bucket": {"exact": bucket, "exists": exists,
                                "kind": "long"}},
        "vectors": {"emb": {"vecs": vpad, "exists": exists, "dims": DIMS,
                            "similarity": "cosine"}}}, vnode.residency))
    qv = make_q(32 + 8 * 8)
    knn_bodies = [{"query": {"knn": {"field": "emb", "ann": False,
                                     "query_vector": [float(a) for a in v]}},
                   "size": 10} for v in qv[:32]]
    toks = qv[32:].reshape(8, 8, DIMS)
    ms_bodies = [{"query": {"knn": {"field": "emb", "query_vectors": [
        [float(a) for a in v] for v in t]}}, "size": 10} for t in toks]
    _ids, _sc, full = exact_cosine_top(np, vpad, exists, qv, 10)
    oracles = {"knn": full[:32],
               "maxsim": full[32:].reshape(8, 8, -1).max(axis=1)}
    del full
    b2_d, d_txt = 0, []
    for name, bodies in (("knn", knn_bodies), ("maxsim", ms_bodies)):
        run_d = msearch(vnode, "sift")
        run_d(pairs_of("sift", bodies))
        counters.reset()
        knn_topk.LAUNCHES = 0
        t = time.perf_counter()
        got = run_d(pairs_of("sift", bodies))
        d_ms = (time.perf_counter() - t) * 1e3
        b2, snap = knn_topk.LAUNCHES, counters.snapshot()
        if b2 != 1 or snap.get("knn_fused_batch") != len(bodies):
            raise AssertionError(f"5e(d) {name}: {b2} B2 launches, counters "
                                 f"{snap}; one launch expected")
        b2_d += b2
        same = 0
        for n, (w, _) in enumerate(_sequential(vnode, "sift", bodies)):
            check_hits(got[n], w, f"5e(d) {name} body {n} vs sequential",
                       rtol=1e-6)
            same += got[n]["hits"] == w["hits"]
        orc = oracles[name]
        for n in range(len(bodies)):
            ids = np.argsort(-orc[n], kind="stable")[:10]
            check_oracle(np, got[n], ids, orc[n][ids], orc[n],
                         f"5e(d) {name} body {n}")
        d_txt.append(f"{len(bodies)} {name} bodies {d_ms:.3f} ms, B2 once, "
                     f"{same} bit-identical to sequential")
    del oracles
    vnode.close()
    log(f"[msearch] (d) on the {N_VECS}-vector slab: " + "; ".join(d_txt)
        + "; hits equal sequential Node.search and the f64 oracle")

    # (e) the coalescer: 64 threads send (a)'s bodies as single searches
    coal = node.serving.coalescer

    def round_(_=None):
        out = [None] * MSEARCH_BATCH
        errs = []
        nxt = itertools.count()

        def worker():
            while True:
                i = next(nxt)
                if i >= MSEARCH_BATCH:
                    return
                try:
                    out[i] = node.search("msmarco", bodies_a[i])
                except Exception as e:  # raised below
                    errs.append(e)
                    return

        threads = [threading.Thread(target=worker)
                   for _ in range(COALESCE_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if errs or any(th.is_alive() for th in threads):
            raise AssertionError(f"5e(e): a coalesced round failed: "
                                 f"{errs[:1]}")
        return out

    # the same rounds with the coalescer on (adaptive, its default) and
    # off (each search on its own path), alternated after a warm round of
    # each
    def in_mode(mode):
        node.serving.apply_cluster_settings({"serving.coalescer.mode": mode})
        return round_()

    in_mode("adaptive")
    in_mode("off")
    before = coal.stats()
    ms_e = {"adaptive": [], "off": []}
    got_e = {}
    for _ in range(3):
        for mode in ms_e:
            t = time.perf_counter()
            got_e[mode] = in_mode(mode)
            ms_e[mode].append((time.perf_counter() - t) * 1e3)
    after = coal.stats()
    in_mode("off")
    prof_off = profile_path(torch, round_)
    in_mode("adaptive")
    prof_e = profile_path(torch, round_)
    node.serving.apply_cluster_settings({})
    flushes = {r: n - before["flushes"].get(r, 0)
               for r, n in after["flushes"].items()
               if n > before["flushes"].get(r, 0)}
    batches = after["batch_size"]["count"] - before["batch_size"]["count"]
    sizes = after["batch_size"]["sum"] - before["batch_size"]["sum"]
    if batches < 1 or after["batch_size"]["max"] < 2:
        raise AssertionError(f"5e(e): no flush held more than one request: "
                             f"{after}")
    for mode, got in got_e.items():
        for n in range(MSEARCH_BATCH):
            check_hits(got[n], got_a[n], f"5e(e) {mode} body {n} vs (a)",
                       rtol=1e-6)
    wall_e = float(np.median(ms_e["adaptive"]))
    wall_off = float(np.median(ms_e["off"]))
    qps_e = MSEARCH_BATCH / wall_e * 1e3
    qps_off = MSEARCH_BATCH / wall_off * 1e3
    solo = after["bypass"].get("solo", 0) - before["bypass"].get("solo", 0)
    log(f"[msearch] (e) {MSEARCH_BATCH} single searches from "
        f"{COALESCE_THREADS} threads through the coalescer: {qps_e:.1f} "
        f"queries/s (median {wall_e:.3f} ms a round of 3), "
        f"{_fmt_prof(prof_e, wall_e, 'round')}; {100 * qps_e / qps_a:.1f}% "
        f"of (a)'s rate; over 3 rounds {batches} batches of "
        f"{sizes / max(batches, 1):.1f} requests on average (largest "
        f"{after['batch_size']['max']}), flushes {flushes}, {solo} solo "
        f"bypasses. The coalescer off, alternated with those rounds: "
        f"{qps_off:.1f} queries/s (median {wall_off:.3f} ms), "
        f"{_fmt_prof(prof_off, wall_off, 'round')}; coalesced / off "
        f"{qps_e / qps_off:.3f}. Every response equal to (a)'s")
    log(f"[msearch] phase 5e took {time.perf_counter() - t0:.1f} s")
    return b1_a, b2_d


# ---------------------------------------------------------------------------
# phase 5f: aggregations on an nyc_taxis stand-in
# ---------------------------------------------------------------------------

TAXI_SHARDS = 4
TAXI_DOCS = 1 << 20        # per shard: one 2^20-doc segment each
TAXI_WINDOW_S = 2.0        # timed requests per body and route: for about
TAXI_MIN_REPS = 25         # this many seconds, at least TAXI_MIN_REPS and
TAXI_MAX_REPS = 200        # at most TAXI_MAX_REPS of them
TAXI_TAIL_REPS = 100       # a p99 is printed from this many requests on
TAXI_PROFILED = 6          # requests per body and route under the profiler
SAMPLE_CAP = 1 << 16       # percentiles' per-segment sample (the reference's)
TAXI_YEAR = 1_420_070_400_000   # 2015-01-01T00:00:00Z
DAY_MS = 86_400_000
#: keyword fields: their values in term order (ordinal = position)
TAXI_KEYWORDS = {
    "vendor_id": ("1", "2", "4"),
    "payment_type": ("1", "2", "3", "4", "5", "6"),
    "rate_code_id": ("1", "2", "3", "4", "5", "6", "99"),
    "store_and_fwd_flag": ("N", "Y"),
}
TAXI_MAPPING = {"properties": dict(
    {k: {"type": "keyword"} for k in TAXI_KEYWORDS},
    passenger_count={"type": "integer"},
    trip_distance={"type": "double"}, fare_amount={"type": "double"},
    tip_amount={"type": "double"}, total_amount={"type": "double"},
    pickup_datetime={"type": "date", "format": "yyyy-MM-dd HH:mm:ss"},
    dropoff_datetime={"type": "date", "format": "yyyy-MM-dd HH:mm:ss"})}
#: the track's aggregation operations (operations/default.json) and the
#: agg types the port serves, every body size 0 as the track sends them
TAXI_BODIES = {
    "distance_amount_agg": {"size": 0, "query": {"bool": {"filter": {
        "range": {"trip_distance": {"lt": 50, "gte": 0}}}}}, "aggs": {
        "distance_histo": {"histogram": {"field": "trip_distance",
                                         "interval": 1}, "aggs": {
            "total_amount_stats": {"stats": {"field": "total_amount"}}}}}},
    "date_histogram_agg": {"size": 0, "query": {"range": {
        "dropoff_datetime": {"gte": "01/01/2015", "lte": "21/01/2015",
                             "format": "dd/MM/yyyy"}}}, "aggs": {
        "dropoffs_over_time": {"date_histogram": {
            "field": "dropoff_datetime", "interval": "day"}}}},
    "keyword_terms": {"size": 0, "aggs": {
        "vendors": {"terms": {"field": "vendor_id"}},
        "payments": {"terms": {"field": "payment_type"}}}},
    "terms_avg_tip": {"size": 0, "aggs": {"payments": {
        "terms": {"field": "payment_type"},
        "aggs": {"avg_tip": {"avg": {"field": "tip_amount"}}}}}},
    "cardinality": {"size": 0, "aggs": {
        "fares": {"cardinality": {"field": "fare_amount"}},
        "rate_codes": {"cardinality": {"field": "rate_code_id"}}}},
    "percentiles": {"size": 0, "aggs": {
        "total": {"percentiles": {"field": "total_amount"}}}},
    "numeric_mix": {"size": 0, "aggs": {
        "fare_stats": {"extended_stats": {"field": "fare_amount"}},
        "passengers": {"stats": {"field": "passenger_count"}},
        "distance_ranges": {"range": {"field": "trip_distance", "ranges": [
            {"to": 2}, {"from": 2, "to": 10}, {"from": 10}]}},
        "no_tip": {"missing": {"field": "tip_amount"}},
        "trips": {"filters": {"filters": {
            "long": {"range": {"trip_distance": {"gte": 10}}},
            "january": {"range": {"pickup_datetime": {
                "gte": "2015-01-01 00:00:00",
                "lt": "2015-02-01 00:00:00"}}}}}}}},
}


def make_taxis(np, n, seed):
    """Generated trip records, one array per field (keywords as term
    ordinals): the shapes of the track's fields, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {
        "vendor_id": rng.choice(3, n, p=[0.46, 0.50, 0.04]),
        "payment_type": rng.choice(
            6, n, p=[0.62, 0.365, 0.008, 0.004, 0.002, 0.001]),
        "rate_code_id": rng.choice(
            7, n, p=[0.972, 0.02, 0.004, 0.002, 0.001, 0.0008, 0.0002]),
        "store_and_fwd_flag": (rng.random(n) < 0.01).astype(np.int64),
        "passenger_count": rng.choice(
            10, n, p=[0.004, 0.70, 0.14, 0.04, 0.02, 0.06, 0.034, 0.001,
                      0.0005, 0.0005]).astype(np.int64),
    }
    for k in TAXI_KEYWORDS:
        out[k] = out[k].astype(np.int32)
    dist = np.round(rng.lognormal(0.8, 0.9, n), 2)
    fare = np.round(np.maximum(2.5, 2.5 + 2.6 * dist
                               + rng.normal(0.0, 1.5, n)), 2)
    # a tip is recorded for card payments; cash trips have none
    tip_exists = out["payment_type"] != 1
    tip = np.round(fare * rng.uniform(0.0, 0.3, n), 2)
    pickup = TAXI_YEAR + rng.integers(0, 365 * DAY_MS, n)
    out.update(
        trip_distance=dist, fare_amount=fare,
        tip_amount=np.where(tip_exists, tip, 0.0), tip_exists=tip_exists,
        total_amount=np.round(fare + np.where(tip_exists, tip, 0.0) + 0.8,
                              2),
        pickup_datetime=pickup,
        dropoff_datetime=pickup + (rng.lognormal(6.5, 0.6, n)
                                   * 1000).astype(np.int64))
    return out


def taxi_shard_arrays(np, taxis, s):
    """``segment_from_arrays``'s arrays for shard s: docs [s * 2^20,
    (s + 1) * 2^20), keyword postings and ordinals, numeric columns."""
    lo, hi = s * TAXI_DOCS, (s + 1) * TAXI_DOCS
    n = TAXI_DOCS
    ones = np.ones(n, np.float32)
    fields, keywords = {}, {}
    for name, terms in TAXI_KEYWORDS.items():
        ords = taxis[name][lo:hi]
        df = np.bincount(ords, minlength=len(terms)).astype(np.int32)
        offsets = np.zeros(len(terms) + 1, np.int64)
        offsets[1:] = np.cumsum(df)
        fields[name] = {
            "terms": list(terms), "df": df, "cf": df.astype(np.int64),
            "offsets": offsets,
            "doc_ids_host": np.argsort(ords, kind="stable").astype(np.int32),
            "tfnorm_host": ones, "tf_host": ones, "avg_len": 1.0,
            "num_docs": n, "total_terms": n}
        single = [[t] for t in terms]  # shared: never mutated
        keywords[name] = {"ords": ords, "exists": np.ones(n, bool),
                          "host_values": [single[o] for o in ords.tolist()]}
    numerics = {}
    for name, kind in (("passenger_count", "integer"),
                       ("trip_distance", "double"),
                       ("fare_amount", "double"), ("tip_amount", "double"),
                       ("total_amount", "double"),
                       ("pickup_datetime", "date"),
                       ("dropoff_datetime", "date")):
        exists = taxis["tip_exists"][lo:hi] if name == "tip_amount" \
            else np.ones(n, bool)
        numerics[name] = {"exact": taxis[name][lo:hi], "exists": exists,
                          "kind": kind}
    return {"num_docs": n, "max_docs": n, "fields": fields,
            "keywords": keywords, "numerics": numerics}


def hash32_np(np, x):
    """The HLL value mix in numpy uint32 (wrapping multiplies)."""
    h = x.astype(np.uint32)
    h = h * np.uint32(2654435761)
    h ^= h >> np.uint32(16)
    h = h * np.uint32(0x45D9F3B)
    h ^= h >> np.uint32(16)
    return h


def hll_bounds(np, values):
    """(lo, hi) int32[4096] register bounds of an f64 column's HLL: each
    value's rank is its exact leading-zero count + 1; a rest whose f32
    lies within 2^-20 below or at a power of two may take one more or
    one less (the f32 formula's log2), the rest exactly that."""
    bits = values.view(np.int64)
    h = hash32_np(np, (bits & 0xFFFFFFFF) ^ ((bits >> 32) & 0xFFFFFFFF))
    reg = (h >> np.uint32(20)).astype(np.int64)
    rest = (h << np.uint32(12)).astype(np.uint32)
    bl = np.zeros(rest.shape, np.int64)  # bit length
    r = rest.astype(np.int64)
    for b in range(32, 0, -1):
        bl = np.where((bl == 0) & (r >> (b - 1) > 0), b, bl)
    exact = np.clip(32 - bl + 1, 1, 21)
    f = rest.astype(np.float32).astype(np.float64)
    with np.errstate(divide="ignore"):
        up = np.exp2(np.ceil(np.log2(np.maximum(f, 1.0))))
    band = (rest > 0) & (f >= up * (1 - 2.0 ** -20))
    lo = np.zeros(4096, np.int64)
    hi = np.zeros(4096, np.int64)
    np.maximum.at(lo, reg, np.clip(exact - band, 1, 21))
    np.maximum.at(hi, reg, np.clip(exact + band, 1, 21))
    return lo, hi, exact, reg


def _hold(cond, what, phase="5f"):
    if not cond:
        raise AssertionError(f"phase {phase}: {what}")


def _near(got, want, rtol, what):
    _hold(got is not None and abs(got - want) <= rtol * abs(want),
          f"{what}: {got!r} vs {want!r} (rtol {rtol})")


def taxi_oracle_check(np, name, resp, t):
    """Hold one response against numpy over the generated arrays ``t``:
    keys, order and counts exact; count, min and max exact; sums and
    averages at rtol 1e-5 of an f64 sum (variance, a difference of two
    sums, at 1e-4); percentiles equal numpy's on the same sample."""
    f32 = np.float32
    aggs = resp["aggregations"]
    n_all = t["trip_distance"].size
    if name == "distance_amount_agg":
        td32 = t["trip_distance"].astype(f32)
        q = (td32 >= f32(0)) & (td32 < f32(50))
        _hold(resp["hits"]["total"] == int(q.sum()), "distance total")
        keys = np.floor(t["trip_distance"][q]).astype(np.int64)
        cnt = np.bincount(keys - keys.min())
        got = aggs["distance_histo"]["buckets"]
        _hold([b["key"] for b in got]
              == [float(k) for k in range(keys.min(), keys.max() + 1)]
              and [b["doc_count"] for b in got] == cnt.tolist(),
              "distance_histo keys or counts")
        tot32 = t["total_amount"].astype(f32)
        for b in got:
            k = b["key"]
            m = q & (td32 >= f32(k)) & (td32 < f32(k + 1))
            n = int(m.sum())
            s = b.get("total_amount_stats")
            if not b["doc_count"]:
                _hold(s is None, f"bucket {k}: stats of an empty bucket")
                continue
            _hold(s["count"] == n and s["min"] == float(tot32[m].min())
                  and s["max"] == float(tot32[m].max()),
                  f"bucket {k} stats count/min/max {s}")
            want = float(t["total_amount"][m].sum())
            _near(s["sum"], want, 1e-5, f"bucket {k} sum")
            _near(s["avg"], want / n, 1e-5, f"bucket {k} avg")
    elif name == "date_histogram_agg":
        lo = TAXI_YEAR
        hi = TAXI_YEAR + 20 * DAY_MS
        d = t["dropoff_datetime"]
        q = (d >= lo) & (d <= hi)
        _hold(resp["hits"]["total"] == int(q.sum()), "date total")
        days = d[q] // DAY_MS
        cnt = np.bincount(days - days.min())
        got = aggs["dropoffs_over_time"]["buckets"]
        want_keys = [int(x) * DAY_MS for x in range(days.min(),
                                                    days.max() + 1)]
        _hold([b["key"] for b in got] == want_keys
              and [b["doc_count"] for b in got] == cnt.tolist(),
              "dropoffs_over_time keys or counts")
        _hold(all(b["key_as_string"] == time.strftime(
            "%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(b["key"] // 1000))
            for b in got), "dropoffs_over_time key_as_string")
    elif name in ("keyword_terms", "terms_avg_tip"):
        _hold(resp["hits"]["total"] == n_all, "terms total")
        fields = (("vendors", "vendor_id"), ("payments", "payment_type")) \
            if name == "keyword_terms" else (("payments", "payment_type"),)
        for agg, field in fields:
            terms = TAXI_KEYWORDS[field]
            cnt = np.bincount(t[field], minlength=len(terms))
            want = sorted(((int(c), terms[i]) for i, c in enumerate(cnt)
                           if c), reverse=True)[:10]
            got = aggs[agg]
            _hold([(b["doc_count"], b["key"]) for b in got["buckets"]]
                  == want and got["sum_other_doc_count"] == 0
                  and got["doc_count_error_upper_bound"] == 0,
                  f"{agg} buckets {got['buckets']}")
            if name == "terms_avg_tip":
                for b in got["buckets"]:
                    m = (t[field] == terms.index(b["key"])) & t["tip_exists"]
                    n = int(m.sum())
                    v = b["avg_tip"]["value"]
                    if n == 0:
                        _hold(v is None, f"avg_tip of {b['key']}")
                    else:
                        _near(v, float(t["tip_amount"][m].sum()) / n, 1e-5,
                              f"avg_tip of {b['key']}")
    elif name == "percentiles":
        rng_parts = []
        for s in range(TAXI_SHARDS):
            part = t["total_amount"][s * TAXI_DOCS: (s + 1) * TAXI_DOCS]
            if part.size > SAMPLE_CAP:
                part = np.random.default_rng(17).choice(
                    part, SAMPLE_CAP, replace=False)
            rng_parts.append(part)
        allv = np.concatenate(rng_parts)
        want = {f"{float(p)}": float(np.percentile(allv, p))
                for p in (1, 5, 25, 50, 75, 95, 99)}
        _hold(aggs["total"]["values"] == want,
              f"percentiles {aggs['total']['values']} vs {want}")
    elif name == "numeric_mix":
        fare = t["fare_amount"]
        fs = aggs["fare_stats"]
        f32v = fare.astype(f32)
        _hold(fs["count"] == n_all and fs["min"] == float(f32v.min())
              and fs["max"] == float(f32v.max()), f"fare_stats {fs}")
        s, sq = float(fare.sum()), float((fare * fare).sum())
        _near(fs["sum"], s, 1e-5, "fare sum")
        _near(fs["avg"], s / n_all, 1e-5, "fare avg")
        _near(fs["sum_of_squares"], sq, 1e-5, "fare sum_of_squares")
        var = sq / n_all - (s / n_all) ** 2
        _near(fs["variance"], var, 1e-4, "fare variance")
        _near(fs["std_deviation"], var ** 0.5, 1e-4, "fare std_deviation")
        ps = aggs["passengers"]
        pc = t["passenger_count"]
        _hold(ps["count"] == n_all and ps["min"] == float(pc.min())
              and ps["max"] == float(pc.max()), f"passengers {ps}")
        _near(ps["sum"], float(pc.sum()), 1e-5, "passengers sum")
        td32 = t["trip_distance"].astype(f32)
        want = [("*-2", int((td32 < f32(2)).sum())),
                ("2-10", int(((td32 >= f32(2)) & (td32 < f32(10))).sum())),
                ("10-*", int((td32 >= f32(10)).sum()))]
        _hold([(b["key"], b["doc_count"])
               for b in aggs["distance_ranges"]["buckets"]] == want,
              f"distance_ranges {aggs['distance_ranges']}")
        _hold(aggs["no_tip"]["doc_count"] == int((~t["tip_exists"]).sum()),
              "no_tip")
        pk = t["pickup_datetime"]
        jan = int(((pk >= TAXI_YEAR) & (pk < TAXI_YEAR + 31 * DAY_MS)).sum())
        _hold(aggs["trips"]["buckets"] == {
            "long": {"doc_count": int((td32 >= f32(10)).sum())},
            "january": {"doc_count": jan}}, f"trips {aggs['trips']}")


def taxi_cardinality_check(np, torch, node, resp, t):
    """Cardinality: each shard's registers (the collector on the card)
    against the numpy build of the same hash; the response is their
    merge. Returns how many of the 4 x 4096 fare registers equal the
    numpy build's exact-rank registers, and the values in the f32 band."""
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.context import SegmentContext
    from elasticsearch_tpu_torch.utils.hashing import (hll_update_host,
                                                       murmur3_32)

    svc = node.get_index("taxis")
    (fares, rates) = parse_aggs(TAXI_BODIES["cardinality"]["aggs"])
    regs, equal, in_band = [], 0, 0
    for s in range(TAXI_SHARDS):
        seg = svc.shards[s].segments[0]
        ctx = SegmentContext(seg, svc.mappings, svc.analysis)
        got = fares.collect(ctx, seg.live).astype(np.int64)
        lo, hi, exact, reg = hll_bounds(
            np, t["fare_amount"][s * TAXI_DOCS: (s + 1) * TAXI_DOCS])
        _hold(np.all((lo <= got) & (got <= hi)),
              f"shard {s}: fare registers outside the numpy bounds")
        want = np.zeros(4096, np.int64)
        np.maximum.at(want, reg, exact)
        equal += int((got == want).sum())
        in_band += int((lo != hi).sum())
        regs.append(got.astype(np.int32))
    _hold(resp["aggregations"]["fares"] == fares.reduce(regs),
          "fares: the response is not the merge of the shards' registers")
    rate_regs = np.zeros(4096, np.int32)
    for s in range(TAXI_SHARDS):
        present = np.unique(t["rate_code_id"][s * TAXI_DOCS:
                                              (s + 1) * TAXI_DOCS])
        hll_update_host(rate_regs, np.array(
            [murmur3_32(TAXI_KEYWORDS["rate_code_id"][i]) for i in present],
            np.uint32))
    _hold(resp["aggregations"]["rate_codes"] == rates.reduce([rate_regs]),
          "rate_codes value")
    return equal, in_band


def phase_aggs(torch, np, dev, card):
    """Phase 5f: aggregations on a stand-in for Elastic Rally's public
    ``nyc_taxis`` track (its ``index.json`` mapping and the aggregation
    operations of ``operations/default.json``), generated from seed 0.
    Cut from the track: 4,194,304 docs in four shards of one 2^20-doc
    segment (the track has 165M); the track's scaled_float fields are
    doubles (ES 2.0 has none); no geo_point fields (geo is ROADMAP A9);
    the other fields of the track's mapping left out. The doc count is
    cut for time, not for the card's memory (the track's keyword and
    numeric columns, about 10 GB, would fit): generating and building
    the docs on the host takes 4-5.3 s per 2^20 of them (the set-up
    line prints it), so the track's 165M would take 11-14 minutes of
    the script's 20 before a request, and the phase has about 60 s.

    Every body runs on the mesh path and on the host loop
    (``index.search.mesh: false``), the two byte-identical and each held
    against numpy over the generated arrays. Per body and route: p50
    over about TAXI_WINDOW_S seconds of requests (TAXI_MIN_REPS to
    TAXI_MAX_REPS), p99 where they number TAXI_TAIL_REPS or more (else
    the slowest, labelled so), device time, kernels and copies a request
    over TAXI_PROFILED profiled requests, and the busy share. Returns
    the node and the generated arrays for phase 5g."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.search.aggregations.metrics import \
        PercentilesAggregator

    _hold(PercentilesAggregator.SAMPLE_CAP == SAMPLE_CAP,
          "the port's percentile sample cap moved")
    t0 = time.perf_counter()
    taxis = make_taxis(np, TAXI_SHARDS * TAXI_DOCS, SEED)
    node = Node(name="taxis", device=dev)
    node.create_index("taxis", {
        "settings": {"number_of_shards": TAXI_SHARDS},
        "mappings": TAXI_MAPPING})
    svc = node.get_index("taxis")
    for s in range(TAXI_SHARDS):
        svc.shards[s].engine.add_segment(segment_from_arrays(
            taxi_shard_arrays(np, taxis, s), node.residency))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    log(f"[aggs] {TAXI_SHARDS * TAXI_DOCS} generated trips over "
        f"{TAXI_SHARDS} shards of one {TAXI_DOCS}-doc segment; set-up "
        f"{setup:.1f} s ({setup * (1 << 20) / (TAXI_SHARDS * TAXI_DOCS):.2f}"
        f" s per 2^20 docs)")

    def on_mesh(flag):
        svc.settings["search"] = {"mesh": flag}

    def run(body, n, window_s=0.0):
        """n requests, or more until ``window_s`` seconds have passed,
        at most TAXI_MAX_REPS: (each one's ms, the last response)."""
        ms, out = [], None
        start = time.perf_counter()
        while len(ms) < n or (len(ms) < TAXI_MAX_REPS and
                              time.perf_counter() - start < window_s):
            t = time.perf_counter()
            out = node.search("taxis", copy.deepcopy(body))
            ms.append((time.perf_counter() - t) * 1e3)
        return np.array(ms), out

    lines, card_eq = [], None
    for name, body in TAXI_BODIES.items():
        res = {}
        for mesh in (True, False):
            on_mesh(mesh)
            run(body, 1)  # first use: dense blocks, stacked copies
            counters.reset()
            ms, resp = run(body, TAXI_MIN_REPS, TAXI_WINDOW_S)
            snap = counters.snapshot()
            prof = profile_path(torch, lambda: run(body, TAXI_PROFILED))
            res[mesh] = (ms, resp, snap, prof)
        on_mesh(True)
        (ms, resp, snap, prof), host = res[True], res[False]
        route = "agg_terms_device" if name == "keyword_terms" else "agg_mask"
        _hold(snap.get("mesh_search") == len(ms)
              and snap.get(route) == len(ms),
              f"{name}: the mesh route did not serve it: {snap}")
        _hold(not any(k.startswith(("mesh_", "agg_")) for k in host[2]),
              f"{name}: the host loop ran the mesh: {host[2]}")
        _hold(json.dumps(dict(resp, took=0), sort_keys=True)
              == json.dumps(dict(host[1], took=0), sort_keys=True),
              f"{name}: the mesh's response differs from the host loop's")
        taxi_oracle_check(np, name, resp, taxis)
        if name == "cardinality":
            card_eq = taxi_cardinality_check(np, torch, node, resp, taxis)
        for label, (ms_, _r, _s, prof_) in (("mesh path", res[True]),
                                            ("host loop", host)):
            if prof_ is None:
                dev_txt = "device time not measured"
            else:
                busy, kern, hd, dh, top = prof_
                per = busy / TAXI_PROFILED
                dev_txt = (f"device {per:.3f} ms a request "
                           f"({100 * per / ms_.mean():.1f}% busy), "
                           f"{kern / TAXI_PROFILED:.1f} kernels, "
                           f"{hd / TAXI_PROFILED:.1f} copies in and "
                           f"{dh / TAXI_PROFILED:.1f} back a request; top: "
                           + "; ".join(top[:3]))
            tail = (f"p99 {np.percentile(ms_, 99):.3f} ms"
                    if len(ms_) >= TAXI_TAIL_REPS else
                    f"slowest {ms_.max():.3f} ms (too few for a p99)")
            lines.append(
                f"[aggs] {name}, {label}"
                + (f" ({route})" if label == "mesh path" else "")
                + f" on {card}: p50 {np.percentile(ms_, 50):.3f} ms, "
                  f"{tail} over {len(ms_)} requests, {dev_txt}")
    for line in lines:
        log(line)
    log(f"[aggs] every response byte-identical on both routes and held "
        f"against numpy: keys, order and counts exact, count/min/max "
        f"exact, sums and averages within 1e-5 of f64 (variance 1e-4), "
        f"percentiles equal numpy's sample; fare HLL registers in the "
        f"numpy bounds on all {TAXI_SHARDS} shards, {card_eq[0]} of "
        f"{TAXI_SHARDS * 4096} equal to the exact-rank build "
        f"({card_eq[1]} with a value in the f32 band)")
    log(f"[aggs] phase 5f took {time.perf_counter() - t0:.1f} s")
    return node, taxis


# ---------------------------------------------------------------------------
# phase 5g: field sort and the request tail on the nyc_taxis stand-in
# ---------------------------------------------------------------------------

SORT_WINDOW_S = 1.0        # timed requests per body and route: about this
SORT_MIN_REPS = 20         # many seconds, at least SORT_MIN_REPS, at most
SORT_PROFILED = 4          # TAXI_MAX_REPS; this many under the profiler
AFTER_PAGES, AFTER_SIZE = 10, 100      # http_logs' search_after operations
SCROLL_PAGES, SCROLL_SIZE = 25, 1000   # geonames' scroll operation
SCROLL_DRAINS = 3          # timed drains of the scroll and of the scan
HL_DOCS = 2000             # the highlight index, written by Node.index
HL_WORDS = ("the quick brown fox jumps over lazy dog river mountain valley "
            "ocean forest desert island city night morning light water "
            "stone bridge road market garden").split()
SCROLL_QUERY = {"range": {"trip_distance": {"gte": 2, "lt": 10}}}
#: scores 1 to 3: how many of three ranges a trip falls in
TAIL_QUERY = {"bool": {"should": [
    {"range": {"trip_distance": {"gte": 5}}},
    {"range": {"fare_amount": {"gte": 20}}},
    {"range": {"tip_amount": {"gte": 3}}}]}}
#: name -> (body, its sort keys for the oracle, runs on the mesh too)
SORT_BODIES = {
    "a_total_amount_desc": ({"sort": [{"total_amount": "desc"}],
                             "size": 10},
                            [("total_amount", "desc", "_last")], True),
    "c_vendor_then_distance": ({"sort": ["vendor_id",
                                         {"trip_distance": "desc"}],
                                "size": 10},
                               [("vendor_id", "asc", "_last"),
                                ("trip_distance", "desc", "_last")], True),
    "d_tip_missing_last": ({"sort": [{"tip_amount": {
        "order": "asc", "missing": "_last"}}], "size": 10},
        [("tip_amount", "asc", "_last")], True),
    "d_tip_missing_first": ({"sort": [{"tip_amount": {
        "order": "asc", "missing": "_first"}}], "size": 10},
        [("tip_amount", "asc", "_first")], True),
    "f_min_score": ({"query": TAIL_QUERY, "min_score": 2, "size": 10},
                    None, False),
    "f_terminate_after": ({"query": SCROLL_QUERY, "terminate_after": 1000,
                           "size": 10}, None, False),
    "f_timeout": ({"query": SCROLL_QUERY, "timeout": "10s", "size": 10},
                  None, False),
    "g_profile": ({"sort": [{"total_amount": "desc"}], "size": 10,
                   "profile": True}, [("total_amount", "desc", "_last")],
                  False),
}


def _taxi_value(t, field, i):
    """The sort value a hit reports for trip ``i`` (None when missing)."""
    if field in TAXI_KEYWORDS:
        return TAXI_KEYWORDS[field][int(t[field][i])]
    if field == "tip_amount" and not t["tip_exists"][i]:
        return None
    v = t[field][i]
    return int(v) if t[field].dtype.kind == "i" else float(v)


def taxi_sort_order(np, t, keys, n):
    """The first ``n`` trips in ES order by ``np.lexsort``: per key a
    missing rank and the value (keywords by ordinal, which is term
    order), then shard and local id, which for one segment a shard is
    the trip's index."""
    cols = []
    for field, order, missing in keys:
        v = t[field]
        if field == "tip_amount":
            rank = np.where(t["tip_exists"], 1, 0 if missing == "_first"
                            else 2)
            v = np.where(t["tip_exists"], v, 0.0)
        else:
            rank = np.ones(v.size, np.int8)
        cols += [rank, -v if order == "desc" else v]
    idx = np.arange(t["trip_distance"].size)
    return np.lexsort([idx] + cols[::-1])[:n]


def _hold_hits(t, resp, want_idx, keys, what):
    """A response's hits are the trips ``want_idx`` in order: each hit's
    local id and, sorted, its sort values."""
    hits = resp["hits"]["hits"]
    _hold([h["_id"] for h in hits]
          == [str(int(i) % TAXI_DOCS) for i in want_idx],
          f"{what}: the hits are not numpy's", "5g")
    if keys:
        _hold([h["sort"] for h in hits]
              == [[_taxi_value(t, f, int(i)) for f, _o, _m in keys]
                  for i in want_idx],
              f"{what}: the sort values are not numpy's", "5g")


def _route_line(np, name, label, ms, prof, per_call=SORT_PROFILED):
    tail = (f"p99 {np.percentile(ms, 99):.3f} ms"
            if len(ms) >= TAXI_TAIL_REPS else
            f"slowest {ms.max():.3f} ms (too few for a p99)")
    if prof is None:
        dev_txt = "device time not measured"
    else:
        busy, kern, hd, dh, top = prof
        per = busy / per_call
        dev_txt = (f"device {per:.3f} ms a request "
                   f"({100 * per / ms.mean():.1f}% busy), "
                   f"{kern / per_call:.1f} kernels, {hd / per_call:.1f} "
                   f"copies in and {dh / per_call:.1f} back a request; "
                   f"top: " + "; ".join(top[:3]))
    return (f"[sort] {name}, {label}: p50 {np.percentile(ms, 50):.3f} ms, "
            f"{tail} over {len(ms)} requests, {dev_txt}")


def phase_sort(torch, np, dev, card, node, t):
    """Phase 5g: field sort, ``search_after``, scroll and the request
    tail on phase 5f's node (4,194,304 generated trips in four shards of
    one 2^20-doc segment), with the bodies of Rally's public tracks:
    ``http_logs``' ``desc_sort_*`` / ``asc_sort_*`` and their
    ``search_after`` forms, ``geonames``' ``scroll`` (25 pages of 1000).
    Each body runs on every route it takes (the mesh path and the host
    loop; ``min_score``, ``terminate_after``, ``timeout``,
    ``search_after``, ``scroll`` and ``profile`` keep a request on the
    host loop) and is held against numpy over the generated arrays:
    ``np.lexsort`` order and sort values exact, totals exact. Per body
    and route: p50 over about SORT_WINDOW_S seconds of requests, p99
    from TAXI_TAIL_REPS on, device time, kernels and copies over
    SORT_PROFILED profiled requests, busy share."""
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import (adc, bm25_topk, knn_topk,
                                             maxsim_adc)
    from elasticsearch_tpu_torch.search.service import (clear_scroll,
                                                        scroll_next)

    hand = (bm25_topk, knn_topk, adc, maxsim_adc)
    t0 = time.perf_counter()
    svc = node.get_index("taxis")
    f32 = np.float32
    n_all = t["trip_distance"].size
    idx_all = np.arange(n_all)

    def on_mesh(flag):
        svc.settings["search"] = {"mesh": flag}

    def timed(fn, n, window_s):
        ms, out = [], None
        start = time.perf_counter()
        while len(ms) < n or (len(ms) < TAXI_MAX_REPS and
                              time.perf_counter() - start < window_s):
            a = time.perf_counter()
            out = fn()
            ms.append((time.perf_counter() - a) * 1e3)
        return np.array(ms), out

    lines = []
    for name, (body, keys, mesh_too) in SORT_BODIES.items():
        want = None
        if keys is not None:
            want = taxi_sort_order(np, t, keys, body["size"])
        answers = {}
        # True: the mesh path; False: the host loop, pinned; None: the
        # host loop because the mesh declines the body's keys
        for mesh in ((True, False) if mesh_too else (None,)):
            on_mesh(mesh is not False)

            def one():
                return node.search("taxis", copy.deepcopy(body))

            for m in hand:
                m.LAUNCHES = 0
            one()  # first use: the sort mirrors, stacked copies
            # the sort path and the request tail launch no hand kernel
            _hold(not any(m.LAUNCHES for m in hand),
                  f"{name}: a hand kernel ran", "5g")
            counters.reset()
            ms, resp = timed(one, SORT_MIN_REPS, SORT_WINDOW_S)
            snap = counters.snapshot()
            if mesh is False:
                _hold(not any(k.startswith("mesh_") for k in snap),
                      f"{name}: the pinned host loop ran the mesh", "5g")
            else:
                route = "mesh_search" if mesh else "mesh_fallback_total"
                _hold(snap.get(route) == len(ms),
                      f"{name}: not served by {route}: {snap}", "5g")
            prof = profile_path(torch, lambda: [one() for _ in
                                                range(SORT_PROFILED)])
            label = {True: "mesh path", False: "host loop",
                     None: "host loop (the mesh declines it)"}[mesh]
            answers[mesh] = resp
            what = f"{name} ({label})"
            if want is not None:
                _hold(resp["hits"]["total"] == n_all,
                      f"{what}: total {resp['hits']['total']}", "5g")
                _hold_hits(t, resp, want, keys, what)
            lines.append(_route_line(np, name, label, ms, prof))
            if name == "g_profile":
                shards = resp["profile"]["shards"]
                _hold(len(shards) == TAXI_SHARDS and all(
                    s["tpu"]["segments"] == 1 and s["tpu"]["phases"][
                        "device_execute_nanos"] > 0 for s in shards),
                    f"{what}: profile {shards[:1]}", "5g")
                ph = shards[0]["tpu"]["phases"]
                lines.append(
                    "[sort] g_profile, shard 0's phases (ms): " + ", ".join(
                        f"{k[:-6]} {v / 1e6:.3f}" for k, v in ph.items()
                        if v))
        if mesh_too:
            _hold(json.dumps(dict(answers[True], took=0), sort_keys=True)
                  == json.dumps(dict(answers[False], took=0),
                                sort_keys=True),
                  f"{name}: the mesh's response differs from the host "
                  f"loop's", "5g")
        if name.startswith("f_"):
            td, fare, tip = (t["trip_distance"].astype(f32),
                             t["fare_amount"].astype(f32),
                             t["tip_amount"].astype(f32))
            if name == "f_min_score":
                score = ((td >= f32(5)).astype(np.int64)
                         + (fare >= f32(20)) + ((tip >= f32(3))
                                                & t["tip_exists"]))
                ok = score >= 2
                total = int(ok.sum())
                top = idx_all[ok][np.lexsort((idx_all[ok], -score[ok]))][
                    :10]
                _hold([h["_score"] for h in resp["hits"]["hits"]]
                      == [float(score[i]) for i in top],
                      f"{name}: scores", "5g")
            else:
                ok = (td >= f32(2)) & (td < f32(10))
                total = int(ok.sum())
                top = idx_all[ok][:10]
                if name == "f_terminate_after":
                    total = TAXI_SHARDS * 1000
                    _hold(resp.get("terminated_early") is True,
                          f"{name}: not terminated early", "5g")
                else:
                    _hold(resp["timed_out"] is False, f"{name}: timed out",
                          "5g")
            _hold(resp["hits"]["total"] == total,
                  f"{name}: total {resp['hits']['total']} vs {total}", "5g")
            _hold_hits(t, resp, top, None, name)
    on_mesh(True)

    # (b) search_after: AFTER_PAGES pages of AFTER_SIZE by pickup time
    pick = t["pickup_datetime"]
    order = np.argsort(pick, kind="stable")
    walk_body = {"sort": [{"pickup_datetime": "asc"}], "size": AFTER_SIZE}
    for mesh in (True, False):
        on_mesh(mesh)
        ms, got = [], []
        counters.reset()
        for _ in range(SORT_MIN_REPS // 2):
            after, ids = None, []
            for _ in range(AFTER_PAGES):
                b = dict(walk_body, search_after=after) if after else \
                    walk_body
                a = time.perf_counter()
                page = node.search("taxis", copy.deepcopy(b))
                ms.append((time.perf_counter() - a) * 1e3)
                ids += [h["_id"] for h in page["hits"]["hits"]]
                after = page["hits"]["hits"][-1]["sort"]
            got = ids
        snap = counters.snapshot()
        # ES's rule, in numpy: a page starts strictly after the cursor
        want, pos = [], 0
        for _ in range(AFTER_PAGES):
            pg = order[pos: pos + AFTER_SIZE]
            want += [str(int(i) % TAXI_DOCS) for i in pg]
            pos = int(np.searchsorted(pick[order], pick[pg[-1]],
                                      side="right"))
        _hold(got == want, "b: the search_after walk is not numpy's", "5g")
        reps = SORT_MIN_REPS // 2
        _hold((snap.get("mesh_search", 0), snap.get("mesh_fallback_total",
                                                    0))
              == ((reps, (AFTER_PAGES - 1) * reps) if mesh else (0, 0)),
              f"b: routes {snap}", "5g")

        def walk():
            after = None
            for _ in range(AFTER_PAGES):
                b = dict(walk_body, search_after=after) if after else \
                    walk_body
                after = node.search("taxis", copy.deepcopy(b))[
                    "hits"]["hits"][-1]["sort"]

        prof = profile_path(torch, walk)
        lines.append(_route_line(
            np, f"b_search_after ({AFTER_PAGES} pages of {AFTER_SIZE})",
            f"page 1 on the mesh path, pages 2-{AFTER_PAGES} on the host "
            f"loop"
            if mesh else "host loop", np.array(ms), prof,
            per_call=AFTER_PAGES))
    on_mesh(True)

    # (e) a score-ordered scroll and a scan: SCROLL_PAGES of SCROLL_SIZE
    td = t["trip_distance"].astype(f32)
    match = idx_all[(td >= f32(2)) & (td < f32(10))]
    for kind in ("scroll", "scan"):
        body = {"query": SCROLL_QUERY, "scroll": "1m", "size": SCROLL_SIZE}
        if kind == "scan":
            body["search_type"] = "scan"
        opens, pages = [], []

        def drain(timing):
            a = time.perf_counter()
            first = node.search("taxis", copy.deepcopy(body))
            if timing:
                opens.append((time.perf_counter() - a) * 1e3)
            got = [h["_id"] for h in first["hits"]["hits"]]
            while len(got) < SCROLL_PAGES * SCROLL_SIZE:
                a = time.perf_counter()
                page = scroll_next(first["_scroll_id"])
                if timing:
                    pages.append((time.perf_counter() - a) * 1e3)
                got += [h["_id"] for h in page["hits"]["hits"]]
            clear_scroll(first["_scroll_id"])
            return first, got

        for _ in range(SCROLL_DRAINS):
            first, got = drain(True)
        _hold(first["hits"]["total"] == match.size
              and got == [str(int(i) % TAXI_DOCS)
                          for i in match[: SCROLL_PAGES * SCROLL_SIZE]],
              f"e: the {kind}'s pages are not numpy's", "5g")
        _hold(kind != "scan" or not first["hits"]["hits"],
              "e: a scan's first page has hits", "5g")
        prof = profile_path(torch, lambda: drain(False))
        busy = (f"device {prof[0]:.3f} ms a drain, {prof[1]} kernels, "
                f"{prof[2]} copies in and {prof[3]} back; top: "
                + "; ".join(prof[4][:3])) if prof else \
            "device time not measured"
        op, pg = np.array(opens), np.array(pages)
        lines.append(
            f"[sort] e_{kind} ({SCROLL_PAGES} pages of {SCROLL_SIZE}, "
            f"{match.size} matches), host loop: open p50 "
            f"{np.percentile(op, 50):.3f} ms (slowest {op.max():.3f}), next "
            f"page p50 {np.percentile(pg, 50):.3f} ms, p99 "
            f"{np.percentile(pg, 99):.3f} ms over {pg.size} pages, a drain "
            f"{(op.sum() + pg.sum()) / SCROLL_DRAINS:.3f} ms; {busy}")

    # (h) highlight on a small text index written through Node.index
    rng = np.random.default_rng(SEED)
    ts = time.perf_counter()
    node.create_index("hl", {"settings": {"number_of_shards": 2},
                             "mappings": {"properties": {
                                 "body": {"type": "text",
                                          "analyzer": "standard"}}}})
    texts = {}
    for i in range(HL_DOCS):
        words = rng.choice(HL_WORDS, size=int(rng.integers(20, 41)))
        texts[str(i)] = " ".join(words).capitalize() + "."
        node.index("hl", str(i), {"body": texts[str(i)]})
    node.refresh("hl")
    hl_setup = time.perf_counter() - ts
    hsvc = node.get_index("hl")
    hl_body = {"query": {"match": {"body": "fox river"}}, "size": 10,
               "highlight": {"fields": {"body": {"fragment_size": 60}}}}
    res, b1 = {}, 0
    for mesh in (True, False):
        hsvc.settings["search"] = {"mesh": mesh}

        def one():
            return node.search("hl", copy.deepcopy(hl_body))

        bm25_topk.LAUNCHES = 0
        one()  # a pure-dense match: B1 on each shard's segment
        _hold(bm25_topk.LAUNCHES == 2, f"h: B1 launched "
              f"{bm25_topk.LAUNCHES} times, not once a shard", "5g")
        b1 += bm25_topk.LAUNCHES
        ms, resp = timed(one, SORT_MIN_REPS, SORT_WINDOW_S)
        prof = profile_path(torch, lambda: [one() for _ in
                                            range(SORT_PROFILED)])
        res[mesh] = resp
        lines.append(_route_line(np, f"h_highlight ({HL_DOCS} docs)",
                                 "mesh path" if mesh else "host loop", ms,
                                 prof))
    _hold(json.dumps(dict(res[True], took=0), sort_keys=True)
          == json.dumps(dict(res[False], took=0), sort_keys=True),
          "h: the mesh's response differs from the host loop's", "5g")
    n_match = sum(1 for s in texts.values()
                  if re.search(r"\b(fox|river)\b", s.lower()))
    _hold(res[True]["hits"]["total"] == n_match, "h: total", "5g")
    for h in res[True]["hits"]["hits"]:
        for frag in h["highlight"]["body"]:
            plain = frag.replace("<em>", "").replace("</em>", "")
            tagged = re.findall(r"<em>(.*?)</em>", frag)
            _hold(plain in texts[h["_id"]] and tagged and all(
                w.lower() in ("fox", "river") for w in tagged)
                and not re.search(r"\b(fox|river)\b", re.sub(
                    r"<em>.*?</em>", "", frag).lower()),
                f"h: fragment {frag!r}", "5g")
    for line in lines:
        log(line)
    log(f"[sort] every body held against numpy on every route it takes "
        f"(order, sort values and totals exact), the mesh's responses "
        f"equal to the host loop's; the highlight index ({HL_DOCS} docs of "
        f"20-40 words, two shards) took {hl_setup:.1f} s to write")
    log(f"[sort] phase 5g took {time.perf_counter() - t0:.1f} s; B1 "
        f"launches in (h)'s two counted requests: {b1}")
    return b1


# ---------------------------------------------------------------------------
# phase 5h: the write path and merges on the card
# ---------------------------------------------------------------------------

WP_DOCS = 1 << 16          # logs-a's documents (cut from 2^18, PERF.md §4)
WP_REFRESHES = 32          # refreshes over logs-a: ~32 fresh segments a shard
WP_SHARDS = 5              # ES 2.0's default index.number_of_shards
WP_B_SHARE = 10            # logs-b holds a further 1/WP_B_SHARE of the docs
WP_PREFIX = 1 << 14        # the CPU comparison's prefix of logs-a
WP_RECLAIM = 0.3           # the share of one shard's docs deleted
WP_REPS = 40               # timed requests per body
WP_MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "ts": {"type": "date"},
}}
#: phase 4's five body shapes on 5h's vocabulary, and a deep page
WP_BODIES = {
    "match": {"query": {"match": {"body": "t0 t1 t5"}}},
    "match_tail": {"query": {"match": {"body": "t2000 t7000 t15000"}}},
    "term": {"query": {"term": {"tag": "g3"}}, "size": 5},
    "bool_range": {"query": {"bool": {
        "must": [{"match": {"body": "t10 t40"}}],
        "filter": [{"range": {"n": {"gte": 100_000, "lt": 600_000}}}]}}},
    "paged": {"query": {"match": {"body": "t3 t9 t27"}},
              "from": 10, "size": 10},
    "deep": {"query": {"match": {"body": "t1 t300"}}, "from": 5000,
             "size": 20},
}
#: dfs bodies: a head term with rarer ones (the f32 generic route)
WP_DFS = [{"query": {"match": {"body": q}}, "size": 10}
          for q in ("t2 t150 t900", "t0 t70 t3000", "t12 t500",
                    "t6 t45 t260 t8000")]


def wp_docs(np, n, seed, start=0):
    """[(id, source)]: a ``body`` of 20-80 tokens drawn Zipf(1.1) from
    phase 5's 30,000-term vocabulary (MS-MARCO-passage lengths), a
    ``tag`` of 9 values, a long ``n`` and a date ``ts``."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.1
    p /= p.sum()
    lens = rng.integers(20, 81, n)
    toks = rng.choice(VOCAB, size=int(lens.sum()), p=p)
    words = np.array([f"t{i}" for i in range(VOCAB)])
    cuts = np.concatenate([[0], np.cumsum(lens)])
    tags = rng.integers(0, 9, n)
    nums = rng.integers(0, 1_000_000, n)
    ts = TAXI_YEAR + rng.integers(0, 30 * DAY_MS, n)
    return [(f"d{start + i}", {
        "body": " ".join(words[toks[cuts[i]: cuts[i + 1]]].tolist()),
        "tag": f"g{int(tags[i])}", "n": int(nums[i]), "ts": int(ts[i])})
        for i in range(n)]


def _strip_took(resp) -> str:
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


@contextlib.contextmanager
def _host_loop():
    """The host loop for every index while the block runs."""
    os.environ["ESTPU_DISABLE_MESH"] = "1"
    try:
        yield
    finally:
        del os.environ["ESTPU_DISABLE_MESH"]


def _wp_time(np, torch, node, index, bodies, reps=WP_REPS):
    """ms of each search of ``bodies`` on ``index``, in turn, until
    ``reps`` requests ran (synchronized), after one warm-up pass."""
    for b in bodies:
        node.search(index, copy.deepcopy(b))
    torch.cuda.synchronize()
    ms = []
    for r in range(reps):
        b = copy.deepcopy(bodies[r % len(bodies)])
        t = time.perf_counter()
        node.search(index, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return np.array(ms)


def _pcts(np, ms) -> str:
    return (f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms over {len(ms)}")


def _dev_line(np, prof, n, ms) -> str:
    """Device time, kernels and copies a request over ``n`` profiled
    requests, and the busy share against the mean of ``ms``."""
    if prof is None:
        return "device time not measured"
    busy, kern, hd, dh, top = prof
    return (f"device {busy / n:.3f} ms a request "
            f"({100 * busy / n / ms.mean():.1f}% busy), {kern / n:.1f} "
            f"kernels, {hd / n:.1f} copies in and {dh / n:.1f} back; top: "
            + "; ".join(top[:3]))


def _profile_bodies(torch, node, index, bodies):
    return profile_path(torch, lambda: [node.search(index, copy.deepcopy(b))
                                        for b in bodies])


def _hold_no_retired(node, retired, what):
    """The executors hold no retired segment; the ``segments`` breaker
    holds exactly the live segments' charges, ``fielddata`` the live
    segments' and the executors' caches'. Returns the two byte counts."""
    segs = [seg for svc in node.indices.values() for s in svc.shards
            for seg in s.segments]
    execs = [svc._mesh_executor for svc in node.indices.values()
             if svc._mesh_executor is not None]
    held = set().union(*[ex.cached_segments() for ex in execs])
    _hold(not (held & retired), f"{what}: an executor holds a retired "
          f"segment", "5h")
    seg_used = node.breakers.breaker("segments").used
    fd_used = node.breakers.breaker("fielddata").used
    want_fd = sum(s.fielddata_bytes() for s in segs) + sum(
        ex.data_bytes() + sum(rd.nbytes for rd in ex._prep.values())
        for ex in execs)
    _hold(seg_used == sum(s.memory_bytes() for s in segs),
          f"{what}: segments breaker {seg_used} != the live segments' "
          f"{sum(s.memory_bytes() for s in segs)}", "5h")
    _hold(fd_used == want_fd, f"{what}: fielddata breaker {fd_used} != "
          f"{want_fd}", "5h")
    return seg_used, fd_used


def _f64_dfs(np, searchers, body, k):
    """The want-response of a dfs ``match`` (or-group) over ``searchers``
    in f64: idf from the df and doc counts summed over every searched
    segment, BM25 tf-normalisation from each segment's own lengths and
    average length, the host loop's order (-score, shard, local)."""
    from elasticsearch_tpu_torch.index.segment import B, K1

    terms = list(dict.fromkeys(body["query"]["match"]["body"].split()))
    segs = [(pos, seg) for pos, s in enumerate(searchers)
            for seg in s.segments]
    n_all = sum(seg.inverted["body"].num_docs for _, seg in segs
                if "body" in seg.inverted)
    df = {t: sum(int(seg.inverted["body"].df[seg.inverted["body"].vocab[t]])
                 for _, seg in segs if t in seg.inverted["body"].vocab)
          for t in terms}
    cands, total = [], 0
    for pos, seg in segs:
        inv = seg.inverted["body"]
        dl = seg.field_lengths["body"].cpu().numpy().astype(np.float64)
        score = np.zeros(seg.max_docs, np.float64)
        hit = np.zeros(seg.max_docs, bool)
        for t in terms:
            if t not in inv.vocab:
                continue
            tid = inv.vocab[t]
            lo, hi = int(inv.offsets[tid]), int(inv.offsets[tid + 1])
            docs = inv.doc_ids_host[lo:hi].astype(np.int64)
            tf = inv.tf_host[lo:hi].astype(np.float64)
            tfn = tf * (K1 + 1.0) / (tf + K1 * (1.0 - B + B * dl[docs]
                                                 / inv.avg_len))
            idf = np.log(1.0 + (n_all - df[t] + 0.5) / (df[t] + 0.5))
            score[docs] += idf * tfn
            hit[docs] = True
        hit &= seg.live_host
        total += int(hit.sum())
        for i in np.nonzero(hit)[0].tolist():
            cands.append((-score[i], pos, i, seg.ids[i], score[i]))
    cands.sort(key=lambda c: c[:3])
    return {"hits": {"total": total, "hits": [
        {"_id": c[3], "_score": c[4]} for c in cands[:k]]}}


def phase_writepath(torch, np, dev, card):
    """Phase 5h: the write path and merges on the card. WP_DOCS generated
    documents (``wp_docs``) go through ``Node.index`` into ``logs-a``
    (five shards) with a refresh every WP_DOCS / WP_REFRESHES docs, so
    each shard gets ~32 fresh segments that the tiered policy (8 a tier)
    folds into ~4; ``logs-b`` takes a further 1/WP_B_SHARE. Checks, each
    held on the card: the mesh's deep page past the round's padded
    width (C1); B1 on merged segments; after ``force_merge(1)`` and after
    a delete-reclaim merge, responses byte-identical to one-refresh
    rebuilds of the live docs in each merged segment's order (C2); no
    retired segment in the executors and the breakers at the live
    segments' bytes after each merge; dfs on one index alike on both
    routes and, over two indices, against an f64 scorer; multi-index
    search, ``indices_boost`` and ``fields`` against a CPU Node on a
    WP_PREFIX-doc prefix; the request cache's hit, byte-equality and
    invalidation. Prints the ingest rate, refresh and merge times, the
    breaker bytes and the read p50/p99s. Returns B1's launches."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk

    t_phase = time.perf_counter()
    docs = wp_docs(np, WP_DOCS, SEED)
    docs_b = wp_docs(np, WP_DOCS // WP_B_SHARE, SEED + 1, start=WP_DOCS)
    log(f"[5h] {len(docs)} + {len(docs_b)} docs generated in "
        f"{time.perf_counter() - t_phase:.1f} s")
    bm25_topk.LAUNCHES = 0
    node = Node(name="writes", device=dev)
    for name in ("logs-a", "logs-b"):
        node.create_index(name, {"settings": {"number_of_shards": WP_SHARDS},
                                 "mappings": WP_MAPPING})
    svc = node.indices["logs-a"]
    every = WP_DOCS // WP_REFRESHES
    refresh_ms, merges = [], []
    c1 = None
    t0 = time.perf_counter()
    for j, (doc_id, src) in enumerate(docs):
        node.index("logs-a", doc_id, src)
        if (j + 1) % every:
            continue
        before = [(s.engine.stats.merge_total, s.engine.stats.merge_docs,
                   s.engine.stats.merge_time_ms) for s in svc.shards]
        t = time.perf_counter()
        node.refresh("logs-a")
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t) * 1e3)
        for s, (m, d, ms) in zip(svc.shards, before):
            st = s.engine.stats
            if st.merge_total > m:
                merges.append((st.merge_time_ms - ms, st.merge_docs - d))
        if (j + 1) // every == 7:
            # C1: seven fresh segments a shard; a page past the rounds'
            # padded width needs more candidates than one slot's width
            t_c1 = time.perf_counter()
            width = max(seg.max_docs for s in svc.shards
                        for seg in s.segments)
            deep = {"query": {"match_all": {}},
                    "from": min(9990, j + 1 - 10), "size": 10}
            _hold(deep["from"] > width, "C1: the page is not past the "
                  "round's width", "5h")
            counters.reset()
            mesh = node.search("logs-a", copy.deepcopy(deep))
            _hold(counters.snapshot().get("mesh_search") == 1,
                  "C1: the deep page did not run on the mesh", "5h")
            with _host_loop():
                host = node.search("logs-a", copy.deepcopy(deep))
            _hold(len(mesh["hits"]["hits"]) == 10 and _strip_took(mesh)
                  == _strip_took(host), "C1: the mesh's deep page is not "
                  "the host loop's full page", "5h")
            c1 = (deep["from"], width, mesh["hits"]["total"],
                  (time.perf_counter() - t_c1) * 1e3)
            t0 += time.perf_counter() - t_c1  # not part of the ingest
    ingest_s = time.perf_counter() - t0
    t = time.perf_counter()
    for doc_id, src in docs_b:
        node.index("logs-b", doc_id, src)
    node.refresh("logs-b")
    b_s = time.perf_counter() - t
    layout = [len(s.segments) for s in svc.shards]
    log(f"[5h] C1 on {card}: match_all from {c1[0]} on the mesh, round "
        f"width {c1[1]}, {c1[2]} docs: the full page, byte-identical to "
        f"the host loop ({c1[3]:.1f} ms for both)")
    rm = np.array(refresh_ms)
    log(f"[5h] ingest on {card}: {WP_DOCS} docs through Node.index into "
        f"logs-a ({WP_SHARDS} shards) in {ingest_s:.1f} s with "
        f"{len(rm)} refreshes and {len(merges)} tier merges counted in: "
        f"{WP_DOCS / ingest_s:.0f} docs/s; refresh p50 "
        f"{np.percentile(rm, 50):.1f} ms, p99 {np.percentile(rm, 99):.1f} "
        f"ms; segments a shard {layout}; logs-b {len(docs_b)} docs in "
        f"{b_s:.1f} s")
    log(f"[5h] tier merges on {card} (ms, docs): " + ", ".join(
        f"({ms:.1f}, {d})" for ms, d in merges))

    # B1 on merged segments, reads with ~4 segments a shard
    match = [{"query": {"match": {"body": f"t{a} t{b}"}}}
             for a, b in ((0, 3), (1, 6), (2, 9), (4, 12), (5, 20),
                          (7, 33), (8, 60), (11, 99))]
    tier_merged = {id(seg) for s in svc.shards for seg in s.segments
                   if seg.num_docs > every}
    _hold(bool(tier_merged), "no tier-merged segment to search", "5h")
    counters.reset()
    b1 = bm25_topk.LAUNCHES
    node.search("logs-a", copy.deepcopy(WP_BODIES["match"]))
    snap = counters.snapshot()
    _hold(snap.get("mesh_search") == 1 and snap.get("bm25_fused_topk", 0)
          >= len(layout) and bm25_topk.LAUNCHES > b1,
          f"B1 did not serve the merged segments on the mesh: {snap}", "5h")

    ms4 = _wp_time(np, torch, node, "logs-a", match)
    prof4 = _profile_bodies(torch, node, "logs-a", match)
    dfs = [dict(b, search_type="dfs_query_then_fetch") for b in WP_DFS]
    for b, plain in zip(dfs, WP_DFS):
        got = node.search("logs-a", copy.deepcopy(b))
        with _host_loop():
            host = node.search("logs-a", copy.deepcopy(b))
        check_hits(got, host, f"5h dfs mesh vs host loop {b}")
        check_hits(got, _f64_dfs(np, [s.searcher for s in svc.shards], b,
                                 10), f"5h dfs vs f64 {b}")
        two = node.search("logs-a,logs-b", copy.deepcopy(b))
        check_hits(two, _f64_dfs(np, [s.searcher for n in ("logs-a",
                                                            "logs-b")
                                      for s in node.indices[n].shards], b,
                                 10), f"5h dfs over two indices vs f64 {b}")
        _hold(node.search("logs-a", copy.deepcopy(plain))["hits"]["hits"]
              != got["hits"]["hits"], "dfs changed no score", "5h")

    dfs_ms = _wp_time(np, torch, node, "logs-a", dfs)
    qtf_ms = _wp_time(np, torch, node, "logs-a", WP_DFS)
    prof_dfs = _profile_bodies(torch, node, "logs-a", dfs)
    multi = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10}
             for a, b in ((2, 150), (0, 44), (9, 700), (3, 31))]
    multi_ms = _wp_time(np, torch, node, "logs-*", multi)
    prof_multi = _profile_bodies(torch, node, "logs-*", multi)
    log(f"[5h] reads on {card}, {layout} segments a shard: match on the "
        f"mesh {_pcts(np, ms4)} requests, "
        f"{_dev_line(np, prof4, len(match), ms4)}")
    log(f"[5h] dfs on {card}: p50 {np.percentile(dfs_ms, 50):.3f} ms "
        f"against query_then_fetch p50 {np.percentile(qtf_ms, 50):.3f} ms "
        f"on the mesh ({len(dfs)} bodies; the same hits on the mesh and "
        f"the host loop, within 1e-5 of the f64 scorer on logs-a and on "
        f"logs-a,logs-b), {_dev_line(np, prof_dfs, len(dfs), dfs_ms)}")
    log(f"[5h] multi-index on {card}: logs-* (two indices, ten shards, the "
        f"host loop) {_pcts(np, multi_ms)} requests, "
        f"{_dev_line(np, prof_multi, len(multi), multi_ms)}")

    # force merge to one segment a shard
    retired = {id(seg) for s in svc.shards for seg in s.segments}
    seg0, fd0 = (node.breakers.breaker(b).used
                 for b in ("segments", "fielddata"))
    t = time.perf_counter()
    svc.force_merge(1)
    torch.cuda.synchronize()
    fm_ms = (time.perf_counter() - t) * 1e3
    seg1, fd1 = _hold_no_retired(node, retired, "force merge")
    _hold([len(s.segments) for s in svc.shards] == [1] * WP_SHARDS,
          "force merge left more than one segment a shard", "5h")
    counters.reset()
    b1 = bm25_topk.LAUNCHES
    node.search("logs-a", copy.deepcopy(WP_BODIES["match"]))
    snap = counters.snapshot()
    _hold(snap.get("mesh_search") == 1 and snap.get("bm25_fused_topk") ==
          WP_SHARDS and bm25_topk.LAUNCHES == b1 + WP_SHARDS,
          f"B1 did not serve the force-merged segments: {snap}", "5h")
    ms1 = _wp_time(np, torch, node, "logs-a", match)
    prof1 = _profile_bodies(torch, node, "logs-a", match)
    log(f"[5h] force merge on {card}: {svc.num_docs} docs into one segment "
        f"a shard in {fm_ms:.1f} ms; breakers segments {seg0} -> {seg1} "
        f"bytes, fielddata {fd0} -> {fd1} bytes (each equal to the live "
        f"segments' and caches' charges; no retired segment cached)")
    log(f"[5h] reads on {card}, one segment a shard: match on the mesh "
        f"{_pcts(np, ms1)} requests, {_dev_line(np, prof1, len(match), ms1)}")

    # C2: responses byte-identical to one-refresh rebuilds
    def rebuild(label):
        fresh = Node(name=label, device=dev)
        fresh.create_index("logs-a", {"settings": {
            "number_of_shards": WP_SHARDS}, "mappings": WP_MAPPING})
        for s in svc.shards:
            for seg in s.segments:
                live = seg.live_host
                for local, doc_id in enumerate(seg.ids):
                    if live[local]:
                        fresh.index("logs-a", doc_id, seg.sources[local])
        fresh.refresh("logs-a")
        want = [len(s.segments) for s in svc.shards]
        _hold([len(s.segments) for s in fresh.indices["logs-a"].shards]
              == want, f"{label}: the rebuild's layout differs", "5h")
        return fresh

    def hold_bytes(fresh, what):
        for name, body in WP_BODIES.items():
            for route in ("mesh", "host"):
                with (_host_loop() if route == "host"
                      else contextlib.nullcontext()):
                    got = node.search("logs-a", copy.deepcopy(body))
                    want = fresh.search("logs-a", copy.deepcopy(body))
                _hold(_strip_took(got) == _strip_took(want) and
                      got["hits"]["hits"], f"{what} {name} {route}: not "
                      "byte-identical to the rebuild", "5h")

    t = time.perf_counter()
    fresh = rebuild("rebuild")
    hold_bytes(fresh, "C2 force merge")
    fresh.close()
    rb1 = time.perf_counter() - t
    shard0 = svc.shards[0]
    (seg,) = shard0.segments
    victims = [d for i, d in enumerate(seg.ids) if i % 10 < 10 * WP_RECLAIM]
    retired = {id(seg)}
    m0 = shard0.engine.stats.merge_total
    t = time.perf_counter()
    for doc_id in victims:
        node.delete("logs-a", doc_id)
    node.refresh("logs-a")
    torch.cuda.synchronize()
    reclaim_ms = (time.perf_counter() - t) * 1e3
    st = shard0.engine.stats
    _hold(st.merge_total == m0 + 1 and shard0.segments[0].deleted_count == 0,
          "the delete-reclaim merge did not fire", "5h")
    _hold_no_retired(node, retired, "reclaim merge")
    t = time.perf_counter()
    fresh = rebuild("rebuild2")
    hold_bytes(fresh, "C2 reclaim")
    fresh.close()
    rb2 = time.perf_counter() - t
    log(f"[5h] C2 on {card}: after force_merge(1) and after deleting "
        f"{len(victims)} of shard 0's {seg.num_docs} docs (a reclaim merge "
        f"of {shard0.segments[0].num_docs} docs; deletes, refresh and "
        f"merge {reclaim_ms:.1f} ms), {len(WP_BODIES)} bodies on both "
        f"routes byte-identical to one-refresh rebuilds of the live docs "
        f"in merged order (rebuilds and checks {rb1:.1f} s and {rb2:.1f} "
        f"s); no retired segment cached")

    # multi-index, indices_boost and fields against a CPU Node
    t = time.perf_counter()
    pair = [Node(name="mi-card", device=dev), Node(name="mi-cpu",
                                                   device="cpu")]
    pre = docs[:WP_PREFIX]
    pre_b = docs_b[: WP_PREFIX // WP_B_SHARE]
    for n in pair:
        for name, part in (("logs-a", pre), ("logs-b", pre_b)):
            n.create_index(name, {"settings": {
                "number_of_shards": WP_SHARDS}, "mappings": WP_MAPPING})
            step = max(1, len(part) // WP_REFRESHES)
            for j, (doc_id, src) in enumerate(part):
                n.index(name, doc_id, src)
                if (j + 1) % step == 0:
                    n.refresh(name)
            n.refresh(name)
    for expr, body in (
            ("logs-*", {"query": {"match": {"body": "t2 t150"}},
                        "size": 20}),
            ("logs-a,logs-b", {"query": {"match": {"body": "t0 t77"}},
                               "indices_boost": {"logs-b": 2.5},
                               "fields": ["tag", "n"], "size": 20}),
            ("_all", dict(WP_DFS[0], search_type="dfs_query_then_fetch",
                          stored_fields=["ts"])),
            ("l*-b", {"query": {"term": {"tag": "g4"}}, "fields": "n"})):
        got, want = (n.search(expr, copy.deepcopy(body)) for n in pair)
        check_hits(got, want, f"5h {expr} card vs CPU")
        _hold([(h["_index"], h.get("fields")) for h in got["hits"]["hits"]]
              == [(h["_index"], h.get("fields"))
                  for h in want["hits"]["hits"]],
              f"5h {expr}: indices or fields differ from the CPU", "5h")
    for n in pair:
        n.close()
    log(f"[5h] multi-index on {card}: logs-*, a comma list with "
        f"indices_boost and fields, _all with dfs and stored_fields, and a "
        f"wildcard equal a CPU Node fed the same writes (a {WP_PREFIX}-doc "
        f"prefix of logs-a and {len(pre_b)} docs of logs-b; "
        f"{time.perf_counter() - t:.1f} s)")

    # the request cache
    agg = {"size": 0, "_query_cache": True,
           "query": {"match": {"body": "t4 t8"}},
           "aggs": {"tags": {"terms": {"field": "tag"}},
                    "n": {"avg": {"field": "n"}}}}
    first = node.search("logs-a", copy.deepcopy(agg))
    second = node.search("logs-a", copy.deepcopy(agg))
    _hold(svc.query_cache_stats == {"hits": 1, "misses": 1, "evictions": 0}
          and json.dumps(first) == json.dumps(second),
          f"request cache: {svc.query_cache_stats}", "5h")
    hit_ms = _wp_time(np, torch, node, "logs-a", [agg])
    node.index("logs-a", "new", {"body": "t4 t8", "tag": "g1", "n": 5,
                                 "ts": TAXI_YEAR})
    node.refresh("logs-a")
    misses = svc.query_cache_stats["misses"]
    third = node.search("logs-a", copy.deepcopy(agg))
    _hold(svc.query_cache_stats["misses"] == misses + 1 and
          third["hits"]["total"] == first["hits"]["total"] + 1,
          "request cache: a write and a refresh did not miss", "5h")
    miss_ms = _wp_time(np, torch, node, "logs-a",
                       [dict(agg, _query_cache=False)], reps=WP_REPS // 4)
    log(f"[5h] request cache on {card}: a size-0 terms+avg body, the second "
        f"call a hit byte-equal to the first, a write and refresh a miss; "
        f"hit {_pcts(np, hit_ms)}, uncached p50 "
        f"{np.percentile(miss_ms, 50):.3f} ms")
    node.close()
    b1 = bm25_topk.LAUNCHES
    log(f"[5h] B1 launched {b1} times in 5h; phase 5h took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return b1


# ---------------------------------------------------------------------------
# phase 5i: the full-text DSL on a positional CSR
# ---------------------------------------------------------------------------

FT_DOCS = N_DOCS           # phase 5's corpus, with each token's position
FT_TITLE = 10              # the title field: each doc's first 10 tokens
FT_VARIANTS = 8            # bodies of each group, run in turn
FT_WINDOW_S = 1.0          # timed requests per group and route: about this
FT_MIN_REPS = 10           # many seconds, at least FT_MIN_REPS, at most
FT_MAX_REPS = 400          # FT_MAX_REPS; p99 from TAXI_TAIL_REPS on
FT_PROFILED = 4            # requests per group and route under the profiler
FT_PREFIX = 1 << 14        # the CPU comparison's prefix of the corpus
FT_MAPPING = {"properties": {"body": {"type": "text"},
                             "title": {"type": "text"}}}


def csr_field(np, terms, docs, pos, n_docs, vocab, lengths):
    """``segment_from_arrays``'s entry for a text field of the token
    stream (term, doc, position), in doc then position order: one stable
    sort by term (a radix sort of 16-bit ids; the stream's doc and
    position order stays within a term) gives the postings
    (build_corpus's, term-major, doc-ascending) and, in the same order,
    the positional CSR."""
    k1, b = 1.2, 0.75
    order = np.argsort(terms.astype(np.int16), kind="stable")
    key = terms[order] * n_docs + docs[order]
    positions = pos[order].astype(np.int32)
    brk = np.ones(key.size, bool)
    brk[1:] = key[1:] != key[:-1]
    first = np.nonzero(brk)[0]
    del brk, order
    tf = np.diff(np.append(first, key.size))
    u_term = (key[first] // n_docs).astype(np.int32)
    u_doc = (key[first] % n_docs).astype(np.int32)
    del key
    df = np.bincount(u_term, minlength=vocab).astype(np.int32)
    offsets = np.zeros(vocab + 1, np.int64)
    offsets[1:] = np.cumsum(df)
    avg = float(lengths[lengths > 0].mean())
    tfn = (tf * (k1 + 1) / (tf + k1 * (1 - b + b * lengths[u_doc] / avg))
           ).astype(np.float32)
    return {"terms": [f"t{t}" for t in range(vocab)], "df": df,
            "cf": np.bincount(u_term, weights=tf,
                              minlength=vocab).astype(np.int64),
            "offsets": offsets, "doc_ids_host": u_doc, "tfnorm_host": tfn,
            "tf_host": tf.astype(np.float32), "avg_len": avg,
            "num_docs": int((lengths > 0).sum()),
            "total_terms": int(lengths.sum()),
            "lengths": lengths.astype(np.float32),
            "positions": positions,
            "pos_offsets": np.append(first, pos.size).astype(np.int64)}


def fulltext_arrays(np, doc_len, terms, n_docs):
    """``segment_from_arrays``'s arrays of the first ``n_docs`` docs: the
    body and its first FT_TITLE tokens as the title."""
    n_tok = int(doc_len[:n_docs].sum())
    dl = doc_len[:n_docs]
    docs = np.repeat(np.arange(n_docs, dtype=np.int64), dl)
    pos = np.arange(n_tok, dtype=np.int64) - np.repeat(np.cumsum(dl) - dl,
                                                       dl)
    body = csr_field(np, terms[:n_tok], docs, pos, n_docs, VOCAB,
                     dl.astype(np.float64))
    head = pos < FT_TITLE
    title = csr_field(np, terms[:n_tok][head], docs[head], pos[head],
                      n_docs, VOCAB, np.minimum(dl, FT_TITLE).astype(
                          np.float64))
    return {"num_docs": n_docs, "max_docs": n_docs,
            "fields": {"body": body, "title": title}}


def fulltext_bodies(np, doc_len, terms, seed):
    """Groups of FT_VARIANTS bodies, each drawn from the corpus with a
    seeded rng: (name, [bodies], served by the mesh, phrase slop or
    None). Phrases are 2-3 consecutive tokens of random docs (Rally
    pmc's ``phrase`` operation's shape)."""
    rng = np.random.default_rng(seed + 9)
    start = np.cumsum(doc_len) - doc_len

    def toks(n):
        d = int(rng.integers(doc_len.size))
        s = int(rng.integers(0, doc_len[d] - n + 1))
        return [f"t{t}" for t in terms[start[d] + s: start[d] + s + n]]

    def phrase():
        return " ".join(toks(int(rng.integers(2, 4))))

    def head(n):  # tokens of a doc's title
        d = int(rng.integers(doc_len.size))
        s = int(rng.integers(0, FT_TITLE - n + 1))
        return [f"t{t}" for t in terms[start[d] + s: start[d] + s + n]]

    V = range(FT_VARIANTS)
    ph = [phrase() for _ in V]
    ph2 = [phrase() for _ in V]
    return [
        ("a_phrase", [{"match_phrase": {"body": p}} for p in ph], True, 0),
        ("b_phrase_slop2", [{"match_phrase": {"body": {
            "query": p, "slop": 2}}} for p in ph], True, 2),
        ("c_multi_match", [{"multi_match": {
            "query": " ".join(head(2) + toks(1)), "type": "best_fields",
            "fields": ["title", "body"], "tie_breaker": 0.3}} for _ in V],
         False, None),
        ("d_prefix", [{"prefix": {"body": f"t{int(rng.integers(100, 999))}"}}
                      for _ in V], True, None),
        ("d_wildcard", [{"wildcard": {"body": f"t{int(rng.integers(1, 9))}?"
                                              f"{int(rng.integers(0, 9))}"}}
                        for _ in V], True, None),
        # three characters: AUTO allows one edit (a scan of the term dict
        # on the host, as in the reference)
        ("e_fuzzy", [{"fuzzy": {"body": f"t{int(rng.integers(10, 99))}"}}
                     for _ in V], True, None),
        ("e_match_fuzziness", [{"match": {"body": {
            "query": " ".join(toks(2)) + f" x{int(rng.integers(10, 99))}",
            "fuzziness": "AUTO"}}} for _ in V], False, None),
        ("f_dis_max", [{"dis_max": {"tie_breaker": 0.2, "queries": [
            {"match_phrase": {"body": p}},
            {"match": {"title": " ".join(head(1))}}]}} for p in ph2],
         True, None),
        ("f_boosting", [{"boosting": {
            "positive": {"match_phrase": {"body": {"query": p, "slop": 1}}},
            "negative": {"wildcard": {"title": "t1?"}},
            "negative_boost": 0.5}} for p in ph2], True, None),
        ("g_query_string", [{"query_string": {
            "query": f'"{p}" AND {toks(1)[0][:3]}*',
            "default_field": "body"}} for p in ph2], False, None),
        ("h_common", [{"common": {"body": {
            "query": " ".join(toks(4)), "cutoff_frequency": 0.001}}}
            for _ in V], False, None),
    ]


def phrase_oracle(np, field, words, slop, D):
    """f64 phrase frequency per doc over the host positional CSR, by
    Lucene's greedy rule as the reference documents it: each occurrence
    of the first term anchors; exact (slop 0): every other term at its
    offset; sloppy: each term's position nearest its expected slot
    (the later one on a tie), matchLength the spread, weight
    1 / (1 + matchLength) when it fits the slop."""
    offsets, u_doc = field["offsets"], field["doc_ids_host"]
    po, positions = field["pos_offsets"], field["positions"]
    cache = field.setdefault("_oracle_entries", {})

    def entries(word):
        """(docs, positions, packed doc << 32 | position keys, sorted)."""
        if word not in cache:
            t = int(word[1:])
            lo, hi = int(offsets[t]), int(offsets[t + 1])
            docs = np.repeat(u_doc[lo:hi].astype(np.int64),
                             np.diff(po[lo:hi + 1]))
            p = positions[po[lo]: po[hi]].astype(np.int64)
            cache[word] = (docs, p, docs * 2 ** 32 + p)
        return cache[word]

    adoc, apos, _ = entries(words[0])
    ok = np.ones(adoc.size, bool)
    lo_adj, hi_adj = apos.copy(), apos.copy()
    for j, w in enumerate(words[1:], 1):
        d, p, key = entries(w)
        want = adoc * 2 ** 32 + apos + j
        i = np.searchsorted(key, want)
        i1, i0 = np.minimum(i, key.size - 1), np.maximum(i - 1, 0)
        if slop == 0:
            ok &= key[i1] == want
            continue
        c1_ok = (i < key.size) & (d[i1] == adoc)
        c0_ok = (i >= 1) & (d[i0] == adoc)
        d1 = np.where(c1_ok, np.abs(p[i1] - apos - j), np.inf)
        d0 = np.where(c0_ok, np.abs(p[i0] - apos - j), np.inf)
        adj = np.where(d0 < d1, p[i0], p[i1]) - j
        found = c0_ok | c1_ok
        ok &= found
        lo_adj = np.where(found, np.minimum(lo_adj, adj), lo_adj)
        hi_adj = np.where(found, np.maximum(hi_adj, adj), hi_adj)
    mlen = hi_adj - lo_adj
    w = np.where(ok & (mlen <= slop), 1.0 / (1.0 + mlen), 0.0)
    return np.bincount(adoc, weights=w, minlength=D)


def _ft_line(np, name, label, ms, prof):
    tail = (f"p99 {np.percentile(ms, 99):.3f} ms"
            if len(ms) >= TAXI_TAIL_REPS else
            f"slowest {ms.max():.3f} ms (too few for a p99)")
    return (f"[5i] {name}, {label}: p50 {np.percentile(ms, 50):.3f} ms, "
            f"{tail} over {len(ms)} requests, "
            + _dev_line(np, prof, FT_PROFILED, ms))


def _hold_same_hits(got, want, what):
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    _hold(got["hits"]["total"] == want["hits"]["total"]
          and [h["_id"] for h in gh] == [h["_id"] for h in wh],
          f"{what}: total {got['hits']['total']} vs "
          f"{want['hits']['total']}, ids differ", "5i")
    g = [h["_score"] for h in gh]
    w = [h["_score"] for h in wh]
    _hold(len(g) == len(w) and all(abs(a - b) <= 1e-5 * abs(b)
                                   for a, b in zip(g, w)),
          f"{what}: scores {g[:3]} vs {w[:3]}", "5i")


def phase_fulltext(torch, np, dev, card):
    """Phase 5i: the full-text DSL (ROADMAP A9a) on phase 5's 2^20-doc
    MS-MARCO-shaped corpus, its positional CSR kept (~63M positions),
    with a title field of each doc's first 10 tokens, loaded through
    ``segment_from_arrays``. Every group of bodies (match_phrase at slop 0
    and 2, multi_match best_fields, prefix, wildcard, fuzzy, match with
    fuzziness, dis_max, boosting, query_string, common) runs on the mesh
    path and on the host loop for about FT_WINDOW_S each: the routes'
    responses byte-identical, the phrases' frequencies against a float64
    numpy oracle over the host positions (exact at slop 0), every body on
    the card against a CPU Node of the port on a 2^14-doc prefix, and the
    positional CSR's bytes released when the node closes."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk
    from elasticsearch_tpu_torch.ops.positional import (phrase_freq,
                                                        positional_bytes)

    t_phase = time.perf_counter()
    doc_len, terms = corpus_tokens(np, FT_DOCS, VOCAB, SEED)
    arrays = fulltext_arrays(np, doc_len, terms, FT_DOCS)
    body_f = arrays["fields"]["body"]
    n_pos = int(body_f["positions"].size)
    t_data = time.perf_counter() - t_phase
    node = Node(name="fulltext", device=dev)
    node.create_index("ft", {"settings": {"number_of_shards": 1},
                             "mappings": FT_MAPPING})
    svc = node.get_index("ft")
    seg = segment_from_arrays(arrays, node.residency)
    svc.shards[0].engine.add_segment(seg)
    fd = node.breakers.breaker("fielddata")
    segs_br = node.breakers.breaker("segments")
    fd0 = fd.used
    groups = fulltext_bodies(np, doc_len, terms, SEED)
    node.search("ft", {"query": groups[0][1][0]})  # places the CSR
    inv = seg.inverted["body"]
    csr_bytes = positional_bytes(inv)
    _hold(csr_bytes == 4 * (2 * n_pos + int(body_f["pos_offsets"].size)),
          f"positional CSR {csr_bytes} bytes", "5i")
    log(f"[5i] {FT_DOCS} docs, {n_pos} positions ({int(body_f['df'].sum())}"
        f" postings) in a term-major, doc-ascending positional CSR, a "
        f"{FT_TITLE}-token title field; data {t_data:.1f} s, set-up "
        f"{time.perf_counter() - t_phase:.1f} s; the CSR on the card "
        f"{csr_bytes} bytes (positions, pos_offsets, doc_per_pos); "
        f"breakers: segments {segs_br.used} bytes, fielddata {fd0} -> "
        f"{fd.used} bytes")

    def timed(bodies, n, window_s):
        ms, out = [], {}
        start = time.perf_counter()
        while len(ms) < n or (len(ms) < FT_MAX_REPS and
                              time.perf_counter() - start < window_s):
            b = bodies[len(ms) % len(bodies)]
            a = time.perf_counter()
            out[len(ms) % len(bodies)] = node.search(
                "ft", {"query": copy.deepcopy(b), "size": 10})
            ms.append((time.perf_counter() - a) * 1e3)
        return np.array(ms), out

    bm25_topk.LAUNCHES = 0
    lines, answers = [], {}
    for name, bodies, mesh_serves, _slop in groups:
        for b in bodies:  # first use: expansions' sorted dicts, memo
            node.search("ft", {"query": copy.deepcopy(b), "size": 10})
        for route in ("mesh", "host"):
            with (_host_loop() if route == "host"
                  else contextlib.nullcontext()):
                counters.reset()
                ms, out = timed(bodies, FT_MIN_REPS, FT_WINDOW_S)
                snap = counters.snapshot()
                prof = profile_path(torch, lambda: [node.search(
                    "ft", {"query": copy.deepcopy(bodies[i % len(bodies)]),
                           "size": 10}) for i in range(FT_PROFILED)])
            if route == "host":
                _hold(not any(k.startswith("mesh_") for k in snap),
                      f"{name}: the pinned host loop ran the mesh", "5i")
                label = "host loop"
            else:
                want_key = ("mesh_search" if mesh_serves
                            else "mesh_fallback_total")
                _hold(snap.get(want_key) == len(ms),
                      f"{name}: not served by {want_key}: {snap}", "5i")
                label = ("mesh path" if mesh_serves else
                         "mesh route, declined to the host loop "
                         "(MeshCompileError)")
            answers[(name, route)] = out
            lines.append(_ft_line(np, name, label, ms, prof))
        for i in range(len(bodies)):
            a, b = answers[(name, "mesh")][i], answers[(name, "host")][i]
            _hold(json.dumps(dict(a, took=0), sort_keys=True)
                  == json.dumps(dict(b, took=0), sort_keys=True),
                  f"{name} body {i}: the mesh's response differs from the "
                  f"host loop's", "5i")
    b1 = bm25_topk.LAUNCHES
    for ln in lines:
        log(ln)

    # (a) and (b): every doc's phrase frequency against the f64 oracle,
    # and each response's total and hits against the oracle's scores
    t = time.perf_counter()
    n_terms = float(FT_DOCS)
    avg = body_f["avg_len"]
    lengths = body_f["lengths"].astype(np.float64)
    n_checked = n_hits = 0
    for name, bodies, _m, slop in groups:
        if slop is None:
            continue
        for i, b in enumerate(bodies):
            q = b["match_phrase"]["body"]
            words = (q["query"] if isinstance(q, dict) else q).split()
            want = phrase_oracle(np, body_f, words, slop, FT_DOCS)
            got = phrase_freq(inv, [(w, j) for j, w in enumerate(words)],
                              FT_DOCS, slop).cpu().numpy()
            if slop == 0:
                _hold(np.array_equal(got, want.astype(np.float32)),
                      f"{name} {words}: frequencies differ from the "
                      f"oracle's", "5i")
            else:
                _hold(np.allclose(got, want, rtol=1e-6, atol=0)
                      and np.array_equal(got > 0, want > 0),
                      f"{name} {words}: frequencies off the oracle's", "5i")
            resp = answers[(name, "mesh")][i]
            _hold(resp["hits"]["total"] == int((want > 0).sum()),
                  f"{name} {words}: total {resp['hits']['total']} vs "
                  f"{int((want > 0).sum())}", "5i")
            idf = sum(np.log(1.0 + (n_terms - body_f["df"][int(w[1:])] + 0.5)
                             / (body_f["df"][int(w[1:])] + 0.5))
                      for w in dict.fromkeys(words))
            norm = 1.2 * (0.25 + 0.75 * lengths / avg)
            score = np.where(want > 0, idf * want * 2.2 / (want + norm),
                             -np.inf)
            top = np.lexsort((np.arange(FT_DOCS), -score))[:10]
            top = top[np.isfinite(score[top])]
            hits = resp["hits"]["hits"]
            s = np.array([h["_score"] for h in hits])
            _hold(len(hits) == top.size and np.allclose(
                s, score[top], rtol=1e-5, atol=0) and np.allclose(
                [score[int(h["_id"])] for h in hits], s, rtol=1e-5, atol=0),
                f"{name} {words}: hits off the oracle's top 10", "5i")
            n_checked += 1
            n_hits += len(hits)
    body_f.pop("_oracle_entries", None)
    log(f"[5i] {n_checked} phrases (slop 0 and 2): every doc's frequency "
        f"equals the f64 oracle's (exact at slop 0, rtol 1e-6 at slop 2), "
        f"totals exact, {n_hits} hits' scores within rtol 1e-5 of the "
        f"oracle's top 10; {time.perf_counter() - t:.1f} s")

    # every body on the card against a CPU Node of the port on a prefix
    t = time.perf_counter()
    pre = fulltext_arrays(np, doc_len, terms, FT_PREFIX)
    pnodes = []
    for d in (dev, "cpu"):
        n = Node(name=f"ft-prefix-{d}", device=d)
        n.create_index("ftp", {"settings": {"number_of_shards": 1},
                               "mappings": FT_MAPPING})
        n.get_index("ftp").shards[0].engine.add_segment(
            segment_from_arrays(pre, n.residency))
        pnodes.append(n)
    n_bodies = 0
    for name, bodies, _m, _s in groups:
        for b in bodies:
            body = {"query": b, "size": 10}
            want = pnodes[1].search("ftp", copy.deepcopy(body))
            _hold_same_hits(pnodes[0].search("ftp", copy.deepcopy(body)),
                            want, f"{name} prefix, card mesh vs CPU")
            with _host_loop():
                _hold_same_hits(pnodes[0].search("ftp", copy.deepcopy(body)),
                                want, f"{name} prefix, card host vs CPU")
            n_bodies += 1
    for n in pnodes:
        n.close()
    log(f"[5i] {n_bodies} bodies on a {FT_PREFIX}-doc prefix: the card's "
        f"mesh path and host loop equal a CPU Node of the port (ids, "
        f"order, totals exact; scores within rtol 1e-5); "
        f"{time.perf_counter() - t:.1f} s")

    node.close()
    _hold(fd.used == 0, f"fielddata {fd.used} bytes after the index closed "
          f"(the CSR's {csr_bytes} included)", "5i")
    log(f"[5i] after the node closed: fielddata {fd.used} bytes (the "
        f"positional CSR's {csr_bytes} released), segments {segs_br.used}")
    del arrays, pre, doc_len, terms
    log(f"[5i] B1 launched {b1} times in 5i's timed runs; phase 5i took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return b1


def _cprofile_rows(st, key, n, per=1):
    """The top ``n`` of a pstats.Stats by ``key`` ("cum" or "own") as
    lines of calls, own ms, cumulative ms (each divided by ``per``) and
    the function."""
    rows = [(ct if key == "cum" else tt, nc, tt, ct, fn)
            for fn, (cc, nc, tt, ct, _callers) in st.stats.items()]
    rows.sort(key=lambda r: -r[0])
    out = []
    for _, nc, tt, ct, (path, line, name) in rows[:n]:
        path = re.sub(r".*/(elasticsearch_tpu_torch|torch)/", r"\1/", path)
        out.append(f"{nc / per:7.1f} {tt * 1e3 / per:8.3f} "
                   f"{ct * 1e3 / per:8.3f}  {path}:{line}({name})")
    return out


def mesh_host_profile(node, on_mesh, bodies):
    """Where the host time of phase 5d goes: cProfile's top 10 by
    cumulative time of one five-shard match query on the mesh path and
    on the host loop, and the top 10 by own time over all the queries
    (each new to the prepared-query memo)."""
    import cProfile
    import pstats

    for flag, name in ((True, "mesh path"), (False, "host loop")):
        on_mesh(flag)
        fresh = [dict(b, _source=True) for b in bodies]  # memo misses
        pr = cProfile.Profile()
        pr.enable()
        node.search("mesh5", copy.deepcopy(fresh[0]))
        pr.disable()
        one = pstats.Stats(pr)
        pr = cProfile.Profile()
        pr.enable()
        for b in fresh[1:]:
            node.search("mesh5", copy.deepcopy(b))
        pr.disable()
        many = pstats.Stats(pr)
        n = len(fresh) - 1
        log(f"[mesh] cProfile on the {name} (calls, own ms, cumulative ms, "
            f"function): one match query, {one.total_tt * 1e3:.3f} ms under "
            f"the profiler, top 10 by cumulative time:\n  "
            + "\n  ".join(_cprofile_rows(one, "cum", 10))
            + f"\n  {n} other queries, per query "
              f"{many.total_tt * 1e3 / n:.3f} ms, top 10 by own time:\n  "
            + "\n  ".join(_cprofile_rows(many, "own", 10, per=n)))
    on_mesh(True)


def _p50(np, ms) -> str:
    return f"{np.percentile(ms, 50):.3f} ms" if ms.size else "no queries"


def profile_read(torch, node, index, bodies, wall_ms, tag):
    """Device time of the same searches under torch.profiler, over the
    host time of the unprofiled run: the device's busy share."""
    for _ in range(2):  # a session that records nothing is tried again
        with _profiled(torch, cpu=True) as prof:
            for body in bodies:
                node.search(index, copy.deepcopy(body))
        dev = _device_rows(prof)
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        if busy_ms > 0:
            break
    else:
        log(f"[{tag}] device busy share: not measured (the profiler "
            "recorded no device time twice)")
        return
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[{tag}] device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms host "
        f"time ({100 * busy_ms / wall_ms:.1f}% busy); top device time: "
        + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                    f" x{e.count}" for e in top))


def device_ops(torch, fn):
    """{name: count} of the device kernels and copies one call of ``fn``
    runs, from torch.profiler (a session that records none is tried once
    more); None when none is recorded."""
    for _ in range(2):
        with _profiled(torch) as prof:
            fn()
        ops = {e.key: e.count for e in _device_rows(prof)}
        if ops:
            return ops
    return None


#: spin-kernel launches that open every profiler session: late in this
#: process the profiler drops the first records of a session (a few, up
#: to all of a short session's), so these take the loss, not the work
PRIMERS = 16
#: (sessions, sessions that dropped primers, primers dropped)
PRIMER_LOSS = [0, 0, 0]


@contextlib.contextmanager
def _profiled(torch, cpu=False):
    """A torch.profiler session (device activity, and host with ``cpu``)
    around the block, which ``PRIMERS`` spin kernels precede. Read it
    with ``_device_rows``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(PRIMERS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def _device_rows(prof):
    """The device rows of a ``_profiled`` session's ``key_averages()``,
    the primers left out and their loss tallied in ``PRIMER_LOSS``."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    seen = sum(e.count for e in rows if "spin_kernel" in e.key)
    PRIMER_LOSS[0] += 1
    if seen < PRIMERS:
        PRIMER_LOSS[1] += 1
        PRIMER_LOSS[2] += PRIMERS - seen
    return [e for e in rows if "spin_kernel" not in e.key]


def _time_ms(torch, fn, iters):
    """Mean ms per call by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(torch, fn, iters):
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler: the call time without the host's share. A session
    that records no device time is tried once more in a fresh one; if
    that reads 0 too, None (not measured). A kernel whose records are not
    a whole multiple of the calls (a record lost past the primers) is
    logged with the CUDA events of the same window."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with _profiled(torch) as prof:
            a.record()
            for _ in range(iters):
                fn()
            b.record()
        rows = _device_rows(prof)
        ms = sum(e.self_device_time_total for e in rows) / 1e3 / iters
        if any(e.count % iters for e in rows):
            log(f"[timing] the profiler's records over {iters} calls: "
                + "; ".join(f"{e.key[:40]} x{e.count} "
                            f"{e.self_device_time_total / 1e3:.4f} ms"
                            for e in rows)
                + f"; CUDA events in the same window "
                  f"{a.elapsed_time(b) / iters:.4f} ms a call")
        if ms > 0:
            return ms
    log("[timing] the profiler recorded no device time twice: not measured")
    return None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_timing(torch, dev, card):
    """B1 at the main path's shape, the rows form with the count: one
    query, R = 8 rows of a whole 256-row block (1 GiB), D = 2^20, k = 10;
    each call takes the next 8 rows, so its rows come from device memory
    (32 sets of 32 MiB pass the 50 MB L2). Also the all-rows form at its
    PR 4 shape (8 gathered rows, rotated past the L2 likewise) and the
    batched form (Q = 256, all rows). Returns the rows form's row."""
    from elasticsearch_tpu_torch.ops.bm25_topk import bm25_dense_topk

    out = {}
    D, k = 1 << 20, 10
    # the rows form: one block, the rows rotate
    qw, block, mask = _b1_inputs(torch, dev, 1, 256, D, 7)
    R = 8
    sets = [(qw[:, :R].contiguous(),
             torch.arange(R * j, R * j + R, dtype=torch.int32, device=dev))
            for j in range(256 // R)]
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(sets)
        return sets[it[0]]

    def kernel():
        w, rows = nxt()
        return bm25_dense_topk(w, block, mask, k=k, rows=rows, count=True,
                               packed=True)

    def lib():  # the same function in PyTorch calls
        w, rows = nxt()
        sub = block.index_select(0, rows.long())
        s = w.to(torch.bfloat16) @ sub.to(torch.bfloat16)
        top = torch.topk(torch.where(mask, s.float(), -torch.inf), k)
        return top, ((sub != 0).any(0) & mask).sum()

    def twin():
        w, rows = nxt()
        return bm25_dense_topk(w, block, mask, k=k, rows=rows, count=True,
                               plain=True)

    kern = _time_ms(torch, kernel, 50)
    plain = _time_ms(torch, twin, 5)
    library = _time_ms(torch, lib, 50)
    kern_dev = _device_ms(torch, kernel, 50)
    lib_dev = _device_ms(torch, lib, 50)
    b = _bound(R * D * 4 + D + R * 8, 2 * k * 4 + 8, 2 * R * D,
               BF16_FLOP_PER_S)
    out["rows"] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                   "library_ms": library, **b}
    log(f"[timing] bm25_dense_topk rows form + count Q=1 R={R} of 256 rows "
        f"D={D} k={k} on {card}: kernel {kern:.4f} ms, plain {plain:.4f} "
        f"ms, library (index_select + bf16 matmul + topk + count) "
        f"{library:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
        f"device time per call: kernel {_fmt(kern_dev)}, library "
        f"{_fmt(lib_dev)}")
    del qw, block, mask, sets
    torch.cuda.empty_cache()

    for label, (Q, F) in (("all rows", (1, 8)), ("batched", (256, 256))):
        in_bytes = Q * F * 4 + F * D * 4 + D
        # rotate input copies past the 50 MB L2, so each launch reads
        # its impact rows from device memory
        n_buf = max(1, -(-200_000_000 // (F * D * 4)))
        bufs = [_b1_inputs(torch, dev, Q, F, D, 7 + j) for j in range(n_buf)]
        it = [0]

        def nxt():
            it[0] = (it[0] + 1) % n_buf
            return bufs[it[0]]

        def lib():
            qw, impact, mask = nxt()
            s = qw.to(torch.bfloat16) @ impact.to(torch.bfloat16)
            return torch.topk(torch.where(mask, s.float(), -torch.inf), k)

        iters = 50 if Q == 1 else 5
        kern = _time_ms(torch, lambda: bm25_dense_topk(*nxt(), k=k), iters)
        plain = _time_ms(torch, lambda: bm25_dense_topk(*nxt(), k=k,
                                                        plain=True),
                         max(2, iters // 10))
        library = _time_ms(torch, lib, iters)
        kern_dev = _device_ms(torch, lambda: bm25_dense_topk(*nxt(), k=k),
                              iters)
        lib_dev = _device_ms(torch, lib, iters)
        b = _bound(in_bytes, Q * k * 8, 2 * Q * F * D, BF16_FLOP_PER_S)
        out[label] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                      "library_ms": library, **b}
        log(f"[timing] bm25_dense_topk {label} Q={Q} F={F} D={D} k={k} on "
            f"{card}: kernel {kern:.4f} ms, plain {plain:.4f} ms, library "
            f"(bf16 matmul + topk) {library:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); device time per "
            f"call: kernel {_fmt(kern_dev)}, library {_fmt(lib_dev)}")
        del bufs
        torch.cuda.empty_cache()
    return out["rows"]


def _bound(in_bytes, out_bytes, ops, peak):
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timing_knn(torch, dev, card):
    """B2 at the brute-force kNN shape of the slice: Q = 1 (and Q = 8,
    MaxSim; Q = 32 and 64, phase 5e's kNN and MaxSim batches), D = 2^20,
    dims = 128, f32 (precise), k = 100, cosine. The
    slab (512 MiB) is ten times the L2, so every call reads it from
    device memory."""
    import torch.nn.functional as F

    from elasticsearch_tpu_torch.ops.knn_topk import knn_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    D, dims, k = 1 << 20, DIMS, 100
    out = {}
    # Q = 32 and 64: _msearch's kNN batch and MaxSim batch (8 x 8 tokens)
    for Q in (1, 8, 32, 64):
        q, v, mask = _b2_inputs(torch, dev, Q, D, dims, 17)

        def lib():
            s = F.normalize(q, dim=1) @ F.normalize(v, dim=1).T
            s = torch.where(mask[None, :], (1.0 + s) * 0.5, -torch.inf)
            return torch.topk(s, k)

        def kernel():
            return knn_topk(q, v, mask, k=k, metric="cosine", precise=True)

        kern = _time_ms(torch, kernel, 20)
        plain = _time_ms(torch, lambda: knn_topk(
            q, v, mask, k=k, metric="cosine", precise=True, plain=True), 2)
        library = _time_ms(torch, lib, 20)
        kern_dev = _device_ms(torch, kernel, 20)
        lib_dev = _device_ms(torch, lib, 20)
        # f32 ops: the row norm (2 per element), the division (1), the
        # dot (2 per element and query)
        b = _bound(D * dims * 4 + D + Q * dims * 4, Q * k * 8,
                   D * dims * (3 + 2 * Q), F32_FLOP_PER_S)
        out[Q] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                  "library_ms": library, **b}
        log(f"[timing] knn_topk Q={Q} D={D} dims={dims} k={k} cosine f32 on "
            f"{card}: kernel {kern:.4f} ms, plain {plain:.4f} ms, library "
            f"(normalize + f32 matmul + topk) {library:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); device time per "
            f"call: kernel {_fmt(kern_dev)}, library {_fmt(lib_dev)}")
        del q, v, mask
        torch.cuda.empty_cache()
    return out[1]


def timing_adc(torch, dev, card, case):
    """B3 at its PR 4 shape, the table-sum over W = 81,920 gathered rows
    of M = 32 codes (K = 256), and at the IVF-PQ query's shape, the fused
    form: one query's probed slots ``case["cand"]`` (W = nprobe * Lmax,
    pads at D) over the whole code table ``case["codes"]`` with its LUT
    and pre-filter words, as phase 5b runs it. The fused form is also
    timed against what the caller ran before it: the code gather, the
    table-sum and the mask. Returns the fused form's row."""
    from elasticsearch_tpu_torch.ops.adc import adc_scores
    from elasticsearch_tpu_torch.ops.bitvec import test_bits

    codes, cand, words, lut = (case[n] for n in ("codes", "cand", "words",
                                                 "lut"))
    N, M = codes.shape
    K = lut.shape[1]
    W = cand.shape[0]
    rows = torch.arange(M, device=dev)
    out = {}

    g = torch.Generator(device=dev).manual_seed(23)
    gathered = torch.randint(0, K, (W, M), generator=g, device=dev,
                             dtype=torch.int64).to(torch.uint8)
    kern = _time_ms(torch, lambda: adc_scores(gathered, lut), 200)
    plain = _time_ms(torch, lambda: adc_scores(gathered, lut, plain=True), 20)
    library = _time_ms(torch, lambda: lut[rows, gathered.long()].sum(1), 200)
    kern_dev = _device_ms(torch, lambda: adc_scores(gathered, lut), 200)
    lib_dev = _device_ms(torch, lambda: lut[rows, gathered.long()].sum(1),
                         200)
    b = _bound(W * M + M * K * 4, W * 4, W * M, F32_FLOP_PER_S)
    out["table"] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                    "library_ms": library, **b}
    log(f"[timing] adc_scores table-sum W={W} M={M} K={K} on {card}: kernel "
        f"{kern:.4f} ms, plain {plain:.4f} ms, library (gather + sum) "
        f"{library:.4f} ms, bound {b['bound_ms']:.6f} ms ({b['bound_by']}); "
        f"device time per call: kernel {_fmt(kern_dev)}, library "
        f"{_fmt(lib_dev)}")

    def fused():
        return adc_scores(codes, lut, cand=cand, filter_words=words)

    def composed(table_sum):  # gather, table-sum, mask
        valid = cand < N
        safe = torch.where(valid, cand, torch.zeros_like(cand)).long()
        valid = valid & test_bits(words, safe)
        return torch.where(valid, table_sum(codes[safe]), -torch.inf)

    def lib():
        return composed(lambda c: lut[rows, c.long()].sum(1))

    def before():  # the caller's sequence up to PR 4
        return composed(lambda c: adc_scores(c, lut))

    kern = _time_ms(torch, fused, 200)
    plain = _time_ms(torch, lambda: adc_scores(
        codes, lut, cand=cand, filter_words=words, plain=True), 20)
    library = _time_ms(torch, lib, 200)
    prev = _time_ms(torch, before, 200)
    kern_dev = _device_ms(torch, fused, 200)
    lib_dev = _device_ms(torch, lib, 200)
    prev_dev = _device_ms(torch, before, 200)
    live = (cand < N) & test_bits(words, torch.where(
        cand < N, cand, torch.zeros_like(cand)).long())
    n_live = int(live.sum())
    n_words = int(torch.unique(cand[cand < N] >> 5).numel())
    b = _bound(W * 4 + n_live * M + n_words * 4 + M * K * 4, W * 4,
               n_live * M, F32_FLOP_PER_S)
    out["fused"] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                    "library_ms": library, **b}
    log(f"[timing] adc_scores fused N={N} W={W} ({n_live} live) M={M} K={K} "
        f"on {card}: kernel {kern:.4f} ms, plain {plain:.4f} ms, library "
        f"(gather + sum + test_bits + where) {library:.4f} ms, PR 4's "
        f"caller (gather + B3 + test_bits + where) {prev:.4f} ms, bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']}); device time per call: "
        f"kernel {_fmt(kern_dev)}, library {_fmt(lib_dev)}, PR 4's caller "
        f"{_fmt(prev_dev)}")
    return out["fused"]


def timing_maxsim(torch, dev, card):
    """B4 at the re-rank's shape: a window of W = 100 candidates (and the
    largest window, W = 10,000) of M = 32 codes, T = 32 token tables of
    K = 256. Returns the W = 100 row."""
    from elasticsearch_tpu_torch.ops.maxsim_adc import maxsim_adc

    M, K, T = 32, 256, RERANK_TOKENS
    rows = torch.arange(M, device=dev)
    out = {}
    for W in (RERANK_WINDOW, 10_000):
        g = torch.Generator(device=dev).manual_seed(29)
        codes = torch.randint(0, K, (W, M), generator=g, device=dev,
                              dtype=torch.int64).to(torch.uint8)
        luts = torch.randn(T, M, K, generator=g, device=dev)

        def lib():
            return luts[:, rows[None, :], codes.long()].sum(2).amax(0)

        kern = _time_ms(torch, lambda: maxsim_adc(codes, luts), 200)
        plain = _time_ms(torch, lambda: maxsim_adc(codes, luts, plain=True),
                         20)
        library = _time_ms(torch, lib, 200)
        kern_dev = _device_ms(torch, lambda: maxsim_adc(codes, luts), 200)
        lib_dev = _device_ms(torch, lib, 200)
        b = _bound(W * M + T * M * K * 4, W * 4, W * T * M, F32_FLOP_PER_S)
        out[W] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                  "library_ms": library, **b}
        log(f"[timing] maxsim_adc W={W} M={M} K={K} T={T} on {card}: kernel "
            f"{kern:.4f} ms, plain {plain:.4f} ms, library (gather + sum + "
            f"amax) {library:.4f} ms, bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}); device time per call: kernel "
            f"{_fmt(kern_dev)}, library {_fmt(lib_dev)}")
    return out[RERANK_WINDOW]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    dev, card = phase_device(torch)
    phase_build()
    err = phase_kernels(torch, dev)
    phase_write(torch, np, dev)
    # each corpus is generated once and shared by the phases that read it
    t = time.perf_counter()
    corpus = build_corpus(np, N_DOCS, VOCAB, SEED)
    sift = make_sift(np, N_VECS, DIMS, SEED)
    log(f"[data] MS-MARCO-shaped postings and SIFT-shaped vectors generated"
        f" in {time.perf_counter() - t:.1f} s")
    b1_read, read_node = phase_read(torch, np, dev, card, corpus)
    launches = {"bm25_dense_topk": b1_read}
    (launches["knn_topk"], launches["adc_scores"], b3_case, ivf_index,
     pq_parts) = phase_vectors(torch, np, dev, card, sift)
    hyb = phase_hybrid(torch, np, dev, card, corpus, sift, ivf_index,
                       pq_parts)
    launches["maxsim_adc"] = hyb["maxsim_adc"]
    del ivf_index, pq_parts
    b1_mesh, b2_mesh, mesh_node, shard_text = phase_mesh(
        torch, np, dev, card, corpus, sift)
    launches["bm25_dense_topk"] += b1_mesh
    launches["knn_topk"] += b2_mesh
    b1_ms, b2_ms = phase_msearch(torch, np, dev, card, corpus, sift,
                                 read_node, mesh_node, shard_text)
    launches["bm25_dense_topk"] += b1_ms
    launches["knn_topk"] += b2_ms
    read_node.close()
    mesh_node.close()
    del corpus, sift, read_node, mesh_node, shard_text
    torch.cuda.empty_cache()
    taxi_node, taxis = phase_aggs(torch, np, dev, card)
    launches["bm25_dense_topk"] += phase_sort(torch, np, dev, card,
                                              taxi_node, taxis)
    taxi_node.close()
    del taxi_node, taxis
    torch.cuda.empty_cache()
    launches["bm25_dense_topk"] += phase_writepath(torch, np, dev, card)
    torch.cuda.empty_cache()
    launches["bm25_dense_topk"] += phase_fulltext(torch, np, dev, card)
    torch.cuda.empty_cache()
    timing = {"bm25_dense_topk": phase_timing(torch, dev, card),
              "knn_topk": timing_knn(torch, dev, card),
              "adc_scores": timing_adc(torch, dev, card, b3_case),
              "maxsim_adc": timing_maxsim(torch, dev, card)}
    del b3_case
    log(f"[done] the profiler dropped primer records in {PRIMER_LOSS[1]} "
        f"of {PRIMER_LOSS[0]} sessions ({PRIMER_LOSS[2]} of "
        f"{PRIMERS * PRIMER_LOSS[0]})")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    replaces = {"bm25_dense_topk": 150, "knn_topk": 39, "adc_scores": 415,
                "maxsim_adc": 585}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"elasticsearch_tpu_torch/csrc/{name}.cu",
        "replaces": f"elasticsearch_tpu/ops/pallas_kernels.py:{line}",
        "launches": launches[name], "max_abs_err": err[name],
        **timing[name]} for name, line in replaces.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
