#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (elasticsearch_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device   the card's name, power limit and compute capability;
2. build    every CUDA kernel, from the sources in the checkout (nvcc,
            sm_90a, one process per source, all started together);
3. kernels  each kernel against its plain PyTorch twin on the card;
4. write    the write path through ``Node``: index, refresh, search,
            delete, checked against the same Node on the CPU;
5. read     the product-sized read path: a 2^20-doc MS-MARCO-shaped
            corpus loaded with ``segment_from_arrays``, 32 Zipfian
            ``match`` queries through ``Node.search`` (the main path:
            kernel launch counts are taken over exactly this run), hits
            held against the plain twin and an exact numpy scorer;
6. timing   each kernel, its plain twin, a one-call library yardstick and
            the card's bound at the main path's shape.

The last two lines of standard output are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``. The script needs a CUDA
card and the repository around it; without either it fails.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

N_DOCS = 1 << 20          # product bench size (bench.py --docs default)
VOCAB = 30_000
N_QUERIES = 32
SEED = 0


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


def phase_build():
    from elasticsearch_tpu_torch.ops import build

    t0 = time.perf_counter()
    out = build.build_all()
    for name, text in out.items():
        usage = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: " + (" | ".join(usage) or "cached"))
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


def phase_kernels(torch, dev) -> float:
    from elasticsearch_tpu_torch.ops.bm25_topk import bm25_dense_topk

    cases = [  # (name, Q, F, D, k, quant, masked prefix)
        ("single query", 1, 8, 1 << 20, 10, None, 0),
        ("k=1000", 1, 8, 1 << 20, 1000, None, 0),
        ("quantized ties, masked prefix", 16, 16, 4096, 10, 1.0, 600),
        ("batched", 256, 256, 1 << 20, 10, None, 0),
        # both sides of the kernel's k <= 32 selection path, ragged D
        ("k=1", 1, 8, 70_001, 1, None, 0),
        ("k=32", 3, 8, 1_000_003, 32, None, 0),
        ("k=33", 1, 16, 1 << 20, 33, 0.5, 0),
    ]
    worst = 0.0
    for n, (name, Q, F, D, k, quant, prefix) in enumerate(cases):
        qw, impact, mask = _b1_inputs(torch, dev, Q, F, D, 100 + n, quant,
                                      prefix)
        v, i = bm25_dense_topk(qw, impact, mask, k=k)
        torch.cuda.synchronize()
        pv, pi = bm25_dense_topk(qw, impact, mask, k=min(k + 1, D),
                                 plain=True)
        err = check_topk(v.cpu().numpy(), i.cpu().numpy(), pv.cpu().numpy(),
                         pi.cpu().numpy(), f"bm25_dense_topk {name}")
        worst = max(worst, err)
        log(f"[kernels] bm25_dense_topk {name} Q={Q} F={F} D={D} k={k}: "
            f"agrees with the plain twin, max abs err {err:g}")
        del qw, impact, mask, v, i, pv, pi
    return worst


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


def build_corpus(np, n_docs, vocab, seed):
    """bench.py::build_corpus's recipe: ~60-token passages, Zipf(1.15)
    vocabulary, term-major postings CSR with BM25 tf-normalization."""
    k1, b = 1.2, 0.75
    rng = np.random.default_rng(seed)
    doc_len = np.clip(rng.normal(60, 15, n_docs), 20, 120).astype(np.int64)
    nnz_tok = int(doc_len.sum())
    terms = rng.zipf(1.15, nnz_tok).astype(np.int64)
    terms = np.where(terms >= vocab, rng.integers(1, vocab, nnz_tok), terms)
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


def make_queries(np, n_q, vocab, df, seed, terms_per_q=4):
    """bench.py::make_queries's recipe: 2-4 Zipf(1.3) term ids each."""
    rng = np.random.default_rng(seed + 1)
    qs = []
    for _ in range(n_q):
        npick = rng.integers(2, terms_per_q + 1)
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


def phase_read(torch, np, dev, card):
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import bm25_topk
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    u_doc, tf, tfn, offsets, df, cf, doc_len = build_corpus(
        np, N_DOCS, VOCAB, SEED)
    D = N_DOCS  # pow2_bucket(2^20) == 2^20
    lengths = np.zeros(D, np.float32)
    lengths[:N_DOCS] = doc_len
    arrays = {"num_docs": N_DOCS, "max_docs": D, "fields": {"body": {
        "terms": [f"t{t}" for t in range(VOCAB)], "df": df, "cf": cf,
        "offsets": offsets, "doc_ids_host": u_doc, "tfnorm_host": tfn,
        "tf_host": tf, "avg_len": float(doc_len.mean()),
        "num_docs": N_DOCS, "total_terms": int(doc_len.sum()),
        "lengths": lengths}}}
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
    profile_read(torch, node, bodies, float(ms.sum()))
    node.close()
    return launches


def _p50(np, ms) -> str:
    return f"{np.percentile(ms, 50):.3f} ms" if ms.size else "no queries"


def profile_read(torch, node, bodies, wall_ms):
    """Device time of the same searches under torch.profiler, over the
    host time of the unprofiled run: the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for body in bodies:
            node.search("msmarco", dict(body))
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0:
        log("[read] device busy share: not measured (the profiler "
            "recorded no device time)")
        return
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[read] device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms host "
        f"time ({100 * busy_ms / wall_ms:.1f}% busy); top device time: "
        + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                    f" x{e.count}" for e in top))


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
    torch.profiler: the call time without the host's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def phase_timing(torch, dev, card):
    from elasticsearch_tpu_torch.ops.bm25_topk import bm25_dense_topk

    out = {}
    for label, (Q, F, D, k) in (("single", (1, 8, 1 << 20, 10)),
                                ("batched", (256, 256, 1 << 20, 10))):
        in_bytes = Q * F * 4 + F * D * 4 + D
        # rotate input copies past the 50 MB L2, so each launch reads
        # its impact rows from device memory, as a query's fresh gather
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
        out_bytes = Q * k * 8
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * Q * F * D / BF16_FLOP_PER_S * 1e3
        out[label] = {"ms": kern, "plain_ms": plain, "library_ms": library,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations"}
        log(f"[timing] bm25_dense_topk {label} Q={Q} F={F} D={D} k={k} on "
            f"{card}: kernel {kern:.4f} ms, plain {plain:.4f} ms, library "
            f"(bf16 matmul + topk) {library:.4f} ms, bound "
            f"{out[label]['bound_ms']:.4f} ms ({out[label]['bound_by']}); "
            f"device time per call: kernel {kern_dev:.4f} ms, library "
            f"{lib_dev:.4f} ms")
        del bufs
        torch.cuda.empty_cache()
    return out


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
    launches = phase_read(torch, np, dev, card)
    timing = phase_timing(torch, dev, card)
    single = timing["single"]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "bm25_dense_topk", "route": "cuda",
        "source": "elasticsearch_tpu_torch/csrc/bm25_dense_topk.cu",
        "replaces": "elasticsearch_tpu/ops/pallas_kernels.py:150",
        "launches": launches, "max_abs_err": err, **single}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
