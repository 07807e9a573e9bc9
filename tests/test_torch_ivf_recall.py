"""IVF-PQ recall of the port's build against the reference's, on one
seeded slab of ``bench.py::make_sift_node``'s recipe (ROADMAP C4).

Phase 5b on the card measures recall@10 0.92 over 1,000,000 vectors in
256 Gaussian clusters, with C = 4000 lists, num_candidates 10,000 (40
probed lists) and the fine re-rank of the top 128 (M = 32, K = 256).
The slab here keeps what sets that recall and scales the rest for the
CPU: 50,000 vectors in 13 clusters keep about 3,900 vectors a cluster;
C = 200 keeps 250 vectors a list (about 15 lists a cluster); 40 probed
lists keep num_candidates 10,000 and the 128-of-10,000 re-rank. Both
packages build IVF and PQ from the same slab and answer the same 64
queries (corpus points plus 0.1 noise); the port's recall must not be
lower than the reference's by more than 1/64 (ten of the 640 true
neighbours).
"""
import numpy as np
import torch

from elasticsearch_tpu import resources as ref_resources
from elasticsearch_tpu.ops import pq as ref_pq
from elasticsearch_tpu.ops.ivf import build_ivf as ref_build_ivf
from elasticsearch_tpu.ops.ivf import \
    ivf_candidate_scores as ref_candidate_scores
from elasticsearch_tpu.resources.breakers import \
    CircuitBreakerService as RefBreakers
from elasticsearch_tpu.resources.residency import ResidencyRegistry
from elasticsearch_tpu_torch.ops.ivf import build_ivf, ivf_candidate_scores
from elasticsearch_tpu_torch.ops.pq import build_pq, place_pq
from elasticsearch_tpu_torch.resources.residency import Residency

N, DIMS, CLUSTERS, LISTS, NPROBE, FINE_K, QUERIES = \
    50_000, 128, 13, 200, 40, 128, 64


def _slab(seed):
    """make_sift_node's recipe (Gaussian centres, unit noise, from
    ``seed + 7``) with CLUSTERS centres, and its queries (``seed + 3``)."""
    rng = np.random.default_rng(seed + 7)
    cents = rng.standard_normal((CLUSTERS, DIMS)).astype(np.float32)
    assign = rng.integers(0, CLUSTERS, N)
    vecs = cents[assign] + rng.standard_normal((N, DIMS)).astype(np.float32)
    D = 1 << (N - 1).bit_length()
    vpad = np.zeros((D, DIMS), np.float32)
    vpad[:N] = vecs
    exists = np.zeros(D, bool)
    exists[:N] = True
    qrng = np.random.default_rng(seed + 3)
    idx = qrng.integers(0, N, QUERIES)
    qs = vecs[idx] + 0.1 * qrng.standard_normal((QUERIES, DIMS)).astype(
        np.float32)
    return vpad, exists, D, qs


def _top10(scores, mask):
    s = np.array(scores, np.float32)
    s[~np.asarray(mask)] = -np.inf
    return set(np.argsort(-s, kind="stable")[:10].tolist())


def test_port_ivf_pq_recall_equals_the_reference(monkeypatch):
    import jax

    svc = RefBreakers(capacity=1 << 32)
    monkeypatch.setattr(ref_resources, "BREAKERS", svc)
    monkeypatch.setattr(ref_resources, "RESIDENCY", ResidencyRegistry(svc))
    vpad, exists, D, qs = _slab(0)
    ref_ivf = ref_build_ivf(vpad, exists, D, C=LISTS)
    ref_codes = ref_pq.place_pq(ref_pq.build_pq(vpad, exists, "cosine"),
                                label="c4")
    tv, te = torch.from_numpy(vpad), torch.from_numpy(exists)
    ivf = build_ivf(tv, te, D, C=LISTS)
    codes = place_pq(build_pq(tv, te, "cosine"),
                     Residency(torch.device("cpu")), label="c4")
    assert (ref_codes.M, ref_codes.K) == (codes.M, codes.K) == (32, 256)
    nc = NPROBE * N // LISTS
    assert ivf.nprobe_for(nc) == ref_ivf.nprobe_for(nc) == NPROBE
    vn = vpad.astype(np.float64)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
    dv = jax.device_put(vpad)
    ref_hits = port_hits = 0
    for q in qs:
        exact = vn @ (q / np.linalg.norm(q)).astype(np.float64)
        exact[~exists] = -np.inf
        want = set(np.argsort(-exact, kind="stable")[:10].tolist())
        ref_hits += len(want & _top10(*ref_candidate_scores(
            ref_ivf, dv, q, nc, "cosine", D, pq=ref_codes, fine_k=FINE_K)))
        s, m = ivf_candidate_scores(ivf, tv, q, nc, "cosine", D, pq=codes,
                                    fine_k=FINE_K)
        port_hits += len(want & _top10(s.numpy(), m.numpy()))
    ref_recall = ref_hits / (10 * QUERIES)
    port_recall = port_hits / (10 * QUERIES)
    print(f"recall@10 over {QUERIES} queries: reference {ref_recall}, "
          f"port {port_recall}")
    # the regime of the card's 0.92: the re-rank loses true neighbours
    assert ref_recall < 1.0
    assert port_recall >= ref_recall - 1 / QUERIES, (port_recall, ref_recall)
