"""``ops/knn.py::knn_topk_chunked`` (B2 chunk by chunk with a running
top-k) against the reference's on the CPU, where B2 runs its plain twin.

In f32 (``use_bf16=False``) the ids equal the reference's and the scores
agree at rtol 1e-5 (the B2 parity bar); in both modes the chunked answer
equals the port's one-launch ``knn_topk`` exactly, ties included (the
lower doc id first, as ``lax.top_k`` keeps it)."""
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import knn as ref_knn
from elasticsearch_tpu_torch.ops.knn import knn_topk, knn_topk_chunked

from _torch_parity import clustered


@pytest.mark.parametrize("metric", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("k, chunk", [(10, 256), (40, 128), (300, 256)])
def test_chunked_matches_the_reference_and_one_launch(metric, k, chunk):
    D = 1024
    vecs = clustered(D, 32, 9, seed=4)
    vecs[500:520] = vecs[100]  # exact ties across chunks
    if metric == "dot_product":
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    mask = np.random.default_rng(5).random(D) > 0.2
    qs = np.concatenate([vecs[[100, 7]], clustered(3, 32, 2, seed=8)])
    tq, tv, tm = (torch.from_numpy(qs), torch.from_numpy(vecs),
                  torch.from_numpy(mask))
    rv, ri = ref_knn.knn_topk_chunked(qs, vecs, mask, k=k, metric=metric,
                                      chunk=chunk, use_bf16=False)
    pv, pi = knn_topk_chunked(tq, tv, tm, k=k, metric=metric, chunk=chunk,
                              use_bf16=False)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-5)
    for bf16 in (False, True):
        cv, ci = knn_topk_chunked(tq, tv, tm, k=k, metric=metric,
                                  chunk=chunk, use_bf16=bf16)
        ov, oi = knn_topk(tq, tv, tm, k=k, metric=metric, precise=not bf16)
        assert torch.equal(ci, oi) and torch.equal(cv, ov)


def test_chunk_must_divide_the_slab():
    v = torch.zeros(100, 4)
    with pytest.raises(ValueError):
        knn_topk_chunked(v[:2], v, torch.ones(100, dtype=torch.bool), k=5,
                         chunk=64)
