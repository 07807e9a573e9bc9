"""Dense-vector kNN ops: similarity scores and the fused top-k.

Port of elasticsearch_tpu/ops/knn.py. ``knn_scores`` is the plain
similarity of a query block against a (small) candidate slab, used by the
IVF stages to score the vectors they gathered. ``knn_topk`` is the
brute-force top-k: kernel B2 (``ops/knn_topk.py``) on a CUDA tensor, its
plain twin on a CPU tensor, with no shape gate.

Scores follow ES dense_vector ``similarity``:
  cosine:      (1 + cos) / 2
  dot_product: (1 + dot) / 2   (vectors assumed unit-norm)
  l2_norm:     1 / (1 + l2^2)
"""
from __future__ import annotations

import torch

# the brute-force top-k is kernel B2's wrapper itself (ops/knn_topk.py):
# the kernel on a CUDA tensor, the plain twin on a CPU tensor
from elasticsearch_tpu_torch.ops.knn_topk import knn_topk  # noqa: F401


def knn_scores(queries: torch.Tensor, vecs: torch.Tensor, *,
               metric: str = "cosine") -> torch.Tensor:
    """Similarity scores f32[Q, D] between queries [Q, dims] and vecs
    [D, dims] in f32: the reference's ``use_bf16=False`` form (HIGHEST
    precision), which is the only one its callers on this path use. On
    the card the product runs in f32 as long as
    ``torch.backends.cuda.matmul.allow_tf32`` stays False, its default."""
    q = queries.to(torch.float32)
    v = vecs.to(torch.float32)
    if metric == "cosine":
        qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                             min=1e-12)
        vn = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                             min=1e-12)
        return (1.0 + qn @ vn.T) * 0.5
    if metric in ("dot_product", "dot"):
        return (1.0 + q @ v.T) * 0.5
    if metric in ("l2_norm", "l2"):
        q2 = torch.sum(q * q, dim=-1, keepdim=True)
        v2 = torch.sum(v * v, dim=-1)[None, :]
        d2 = torch.clamp(q2 - 2.0 * (q @ v.T) + v2, min=0.0)
        return 1.0 / (1.0 + d2)
    raise ValueError(f"unknown knn metric [{metric}]")
