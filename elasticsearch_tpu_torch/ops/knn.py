"""Dense-vector kNN ops: similarity scores and the fused top-k.

Port of elasticsearch_tpu/ops/knn.py. ``knn_scores`` is the plain
similarity of a query block against a (small) candidate slab, used by the
IVF stages to score the vectors they gathered. ``knn_topk`` is the
brute-force top-k: kernel B2 (``ops/knn_topk.py``) on a CUDA tensor, its
plain twin on a CPU tensor, with no shape gate. ``exact_rescore_topk``
and ``merge_candidate_topk`` are the two stages the mesh's vector rounds
run after B2 (``parallel/executor.py``). ``knn_topk_chunked`` runs B2
over a slab chunk by chunk with a running top-k (the reference's API for
a slab too large for one [Q, D] score block; nothing in the port calls
it).

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


NEG_INF = float("-inf")


def exact_rescore_topk(queries: torch.Tensor, vecs: torch.Tensor,
                       vals: torch.Tensor, idx: torch.Tensor, *,
                       metric: str = "cosine"):
    """f32 re-rank of a bf16 candidate sweep (the reference's
    ``ops/knn.py::exact_rescore_topk``): gather the [Q, k] candidates,
    score them in f32 and re-sort each row by (-score, position).
    Invalid candidates (vals == -inf) stay -inf and sort last; their ids
    are clamped into the slab for the gather and never read back."""
    D = vecs.shape[0]
    safe = torch.clamp(idx.to(torch.int64), 0, D - 1)
    cand = vecs.to(torch.float32)[safe]  # [Q, k, dims]
    q = queries.to(torch.float32)
    if metric == "cosine":
        qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                      keepdim=True),
                             min=1e-12)
        cn = cand / torch.clamp(torch.linalg.vector_norm(cand, dim=-1,
                                                         keepdim=True),
                                min=1e-12)
        s = (1.0 + torch.einsum("qd,qkd->qk", qn, cn)) * 0.5
    elif metric in ("dot_product", "dot"):
        s = (1.0 + torch.einsum("qd,qkd->qk", q, cand)) * 0.5
    elif metric in ("l2_norm", "l2"):
        d2 = torch.sum((q[:, None, :] - cand) ** 2, dim=-1)
        s = 1.0 / (1.0 + d2)
    else:
        raise ValueError(f"unknown knn metric [{metric}]")
    s = torch.where(vals > NEG_INF, s, torch.full_like(s, NEG_INF))
    new_v, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return new_v, torch.gather(idx, 1, pos).to(torch.int32)


def merge_candidate_topk(vals: torch.Tensor, ids: torch.Tensor, *, k: int):
    """Per-row dedup-by-max + top-k over candidate (score, id) pairs (the
    reference's ``ops/knn.py::merge_candidate_topk``).

    vals f32[Q, N], ids i32[Q, N] (ids repeat when several query tokens
    surface the same doc; invalid slots carry -inf). Returns ([Q, k]
    vals, [Q, k] i32 ids, i32[Q] unique-valid counts). Pairs sort by (id
    ascending, score descending), so the first occurrence of an id is its
    max; later ones are masked to -inf; then a stable top-k, so equal
    scores rank by ascending doc id (``lax.top_k``'s rule over a dense
    score row)."""
    width = vals.shape[1]
    if k > width:
        raise ValueError(f"k [{k}] exceeds candidate width [{width}]")
    by_val = torch.sort(vals, dim=1, descending=True, stable=True).indices
    v1 = torch.gather(vals, 1, by_val)
    i1 = torch.gather(ids, 1, by_val)
    by_id = torch.sort(i1, dim=1, stable=True).indices
    sid = torch.gather(i1, 1, by_id)
    sval = torch.gather(v1, 1, by_id)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    valid = first & (sval > NEG_INF)
    n_unique = valid.sum(1, dtype=torch.int32)
    sel = torch.where(valid, sval, torch.full_like(sval, NEG_INF))
    best_v, pos = torch.sort(sel, dim=1, descending=True, stable=True)
    best_v, pos = best_v[:, :k], pos[:, :k]
    return best_v, torch.gather(sid, 1, pos).to(torch.int32), n_unique


def knn_topk_chunked(queries: torch.Tensor, vecs: torch.Tensor,
                     mask: torch.Tensor, *, k: int, metric: str = "cosine",
                     chunk: int = 1 << 16, use_bf16: bool = True,
                     plain: bool = False):
    """Top-k over ``vecs`` [D, dims] taken ``chunk`` rows at a time (D a
    multiple of ``chunk``): B2 (its twin on the CPU, or with ``plain``)
    on each chunk, merged into the running top-k by a stable sort of
    [best, chunk's], so equal scores keep the lower doc id as
    ``lax.top_k`` does. ``use_bf16`` False scores in f32 (B2's
    ``precise``). Returns (f32[Q, k] scores, i32[Q, k] ids)."""
    D = vecs.shape[0]
    if D % chunk != 0:
        raise ValueError("corpus rows must be padded to a multiple of chunk")
    Q = queries.shape[0]
    best_v = torch.full((Q, k), NEG_INF, dtype=torch.float32,
                        device=queries.device)
    best_i = torch.zeros((Q, k), dtype=torch.int32, device=queries.device)
    for s in range(0, D, chunk):
        cv, ci = knn_topk(queries, vecs[s:s + chunk], mask[s:s + chunk],
                          k=min(k, chunk), metric=metric,
                          precise=not use_bf16, plain=plain)
        mv = torch.cat([best_v, cv], dim=1)
        mi = torch.cat([best_i, ci + s], dim=1)
        best_v, pos = torch.sort(mv, dim=1, descending=True, stable=True)
        best_v = best_v[:, :k].contiguous()
        best_i = torch.gather(mi, 1, pos[:, :k]).contiguous()
    return best_v, best_i
