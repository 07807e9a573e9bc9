"""Entry points of the port's models: a forward check and a dry run.

Port of ``__graft_entry__.py``. ``entry()`` gives the flagship dual
encoder's forward (query and passage embeddings, the model behind
`dense_vector` hybrid search) with example inputs.

``dryrun(n, device)`` runs the reference's three multi-chip programs
over the devices of ``device`` (``utils/device.py::resolve_devices``:
every visible card by default, ``"cpu"`` only when asked, or a list
that may name one device several times), n positions each laid over
``min(n, len(devices))`` of them (``parallel/mesh.py``):

1. one contrastive train step under ``training_mesh(n, devices)``, the
   parameters tensor-parallel and the batch two rows a 'dp' group
   (``models/mesh_step.py``);
2. the ring-attention encode over ``build_sp_mesh(n, devices)``, held
   against the dense encode;
3. a distributed search round: an index of n shards on a ``Node`` over
   the devices, through the mesh executor (one BM25 query and one kNN
   batch), held against the host loop.

Both run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import os
import random

import numpy as np


def _small_cfg(max_len: int = 32):
    from elasticsearch_tpu_torch.models import DualEncoderConfig

    return DualEncoderConfig(
        vocab_size=512, max_len=max_len, d_model=64, n_heads=4,
        n_layers=2, d_ff=128, embed_dim=32)


def entry(device=None):
    """(fn, example_args): ``fn(model, token_ids, attn_mask) -> f32[B, E]``
    on the model's device."""
    import torch

    from elasticsearch_tpu_torch.models import encode, init_params

    cfg = _small_cfg()
    model = init_params(cfg, device=device)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                       size=(8, cfg.max_len)),
                          device=model.device)
    mask = torch.ones((8, cfg.max_len), device=model.device)
    return encode, (model, ids, mask)


def dryrun(n_devices: int, device=None) -> None:
    """The three programs over ``n_devices`` positions; raises on a
    failed check."""
    from elasticsearch_tpu_torch.models import make_train_step
    from elasticsearch_tpu_torch.parallel.mesh import training_mesh
    from elasticsearch_tpu_torch.utils.device import resolve_devices

    devices = resolve_devices(device)
    cfg = _small_cfg(max_len=16)
    mesh = training_mesh(n_devices, device=devices)
    step, _opt = make_train_step(cfg, mesh=mesh)

    # the batch must divide dp: two rows a dp group
    B = 2 * mesh.dp
    rng = np.random.default_rng(0)

    def mk_ids():
        return rng.integers(1, cfg.vocab_size, size=(B, cfg.max_len))

    mask = np.ones((B, cfg.max_len), np.float32)
    loss = float(step(mk_ids(), mask, mk_ids(), mask))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    print(f"dryrun(n={n_devices}): mesh={mesh.shape} B={B} "
          f"loss={loss:.4f} over {min(n_devices, len(devices))} mesh "
          f"devices of [{', '.join(map(str, devices))}] ok")
    _dryrun_ring_encode(n_devices, devices)
    _dryrun_distributed_search(n_devices, devices)


def _dryrun_ring_encode(n_devices: int, devices) -> None:
    """The ring encode over n sequence slots on the devices against the
    dense encode of the same parameters."""
    from elasticsearch_tpu_torch.models import encode, init_params
    from elasticsearch_tpu_torch.models.ring_encoder import (build_sp_mesh,
                                                             ring_encode)

    cfg = _small_cfg(max_len=8 * n_devices)
    mesh = build_sp_mesh(n_devices, devices)
    model = init_params(cfg, seed=1, device=mesh.device)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, cfg.vocab_size, size=(2, cfg.max_len))
    mask = np.ones((2, cfg.max_len), np.float32)
    mask[1, cfg.max_len // 2:] = 0.0
    ring = ring_encode(cfg, model, ids, mask, mesh).cpu().numpy()
    dense = encode(model, ids, mask).cpu().numpy()
    cos = np.sum(ring * dense, axis=-1)
    if not np.all(cos > 0.999):
        raise AssertionError(f"sp ring encode diverged from dense: {cos}")
    print(f"sp ring encode: mesh=(sp={n_devices}) over {mesh.n_devices} "
          f"mesh devices L={cfg.max_len} cos_vs_dense={cos.min():.5f} ok")


def _dryrun_distributed_search(n_devices: int, devices) -> None:
    """One BM25 round and one kNN round through the mesh executor over n
    shards on a node over the devices, the BM25 round against the host
    loop."""
    from elasticsearch_tpu_torch.monitor import kernels
    from elasticsearch_tpu_torch.node import Node

    node = Node(name="dryrun", device=list(devices))
    try:
        node.create_index("dr", {
            "settings": {"number_of_shards": n_devices},
            "mappings": {"properties": {
                "body": {"type": "text"},
                "emb": {"type": "dense_vector", "dims": 8}}}})
        svc = node.indices["dr"]
        rng = random.Random(7)
        words = ["alpha", "beta", "gamma", "delta", "fox", "dog"]
        for i in range(16 * n_devices):
            svc.index_doc(str(i), {
                "body": " ".join(rng.choices(words, k=5)),
                "emb": [rng.random() for _ in range(8)]})
        svc.refresh()
        ex = svc.mesh_executor()
        if ex.S != n_devices:
            raise AssertionError(f"{ex.S} slots for {n_devices} shards")

        body = {"query": {"match": {"body": "fox delta"}}, "size": 5}
        kernels.reset()
        r = node.search("dr", dict(body))
        if kernels.snapshot().get("mesh_search", 0) != 1:
            raise AssertionError(f"the mesh did not serve the round: "
                                 f"{kernels.snapshot()}")
        top = [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]
        if not (r["hits"]["total"] > 0 and top):
            raise AssertionError(f"an empty round: {r}")

        os.environ["ESTPU_DISABLE_MESH"] = "1"
        try:
            r_host = node.search("dr", dict(body))
        finally:
            del os.environ["ESTPU_DISABLE_MESH"]
        host_top = [(h["_id"], h["_score"]) for h in r_host["hits"]["hits"]]
        if [i for i, _ in top] != [i for i, _ in host_top] or any(
                abs(a - b) >= 1e-5 for (_, a), (_, b) in zip(top, host_top)):
            raise AssertionError(f"mesh {top} against host loop {host_top}")

        qs = np.asarray([[rng.random() for _ in range(8)] for _ in range(4)],
                        np.float32)
        vals = ex.search_knn("emb", qs, k=3)[0]
        if vals.shape != (4, 3) or not np.isfinite(vals).all():
            raise AssertionError(f"kNN round: {vals}")
        print(f"distributed search round: shards={n_devices} over "
              f"{ex.n_devices} mesh devices "
              f"total={r['hits']['total']} "
              f"top={[(i, round(s, 4)) for i, s in top[:3]]} "
              f"knn_merged_shape={vals.shape} ok")
    finally:
        node.close()
