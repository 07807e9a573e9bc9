"""Models: the dual encoder for dense-retrieval embeddings.

Port of elasticsearch_tpu/models/__init__.py. The reference installs its
retrace auditor before any jit binds; the port's first-touch counter
(``tracing/retrace.py``) needs no installing, and the encoders and the
train step record their first dispatches in it.
"""
from elasticsearch_tpu_torch.tracing import retrace as _retrace

_retrace.ensure_installed()

from elasticsearch_tpu_torch.models.dual_encoder import (  # noqa: E402
    DualEncoder,
    DualEncoderConfig,
    SimpleTokenizer,
    batch_sharding,
    build_model,
    contrastive_loss,
    encode,
    init_params,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    param_shardings,
    params_from_flax,
    params_to_flax,
    save_checkpoint,
)

__all__ = [
    "DualEncoder", "DualEncoderConfig", "SimpleTokenizer", "batch_sharding",
    "build_model", "contrastive_loss", "encode", "init_params",
    "load_checkpoint", "make_optimizer", "make_train_step",
    "param_shardings", "params_from_flax", "params_to_flax",
    "save_checkpoint",
]
