"""elasticsearch_tpu_torch — the PyTorch/CUDA port of elasticsearch_tpu.

The JAX package stays as the reference; this package reproduces it with
PyTorch tensors and hand-written CUDA kernels for Hopper. Module paths
mirror the reference's. It imports neither ``jax`` nor anything of the
JAX package.

Public entry point:
    from elasticsearch_tpu_torch import Node
"""

__version__ = "0.1.0"

__all__ = ["Node", "__version__"]


def __getattr__(name):  # lazy: keep the root import light
    if name == "Node":
        from elasticsearch_tpu_torch.node import Node

        return Node
    raise AttributeError(name)
