"""elasticsearch_tpu_torch — the PyTorch/CUDA port of elasticsearch_tpu.

The JAX package stays as the reference; this package reproduces it with
PyTorch tensors and hand-written CUDA kernels for Hopper. Module paths
mirror the reference's. It imports neither ``jax`` nor anything of the
JAX package.

Public entry points:
    from elasticsearch_tpu_torch import Node, Client
    python -m elasticsearch_tpu_torch.server --port 9200
"""

__version__ = "0.1.0"

__all__ = ["Node", "Client", "__version__"]


def __getattr__(name):  # lazy: keep the root import light
    if name == "Node":
        from elasticsearch_tpu_torch.node import Node

        return Node
    if name == "Client":
        from elasticsearch_tpu_torch.client import Client

        return Client
    raise AttributeError(name)
