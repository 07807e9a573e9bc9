"""Distributed execution on one card: the shard and training meshes as
slots of the device, the mesh programs, placement.

Port of elasticsearch_tpu/parallel/__init__.py's mesh exports.
"""
from elasticsearch_tpu_torch.parallel.mesh import (
    ShardMesh, TrainingMesh, mesh_size, shard_mesh, training_mesh)

__all__ = ["ShardMesh", "TrainingMesh", "mesh_size", "shard_mesh",
           "training_mesh"]
