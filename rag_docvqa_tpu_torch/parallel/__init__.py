"""Multi-device parallelism: process-group meshes over `torch.distributed`,
the sharded embedding index and the sharded MaxSim collective."""

from rag_docvqa_tpu_torch.parallel.index import ShardedIndex, sharded_maxsim_topk, single_device_query
from rag_docvqa_tpu_torch.parallel.mesh import Mesh, create_mesh, default_mesh

__all__ = ["Mesh", "create_mesh", "default_mesh", "ShardedIndex", "sharded_maxsim_topk", "single_device_query"]
