"""The resident embedding index and its global top-k query (one GPU; the
collectives over several are not ported yet)."""

from rag_docvqa_tpu_torch.parallel.index import ShardedIndex, sharded_maxsim_topk, single_device_query

__all__ = ["ShardedIndex", "sharded_maxsim_topk", "single_device_query"]
