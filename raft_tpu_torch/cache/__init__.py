"""Vector cache — the port of ``raft_tpu/cache`` (analog of raft/cache,
cpp/include/raft/cache/cache_util.cuh:45-334)."""

from raft_tpu_torch.cache.cache import VectorCache

__all__ = ["VectorCache"]
