"""Approximate nearest-neighbour indexes of the port (IVF-Flat)."""

from raft_tpu_torch.spatial.ann.interop import (
    ivf_flat_index_from_arrays,
    load_ivf_flat,
)
from raft_tpu_torch.spatial.ann.ivf_flat import (
    IVFFlatIndex,
    IVFFlatParams,
    ivf_flat_build,
    ivf_flat_search,
    ivf_flat_search_grouped,
)

__all__ = [
    "IVFFlatIndex", "IVFFlatParams", "ivf_flat_build",
    "ivf_flat_index_from_arrays", "ivf_flat_search",
    "ivf_flat_search_grouped", "load_ivf_flat",
]
