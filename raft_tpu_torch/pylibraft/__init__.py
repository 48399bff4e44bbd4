"""pylibraft-shaped facade — the port of ``raft_tpu/pylibraft``: signature
parity with the reference Python API (python/pylibraft/pylibraft/:
common.Handle, distance.pairwise_distance; python/raft/raft/: Handle /
Stream — SURVEY.md §2 #44-45).

Where pylibraft accepts any ``__cuda_array_interface__`` object and
writes into a preallocated output, this facade accepts anything
``torch.as_tensor`` takes (numpy arrays, tensors,
``__cuda_array_interface__`` objects), places it on the handle's device
(the default handle's: CUDA, raising without one), and returns the
result.
"""

from raft_tpu_torch.pylibraft.common import DeviceResources, Handle, Stream
from raft_tpu_torch.pylibraft import cluster, distance, neighbors

__all__ = [
    "Handle",
    "Stream",
    "DeviceResources",
    "distance",
    "cluster",
    "neighbors",
]
