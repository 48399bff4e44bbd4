"""pylibraft.distance facade — the port of
``raft_tpu/pylibraft/distance.py``: signature parity with
python/pylibraft/pylibraft/distance/pairwise_distance.pyx:91-192
(``distance(X, Y, dists, metric)``) and fused_l2_nn_argmin.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.distance import fused_l2_nn_argmin as _fused_argmin
from raft_tpu_torch.distance import pairwise_distance as _pairwise
from raft_tpu_torch.distance.distance_type import DISTANCE_NAMES
from raft_tpu_torch.pylibraft.common import _place

__all__ = ["SUPPORTED_DISTANCES", "distance", "fused_l2_nn_argmin",
           "pairwise_distance"]

#: metric names accepted by the reference pyx (pairwise_distance.pyx:35-60)
SUPPORTED_DISTANCES = sorted(DISTANCE_NAMES)


def pairwise_distance(X, Y, out=None, metric: str = "euclidean",
                      p: float = 2.0, handle=None):
    """All-pairs distances (reference pairwise_distance.pyx:91), on the
    handle's device. ``out``: when a tensor, the result is copied into
    it; when a writeable numpy array, written into it. The result is
    always returned."""
    d = _pairwise(_place(X, handle), _place(Y, handle), metric, p=p)
    if isinstance(out, torch.Tensor):
        out.copy_(d)
    elif out is not None:
        view = np.asarray(out)
        if view.flags.writeable:
            view[...] = d.cpu().numpy()
    return d


distance = pairwise_distance  # reference exposes both spellings


def fused_l2_nn_argmin(X, Y, handle=None):
    """Nearest-row index under L2 (pylibraft 22.08 fused_l2_nn_argmin)."""
    return _fused_argmin(_place(X, handle), _place(Y, handle))
