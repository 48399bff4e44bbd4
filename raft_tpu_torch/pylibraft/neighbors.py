"""pylibraft.neighbors facade — the port of
``raft_tpu/pylibraft/neighbors.py``: brute-force and IVF entry points
shaped like the reference's Python neighbors API (pylibraft 22.10+
neighbors.ivf_pq / brute_force; 22.06 exposes kNN through C++ and
pyraft). Builds and searches run on the handle's device.
"""

from __future__ import annotations

from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.pylibraft.common import _place
from raft_tpu_torch.spatial import brute_force_knn as _bfknn
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams, IVFPQParams, ivf_flat_build, ivf_flat_search,
    ivf_pq_build, ivf_pq_search,
)

__all__ = ["brute_force", "ivf_flat", "ivf_pq"]


class brute_force:
    @staticmethod
    def knn(dataset, queries, k: int, metric: str = "l2", handle=None):
        return _bfknn(_place(dataset, handle), _place(queries, handle), k,
                      metric=metric)


class ivf_flat:
    IndexParams = IVFFlatParams

    @staticmethod
    def build(dataset, params: IVFFlatParams = IVFFlatParams(), handle=None):
        return ivf_flat_build(_place(dataset, handle), params,
                              device=ensure_resources(handle).device)

    @staticmethod
    def search(index, queries, k: int, n_probes: int = 8, handle=None):
        return ivf_flat_search(index, _place(queries, handle), k,
                               n_probes=n_probes)


class ivf_pq:
    IndexParams = IVFPQParams

    @staticmethod
    def build(dataset, params: IVFPQParams = IVFPQParams(), handle=None):
        return ivf_pq_build(_place(dataset, handle), params,
                            device=ensure_resources(handle).device)

    @staticmethod
    def search(index, queries, k: int, n_probes: int = 8, handle=None):
        return ivf_pq_search(index, _place(queries, handle), k,
                             n_probes=n_probes)
