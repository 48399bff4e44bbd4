"""Generic ANN entry points — the port of ``raft_tpu/spatial/ann/approx.py``,
the analog of the reference's ``approx_knn_build_index`` /
``approx_knn_search`` (cpp/include/raft/spatial/knn/detail/
ann_quantized_faiss.cuh:115-206), which dispatch on the dynamic type of
the ``knnIndexParam`` subclass. The dispatch key is the params dataclass
type at build and the index type at search, with the JAX package's
tables: IVF-SQ has no throughput path, so its searches stay per-query.
"""

from __future__ import annotations

import inspect
from typing import Tuple

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.spatial.ann.ivf_flat import (
    IVFFlatIndex, IVFFlatParams, ivf_flat_build, ivf_flat_search,
    ivf_flat_search_grouped,
)
from raft_tpu_torch.spatial.ann.ivf_pq import (
    IVFPQIndex, IVFPQParams, ivf_pq_build, ivf_pq_search,
    ivf_pq_search_grouped,
)
from raft_tpu_torch.spatial.ann.ivf_sq import (
    IVFSQIndex, IVFSQParams, ivf_sq_build, ivf_sq_search,
)

__all__ = ["approx_knn_build_index", "approx_knn_search"]

_BUILDERS = {
    IVFFlatParams: ivf_flat_build,
    IVFPQParams: ivf_pq_build,
    IVFSQParams: ivf_sq_build,
}

# (per-query latency path, grouped throughput path or None)
_SEARCHERS = {
    IVFFlatIndex: (ivf_flat_search, ivf_flat_search_grouped),
    IVFPQIndex: (ivf_pq_search, ivf_pq_search_grouped),
    IVFSQIndex: (ivf_sq_search, None),
}

# queries at or above which "auto" takes the grouped path
_AUTO_THROUGHPUT_NQ = 1024


def approx_knn_build_index(x, params, *, device=None):
    """Build the ANN index selected by the dynamic params type (reference
    approx_knn_build_index:115). ``device``: where array input goes
    (CUDA by default), as the builders take it."""
    builder = _BUILDERS.get(type(params))
    errors.expects(
        builder is not None,
        "approx_knn_build_index: unknown params type %s (expected one of %s)",
        type(params).__name__, sorted(c.__name__ for c in _BUILDERS),
    )
    return builder(x, params, device=device)


def _params(fn):
    # the searches keep functools.wraps on their decorators, so unwrap
    # reaches the signature of the function itself
    return inspect.signature(
        inspect.unwrap(getattr(fn, "__wrapped__", fn))).parameters


def approx_knn_search(
    index, queries, k: int, *, n_probes: int = 8, mode: str = "auto",
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search any ANN index (reference approx_knn_search:169).

    ``mode``: "latency" (per-query path), "throughput" (grouped
    list-major path where the index family has one), or "auto" —
    throughput at 1,024 queries or more. A kwarg no path of the index
    accepts raises; one only the other mode's path accepts is dropped
    and logged (``raft_tpu_torch.core.logger``)."""
    entry = _SEARCHERS.get(type(index))
    errors.expects(
        entry is not None,
        "approx_knn_search: unknown index type %s (expected one of %s)",
        type(index).__name__, sorted(c.__name__ for c in _SEARCHERS),
    )
    errors.expects(
        mode in ("auto", "latency", "throughput"),
        "approx_knn_search: unknown mode %r", mode,
    )
    per_query, grouped = entry
    nq = queries.shape[0]

    known = set(_params(per_query))
    if grouped is not None:
        known |= set(_params(grouped))
    unknown = sorted(set(kw) - known)
    errors.expects(
        not unknown,
        "approx_knn_search: unknown kwarg(s) %s (no search path accepts "
        "them; valid tuning kwargs: %s)",
        ", ".join(unknown),
        ", ".join(sorted(known - {"index", "queries", "k"})),
    )

    def call(fn):
        params = _params(fn)
        dropped = sorted(n for n in kw if n not in params)
        if dropped:
            from raft_tpu_torch.core import logger

            logger.info(
                "approx_knn_search: kwarg(s) %s apply to the other search "
                "mode and were ignored by the selected path",
                ", ".join(dropped),
            )
        return fn(
            index, queries, k, n_probes=n_probes,
            **{n: v for n, v in kw.items() if n in params},
        )

    if mode == "throughput" or (mode == "auto"
                                and nq >= _AUTO_THROUGHPUT_NQ):
        errors.expects(
            grouped is not None or mode == "auto",
            "approx_knn_search: %s has no throughput (grouped) path",
            type(index).__name__,
        )
        if grouped is not None:
            return call(grouped)
    return call(per_query)
