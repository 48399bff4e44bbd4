"""Random ball cover — the port of ``raft_tpu/spatial/ann/ball_cover.py``,
the analog of cpp/include/raft/spatial/knn/ball_cover.cuh:34-144
(``BallCoverIndex`` ball_cover_common.h:38-90, rbc_build_index /
rbc_knn_query / rbc_all_knn_query).

Build: √n landmarks by default, every point assigned to its closest
landmark (its "ball"), the balls stored in the shared sorted-list layout
(:func:`~raft_tpu_torch.spatial.ann.common.build_list_storage`) with
each ball's radius, the largest true distance of a member to its
landmark. ``metric="l2"`` takes k-means landmarks (``kmeans_fit``, 10
iterations); ``metric="haversine"`` takes (lat, lon) radian rows and
samples data points as landmarks. Both draw from a CPU
``torch.Generator`` seeded with ``seed``: the JAX package draws from
JAX's PRNG, so one seed gives the two packages different landmarks, and
:func:`_assemble` builds the index from given landmarks and labels.

Query (the reference's triangle-inequality strategy): the ``n_probes``
balls with the nearest landmarks are scored in full; a ball can hold a
closer neighbour only if d(q, L) − radius_L < the k-th distance, so the
k-th distance certifies, per query, whether the answer is exact
(``n_probes = n_landmarks`` is exhaustively exact). Queries run in
internal blocks sized so the candidate gather (block, n_probes ·
max_list, d) stays within ``_GATHER_BYTES``. The l2 roots are taken in
f64 (correctly rounded on every device).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
from raft_tpu_torch.core.device import as_tensor, call_device
from raft_tpu_torch.distance.pairwise import (
    haversine_core,
    haversine_distance,
    relu0,
    sqrt_f64,
)
from raft_tpu_torch.spatial.ann.common import (
    ListStorage,
    build_list_storage,
    check_candidate_pool,
    coarse_probe,
    score_l2_candidates,
    select_candidates,
)
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = ["BallCoverIndex", "rbc_build_index", "rbc_knn_query",
           "rbc_all_knn_query"]

# bytes of one query block's f32 candidate gather
_GATHER_BYTES = 256 << 20
# rows per block of the haversine build's (rows, n_landmarks) distances
_BUILD_ROWS = 1 << 16


@dataclasses.dataclass
class BallCoverIndex:
    """Analog of BallCoverIndex (ball_cover_common.h:38)."""

    landmarks: torch.Tensor     # (n_landmarks, d)
    radii: torch.Tensor         # (n_landmarks,) f32 TRUE metric distances
    data_sorted: torch.Tensor   # (n + 1, d), a zero sentinel row appended
    storage: ListStorage
    metric: str = "l2"

    @property
    def device(self) -> torch.device:
        return self.landmarks.device


def _haversine_rows(q, cand, valid):
    """Row-batched haversine: q (nq, 2) against cand (nq, C, 2) radian
    pairs, +inf where invalid."""
    d = haversine_core(q[:, 0][:, None], q[:, 1][:, None],
                       cand[..., 0], cand[..., 1])
    return torch.where(valid, d, float("inf"))


def _member_dists(x, landmarks, labels, metric: str):
    """Each row's true distance to its own landmark: the difference form
    for l2, the haversine formula otherwise."""
    lm = landmarks[labels]
    if metric == "haversine":
        return haversine_core(x[:, 0], x[:, 1], lm[:, 0], lm[:, 1])
    return sqrt_f64(relu0(torch.sum((x - lm) ** 2, dim=1)))


def _assemble(x, landmarks, labels, metric: str) -> BallCoverIndex:
    """The index over ``x`` from its landmarks and each row's ball
    (``labels``): the sorted-list storage, the rows in list order with a
    sentinel row, and every ball's radius (the max over zeros of its
    members' true distances). Shared by the build and by indexes carried
    from the JAX package's landmarks."""
    dev = x.device
    labels = torch.as_tensor(labels, device=dev).long()
    n_land = landmarks.shape[0]
    storage = build_list_storage(labels.cpu().numpy(), n_land, dev)
    data_sorted = torch.cat([x[storage.sorted_ids.long()],
                             x.new_zeros((1, x.shape[1]))])
    member_d = _member_dists(x.float(), landmarks.float(), labels, metric)
    radii = torch.zeros(n_land, dtype=torch.float32, device=dev)
    radii = radii.scatter_reduce(0, labels, member_d.float(), "amax")
    return BallCoverIndex(landmarks, radii, data_sorted, storage, metric)


def rbc_build_index(x, *, n_landmarks: int = 0, seed: int = 0,
                    metric: str = "l2", device=None) -> BallCoverIndex:
    """Build (reference rbc_build_index, ball_cover.cuh:34): √n landmarks
    by default. ``metric="haversine"`` expects (lat, lon) RADIAN rows.
    ``x``: a tensor (built on its device) or an array (placed on
    ``device``, CUDA by default)."""
    x = as_tensor(x, call_device(x, device=device))
    errors.check_matrix(x, "x")
    errors.expects(
        metric in ("l2", "haversine"),
        "metric must be 'l2' or 'haversine', got %r", metric,
    )
    n = x.shape[0]
    if n_landmarks <= 0:
        n_landmarks = max(int(np.sqrt(n)), 1)

    if metric == "haversine":
        errors.expects(
            x.shape[1] == 2,
            "haversine expects (lat, lon) pairs, got %d columns", x.shape[1],
        )
        # landmarks are SAMPLED data points (Euclidean centroid averages
        # mean nothing on the sphere)
        gen = torch.Generator().manual_seed(int(seed))
        sel = torch.randperm(n, generator=gen)[:min(n_landmarks, n)]
        landmarks = x[torch.sort(sel).values.to(x.device)]
        labels = torch.cat([
            torch.argmin(haversine_distance(x[r0:r0 + _BUILD_ROWS].float(),
                                            landmarks.float()), dim=1)
            for r0 in range(0, n, _BUILD_ROWS)])
    else:
        out = kmeans_fit(
            x, KMeansParams(n_clusters=n_landmarks, max_iter=10, seed=seed))
        landmarks, labels = out.centroids, out.labels
    return _assemble(x, landmarks, labels, metric)


def _query_block(index: BallCoverIndex, qf, k: int, n_probes: int):
    """One block of :func:`rbc_knn_query`."""
    nq = qf.shape[0]
    storage = index.storage
    n_land = index.landmarks.shape[0]
    lmf = index.landmarks.float()
    if index.metric == "haversine":
        all_ld = haversine_distance(qf, lmf)
        _, probes = top_k_smallest(all_ld, n_probes)
    else:
        # one full-f32 gram serves the probe and the certificate
        probes, ld2 = coarse_probe(qf, lmf, n_probes)
        all_ld = sqrt_f64(relu0(ld2))

    cand_pos = storage.list_index[probes].reshape(nq, -1).long()
    cand = index.data_sorted[cand_pos].float()
    valid = cand_pos < storage.n
    if index.metric == "haversine":
        dist = _haversine_rows(qf, cand, valid)
        dists, ids = select_candidates(storage, cand_pos, dist, k)
    else:
        d2 = score_l2_candidates(qf, cand, valid)
        vals, ids = select_candidates(storage, cand_pos, d2, k)
        dists = sqrt_f64(relu0(vals))

    # exactness certificate: every UNPROBED ball satisfies
    # d(q, L) - radius_L >= kth (probed balls were fully scored)
    kth = dists[:, k - 1]
    probed = torch.zeros((nq, n_land), dtype=torch.bool, device=qf.device)
    probed.scatter_(1, probes.long(), True)
    bound = all_ld - index.radii[None, :]
    exact = torch.all(probed | (bound >= kth[:, None]), dim=1)
    return dists, ids, exact


def rbc_knn_query(index: BallCoverIndex, queries, k: int, *,
                  n_probes: int = 16
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN query. Returns (dists (nq, k) f32 true metric, ids (nq, k)
    int32, exact (nq,) bool certificate).

    ``exact[i]`` is True when the triangle inequality proves no unprobed
    ball can hold a closer neighbour — the reference's pruning criterion
    (detail/ball_cover.cuh perform_post_filter_registers) used as a
    per-query certificate."""
    q = as_tensor(queries, index.device)
    errors.check_matrix(q, "queries")
    nq, d = q.shape
    n_land = index.landmarks.shape[0]
    n_probes = min(n_probes, n_land)
    check_candidate_pool(k, n_probes, index.storage)
    qf = q.float()
    per_query = n_probes * index.storage.max_list * d * 4
    block = max(1, _GATHER_BYTES // max(per_query, 1))
    outs = [_query_block(index, qf[s:s + block], k, n_probes)
            for s in range(0, nq, block)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def rbc_all_knn_query(index: BallCoverIndex, k: int, *, n_probes: int = 16):
    """All-points kNN over the index's own data (reference
    rbc_all_knn_query, ball_cover.cuh:69): row i of the answer is
    original point i's."""
    x = index.data_sorted[: index.storage.n]
    # un-permute so row i queries original point i
    inv = torch.argsort(index.storage.sorted_ids)
    return rbc_knn_query(index, x[inv], k, n_probes=n_probes)
