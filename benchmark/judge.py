"""The comparison that decides ``correct``, and ``recall_at_10``.

Every answer the window produced is held against the plain reference
(``reference/exact.py``), run once the window has closed on the same
rows and queries the harness handed the program:

* ``dist_gap``: for each returned (id, distance), the gap between the
  squared distance the program returned and the exact float64 squared
  distance of that query to that id, over |q|² + |x|² (the scale of an
  f32 expansion's rounding); the widest over all answers. An id outside
  the rows, or one returned twice for one query, reads infinite. This
  catches a distance computed in a lower precision, an answer altered
  where it is produced, and an answer meant for another query.
* ``recall_at_10`` (the end-to-end metric, not a limit): over every
  answered query, the share of the reference's exact top-k ids found among
  the ids returned.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import exact


def _as_squared(dists: torch.Tensor, distance: str) -> torch.Tensor:
    d = dists.double()
    if distance == "l2":
        return d * d
    if distance == "sqeuclidean":
        return d
    raise ValueError(f"unknown distance kind {distance!r}")


def dist_gap(x, q, qidx, dists, ids, distance: str, block: int = 1 << 16) -> float:
    """The widest normalised gap over answers ``(qidx (m,), dists (m, k),
    ids (m, k))``; infinite where an id is invalid or repeated."""
    n = x.shape[0]
    worst = 0.0
    for s in range(0, qidx.shape[0], block):
        qi = qidx[s:s + block].to(x.device).long()
        di = dists[s:s + block].to(x.device)
        ii = ids[s:s + block].to(x.device).long()
        valid = (ii >= 0) & (ii < n)
        srt = torch.sort(ii, dim=1).values
        repeated = (srt[:, 1:] == srt[:, :-1]).any(1)
        if not bool(valid.all()) or bool(repeated.any()) or not bool(
                torch.isfinite(di).all()):
            return math.inf
        ref, scale = exact.pair_d2(x, q, qi, ii)
        gap = (_as_squared(di, distance) - ref).abs() / scale.clamp_min(1e-300)
        worst = max(worst, float(gap.max()))
    return worst


def recall_hits(true_ids: torch.Tensor, qidx, ids) -> int:
    """How many of the exact top-k ids of queries ``qidx`` are among the
    returned ``ids`` (m, k)."""
    t = true_ids[qidx.to(true_ids.device).long()]
    got = ids.to(true_ids.device).long()
    return int((t[:, :, None] == got[:, None, :]).any(2).sum())


def judge(x, q, answers, *, k: int, distance: str, limits: dict) -> dict:
    """``answers``: a list of (qidx (m,), dists (m, k), ids (m, k)) host or
    device tensors, one per distinct answer set, each with the number of
    times it was returned. Returns the compared numbers with their limits,
    ``correct`` and the recall."""
    _, true_ids = exact.topk(x, q, k)
    hits = rows = 0
    gap = 0.0
    for (qidx, dists, ids), times in answers:
        hits += times * recall_hits(true_ids, qidx, ids)
        rows += times * qidx.shape[0]
        gap = max(gap, dist_gap(x, q, qidx, dists, ids, distance))
    checks = {
        "dist_gap": {"value": gap, "limit": float(limits["dist_gap"])},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    recall = hits / (rows * k) if rows else 0.0
    return {"checks": checks, "correct": correct, "recall": recall}
