"""Degraded-result contract of the sharded searches — the port of
``raft_tpu/resilience/degraded.py``.

When a shard is down, the sharded search
(:func:`raft_tpu_torch.comms.mnmg_ivf_flat.mnmg_ivf_flat_search` with
``shard_mask=``) answers from the surviving shards instead of failing
the whole query: a down shard contributes +inf distances to the merge,
and the result reports how much of the index was consulted —
``coverage`` per query (the fraction of probed lists served by a live
rank) and a ``partial`` flag. Non-finite query rows are neutralized at
the entry (zeroed for compute, reported through ``row_valid``, their
outputs forced to +inf / -1), so one poisoned row cannot contaminate
its batchmates' merged top-k.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.resilience.health import HealthReport, ShardHealth

__all__ = [
    "PartialSearchResult", "mask_invalid_rows", "probe_coverage",
    "resolve_shard_mask", "sanitize_query_rows",
]


@dataclasses.dataclass(frozen=True)
class PartialSearchResult:
    """A sharded search answer that may cover only part of the index.

    distances : (nq, k) merged distances; +inf where no live candidate
        filled the slot (and everywhere for an invalid query row).
    ids : (nq, k) global row ids; -1 wherever ``distances`` is +inf.
    coverage : (nq,) float32 — fraction of the query's probed lists
        served by a live rank (1.0 = fully served; 0.0 for an invalid
        row). Lists owned by no rank count as not covered.
    row_valid : (nq,) bool — False for query rows neutralized at entry.

    ``partial`` (a host sync of the small coverage / validity tensors)
    is True iff a row was invalid or a query's coverage fell short."""

    distances: torch.Tensor
    ids: torch.Tensor
    coverage: torch.Tensor
    row_valid: torch.Tensor

    @property
    def partial(self) -> bool:
        cov = self.coverage.cpu().numpy()
        valid = self.row_valid.cpu().numpy()
        return bool((cov < 1.0).any() or (~valid).any())

    @property
    def min_coverage(self) -> float:
        """The worst-served query's coverage (host sync)."""
        return float(self.coverage.min())


def resolve_shard_mask(shard_mask: Any, n_ranks: int) -> np.ndarray:
    """Normalize a ``shard_mask=`` argument to an int32 ``(P,)`` validity
    array (1 = up): ``True`` (all up), a :class:`ShardHealth`, a
    :class:`HealthReport` (folded through a throwaway tracker), or any
    array-like of per-rank truth. All-down is allowed: every slot merges
    to +inf and coverage is 0."""
    if shard_mask is True:
        return np.ones(n_ranks, np.int32)
    if isinstance(shard_mask, HealthReport):
        # telemetry=False: a tracker that lives for one normalization
        # must not drive the global flip counters or the ranks-up gauge
        shard_mask = ShardHealth(
            n_ranks, telemetry=False).apply_report(shard_mask)
    if isinstance(shard_mask, ShardHealth):
        arr = shard_mask.mask()
    elif isinstance(shard_mask, torch.Tensor):
        arr = shard_mask.cpu().numpy()
    else:
        arr = np.asarray(shard_mask)
    errors.expects(
        arr.shape == (n_ranks,),
        "shard_mask: expected shape (%d,) to match the communicator, got "
        "%s", n_ranks, tuple(arr.shape),
    )
    return (np.asarray(arr) != 0).astype(np.int32)


# --------------------------------------------- helpers of the rank bodies
def sanitize_query_rows(qf):
    """Neutralize non-finite query rows: returns ``(q_clean, row_valid)``,
    poisoned rows zeroed (a zero row cannot produce NaN distances that
    would poison the shared merge) and marked for output masking."""
    row_valid = torch.isfinite(qf).all(dim=-1)
    return torch.where(row_valid[:, None], qf, 0.0), row_valid


def probe_coverage(owner_of_probe, alive, row_valid):
    """Per-query served fraction: of the probed lists (``owner_of_probe``
    (nq, p), each probe's serving rank, -1 = unowned) the fraction
    served by a live rank per ``alive`` (P,). Invalid rows report 0."""
    n_ranks = alive.shape[0]
    live = (owner_of_probe >= 0) & (
        alive[torch.clamp(owner_of_probe, 0, n_ranks - 1).long()] > 0)
    # the sum times the f32 reciprocal of the probe count: how XLA's CPU
    # backend lowers the reference's jnp.mean (a division differs by an
    # ulp at, for example, 5/6)
    p = live.shape[-1]
    cov = live.to(torch.float32).sum(dim=-1) * (1.0 / p)
    return torch.where(row_valid, cov, 0.0)


def mask_invalid_rows(md, mi, row_valid):
    """Force the outputs of neutralized rows to the empty answer (+inf
    distances, -1 ids)."""
    md = torch.where(row_valid[:, None], md, float("inf"))
    mi = torch.where(row_valid[:, None], mi, -1)
    return md, mi
