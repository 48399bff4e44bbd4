"""Cross-host serving over a two-level (DCN x ICI) communicator — the port
of ``raft_tpu/comms/multihost.py``: the hierarchical merge and its
compressed wire format, its byte model, and the host-aware placement
helpers.

The flat merge of the sharded engines allgathers every rank's (nq, k)
part at deployment width. Across hosts that allgather is the whole
serving budget, so the cross-host tail is restructured around the
hierarchy, as :func:`~raft_tpu_torch.comms.comms.hierarchical_allreduce`
restructures an allreduce:

1. **Inner stage.** Each host allgathers its ranks' (nq, k) parts over
   its inner level and runs ``merge_parts_select_k`` — the host's exact
   f32 top-k.
2. **Outer stage** (:func:`hierarchical_merge_select_k`). Only each
   host's top-k crosses hosts, as **bf16 distances + int32 global ids**
   (6 bytes a candidate instead of 8, and D host parts instead of D·I
   rank parts); selection runs on the widened bf16 keys with per-part
   provenance.
3. **The f32 rerank tail.** Each host recovers the exact f32 values of
   the entries it contributed through one (nq, k) outer allreduce, and
   the k selected are re-sorted by exact value. The one divergence from
   the flat merge left is a pair straddling the k-boundary closer than
   one bf16 ulp; ``wire="f32"`` removes it.

:func:`host_rank_mask` expands a per-host health mask to ranks, and
:func:`host_aware_offset` picks the replica stripe that lands every copy
of a shard on a different host.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.spatial.selection import (
    merge_parts_provenance_select_k,
    top_k_smallest,
)

__all__ = [
    "comms_levels", "dcn_merge_accounting", "hier_axes",
    "hierarchical_merge_select_k", "host_aware_offset", "host_rank_mask",
]

# the compressed wire format: value bytes per candidate by wire dtype,
# plus the int32 global id every candidate carries either way
_WIRE_VALUE_BYTES = {"bf16": 2, "f32": 4}
_WIRE_ID_BYTES = 4


def hier_axes(comms) -> typing.Optional[tuple]:
    """``(outer_axis, inner_axis, n_hosts, inner_size)`` when ``comms``
    is two-level with more than one host — the switch between the flat
    and the hierarchical merge tails — else None."""
    lv = getattr(comms, "levels", None)
    if lv is not None and lv[2] > 1:
        return lv
    return None


def comms_levels(comms) -> tuple:
    """``(n_hosts, inner_size)`` of a communicator: the two-level shape
    of a hierarchical one, ``(1, size)`` for a flat one."""
    h = hier_axes(comms)
    if h is None:
        return 1, int(comms.size)
    return h[2], h[3]


def hierarchical_merge_select_k(outer, slice_vals, slice_ids, k: int, *,
                                wire: str = "bf16",
                                select_min: bool = True):
    """The outer stage of the two-stage cross-host merge, inside ``run``
    (``outer`` is the rank's facade across hosts): ``slice_vals`` /
    ``slice_ids`` are this host's (nq, kk) exact top-k, best first, f32
    values and global int32 ids, the same on every rank of the host.

    ``wire="bf16"`` exchanges bf16 values and int32 ids, selects on the
    widened keys with per-host provenance, recovers the selected
    entries' exact f32 values from their hosts through one (nq, k)
    allreduce and re-sorts by exact value; ``wire="f32"`` exchanges the
    values uncompressed (bit-identical to the flat merge). Returns
    ``(vals (nq, k), ids (nq, k))``, best first."""
    errors.expects(
        wire in _WIRE_VALUE_BYTES,
        "wire=%r not a known wire format (bf16 | f32)", wire,
    )
    if wire == "f32":
        gv = outer.allgather(slice_vals)             # (D, nq, kk)
        gi = outer.allgather(slice_ids)
        mv, mi, _, _ = merge_parts_provenance_select_k(
            gv, gi, k, select_min=select_min)
        return mv, mi
    my_slice = outer.get_rank()
    gv = outer.allgather(slice_vals.to(torch.bfloat16))
    gi = outer.allgather(slice_ids)
    # select on the widened wire keys: the bytes are already spent
    mv, mi, part, slot = merge_parts_provenance_select_k(
        gv.to(slice_vals.dtype), gi, k, select_min=select_min)
    # the f32 rerank tail: each host contributes the exact values of its
    # own selected entries (0 elsewhere — provenance is unique)
    mine = part == my_slice
    contrib = torch.where(
        mine, torch.gather(slice_vals, 1, slot.long()),
        torch.zeros((), dtype=slice_vals.dtype, device=slice_vals.device))
    exact = outer.allreduce(contrib)
    if select_min:
        ev, p = top_k_smallest(exact, k)
    else:
        ev, p = top_k_smallest(-exact, k)
        ev = -ev
    return ev, torch.gather(mi, 1, p)


def dcn_merge_accounting(k: int, n_hosts: int, chips_per_host: int, *,
                         wire: str = "bf16") -> dict:
    """Cross-host bytes per query of the merge tail, flat against
    hierarchical, at ``n_hosts`` hosts of ``chips_per_host`` ranks (the
    bytes a host receives across hosts; within-host traffic is free by
    convention): flat ``(W - I) * k * 8`` with ``W = n_hosts *
    chips_per_host``; hierarchical ``(D - 1) * k * (wire_bytes + 4)``,
    plus for bf16 the rerank tail's ring allreduce ``2 (D - 1) / D * k *
    4``. Returns ``{"flat_bytes_per_query", "hier_bytes_per_query",
    "ratio", ...}``."""
    errors.expects(
        wire in _WIRE_VALUE_BYTES,
        "wire=%r not a known wire format (bf16 | f32)", wire,
    )
    errors.expects(
        n_hosts >= 1 and chips_per_host >= 1 and k >= 1,
        "dcn_merge_accounting: bad geometry (k=%d, hosts=%d, chips=%d)",
        k, n_hosts, chips_per_host,
    )
    W = n_hosts * chips_per_host
    flat = (W - chips_per_host) * k * (4 + _WIRE_ID_BYTES)
    hier = (n_hosts - 1) * k * (_WIRE_VALUE_BYTES[wire] + _WIRE_ID_BYTES)
    if wire == "bf16" and n_hosts > 1:
        hier += 2.0 * (n_hosts - 1) / n_hosts * k * 4
    return {
        "k": k,
        "n_hosts": n_hosts,
        "chips_per_host": chips_per_host,
        "wire": wire,
        "flat_bytes_per_query": float(flat),
        "hier_bytes_per_query": float(hier),
        "ratio": float(flat) / hier if hier else float("inf"),
    }


def host_rank_mask(host_alive, inner_size: int) -> np.ndarray:
    """Expand a per-host health mask to the flat ``(P,)`` rank mask:
    host h covers ranks ``[h * inner_size, (h+1) * inner_size)``."""
    host_alive = np.asarray(host_alive)
    errors.expects(
        host_alive.ndim == 1 and inner_size >= 1,
        "host_rank_mask: expected a 1-D host mask and inner_size >= 1, "
        "got shape %s, inner_size=%d", tuple(host_alive.shape), inner_size,
    )
    return np.repeat((host_alive != 0).astype(np.int32), inner_size)


def host_aware_offset(n_ranks: int, inner_size: int,
                      replication: int) -> int:
    """The replica stripe offset that lands every copy of a shard on a
    different host: ``inner_size * max(1, n_hosts // R)``. Requires
    R <= n_hosts."""
    errors.expects(
        inner_size >= 1 and n_ranks % inner_size == 0,
        "host_aware_offset: n_ranks=%d not a whole number of "
        "inner_size=%d hosts", n_ranks, inner_size,
    )
    n_hosts = n_ranks // inner_size
    errors.expects(
        1 <= replication <= n_hosts,
        "host_aware_offset: R=%d copies cannot land on distinct hosts "
        "(%d hosts) — pass an explicit replica_offset to accept "
        "same-host copies", replication, n_hosts,
    )
    return inner_size * max(1, n_hosts // replication)
