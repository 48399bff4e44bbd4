"""Connected-components fixup of the port — the counterpart of
``raft_tpu/sparse/connect.py`` (analog of
``raft::linkage::connect_components``,
cpp/include/raft/sparse/selection/connect_components.cuh:66, reduce op
``FixConnectivitiesRedOp`` detail/connect_components.cuh:95-134).

For every row, its nearest row of another colour: the port's
``fused_l2_nn`` (blocked f32 ``torch.matmul``, TF32 off) with a
``mask_op`` that masks same-colour pairs on global indices. Then a
segment-min per colour, and the row with the lowest index among a
colour's ties as its representative: one cross-component edge a colour.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.device import as_tensor, call_device
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.sparse.coo import COO

__all__ = ["connect_components", "get_n_components"]


def get_n_components(color, *, device=None) -> torch.Tensor:
    """The number of distinct colours (reference get_n_components), a
    0-d tensor on the colours' device."""
    color = as_tensor(color, call_device(color, device=device)).long()
    present = torch.zeros(color.shape[0], dtype=torch.int32,
                          device=color.device)
    return present.index_fill_(0, color, 1).sum()


def connect_components(x, color, *, device=None) -> COO:
    """A COO of cross-component nearest-neighbour edges: for each colour
    c, the closest pair (i in c, j not in c), i the lowest row among
    ties. The caller symmetrizes (reference connect_components.cuh:66:
    fusedL2NN with a reduce op that skips same-colour candidates, then a
    segment-min per colour)."""
    dev = call_device(x, color, device=device)
    x = as_tensor(x, dev)
    color = as_tensor(color, dev).long()
    n = x.shape[0]

    def mask_op(rows, cols):
        return color[rows] != color[cols]

    minv, mini = fused_l2_nn(x, x, mask_op=mask_op)

    # segment-min per colour: the best cross edge of each component
    best = torch.full((n,), float("inf"), device=dev).scatter_reduce_(
        0, color, minv, "amin", include_self=True)
    is_best = minv == best[color]
    # one representative a colour: the lowest row index among the ties
    ar = torch.arange(n, device=dev)
    rep = torch.full((n,), n, dtype=ar.dtype, device=dev).scatter_reduce_(
        0, color, torch.where(is_best, ar, torch.full_like(ar, n)), "amin",
        include_self=True)
    chosen = rep[color] == ar
    rows = torch.where(chosen, ar, 0).to(torch.int32)
    cols = torch.where(chosen, mini, 0).to(torch.int32)
    vals = torch.where(chosen, minv, torch.zeros_like(minv))

    # the chosen edges to the front
    order = torch.sort((~chosen).to(torch.uint8), stable=True)[1]
    nnz = chosen.sum().to(torch.int32)
    mask = ar < nnz
    return COO(torch.where(mask, rows[order], 0),
               torch.where(mask, cols[order], 0),
               torch.where(mask, vals[order], torch.zeros_like(vals)),
               nnz, (n, n))
