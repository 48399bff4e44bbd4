"""Minimum spanning tree / forest of the port — the counterpart of
``raft_tpu/sparse/mst.py`` (analog of the reference Borůvka solver,
cpp/include/raft/sparse/mst/mst_solver.cuh:42-56 ``MST_solver``).

The same rounds as the JAX package, on the device: the minimum outgoing
weight of each component by a scatter-min over both endpoints, then the
lowest edge id among the weight ties (the deterministic two-pass
tie-break that replaces the reference's weight alteration), the
selected edges written once into the output by a rank compaction
(through a dummy slot past the end that the unselected entries all
write and nothing reads), and the components contracted by hooking the
larger colour onto the smaller along every selected edge and pointer
jumping. ``scatter_reduce_(..., "amin")`` stands in for ``.at[].min``,
so every step is order-independent and the result equals the JAX
package's bitwise.

The JAX package runs the nested ``lax.while_loop``s on the device; here
they are host loops, and each loop test (an ``any`` over the device) is
one host sync. :func:`boruvka_mst` counts them into ``stats``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raft_tpu_torch.sparse.coo import COO

__all__ = ["MSTResult", "boruvka_mst"]

_MAX_ROUNDS = 64


class MSTResult(NamedTuple):
    """Analog of ``Graph_COO`` output (mst_solver.cuh:27)."""

    src: torch.Tensor        # (n-1,) int32, -1 padded for forests
    dst: torch.Tensor        # (n-1,) int32
    weight: torch.Tensor     # (n-1,) f32, +inf padded
    n_edges: torch.Tensor    # () int32, the edges of the tree / forest
    color: torch.Tensor      # (n,) int32, the final component labels


class _Syncs:
    """Counts the host syncs of the loop tests."""

    def __init__(self):
        self.n = 0

    def any(self, t) -> bool:
        self.n += 1
        return bool(t.any())


def _pointer_jump(c, syncs: _Syncs):
    """c <- c[c] to a fixpoint (the reference's label contraction,
    mst_kernels.cuh min_pair_colors + final_color_indices)."""
    while syncs.any(c != c[c]):
        c = c[c]
    return c


def _scatter_min(init, index, src):
    return init.scatter_reduce_(0, index, src, "amin", include_self=True)


def _boruvka(rows, cols, weights, valid, n: int, stats: Optional[dict]):
    dev = rows.device
    cap = rows.shape[0]
    eidx = torch.arange(cap, device=dev)
    out_cap = max(n - 1, 1)
    inf = torch.tensor(float("inf"), device=dev)
    syncs = _Syncs()
    hook_iters = 0

    def cross(c):
        return valid & (c[rows] != c[cols])

    color = torch.arange(n, device=dev)
    msrc = torch.full((out_cap,), -1, dtype=torch.int32, device=dev)
    mdst = torch.full((out_cap,), -1, dtype=torch.int32, device=dev)
    mw = torch.full((out_cap,), float("inf"), device=dev)
    rounds = 0
    while rounds < _MAX_ROUNDS and syncs.any(cross(color)):
        cu = color[rows]
        cv = color[cols]
        is_cross = cross(color)
        w = torch.where(is_cross, weights, inf)
        # pass 1: the minimum outgoing weight of each component (an edge
        # leaves both endpoint components: the symmetric-graph step)
        minw = _scatter_min(_scatter_min(
            torch.full((n,), float("inf"), device=dev), cu, w), cv, w)
        # pass 2: the lowest edge id among the weight ties
        big = torch.full_like(eidx, cap)
        mine = torch.full((n,), cap, dtype=eidx.dtype, device=dev)
        mine = _scatter_min(mine, cu, torch.where(
            is_cross & (w == minw[cu]), eidx, big))
        mine = _scatter_min(mine, cv, torch.where(
            is_cross & (w == minw[cv]), eidx, big))
        # an edge is selected iff it is some component's choice (a mutual
        # choice is one edge id, so it is written once)
        selected = is_cross & ((mine[cu] == eidx) | (mine[cv] == eidx))

        # record each selected edge once: rank-compact into the output;
        # unselected entries write the dummy slot at out_cap, sliced off
        k_before = torch.sum(mw < inf)
        rank = torch.cumsum(selected, 0) - 1
        pos = torch.where(selected, k_before + rank,
                          torch.full_like(rank, out_cap))
        pos = torch.clamp_max(pos, out_cap)

        def put(buf, vals):
            padded = torch.cat([buf, buf[-1:]])
            src = torch.where(selected, vals.to(buf.dtype), padded[pos])
            return padded.scatter_(0, pos, src)[:out_cap]

        msrc = put(msrc, rows)
        mdst = put(mdst, cols)
        mw = put(mw, weights)

        # contract: hook the larger colour onto the smaller along every
        # selected edge and pointer-jump, until every selected edge is
        # internal (one scatter-min applies one union per root). Colours
        # are root vertex ids, so color[] indexed by a colour is its root.
        c = color
        while syncs.any(selected & (c[rows] != c[cols])):
            hu = c[rows]
            hv = c[cols]
            live = selected & (hu != hv)
            small = torch.minimum(hu, hv)
            large = torch.maximum(hu, hv)
            c = _scatter_min(c.clone(), large,
                             torch.where(live, small, c[large]))
            c = _pointer_jump(c, syncs)
            hook_iters += 1
        color = c
        rounds += 1

    n_edges = torch.sum(mw < inf).to(torch.int32)
    if stats is not None:
        stats.update(rounds=rounds, syncs=syncs.n, hook_iters=hook_iters)
    return MSTResult(msrc, mdst, mw, n_edges, color.to(torch.int32))


def boruvka_mst(graph: COO, *, stats: Optional[dict] = None) -> MSTResult:
    """The MST / MSF of a symmetric weighted COO graph (reference
    mst_solver.cuh:42 ``MST_solver::solve``), on the graph's device.
    ``stats``, a dict, receives the Borůvka ``rounds``, the loop tests'
    host ``syncs`` and the ``hook_iters``."""
    n = graph.shape[0]
    assert graph.shape[0] == graph.shape[1], "MST needs a square graph"
    return _boruvka(graph.rows.long(), graph.cols.long(),
                    graph.vals.to(torch.float32), graph.valid_mask(), n,
                    stats)
