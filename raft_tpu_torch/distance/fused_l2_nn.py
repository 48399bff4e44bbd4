"""Fused L2 nearest neighbor — the port of
``raft_tpu/distance/fused_l2_nn.py:43`` (analog of
``raft::distance::fusedL2NN``).

For every row of ``x``, the nearest row of ``y`` under squared L2, as
blocked f32 gram tiles (``torch.matmul``, TF32 off) folded into a running
(min, argmin): ``max(‖x‖² + ‖y‖² − 2 x·y, 0)``, ties to the lowest
column. Rows of ``x`` are processed in blocks too, so the (rows, block)
tile stays bounded at large m.

``mask_op`` generalises the reference's pluggable reduce op (the masked
``FixConnectivitiesRedOp`` of connect_components,
sparse/selection/detail/connect_components.cuh:95-134): it is called
with the GLOBAL row and column indices of each tile, so its answers do
not depend on the row blocking or on ``block_n``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.distance.pairwise import sqrt_f64

__all__ = ["fused_l2_nn", "fused_l2_nn_argmin"]

_PRECISIONS = (None, "default", "highest")

# rows of x per tile: bounds the (rows, block_n) f32 tile at 256 MiB
_ROW_BLOCK = 1 << 16


def _choose_block(n: int) -> int:
    for b in (1024, 512, 256, 128):
        if n >= b:
            return b
    return max(n, 1)


@full_f32
def fused_l2_nn(x, y, *, sqrt: bool = False, block_n: Optional[int] = None,
                mask_op: Optional[Callable] = None, precision=None):
    """Returns ``(min_dist (m,) f32, min_idx (m,) int32)``: the squared
    distance, or with ``sqrt=True`` its root (taken in f64, so correctly
    rounded on every device).

    ``block_n``: columns of ``y`` per tile (default 1024 down to 128 by
    ``n``); it changes the tiling only. ``mask_op(rows (mb, 1) int64,
    cols (1, bn) int64) -> bool (mb, bn)``, on global indices: pairs it
    masks out count as +inf, and a row with every pair masked gives
    (inf, 0). ``precision``: ``None``/``"highest"``/``"default"``,
    accepted for parity with the JAX signature; all three run full f32
    products, which is what both mean on the JAX package's CPU
    reference."""
    errors.check_matrix(x, "x")
    errors.check_matrix(y, "y")
    errors.check_same_cols(x, y)
    errors.expects(precision in _PRECISIONS,
                   "precision must be one of %s, got %r", _PRECISIONS,
                   precision)
    errors.expects(block_n is None or block_n >= 1,
                   "block_n must be >= 1, got %r", block_n)
    xf = x.float()
    yf = y.float()
    m, n = xf.shape[0], yf.shape[0]
    bn = block_n or _choose_block(n)
    yn = torch.sum(yf * yf, dim=1)
    minv = torch.empty(m, dtype=torch.float32, device=xf.device)
    mini = torch.empty(m, dtype=torch.int64, device=xf.device)
    for r0 in range(0, m, _ROW_BLOCK):
        xb = xf[r0:r0 + _ROW_BLOCK]
        xn = torch.sum(xb * xb, dim=1)
        bmin_all = torch.full((xb.shape[0],), float("inf"),
                              device=xf.device)
        bidx_all = torch.zeros(xb.shape[0], dtype=torch.int64,
                               device=xf.device)
        rows = torch.arange(r0, r0 + xb.shape[0],
                            device=xf.device)[:, None]
        for j0 in range(0, n, bn):
            g = xb @ yf[j0:j0 + bn].T
            d2 = torch.clamp_min(
                xn[:, None] + yn[None, j0:j0 + bn] - 2.0 * g, 0.0
            )
            if mask_op is not None:
                cols = torch.arange(j0, j0 + g.shape[1],
                                    device=xf.device)[None, :]
                d2 = torch.where(mask_op(rows, cols), d2, float("inf"))
            bidx = torch.argmin(d2, dim=1)
            bmin = torch.gather(d2, 1, bidx[:, None])[:, 0]
            upd = bmin < bmin_all
            bmin_all = torch.where(upd, bmin, bmin_all)
            bidx_all = torch.where(upd, bidx + j0, bidx_all)
        minv[r0:r0 + _ROW_BLOCK] = bmin_all
        mini[r0:r0 + _ROW_BLOCK] = bidx_all
    if sqrt:
        minv = sqrt_f64(minv)
    return minv, mini.to(torch.int32)


def fused_l2_nn_argmin(x, y, **kw):
    """Index-only variant (reference fused_l2_nn.cuh:44
    ``fusedL2NNMinReduce`` with MinReduceOp): (m,) int32."""
    return fused_l2_nn(x, y, **kw)[1]
