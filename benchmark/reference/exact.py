"""Exact squared-L2 k-nearest neighbours by brute force, and the exact
distance of any (query, row) pair.

``topk`` scores every row in blocks with the f32 expansion
|q|² + |x|² − 2 q·x (TF32 off), keeps ``2k`` candidates a query, and
re-ranks them by the direct difference in float64, so the returned ids
are the exact top-k (ties to the lower id) unless the f32 expansion
misorders rows across a 2k margin. With ``dtype=torch.bfloat16`` the same
search runs in bf16 throughout (rows, queries, products and the kept
distances), without the f64 re-rank: the control that must come out as
not correct.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _blocked_candidates(x, q, c, row_block, dtype):
    qd = q.to(dtype)
    qn = (qd * qd).sum(1, dtype=dtype)[:, None]
    best_v = torch.full((q.shape[0], c), float("inf"), dtype=dtype, device=q.device)
    best_i = torch.zeros((q.shape[0], c), dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], row_block):
        xb = x[s:s + row_block].to(dtype)
        d2 = qn + (xb * xb).sum(1, dtype=dtype)[None, :] - 2.0 * (qd @ xb.T)
        v, i = torch.topk(d2, min(c, xb.shape[0]), dim=1, largest=False)
        v = torch.cat([best_v, v], 1)
        i = torch.cat([best_i, i + s], 1)
        best_v, o = torch.topk(v, c, dim=1, largest=False)
        best_i = torch.gather(i, 1, o)
    return best_v, best_i


def pair_d2(x, q, qidx, ids) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact float64 squared distances between queries ``q[qidx]`` (m,)
    and rows ``x[ids]`` (m, k), and the float64 |q|² + |x|² of each pair
    (the scale of the expansion's rounding). ``ids`` must be valid rows."""
    qv = q[qidx].double()[:, None, :]
    xv = x[ids].double()
    diff = xv - qv
    return (diff * diff).sum(2), (qv * qv).sum(2) + (xv * xv).sum(2)


def topk(x, q, k: int, *, dtype=torch.float32, row_block: int = 1 << 16,
         query_block: int = 16384) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distances (nq, k) f32, ids (nq, k) int64) of the k rows of
    ``x`` nearest each query of ``q``."""
    out_v, out_i = [], []
    with no_tf32():
        for s in range(0, q.shape[0], query_block):
            qb = q[s:s + query_block]
            if dtype != torch.float32:
                v, i = _blocked_candidates(x, qb, k, row_block, dtype)
                out_v.append(v.float())
                out_i.append(i)
                continue
            _, cand = _blocked_candidates(x, qb, 2 * k, row_block, torch.float32)
            d2, _ = pair_d2(x, qb, torch.arange(qb.shape[0], device=q.device), cand)
            # ties to the lower id: sort by id first, then stably by distance
            cand, o = torch.sort(cand, dim=1)
            d2 = torch.gather(d2, 1, o)
            d2, o = torch.sort(d2, dim=1, stable=True)
            out_v.append(d2[:, :k].float())
            out_i.append(torch.gather(cand, 1, o)[:, :k])
    return torch.cat(out_v), torch.cat(out_i)
