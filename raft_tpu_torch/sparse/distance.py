"""Sparse pairwise distances and sparse kNN of the port — the counterpart
of ``raft_tpu/sparse/distance.py`` (analog of raft/sparse/distance,
cpp/include/raft/sparse/distance/: the load-balanced COO SpMV with
dense-smem and hash strategies, detail/coo_spmv.cuh:48-205, and
raft/sparse/selection/knn.cuh:54, batched sparse brute-force kNN).

Two strategies, as in the JAX package:

* **"dense"** (moderate d): blocks of CSR rows are scattered into dense
  (block, d) tiles that the dense metric engine
  (:func:`raft_tpu_torch.spatial.knn._block_dist`) reads.
* **"colblock"** (high d): the (rows, d) matrix is never densified.
  Distances accumulate over column blocks; per block only the
  (rows, col_block) slabs exist. Expanded metrics accumulate a gram,
  unexpanded ones their per-feature terms; row norms and sums come from
  segment sums over the sparse values. A prebuilt
  :class:`SparseColBlockIndex` (built once on the host) streams index
  row blocks, each (column block x row block) cell one contiguous slice
  of presorted entries.

``strategy="auto"`` densifies while the dense side stays within
``_DENSE_BYTES_BUDGET``.

Port notes. Every product runs in full f32 with TF32 off, whatever
``precision`` says (``None``, ``"highest"`` and ``"default"`` all mean
IEEE f32 on the JAX package's CPU reference). ``lax.top_k(-d, k)`` is
:func:`~raft_tpu_torch.spatial.selection.top_k_smallest` and the
streaming merge :func:`~raft_tpu_torch.spatial.selection.merge_topk`.
Where the JAX package skips an empty (column block x row block) cell
with ``lax.cond``, the port reads the occupancy on the host: the
prebuilt index keeps numpy copies of its cell offsets, and a call reads
the query side's (and a CSR index's) occupancy in one host read, never
one a block; :data:`HOST_SYNCS` counts them. Distinct (row, column)
entries scatter with a plain indexed write; the prebuilt route's segment
sums add repeated entries in their sorted order (``segment_reduce``),
so a call gives the same bits every time on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import call_device
from raft_tpu_torch.distance.distance_type import (
    DistanceType,
    EXPANDED_METRICS,
    resolve_metric,
)
from raft_tpu_torch.distance.pairwise import (
    _TILE_ELEMS,
    _UNEXPANDED_TABLE,
    _gram,
    _lp_table,
    _nonzero,
    relu0,
    sqrt_f64,
)
from raft_tpu_torch.sparse.coo import CSR, scatter_rows
from raft_tpu_torch.spatial.knn import _block_dist
from raft_tpu_torch.spatial.selection import merge_topk, top_k_smallest

__all__ = [
    "densify_rows",
    "sparse_pairwise_distance",
    "sparse_brute_force_knn",
    "SparseColBlockIndex",
    "sparse_colblock_index_build",
]

# auto strategy: densify only while the dense index block stays this small
_DENSE_BYTES_BUDGET = 1 << 28  # 256 MiB
# colblock: single (m, n) accumulator while it fits (one scatter pass over
# the index per column block); scan index row blocks beyond that
_ACC_BYTES_BUDGET = 1 << 28

_PRECISIONS = (None, "default", "highest")

# host reads of block occupancy made by the colblock routes (one a call)
HOST_SYNCS = 0


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host, counted in :data:`HOST_SYNCS`."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return t.cpu().numpy()


def _pick_block_n(block_n, m, n):
    if block_n is not None:
        return block_n
    return n if m * n * 4 <= _ACC_BYTES_BUDGET else 4096


def densify_rows(csr: CSR, row_start: int, block_rows: int) -> torch.Tensor:
    """Scatter rows [row_start, row_start + block_rows) into a dense
    (block_rows, d) block (the 'dense strategy' analog,
    coo_spmv_strategies/dense_smem_strategy.cuh); rows past the matrix
    are zero. The CSR's (row, column) entries are distinct."""
    d = csr.shape[1]
    rows = csr.row_ids().long()
    in_blk = (csr.valid_mask() & (rows >= row_start)
              & (rows < row_start + block_rows))
    local = torch.where(in_blk, rows - row_start, block_rows)
    vals = torch.where(in_blk, csr.data, torch.zeros_like(csr.data))
    dense = torch.zeros((block_rows + 1, d), dtype=csr.data.dtype,
                        device=csr.data.device)
    dense[local, csr.indices.long()] = vals
    return dense[:block_rows]


# ---------------------------------------------------------------------------
# colblock strategy (high d — the hash-strategy analog; nothing of size
# O(rows × d) ever materialises)
# ---------------------------------------------------------------------------


def _canonicalize_colblock_metric(metric: DistanceType) -> DistanceType:
    """The unexpanded L2 variants take the expanded (gram) form: the same
    value, without accumulating over every padded feature."""
    return {
        DistanceType.L2Unexpanded: DistanceType.L2Expanded,
        DistanceType.L2SqrtUnexpanded: DistanceType.L2SqrtExpanded,
    }.get(metric, metric)


def _value_transform(metric: DistanceType, v):
    """Per-entry transforms with f(0) = 0 (Hellinger's root on the sparse
    values, never on a dense matrix)."""
    if metric == DistanceType.HellingerExpanded:
        return torch.sqrt(relu0(v))
    return v


def _row_stats(csr: CSR):
    """Per-row (squared norm, sum) as segment sums over the sparse values,
    each row's entries added in their order."""
    v = torch.where(csr.valid_mask(), csr.data, torch.zeros_like(
        csr.data)).float()
    return scatter_rows(csr, v * v), scatter_rows(csr, v)


def _expanded_from_gram(metric, g, an, asum, bn_, bsum, d):
    """Expanded-metric epilogues from the gram and the sparse row moments
    (the JAX package's formulas; centering through raw moments:
    <x-mu_x, y-mu_y> = <x,y> - d*mu_x*mu_y with mu = rowsum/d)."""
    if metric == DistanceType.InnerProduct:
        return g
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        d2 = relu0(an[:, None] + bn_[None, :] - 2.0 * g)
        return sqrt_f64(d2) if metric == DistanceType.L2SqrtExpanded else d2
    if metric == DistanceType.CosineExpanded:
        denom = torch.sqrt(an)[:, None] * torch.sqrt(bn_)[None, :]
        return 1.0 - g / _nonzero(denom)
    if metric == DistanceType.CorrelationExpanded:
        gc = g - asum[:, None] * bsum[None, :] / d
        anc = relu0(an - asum * asum / d)
        bnc = relu0(bn_ - bsum * bsum / d)
        denom = torch.sqrt(anc)[:, None] * torch.sqrt(bnc)[None, :]
        return 1.0 - gc / _nonzero(denom)
    if metric == DistanceType.HellingerExpanded:
        # the gram was computed on root-transformed values
        return torch.sqrt(relu0(1.0 - g))
    if metric == DistanceType.RusselRaoExpanded:
        return (d - g) / d
    if metric == DistanceType.JaccardExpanded:
        denom = asum[:, None] + bsum[None, :] - g
        return 1.0 - g / _nonzero(denom)
    if metric == DistanceType.DiceExpanded:
        denom = asum[:, None] + bsum[None, :]
        return 1.0 - 2.0 * g / _nonzero(denom)
    raise NotImplementedError(metric)


def _scatter_colblock(rows, cols, vals, in_blk, n_rows, c0, cb):
    """Dense (n_rows, cb) slab of the entries flagged ``in_blk``; the rest
    land on a dummy row that is sliced off."""
    r = torch.where(in_blk, rows, n_rows)
    lc = torch.where(in_blk, cols - c0, 0)
    dense = torch.zeros((n_rows + 1, cb), dtype=torch.float32,
                        device=vals.device)
    dense[r, lc] = torch.where(in_blk, vals, torch.zeros_like(vals))
    return dense[:n_rows]


def _spec(metric, p, what):
    errors.expects(metric != DistanceType.Haversine,
                   "haversine has d=2; use %s", what)
    return (_lp_table(p) if metric == DistanceType.LpUnexpanded
            else _UNEXPANDED_TABLE[metric])


def _make_accumulators(expanded, spec, m, ncols, dev):
    """Zero accumulators: one gram, or one a core term."""
    n_acc = 1 if expanded else len(spec["core"](torch.zeros(1),
                                                torch.zeros(1)))
    return [torch.zeros((m, ncols), dtype=torch.float32, device=dev)
            for _ in range(n_acc)]


def _core_reduce(spec, da, db):
    """The unexpanded core's per-feature terms of (m, cb) x (n, cb) slabs,
    reduced over the block's features, in (rows, cols, cb) broadcast
    tiles of at most ``_TILE_ELEMS`` elements (XLA fuses the broadcast;
    each entry's reduction sees the block's whole feature row)."""
    m, cb = da.shape
    n = db.shape[0]
    red = ((lambda t: torch.sum(t, dim=-1)) if spec["reducer"] == "sum"
           else (lambda t: torch.amax(t, dim=-1)))
    bn = max(1, min(n, _TILE_ELEMS // max(cb, 1)))
    bm = max(1, _TILE_ELEMS // (bn * max(cb, 1)))
    outs = None
    for i in range(0, m, bm):
        for j in range(0, n, bn):
            terms = spec["core"](da[i:i + bm, None, :], db[None, j:j + bn, :])
            if outs is None:
                outs = [torch.empty((m, n), dtype=torch.float32,
                                    device=da.device) for _ in terms]
            for o, t in zip(outs, terms):
                o[i:i + bm, j:j + bn] = red(t)
    return outs


def _accumulate_block(expanded, spec, accs, da, db):
    """Fold one (m, cb) x (n, cb) pair of dense slabs into the running
    accumulators: the gram for expanded metrics (full f32), the reduced
    core terms for unexpanded ones."""
    if expanded:
        accs[0] = accs[0] + _gram(da, db)
        return accs
    comb = torch.add if spec["reducer"] == "sum" else torch.maximum
    return [comb(a, r) for a, r in zip(accs, _core_reduce(spec, da, db))]


def _occupancy(ids, valid, n_bins: int) -> torch.Tensor:
    """Entries a bin holds: ``valid`` entries counted in ``ids``' bins
    (padding counted in a dropped bin), on the device."""
    return torch.zeros(n_bins + 1, dtype=torch.int64,
                       device=ids.device).index_add_(
        0, torch.where(valid, ids, n_bins),
        torch.ones_like(ids))[:n_bins]


def _finish(metric, spec, accs, an, asum, bn_, bsum, d, p, c0, n):
    """The metric from the accumulators of index columns [c0, c0 + bn),
    columns past ``n`` at +inf."""
    if metric in EXPANDED_METRICS:
        out = _expanded_from_gram(metric, accs[0], an, asum, bn_, bsum, d)
    else:
        out = spec["fin"](tuple(accs), d, p)
    cols = c0 + torch.arange(out.shape[1], device=out.device)[None, :]
    return torch.where(cols < n, out, float("inf"))


def _colblock_pair_dists(a: CSR, b: CSR, metric, p, col_block, block_n):
    """(m, n) distances via the colblock strategy, by index row blocks of
    ``block_n``: returns ``(one_nblock, nnb, bn)``, ``one_nblock(j)``
    the +inf-padded (m, bn) slab against index rows [j*bn, (j+1)*bn).
    One host read of the block occupancy a call."""
    metric = _canonicalize_colblock_metric(metric)
    m, d = a.shape
    n = b.shape[0]
    bn = min(block_n, n)
    nnb = -(-n // bn)
    ncb = -(-d // col_block)
    expanded = metric in EXPANDED_METRICS
    spec = None if expanded else _spec(metric, p, "strategy='dense'")
    dev = a.data.device

    avals = _value_transform(metric, a.data.float())
    bvals = _value_transform(metric, b.data.float())
    arows, avalid, acols = a.row_ids().long(), a.valid_mask(), a.indices.long()
    brows, bvalid, bcols = b.row_ids().long(), b.valid_mask(), b.indices.long()
    an, asum = _row_stats(a)
    bn_stats, bsum = _row_stats(b)
    if metric == DistanceType.HellingerExpanded:
        # stats on transformed values: |sqrt(x)|^2 = rowsum(x)
        an, bn_stats = asum, bsum
    # the column blocks a occupies, and each (column block, row block)
    # cell of b: one host read
    occ = _host(torch.cat([
        _occupancy(acols // col_block, avalid, ncb),
        _occupancy((bcols // col_block) * nnb + brows // bn, bvalid,
                   ncb * nnb)]))
    a_occ, b_occ = occ[:ncb] > 0, occ[ncb:].reshape(ncb, nnb) > 0

    def one_nblock(j):
        nb0 = j * bn
        b_inrow = bvalid & (brows >= nb0) & (brows < nb0 + bn)
        accs = _make_accumulators(expanded, spec, m, bn, dev)
        for c in range(ncb):
            # a gram gains nothing from a block empty on either side; an
            # unexpanded core still sees one-sided values
            live = (a_occ[c] and b_occ[c, j]) if expanded else (
                a_occ[c] or b_occ[c, j])
            if not live:
                continue
            c0 = c * col_block
            a_in = avalid & (acols >= c0) & (acols < c0 + col_block)
            b_in = b_inrow & (bcols >= c0) & (bcols < c0 + col_block)
            da = _scatter_colblock(arows, acols, avals, a_in, m, c0,
                                   col_block)
            db = _scatter_colblock(brows - nb0, bcols, bvals, b_in, bn, c0,
                                   col_block)
            accs = _accumulate_block(expanded, spec, accs, da, db)
        bpad = torch.nn.functional.pad
        pad = (0, nb0 + bn - min(nb0 + bn, n))
        return _finish(metric, spec, accs, an, asum,
                       bpad(bn_stats[nb0:nb0 + bn], pad),
                       bpad(bsum[nb0:nb0 + bn], pad), d, p, nb0, n)

    return one_nblock, nnb, bn


# ---------------------------------------------------------------------------
# Prebuilt column-blocked index: build once (host), search many (device).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseColBlockIndex:
    """Entries grouped by column block, sorted by (row, local col) within a
    block, padded per block to a common capacity. Padding lands on a
    dummy row (row = n, lcol = col_block - 1, val = 0).

    ``rb_off[j, r]`` marks where index row block r begins within column
    block j's sorted entries, so each (column block x row block) cell is
    one contiguous slice and searches stream index row blocks. The entry
    arrays carry ``cap_cell`` entries of extra padding, as in the JAX
    package. ``rb_off_host`` / ``counts_host`` are numpy copies of the
    offsets and counts (made at construction), from which a search reads
    each cell's occupancy with no host sync."""

    rows: torch.Tensor       # (ncb, cap_blk + cap_cell) int32
    lcols: torch.Tensor      # (ncb, cap_blk + cap_cell) int32
    vals: torch.Tensor       # (ncb, cap_blk + cap_cell) f32
    counts: torch.Tensor     # (ncb,) int32: live entries per block
    rb_off: torch.Tensor     # (ncb, nrb + 1) int32: row-block boundaries
    shape: Tuple[int, int]
    col_block: int
    row_block: int
    cap_cell: int
    rb_off_host: Optional[np.ndarray] = dataclasses.field(default=None,
                                                          repr=False)
    counts_host: Optional[np.ndarray] = dataclasses.field(default=None,
                                                          repr=False)

    def __post_init__(self):
        self.shape = tuple(int(v) for v in self.shape)
        if self.rb_off_host is None:
            self.rb_off_host = self.rb_off.cpu().numpy()
        if self.counts_host is None:
            self.counts_host = self.counts.cpu().numpy()


def sparse_colblock_index_build(x, col_block: int = 4096,
                                row_block: int = 4096, *,
                                device=None) -> SparseColBlockIndex:
    """Host-side build from a CSR, a scipy sparse matrix, or a dense array
    or tensor. ``row_block`` fixes the search-time row streaming (the
    (m, row_block) distance-slab height). The index lands on ``device``
    when given, else on ``x``'s device if it is a CSR or a tensor, else
    on CUDA (raising without it)."""
    if isinstance(x, CSR):
        dev = call_device(x.indptr, device=device)
        valid = x.valid_mask().cpu().numpy()
        rows = x.row_ids().cpu().numpy()[valid]
        cols = x.indices.cpu().numpy()[valid]
        vals = x.data.cpu().numpy()[valid]
        shape = x.shape
    elif hasattr(x, "tocoo"):  # scipy sparse
        dev = call_device(device=device)
        coo = x.tocoo()
        rows, cols, vals = coo.row, coo.col, coo.data
        shape = coo.shape
    else:
        dev = call_device(x, device=device)
        dense = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x))
        rows, cols = np.nonzero(dense)
        vals = dense[rows, cols]
        shape = dense.shape
    n, d = shape
    row_block = min(row_block, n)
    errors.expects(
        (max(n, row_block) + 1) * col_block < 2**31,
        "segment ids overflow int32: (n+1)*col_block = %d",
        (n + 1) * col_block,
    )
    ncb = max(-(-d // col_block), 1)
    nrb = max(-(-n // row_block), 1)
    blk = cols // col_block
    lcols = cols - blk * col_block
    order = np.lexsort((lcols, rows, blk))
    blk, rows, lcols, vals = blk[order], rows[order], lcols[order], vals[order]
    counts = np.bincount(blk, minlength=ncb).astype(np.int32)
    cap = max(int(counts.max()) if len(counts) else 1, 1)

    # per-(col block, row block) cell boundaries and the widest cell
    starts = np.concatenate([[0], np.cumsum(counts)])
    rb_off = np.zeros((ncb, nrb + 1), np.int32)
    for j in range(ncb):
        s, e = starts[j], starts[j + 1]
        rb_off[j] = np.searchsorted(
            rows[s:e], np.arange(nrb + 1) * row_block, side="left"
        ).astype(np.int32)
    cap_cell = max(int(np.diff(rb_off, axis=1).max()) if rb_off.size else 1,
                   1)

    out_r = np.full((ncb, cap + cap_cell), n, np.int32)
    out_c = np.full((ncb, cap + cap_cell), col_block - 1, np.int32)
    out_v = np.zeros((ncb, cap + cap_cell), np.float32)
    for j in range(ncb):
        s, e = starts[j], starts[j + 1]
        out_r[j, : e - s] = rows[s:e]
        out_c[j, : e - s] = lcols[s:e]
        out_v[j, : e - s] = vals[s:e]
    return SparseColBlockIndex(
        torch.as_tensor(out_r, device=dev), torch.as_tensor(out_c, device=dev),
        torch.as_tensor(out_v, device=dev), torch.as_tensor(counts,
                                                            device=dev),
        torch.as_tensor(rb_off, device=dev), (n, d), col_block, row_block,
        cap_cell, rb_off_host=rb_off, counts_host=counts,
    )


def _sorted_segment_dense(ids, vals, n_rows: int, cb: int):
    """The dense (n_rows, cb) slab of entries at flat positions ``ids``
    (sorted), repeated positions added in their order: each run's sum by
    ``segment_reduce`` (run start i gets the segment up to the next run
    start, every other position an empty one), then one indexed write of
    the distinct positions."""
    e = ids.shape[0]
    if e == 0:
        return torch.zeros((n_rows, cb), dtype=torch.float32,
                           device=vals.device)
    start = torch.ones(e, dtype=torch.bool, device=ids.device)
    start[1:] = ids[1:] != ids[:-1]
    pos = torch.arange(e, device=ids.device)
    nxt = torch.where(start, pos, e)
    # offsets[i] = the first run start at or after i
    offsets = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,))
    offsets = torch.cat([offsets, offsets.new_tensor([e])])
    sums = torch.segment_reduce(vals, "sum", offsets=offsets, unsafe=True)
    flat = torch.zeros(n_rows * cb + 1, dtype=torch.float32,
                       device=vals.device)
    flat[torch.where(start, ids, n_rows * cb)] = sums
    return flat[:-1].reshape(n_rows, cb)


def _layout_block_dists(layout: SparseColBlockIndex, a: CSR, metric, p):
    """Row-block streaming distances of CSR queries against a prebuilt
    index: returns ``(one_nblock, nrb, bn)`` as
    :func:`_colblock_pair_dists` does. A cell's index side is one
    contiguous slice of presorted entries and a sorted segment sum; its
    occupancy comes from the host copy of ``rb_off``, the query side's
    from one host read a call."""
    metric = _canonicalize_colblock_metric(metric)
    m, d = a.shape
    n = layout.shape[0]
    cb = layout.col_block
    bn = layout.row_block
    ncb = layout.rows.shape[0]
    nrb = layout.rb_off_host.shape[1] - 1
    expanded = metric in EXPANDED_METRICS
    spec = None if expanded else _spec(metric, p, "a CSR index")
    dev = a.data.device

    avals = _value_transform(metric, a.data.float())
    lvals = _value_transform(metric, layout.vals)
    arows, avalid, acols = a.row_ids().long(), a.valid_mask(), a.indices.long()
    an, asum = _row_stats(a)

    # index row stats from the layout, each row's entries added in
    # column order (the layout's flat order within a row)
    flat_r = layout.rows.reshape(-1).long()
    flat_v = lvals.reshape(-1)
    by_row = torch.sort(flat_r, stable=True)
    sr, sv = by_row.values, flat_v[by_row.indices]
    offsets = torch.searchsorted(sr, torch.arange(
        n + 2, device=dev))
    bn_stats = torch.segment_reduce(sv * sv, "sum", offsets=offsets,
                                    unsafe=True)[:n]
    bsum = torch.segment_reduce(sv, "sum", offsets=offsets, unsafe=True)[:n]
    a_occ = _host(_occupancy(acols // cb, avalid, ncb)) > 0
    cells = np.diff(layout.rb_off_host, axis=1)           # (ncb, nrb)

    def one_nblock(r):
        r0 = r * bn
        accs = _make_accumulators(expanded, spec, m, bn, dev)
        for j in range(ncb):
            cnt = int(cells[j, r])
            live = (a_occ[j] and cnt > 0) if expanded else (
                a_occ[j] or cnt > 0)
            if not live:
                continue
            c0 = j * cb
            a_in = avalid & (acols >= c0) & (acols < c0 + cb)
            da = _scatter_colblock(arows, acols, avals, a_in, m, c0, cb)
            off = int(layout.rb_off_host[j, r])
            rr = layout.rows[j, off:off + cnt].long()
            lc = layout.lcols[j, off:off + cnt].long()
            db = _sorted_segment_dense((rr - r0) * cb + lc,
                                       lvals[j, off:off + cnt], bn, cb)
            accs = _accumulate_block(expanded, spec, accs, da, db)
        aa = asum if metric == DistanceType.HellingerExpanded else an
        pad = (0, r0 + bn - min(r0 + bn, n))
        bpad = torch.nn.functional.pad
        return _finish(metric, spec, accs, aa, asum,
                       bpad(bn_stats[r0:r0 + bn], pad),
                       bpad(bsum[r0:r0 + bn], pad), d, p, r0, n)

    return one_nblock, nrb, bn


def _check_precision(precision):
    errors.expects(precision in _PRECISIONS,
                   "precision must be one of %s, got %r", _PRECISIONS,
                   precision)


def _strided(one_nblock, nb: int, n: int):
    """The (m, n) matrix of every row block's slab."""
    return torch.cat([one_nblock(j) for j in range(nb)], dim=1)[:, :n]


def _on(csr: CSR, dev) -> CSR:
    return CSR(*(t.to(dev) for t in (csr.indptr, csr.indices, csr.data,
                                      csr.nnz)), csr.shape)


def sparse_pairwise_distance(a: CSR, b, metric="l2_sqrt_expanded", *,
                             p: float = 2.0, block_m: int = 512,
                             strategy: str = "auto", col_block: int = 4096,
                             block_n=None, precision=None, device=None):
    """Full (m, n) distance matrix between CSR row sets (reference
    sparse/distance/distance.cuh pairwiseDistance dispatch).

    ``strategy``: "dense" (row densification, moderate d), "colblock"
    (column-blocked accumulation, high d), or "auto", which takes
    colblock once a densified side would exceed ``_DENSE_BYTES_BUDGET``.
    ``b`` may also be a prebuilt :class:`SparseColBlockIndex` (always
    colblock). ``precision`` is accepted as ``fused_l2_nn`` accepts it:
    every value runs full f32 products. Runs on ``device`` when given,
    else on ``a``'s device."""
    _check_precision(precision)
    metric = resolve_metric(metric)
    dev = call_device(a.indptr, device=device)
    a = _on(a, dev)
    if isinstance(b, SparseColBlockIndex):
        errors.expects(
            a.shape[1] == b.shape[1],
            "column mismatch: a has %d, index has %d", a.shape[1], b.shape[1],
        )
        one_nblock, nrb, _ = _layout_block_dists(b, a, metric, p)
        return _strided(one_nblock, nrb, b.shape[0])
    b = _on(b, dev)
    m, d = a.shape
    n = b.shape[0]
    errors.expects(
        a.shape[1] == b.shape[1],
        "column mismatch: a has %d, b has %d", a.shape[1], b.shape[1],
    )
    errors.expects(
        strategy in ("auto", "dense", "colblock"),
        "unknown strategy %r (auto|dense|colblock)", strategy,
    )
    if strategy == "auto":
        # budget both densified sides: the full index and one query block
        dense_bytes = max(n, min(block_m, m)) * d * 4
        strategy = ("colblock" if dense_bytes > _DENSE_BYTES_BUDGET
                    else "dense")
        if metric == DistanceType.Haversine:
            strategy = "dense"

    if strategy == "colblock":
        one_nblock, nnb, _ = _colblock_pair_dists(
            a, b, metric, p, col_block, _pick_block_n(block_n, m, n))
        return _strided(one_nblock, nnb, n)

    bd = densify_rows(b, 0, n)  # the index side densified once
    bm = min(block_m, m)
    return torch.cat([_block_dist(densify_rows(a, i, bm), bd, metric, p)
                      for i in range(0, m, bm)])[:m]


def _stream_topk(one_nblock, nb: int, bn: int, m: int, k: int, dev):
    """The k smallest of every row over the row-block slabs: each slab's
    own top-k merged into a running list."""
    if nb == 1:
        vals, idxs = top_k_smallest(one_nblock(0), min(k, bn))
        return vals, idxs.to(torch.int32)
    rv = torch.full((m, k), float("inf"), dtype=torch.float32, device=dev)
    ri = torch.zeros((m, k), dtype=torch.int32, device=dev)
    for j in range(nb):
        bv, bi = top_k_smallest(one_nblock(j), min(k, bn))
        rv, ri = merge_topk(rv, ri, bv, bi + j * bn, select_min=True)
    return rv, ri.to(torch.int32)


def sparse_brute_force_knn(index, queries: CSR, k: int, *,
                           metric="l2_sqrt_expanded", p: float = 2.0,
                           block_q: int = 512, block_n=None,
                           strategy: str = "auto", col_block: int = 4096,
                           precision=None, device=None):
    """Batched sparse brute-force kNN (reference
    sparse/selection/knn.cuh:54 ``brute_force_knn``): densified blocks
    and a streaming top-k merge, or with ``strategy="colblock"`` the
    (all queries x index row block) slabs accumulated over column blocks
    (O(rows x col_block) memory, any d). ``index`` may also be a
    prebuilt :class:`SparseColBlockIndex`, the repeated-search path.

    ``precision``: ``None``, ``"highest"`` or ``"default"``; all run full
    f32 products (the JAX package's ``"default"`` is its TPU's bf16
    path, IEEE f32 on its CPU reference). Runs on ``device`` when given,
    else on ``queries``' device. Returns (dists (m, k) f32, indices
    (m, k) int32), nearest first, ties to the lowest index."""
    _check_precision(precision)
    metric = resolve_metric(metric)
    dev = call_device(queries.indptr, device=device)
    queries = _on(queries, dev)
    m = queries.shape[0]
    n = index.shape[0]
    errors.check_k(k, n)
    errors.expects(
        queries.shape[1] == index.shape[1],
        "column mismatch: queries have %d, index has %d",
        queries.shape[1], index.shape[1],
    )
    if isinstance(index, SparseColBlockIndex):
        one_nblock, nrb, bn = _layout_block_dists(index, queries, metric, p)
        return _stream_topk(one_nblock, nrb, bn, m, k, dev)
    index = _on(index, dev)
    errors.expects(
        strategy in ("auto", "dense", "colblock"),
        "unknown strategy %r (auto|dense|colblock)", strategy,
    )
    if strategy == "auto":
        # budget both densified sides: one index block and one query block
        dense_rows = max(min(block_n or 2048, n), min(block_q, m))
        strategy = ("colblock"
                    if dense_rows * index.shape[1] * 4 > _DENSE_BYTES_BUDGET
                    else "dense")
        if metric == DistanceType.Haversine:
            strategy = "dense"

    if strategy == "colblock":
        one_nblock, nnb, bn = _colblock_pair_dists(
            queries, index, metric, p, col_block,
            max(k, _pick_block_n(block_n, m, n)))
        return _stream_topk(one_nblock, nnb, bn, m, k, dev)

    bn = max(k, min(block_n or 2048, n))
    bq = min(block_q, m)
    out_v, out_i = [], []
    for q0 in range(0, m, bq):
        qd = densify_rows(queries, q0, bq)
        rv = torch.full((bq, k), float("inf"), dtype=torch.float32,
                        device=dev)
        ri = torch.zeros((bq, k), dtype=torch.int32, device=dev)
        cols = torch.arange(bn, device=dev)[None, :]
        for j0 in range(0, n, bn):
            yd = densify_rows(index, j0, bn)
            dmat = torch.where(j0 + cols < n, _block_dist(qd, yd, metric, p),
                               float("inf"))
            bv, bi = top_k_smallest(dmat, k)
            rv, ri = merge_topk(rv, ri, bv, bi + j0, select_min=True)
        out_v.append(rv)
        out_i.append(ri)
    return (torch.cat(out_v)[:m], torch.cat(out_i)[:m].to(torch.int32))
