"""The yardstick of the roofline metrics: the card's peaks and the least
work of a search batch and of each list-scan launch.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit: 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3. The
least time of some work is the larger of its operations at the bf16
rate and its bytes at the HBM rate.

The counts come from the inputs, not from how the program does the work,
so they read the same whatever implements it:

* operations: 2·d per (query, row of a probed list) for the flat scan,
  M per (query, code row) for the PQ ADC scan;
* bytes: each distinct probed list's rows read once at the width the
  index stores for its scan (bf16 rows for IVF-Flat, M bytes of codes
  for IVF-PQ); for a whole search also the f32 queries in and the k
  answers (f32 distance, int32 id) out.

A change of the stored width changes this yardstick.
"""

from __future__ import annotations

import torch

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_time_s(ops: float, nbytes: float) -> float:
    return max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def probe(q: torch.Tensor, centroids: torch.Tensor, n_probes: int) -> torch.Tensor:
    """The ``n_probes`` lists nearest each query (squared L2, f32)."""
    c = centroids.float()
    qf = q.float()
    d2 = (qf * qf).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * (qf @ c.T)
    return torch.topk(d2, n_probes, dim=1, largest=False).indices


def search_counts(probes: torch.Tensor, list_sizes: torch.Tensor, *, dim: int,
                  k: int, ops_per_row: int, row_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one search batch whose queries probe
    ``probes`` (nq, p) of lists sized ``list_sizes``."""
    sizes = list_sizes.long()
    nq = probes.shape[0]
    ops = ops_per_row * int(sizes[probes].sum())
    listed = torch.unique(probes)
    nbytes = int(sizes[listed].sum()) * row_bytes + nq * dim * 4 + nq * k * 8
    return ops, nbytes


def _live_spans(live: torch.Tensor, bounds: torch.Tensor, l_pad: int):
    n_live = live.sum(1).long()
    span = (bounds[:, 1].long().clamp(0, l_pad)
            - bounds[:, 0].long().clamp(0, l_pad)).clamp(min=0)
    return n_live, torch.where(n_live > 0, span, 0)


def flat_scan_counts(n_ids, qmat, dim, row_size, query_size, bounds,
                     l_pad) -> tuple[int, int]:
    """(operations, bytes) of one flat list-scan launch (``flat_scan_lists``
    with ``qmat`` naming query rows ``[0, n_ids)``, ``row_size`` /
    ``query_size`` bytes an element): the rows in [lo, hi) of every list
    with a live query slot, and each distinct live query row, read once."""
    live = (qmat >= 0) & (qmat < n_ids)
    n_live, span = _live_spans(live, bounds, l_pad)
    ops = 2 * dim * int((n_live * span).sum())
    nbytes = (int(span.sum()) * dim * row_size
              + torch.unique(qmat[live]).numel() * dim * query_size)
    return ops, nbytes


def pq_adc_counts(n_luts, lut_map, m, code_size, bounds, l_pad) -> tuple[int, int]:
    """(operations, bytes) of one PQ ADC launch (``pq_adc_lists`` over
    ``n_luts`` LUT rows): M per (live slot, code row in [lo, hi)), each
    live list's codes read once."""
    live = (lut_map >= 0) & (lut_map < n_luts)
    n_live, span = _live_spans(live, bounds, l_pad)
    ops = m * int((n_live * span).sum())
    nbytes = int(span.sum()) * m * code_size
    return ops, nbytes
