"""The yardstick of the graph walk's candidate scan: the least time of one
launch of the beam kernel (#5, ``graph_kernel.beam_scan_score``).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit: 67 TFLOP/s in f32 off the tensor cores, 3.35 TB/s of HBM3. The
least time of some work is the larger of its operations at that rate and
its bytes at the HBM rate.

The counts come from the launch's inputs, ``ids`` (queries, Cpad) int32
into an (rows, d) f32 table, not from how the kernel does the work:

* bytes: each distinct row the ids name read once at 4·d bytes (a row
  named by many queries or slots is still one read: counting slots would
  pass 100% wherever rows repeat), the ids, the f32 queries and the
  (queries, 2) bounds in; the sub-chunk minima and the exact distances
  out;
* operations, at the f32 rate: 4·d a candidate slot (a dot on rounded
  and one on unrounded operands), and the norms once a distinct row and
  once a query.

This is ``chip_smoke.py``'s ``beam_bound``, kept here as the benchmark's
own; only a ``benchmark`` PR may change it.
"""

from __future__ import annotations

import torch

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
SUBCHUNK = 8


def beam_scan_counts(ids: torch.Tensor, d: int) -> tuple[int, float]:
    """(bytes, operations) of one launch over candidate ids ``ids``."""
    nq, c_pad = ids.shape
    distinct = torch.unique(ids).numel()
    nbytes = (distinct * 4 * d + nq * c_pad * 4 + nq * 4 * d + 8 * nq
              + nq * (c_pad // SUBCHUNK) * 4 + nq * c_pad * 4)
    ops = 4.0 * (nq * c_pad + distinct + nq) * d
    return nbytes, ops


def beam_scan_least_s(ids: torch.Tensor, d: int) -> float:
    nbytes, ops = beam_scan_counts(ids, d)
    return max(ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
