"""The yardstick of the brute-force kNN rooflines: the least time of its
phase-1 launch (#6, ``chunk_mins``) and of its rescore launch (#7,
``rescore_scores``).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit: 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32 off
them, 3.35 TB/s of HBM3. The least time of some work is the larger of its
operations at its rate and its bytes at the HBM rate.

The counts come from the inputs, not from how the program does the work:

* phase 1 of m queries over n rows of width d: 2·d·m·n operations at the
  bf16 rate (the configuration ranks chunks in bf16); the rows read once
  at their stored width, the f32 queries in, the (m, ⌈n/128⌉) f32 chunk
  minima out;
* the rescore of m × c candidate chunks: 2·d·m·c·128 operations at the
  **f32** rate, since the rescore is exact f32; each distinct named
  chunk's rows read once at their stored width, the f32 queries in, the
  (m, c·128) f32 scores out.

A rescore moved onto the tensor cores would make its count stale; only a
``benchmark`` PR may change this yardstick.
"""

from __future__ import annotations

import torch

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
CHUNK = 128


def least_time_s(ops: float, nbytes: float, flop_per_s: float) -> float:
    return max(ops / flop_per_s, nbytes / HBM_BYTES_PER_S)


def chunk_mins_counts(m: int, n: int, d: int, row_size: int) -> tuple[int, int]:
    """(operations, bytes) of one phase-1 launch."""
    ops = 2 * d * m * n
    nbytes = n * d * row_size + m * d * 4 + m * -(-n // CHUNK) * 4
    return ops, nbytes


def chunk_mins_least_s(m: int, n: int, d: int, row_size: int) -> float:
    return least_time_s(*chunk_mins_counts(m, n, d, row_size), BF16_FLOP_PER_S)


def rescore_counts(cids: torch.Tensor, n: int, d: int, row_size: int) -> tuple[int, int]:
    """(operations, bytes) of one rescore launch over the candidate chunk
    ids ``cids`` (m, c) of an index of ``n`` rows."""
    m, c = cids.shape
    ops = 2 * d * m * c * CHUNK
    chunks = torch.unique(cids.long())
    rows = int((n - chunks * CHUNK).clamp(0, CHUNK).sum())
    nbytes = rows * d * row_size + m * d * 4 + m * c * CHUNK * 4
    return ops, nbytes


def rescore_least_s(cids: torch.Tensor, n: int, d: int, row_size: int) -> float:
    return least_time_s(*rescore_counts(cids, n, d, row_size), F32_FLOP_PER_S)
