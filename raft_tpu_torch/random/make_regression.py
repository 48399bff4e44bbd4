"""make_regression of the port — the counterpart of
``raft_tpu/random/make_regression.py`` (reference
cpp/include/raft/random/make_regression.cuh and
detail/make_regression.cuh: Gaussian X, optionally of low effective
rank through an SVD-shaped spectrum, ``n_informative`` coefficients,
bias, noise, shuffle; X, y and optionally the coefficients).
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.random.rng import RngState, _resolve

__all__ = ["make_regression"]


def _low_rank_matrix(gen, n_samples, n_features, effective_rank,
                     tail_strength, dtype, dev):
    # singular profile: a bell-shaped low rank plus an exponential tail
    # (the reference's and sklearn's construction)
    n = min(n_samples, n_features)
    u, _ = torch.linalg.qr(torch.randn((n_samples, n), generator=gen,
                                       dtype=dtype, device=dev))
    v, _ = torch.linalg.qr(torch.randn((n_features, n), generator=gen,
                                       dtype=dtype, device=dev))
    sing_ind = torch.arange(n, dtype=dtype, device=dev) / effective_rank
    s = ((1 - tail_strength) * torch.exp(-(sing_ind ** 2))
         + tail_strength * torch.exp(-0.1 * sing_ind))
    return (u * s[None, :]) @ v.T


@full_f32
def make_regression(n_samples: int, n_features: int, n_informative: int,
                    state: Optional[RngState] = None, n_targets: int = 1,
                    bias: float = 0.0, effective_rank: Optional[int] = None,
                    tail_strength: float = 0.5, noise: float = 0.0,
                    shuffle: bool = True, coef: bool = False,
                    dtype=torch.float32, *,
                    generator: Optional[torch.Generator] = None,
                    device=None):
    """Returns (X, y[, w]) with y = X @ w + bias + noise * N(0, 1), the
    products in full f32."""
    gen, dev = _resolve(state, generator, device)
    if effective_rank is None:
        x = torch.randn((n_samples, n_features), generator=gen, dtype=dtype,
                        device=dev)
    else:
        x = _low_rank_matrix(gen, n_samples, n_features, effective_rank,
                             tail_strength, dtype, dev)

    n_informative = min(n_informative, n_features)
    w = torch.zeros((n_features, n_targets), dtype=dtype, device=dev)
    w[:n_informative] = 100.0 * torch.rand((n_informative, n_targets),
                                           generator=gen, dtype=dtype,
                                           device=dev)
    y = x @ w + bias
    if noise > 0:
        y = y + noise * torch.randn(y.shape, generator=gen, dtype=dtype,
                                    device=dev)
    if shuffle:
        row_perm = torch.randperm(n_samples, generator=gen, device=dev)
        col_perm = torch.randperm(n_features, generator=gen, device=dev)
        x = x[row_perm][:, col_perm]
        y = y[row_perm]
        w = w[col_perm]

    y = y[:, 0] if n_targets == 1 else y
    if coef:
        return x, y, (w[:, 0] if n_targets == 1 else w)
    return x, y
