"""multi_variable_gaussian of the port — the counterpart of
``raft_tpu/random/multi_variable_gaussian.py`` (reference
cpp/include/raft/random/multi_variable_gaussian.cuh: a Cholesky or
eigendecomposition of the covariance and a product with standard
normals).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.device import as_tensor, full_f32
from raft_tpu_torch.random.rng import _resolve

__all__ = ["multi_variable_gaussian"]


@full_f32
def multi_variable_gaussian(state, n_points: int, mu, cov,
                            method: str = "cholesky", dtype=torch.float32,
                            *, generator=None, device=None):
    """``n_points`` draws from N(mu, cov) as columns: (dim, n_points),
    like the reference. ``method="cholesky"``, or any other value for an
    eigendecomposition square root (PSD but singular covariances)."""
    gen, dev = _resolve(state, generator, device, mu, cov)
    mu = as_tensor(mu, dev).to(dtype)
    cov = as_tensor(cov, dev).to(dtype)
    dim = mu.shape[0]
    z = torch.randn((dim, n_points), generator=gen, dtype=dtype, device=dev)
    if method == "cholesky":
        lower = torch.linalg.cholesky(cov)
    else:
        w, v = torch.linalg.eigh(cov)
        lower = v * torch.sqrt(torch.clamp_min(w, 0.0))[None, :]
    return mu[:, None] + lower @ z
