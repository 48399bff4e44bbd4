"""Decompositions and solvers of the port — the counterpart of
``raft_tpu/linalg/decomp.py`` (reference linalg/detail/{eig,svd,rsvd,qr,
lstsq,cholesky_r1_update}.cuh over cuSOLVER).

Every factorization is ``torch.linalg`` (cuSOLVER on the card), in the
input's float dtype with TF32 off. Eigen- and singular vectors are
unique only up to sign, so they may differ from the JAX package's by a
sign per column. The divide-and-conquer and Jacobi variants share one
implementation each, as in the JAX package.

``rsvd_fixed_rank`` / ``rsvd_perc`` draw their test matrix from a
``torch.Generator`` (``generator=``; default a CPU generator seeded 0)
where the JAX package takes a PRNG key: the draws differ between the
packages, the singular values of a matrix of rank <= k do not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import as_tensor, call_device, full_f32
from raft_tpu_torch.linalg.gemm import gemm

__all__ = [
    "eig_dc", "eig_jacobi", "eig_sel_dc", "qr_get_q", "qr_get_qr", "svd_qr",
    "svd_eig", "svd_jacobi", "svd_reconstruction", "rsvd_fixed_rank",
    "rsvd_perc", "lstsq_svd_qr", "lstsq_svd_jacobi", "lstsq_eig",
    "lstsq_qr", "cholesky_rank1_update",
]


def _t(x, device=None):
    return as_tensor(x, call_device(x, device=device))


# -- symmetric eigen (reference linalg/detail/eig.cuh:32-231) ----------------

@full_f32
def eig_dc(cov, n_eig_vals: Optional[int] = None, *, device=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a symmetric matrix, eigenvalues ascending
    (reference eigDC via syevd). Returns (eig_vectors in columns,
    eig_vals)."""
    w, v = torch.linalg.eigh(_t(cov, device))
    if n_eig_vals is not None:
        w = w[:n_eig_vals]
        v = v[:, :n_eig_vals]
    return v, w


def eig_jacobi(cov, tol: float = 1e-7, sweeps: int = 15, *, device=None):
    """Jacobi variant (reference eigJacobi). ``tol`` and ``sweeps`` are
    validated and then unused: the port solves with ``torch.linalg.eigh``
    (cuSOLVER's divide and conquer on the card), exact to working
    precision, which no positive ``tol`` or sweep budget loosens."""
    errors.expects(tol > 0, "tol must be > 0, got %s", tol)
    errors.expects(sweeps >= 1, "sweeps must be >= 1, got %s", sweeps)
    return eig_dc(cov, device=device)


@full_f32
def eig_sel_dc(cov, n_eig_vals: int, largest: bool = True, *, device=None):
    """The ``n_eig_vals`` largest (or smallest) eigenpairs (reference
    eigSelDC via syevdx), in ascending order."""
    w, v = torch.linalg.eigh(_t(cov, device))
    if largest:
        return v[:, -n_eig_vals:], w[-n_eig_vals:]
    return v[:, :n_eig_vals], w[:n_eig_vals]


# -- QR (reference linalg/detail/qr.cuh) -------------------------------------

@full_f32
def qr_get_q(a, *, device=None) -> torch.Tensor:
    return torch.linalg.qr(_t(a, device), mode="reduced")[0]


@full_f32
def qr_get_qr(a, *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    q, r = torch.linalg.qr(_t(a, device), mode="reduced")
    return q, r


# -- SVD (reference linalg/detail/svd.cuh:39-171) ----------------------------

@full_f32
def svd_qr(a, gen_left_vec: bool = True, gen_right_vec: bool = True, *,
           device=None):
    """Thin SVD (reference svdQR over gesvd). Returns (u, s, v) with the
    right singular vectors in the COLUMNS of v (not vᵀ), as the
    reference returns them."""
    u, s, vt = torch.linalg.svd(_t(a, device), full_matrices=False)
    return (u if gen_left_vec else None, s, vt.T if gen_right_vec else None)


@full_f32
def svd_eig(a, *, device=None):
    """SVD through the eigendecomposition of the Gram matrix aᵀa
    (reference svdEig, for tall-skinny a). Returns (u, s, v), s
    descending."""
    a = _t(a, device)
    w, v = torch.linalg.eigh(gemm(a, a, trans_a=True))
    w = torch.flip(w, (0,))
    v = torch.flip(v, (1,))
    s = torch.sqrt(torch.clamp_min(w, 0))
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return gemm(a, v) / safe[None, :], s, v


def svd_jacobi(a, tol: float = 1e-7, sweeps: int = 15, *, device=None):
    """Jacobi variant (reference svdJacobi via gesvdj): ``tol`` and
    ``sweeps`` are validated and unused, as for :func:`eig_jacobi`."""
    errors.expects(tol > 0, "tol must be > 0, got %s", tol)
    errors.expects(sweeps >= 1, "sweeps must be >= 1, got %s", sweeps)
    return svd_qr(a, device=device)


def svd_reconstruction(u, s, v, *, device=None):
    """u @ diag(s) @ vᵀ (reference svdReconstruction)."""
    dev = call_device(u, s, v, device=device)
    us = as_tensor(u, dev) * as_tensor(s, dev)[None, :]
    return gemm(us, as_tensor(v, dev), trans_b=True)


# -- randomized SVD (reference linalg/detail/rsvd.cuh:57,374) ----------------

def rsvd_fixed_rank(a, k: int, p: int = 10, n_iters: int = 2, *,
                    generator: Optional[torch.Generator] = None,
                    use_bbt: bool = False, device=None):
    """Randomized SVD with oversampling ``p`` and ``n_iters`` subspace
    iterations (reference rsvdFixedRank: QB decomposition, then a small
    dense SVD). The test matrix is drawn on the host from ``generator``
    (default: seeded 0). Returns (u[:, :k], s[:k], v[:, :k])."""
    a = _t(a, device)
    m, n = a.shape
    l = min(k + p, n)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    omega = torch.randn((n, l), generator=generator, dtype=a.dtype,
                        device=generator.device).to(a.device)
    y = gemm(a, omega)                  # (m, l)
    q = qr_get_q(y)
    for _ in range(n_iters):
        z = gemm(a, q, trans_a=True)    # (n, l)
        q = qr_get_q(z)
        y = gemm(a, q)                  # (m, l)
        q = qr_get_q(y)
    b = gemm(q, a, trans_a=True)        # (l, n)
    ub, s, v = svd_qr(b)
    u = gemm(q, ub)
    return u[:, :k], s[:k], v[:, :k]


def rsvd_perc(a, perc: float, p: int = 10, n_iters: int = 2, *,
              generator: Optional[torch.Generator] = None, device=None):
    """The rank as a fraction of min(m, n) (reference rsvdPerc)."""
    a = _t(a, device)
    k = max(1, int(perc * min(a.shape)))
    return rsvd_fixed_rank(a, k, p=p, n_iters=n_iters, generator=generator)


# -- least squares (reference linalg/detail/lstsq.cuh:120-355) ---------------

@full_f32
def lstsq_svd_qr(a, b, *, device=None):
    """argmin ||a w - b|| through the SVD (reference lstsqSvdQR);
    singular values below 1e-10 x the largest are dropped."""
    dev = call_device(a, b, device=device)
    a = as_tensor(a, dev)
    b = as_tensor(b, dev)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    safe = torch.where(s > 1e-10 * s.max(), s, torch.full_like(s, torch.inf))
    return (vt.T * (1.0 / safe)[None, :]) @ (u.T @ b)


def lstsq_svd_jacobi(a, b, *, device=None):
    return lstsq_svd_qr(a, b, device=device)


@full_f32
def lstsq_eig(a, b, *, device=None):
    """Through the eigendecomposition of aᵀa (reference lstsqEig)."""
    dev = call_device(a, b, device=device)
    a = as_tensor(a, dev)
    b = as_tensor(b, dev)
    g = gemm(a, a, trans_a=True)
    rhs = a.T @ b
    w, v = torch.linalg.eigh(g)
    floor = 1e-10 * torch.clamp_min(w.max(), 1e-30)
    safe = torch.where(w > floor, w, torch.full_like(w, torch.inf))
    vr = v.T @ rhs
    return v @ (vr / (safe if vr.ndim == 1 else safe[:, None]))


@full_f32
def lstsq_qr(a, b, *, device=None):
    """Through a QR factorization (reference lstsqQR)."""
    dev = call_device(a, b, device=device)
    q, r = torch.linalg.qr(as_tensor(a, dev), mode="reduced")
    rhs = q.T @ as_tensor(b, dev)
    vec = rhs.ndim == 1
    out = torch.linalg.solve_triangular(r, rhs[:, None] if vec else rhs,
                                        upper=True)
    return out[:, 0] if vec else out


# -- Cholesky rank-1 update (reference linalg/detail/cholesky_r1_update.cuh) --

@full_f32
def cholesky_rank1_update(l, n: int, lower: bool = True, eps: float = 0.0,
                          *, device=None):
    """Grow a Cholesky factor by one row: ``l`` (n, n) holds the factor
    of A[:n-1, :n-1] in its leading block and A[n-1, :n] in its last row
    (lower; the transpose for ``lower=False``). Returns the factor of
    A[:n, :n]."""
    l = _t(l, device)
    if not lower:
        l = l.T
    l_prev = l[: n - 1, : n - 1]
    a_row = l[n - 1, : n - 1]
    a_nn = l[n - 1, n - 1]
    if n > 1:
        y = torch.linalg.solve_triangular(l_prev, a_row[:, None],
                                          upper=False)[:, 0]
    else:
        y = a_row
    d = a_nn - torch.dot(y, y)
    if eps > 0:
        d = torch.clamp_min(d, eps)
    out = l.clone()
    out[n - 1, : n - 1] = y
    out[n - 1, n - 1] = torch.sqrt(d)
    out[: n - 1, n - 1] = 0
    return out if lower else out.T
