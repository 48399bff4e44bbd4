"""Lanczos eigensolver of the port — the counterpart of
``raft_tpu/linalg/lanczos.py`` (reference linalg/detail/lanczos.cuh:
computeSmallestEigenvectors:745 / computeLargestEigenvectors:1089).

Thick-restart Lanczos (Wu & Simon) with full reorthogonalization, as in
the JAX package: a fixed-width (ncv, n) basis, each step two classical
Gram-Schmidt passes against the rows filled so far, the projected
(ncv, ncv) matrix solved for its Ritz pairs, restart cycles that keep
the ``keep`` Ritz pairs nearest the wanted end, and a beta-based Ritz
residual test against ``tol``. The JAX package runs the cycles under
``lax.while_loop``; here they are a host loop. A Lanczos step makes no
host sync (breakdown is handled with ``torch.where``, as the JAX step
does); the convergence test copies the projected matrix and the last
beta to the host once a restart cycle, where the (ncv, ncv) eigenproblem
is solved.

Random draws come from ``torch.Generator``s where the JAX package uses
PRNG keys, so they differ between the packages: ``v0`` (when not given)
from a CPU generator seeded with ``seed``, the breakdown vectors from a
generator on the call's device seeded 1811. Passing the same ``v0`` to
both packages makes the solves comparable.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core import logger
from raft_tpu_torch.core.device import as_tensor, call_device, full_f32

__all__ = ["lanczos_solver", "lanczos_smallest_eigenvectors",
           "lanczos_largest_eigenvectors"]

_BREAKDOWN_SEED = 1811


def _reorth(V, w, j: int):
    """Two passes of classical Gram-Schmidt of w against rows 0..j of V."""
    Vm = V[: j + 1]
    for _ in range(2):
        w = w - Vm.T @ (Vm @ w)
    return w


def _lanczos_extend(matvec, V, B, v_start, start: int, gen):
    """Fill rows ``start`` .. ncv-1 of the orthonormal basis V with
    Lanczos steps, writing alpha / beta into B. Returns (v_next,
    beta_last), the residual direction and norm that link to the
    (ncv+1)-th vector, both on the device.

    Breakdown (the residual collapsed relative to ||A v||): the next
    vector is a fresh random one orthogonalized against V, with zero
    coupling written to B, as in the JAX package."""
    ncv, n = V.shape
    v = v_start
    beta_eff = torch.zeros((), dtype=V.dtype, device=V.device)
    for j in range(start, ncv):
        V[j] = v
        w = matvec(v)
        w_scale = torch.linalg.vector_norm(w)
        B[j, j] = torch.dot(w, v)
        w = _reorth(V, w, j)
        beta = torch.linalg.vector_norm(w)
        broke = beta <= torch.clamp_min(1e-6 * w_scale, 1e-30)
        fresh = _reorth(V, torch.randn(n, generator=gen, dtype=V.dtype,
                                       device=V.device), j)
        w = torch.where(broke, fresh, w)
        beta_eff = torch.where(broke, torch.zeros_like(beta), beta)
        nrm = torch.linalg.vector_norm(w)
        v = w / torch.where(nrm > 1e-30, nrm, torch.ones_like(nrm))
        if j + 1 < ncv:
            B[j, j + 1] = beta_eff
            B[j + 1, j] = beta_eff
    return v, beta_eff


def _ritz(B_host, beta_last: float, ncv: int):
    w, Z = torch.linalg.eigh(B_host)        # ascending
    return w, Z, torch.abs(beta_last * Z[ncv - 1, :])


def _wanted_converged(w, res, tol, n_components, ncv, smallest, eps):
    # residual test on the wanted end, relative to |lambda| with an
    # absolute floor; eps x the spectral scale floors the reachable
    # residual (the JAX package's rule, lanczos.py:120-136)
    scale = torch.max(torch.abs(w))
    eff_tol = max(tol, 10.0 * eps)
    thr = torch.clamp_min(eff_tol * torch.clamp_min(torch.abs(w), 1.0),
                          10.0 * eps * scale)
    ok = res <= thr
    return bool(ok[:n_components].all() if smallest
                else ok[ncv - n_components:].all())


@full_f32
def _thick_restart_lanczos(matvec, n, n_components, ncv, keep, max_restarts,
                           tol, v0, smallest, dtype):
    dev = v0.device
    eps = torch.finfo(dtype).eps
    gen = torch.Generator(device=dev).manual_seed(_BREAKDOWN_SEED)
    v0 = v0 / torch.linalg.vector_norm(v0)
    V = torch.zeros((ncv, n), dtype=dtype, device=dev)
    B = torch.zeros((ncv, ncv), dtype=dtype, device=dev)
    v_next, beta_last = _lanczos_extend(matvec, V, B, v0, 0, gen)

    def host_ritz():
        # the cycle's one sync: B and the last beta to the host together
        packed = torch.cat([B.reshape(-1), beta_last.reshape(1)]).cpu()
        beta = float(packed[-1])
        return _ritz(packed[:-1].reshape(ncv, ncv), beta, ncv) + (beta,)

    it = 0
    w, Z, res, beta = host_ritz()
    while it < max_restarts and not _wanted_converged(
            w, res, tol, n_components, ncv, smallest, eps):
        # thick restart: keep the `keep` Ritz pairs nearest the wanted
        # end; the projected matrix becomes diag(theta) with the
        # beta * Z[last] coupling row to the carried residual vector
        sel = (torch.arange(keep) if smallest
               else ncv - 1 - torch.arange(keep))
        Zs = Z[:, sel]                                  # (ncv, keep)
        Bn = torch.zeros((ncv, ncv), dtype=dtype)
        Bn[torch.arange(keep), torch.arange(keep)] = w[sel]
        s = beta * Zs[ncv - 1, :]
        Bn[keep, :keep] = s
        Bn[:keep, keep] = s
        Vn = torch.zeros((ncv, n), dtype=dtype, device=dev)
        Vn[:keep] = Zs.to(dev).T @ V                    # kept Ritz vectors
        Vn[keep] = v_next
        V, B = Vn, Bn.to(dev)
        v_next, beta_last = _lanczos_extend(matvec, V, B, v_next, keep, gen)
        it += 1
        w, Z, res, beta = host_ritz()

    if smallest:
        w_sel, Z_sel, res_sel = (w[:n_components], Z[:, :n_components],
                                 res[:n_components])
    else:
        w_sel = torch.flip(w[-n_components:], (0,))
        Z_sel = torch.flip(Z[:, -n_components:], (1,))
        res_sel = torch.flip(res[-n_components:], (0,))
    vecs = V.T @ Z_sel.to(dev)
    return w_sel.to(dev), vecs, res_sel.to(dev), it


def lanczos_solver(matvec: Callable, n: int, n_components: int,
                   ncv: Optional[int] = None, max_iter: int = 0,
                   tol: float = 1e-9, seed: int = 42, smallest: bool = True,
                   v0=None, dtype=torch.float32, return_info: bool = False,
                   *, device=None):
    """Extreme eigenpairs of the symmetric operator ``matvec`` (a
    callable on (n,) tensors of the call's device) by thick-restart
    Lanczos. Returns (eigenvalues (k,), eigenvectors (n, k)), the values
    ascending for ``smallest`` and descending otherwise, as the
    reference returns them (lanczos.cuh:745/:1089).

    ``tol``: the Ritz residual test, relative to |lambda| with an
    absolute floor of ``tol`` itself (Laplacian spectra reach 0), and
    floored at 10 eps x the spectral scale. ``max_iter`` bounds the
    Lanczos steps over all restarts (0: 100 x ncv); ``ncv`` is the
    Krylov width of a cycle. ``return_info=True`` also returns
    (residuals (k,), restarts). The call runs on ``device`` when given,
    else on ``v0``'s device if it is a tensor, else on CUDA (raising
    without it)."""
    if ncv is None or ncv <= 0:
        ncv = min(n, max(4 * n_components + 1, 32))
    ncv = min(ncv, n)
    if not (1 <= n_components <= n):
        raise ValueError(
            f"n_components={n_components} out of range [1, n={n}] — an "
            f"n-dimensional operator has at most n eigenpairs"
        )
    if n_components > ncv - 2:
        if n > ncv:
            raise ValueError(
                f"n_components={n_components} needs ncv >= n_components + 2 "
                f"for thick restart (got ncv={ncv})"
            )
        # full-width Krylov (ncv == n): one cycle is an exact
        # tridiagonalization, but if it does NOT converge to tol, restart
        # cycles can only retain ncv - 2 Ritz pairs — fewer than wanted —
        # and may stall against the restart budget. Not silent.
        logger.warn(
            "lanczos: n_components=%d exceeds ncv-2=%d at full Krylov "
            "width (n=%d <= ncv); restarts retain only %d Ritz pairs and "
            "convergence may stall — for this many pairs prefer a dense "
            "eigendecomposition (linalg.eig_dc)",
            n_components, ncv - 2, n, ncv - 2,
        )
    # keep at least every wanted pair across restarts (discarding one
    # re-derives it from scratch each cycle and stalls convergence)
    keep = min(max(n_components, min(2 * n_components, ncv - 2)),
               max(ncv - 2, 1))
    steps_per_cycle = max(ncv - keep, 1)
    max_steps = max_iter if max_iter and max_iter > 0 else 100 * ncv
    max_restarts = max(0, -(-(max_steps - ncv) // steps_per_cycle))
    dev = call_device(v0, device=device)
    if v0 is None:
        v0 = torch.randn(n, generator=torch.Generator().manual_seed(seed),
                         dtype=dtype).to(dev)
    else:
        v0 = as_tensor(v0, dev).to(dtype)
    w, vecs, res, it = _thick_restart_lanczos(
        matvec, n, n_components, ncv, keep, max_restarts, float(tol), v0,
        smallest, dtype,
    )
    if return_info:
        return w, vecs, res, it
    return w, vecs


def lanczos_smallest_eigenvectors(matvec, n, n_components, **kw):
    """Reference lanczos.cuh:745 computeSmallestEigenvectors."""
    return lanczos_solver(matvec, n, n_components, smallest=True, **kw)


def lanczos_largest_eigenvectors(matvec, n, n_components, **kw):
    """Reference lanczos.cuh:1089 computeLargestEigenvectors."""
    return lanczos_solver(matvec, n, n_components, smallest=False, **kw)
