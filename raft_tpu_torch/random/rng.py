"""Random number generation of the port — the counterpart of
``raft_tpu/random/rng.py`` (reference cpp/include/raft/random/
rng_state.hpp:26-50 ``RngState``, rng.cuh:39-368 the distributions,
detail/rng_device.cuh the Philox and PCG generators).

JAX's threefry streams cannot be reproduced in torch, so
:class:`RngState` keeps its fields (seed, base subsequence, generator
type) and ``advance``, but each draw derives a ``torch.Generator`` on
the call's device from (seed, subsequence) instead of a JAX key. The
same state gives the same bits on the same device. Every function also
takes ``generator=`` (a ``torch.Generator``, which then decides the
draws and, without ``device=``, the device).

Entry points run on ``device`` when given, else on the device of their
tensor arguments, else on the generator's, else on CUDA (raising
without it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from raft_tpu_torch.core.device import as_tensor, call_device
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = [
    "RngState", "GenPhilox", "GenPC", "uniform", "uniform_int", "normal",
    "normal_int", "normal_table", "fill", "bernoulli", "scaled_bernoulli",
    "gumbel", "lognormal", "logistic", "exponential", "rayleigh", "laplace",
    "discrete", "custom_distribution", "sample_without_replacement",
    "permute",
]

# generator type tags (reference rng_state.hpp GeneratorType)
GenPhilox = "philox"
GenPC = "pc"

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit words."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclasses.dataclass
class RngState:
    """Host-side RNG state (reference random/rng_state.hpp)."""

    seed: int = 0
    base_subsequence: int = 0
    type: str = GenPhilox

    def advance(self, n: int = 1) -> None:
        """Skip ahead (reference RngState::advance)."""
        self.base_subsequence += n

    def key(self, advance: bool = True) -> int:
        """The 63-bit generator seed of the current subsequence (the
        port's counterpart of the JAX key), then advance."""
        k = _mix64(_mix64(self.seed & _MASK64) ^ (
            self.base_subsequence & _MASK64)) >> 1
        if advance:
            self.base_subsequence += 1
        return k

    def generator(self, device=None, advance: bool = True
                  ) -> torch.Generator:
        """A ``torch.Generator`` on ``device`` (CUDA by default) seeded
        from the current subsequence; advances as :meth:`key` does."""
        dev = call_device(device=device)
        return torch.Generator(device=dev).manual_seed(self.key(advance))


def _resolve(state, generator, device, *tensors):
    """(generator, device) of a call: ``generator`` when given, else one
    derived from ``state`` (an :class:`RngState`, a ``torch.Generator``
    or an int seed; None is ``RngState(0)``)."""
    if generator is None and isinstance(state, torch.Generator):
        generator = state
    if device is None and not any(isinstance(t, torch.Tensor)
                                  for t in tensors) and generator is not None:
        device = generator.device
    dev = call_device(*tensors, device=device)
    if generator is None:
        if state is None:
            state = RngState(0)
        elif isinstance(state, int):
            state = RngState(state)
        generator = state.generator(dev)
    return generator, dev


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _u(gen, shape, dtype, dev, low=0.0, high=1.0):
    """Uniform draws in [low, high)."""
    u = torch.rand(_shape(shape), generator=gen, dtype=dtype, device=dev)
    return low + (high - low) * u if (low, high) != (0.0, 1.0) else u


def _tiny_open(gen, shape, dtype, dev):
    """Uniform draws in [tiny, 1): ``log`` of them is finite."""
    return torch.clamp_min(_u(gen, shape, dtype, dev),
                           torch.finfo(dtype).tiny)


# -- distributions (reference rng.cuh:39-368) --------------------------------

def uniform(state, shape, low=0.0, high=1.0, dtype=torch.float32, *,
            generator=None, device=None):
    gen, dev = _resolve(state, generator, device)
    return _u(gen, shape, dtype, dev, low, high)


def uniform_int(state, shape, low, high, dtype=torch.int32, *,
                generator=None, device=None):
    gen, dev = _resolve(state, generator, device)
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         dtype=dtype, device=dev)


def normal(state, shape, mu=0.0, sigma=1.0, dtype=torch.float32, *,
           generator=None, device=None):
    gen, dev = _resolve(state, generator, device)
    return mu + sigma * torch.randn(_shape(shape), generator=gen,
                                    dtype=dtype, device=dev)


def normal_int(state, shape, mu, sigma, dtype=torch.int32, *,
               generator=None, device=None):
    return torch.round(normal(state, shape, mu, sigma, generator=generator,
                              device=device)).to(dtype)


def normal_table(state, n_rows: int, mu_vec, sigma_vec, dtype=torch.float32,
                 *, generator=None, device=None):
    """Per-column (mu, sigma) normal draws (reference rng.cuh:normalTable)."""
    gen, dev = _resolve(state, generator, device, mu_vec, sigma_vec)
    mu_vec = as_tensor(mu_vec, dev).to(dtype)
    sigma_vec = as_tensor(sigma_vec, dev).to(dtype)
    z = torch.randn((n_rows, mu_vec.shape[0]), generator=gen, dtype=dtype,
                    device=dev)
    return mu_vec[None, :] + sigma_vec[None, :] * z


def fill(state, shape, val, dtype=torch.float32, *, generator=None,
         device=None):
    del state, generator
    return torch.full(_shape(shape), val, dtype=dtype,
                      device=call_device(device=device))


def bernoulli(state, shape, prob, dtype=torch.bool, *, generator=None,
              device=None):
    gen, dev = _resolve(state, generator, device)
    return (_u(gen, shape, torch.float32, dev) < prob).to(dtype)


def scaled_bernoulli(state, shape, prob, scale, dtype=torch.float32, *,
                     generator=None, device=None):
    """-scale with probability ``prob``, else +scale (reference
    scaled_bernoulli)."""
    gen, dev = _resolve(state, generator, device)
    b = _u(gen, shape, torch.float32, dev) < prob
    return torch.where(b, -scale, scale).to(dtype)


def gumbel(state, shape, mu=0.0, beta=1.0, dtype=torch.float32, *,
           generator=None, device=None):
    gen, dev = _resolve(state, generator, device)
    return mu + beta * -torch.log(-torch.log(_tiny_open(gen, shape, dtype,
                                                        dev)))


def lognormal(state, shape, mu=0.0, sigma=1.0, dtype=torch.float32, *,
              generator=None, device=None):
    return torch.exp(normal(state, shape, mu, sigma, dtype,
                            generator=generator, device=device))


def logistic(state, shape, mu=0.0, scale=1.0, dtype=torch.float32, *,
             generator=None, device=None):
    gen, dev = _resolve(state, generator, device)
    u = _tiny_open(gen, shape, dtype, dev)
    return mu + scale * (torch.log(u) - torch.log1p(-u))


def exponential(state, shape, lam=1.0, dtype=torch.float32, *,
                generator=None, device=None):
    gen, dev = _resolve(state, generator, device)
    return -torch.log1p(-_u(gen, shape, dtype, dev)) / lam


def rayleigh(state, shape, sigma=1.0, dtype=torch.float32, *,
             generator=None, device=None):
    gen, dev = _resolve(state, generator, device)
    u = _u(gen, shape, dtype, dev, 1e-12, 1.0)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def laplace(state, shape, mu=0.0, scale=1.0, dtype=torch.float32, *,
            generator=None, device=None):
    gen, dev = _resolve(state, generator, device)
    eps = torch.finfo(dtype).eps / 2
    u = _u(gen, shape, dtype, dev, -1.0 + eps, 1.0)
    return -torch.sign(u) * torch.log1p(-torch.abs(u)) * scale + mu


def discrete(state, shape, probs, dtype=torch.int32, *, generator=None,
             device=None):
    """Indices drawn with the weights ``probs`` (reference
    rng.cuh:discrete)."""
    gen, dev = _resolve(state, generator, device, probs)
    probs = as_tensor(probs, dev).float()
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    out = torch.multinomial(torch.clamp_min(probs, 0.0), n, replacement=True,
                            generator=gen)
    return out.reshape(shape).to(dtype)


def custom_distribution(state, shape, inv_cdf: Callable,
                        dtype=torch.float32, *, generator=None, device=None):
    """Inverse-CDF sampling: ``inv_cdf`` of uniform draws."""
    gen, dev = _resolve(state, generator, device)
    return inv_cdf(_u(gen, shape, dtype, dev))


# -- sampling / permutation ---------------------------------------------------

def sample_without_replacement(state, n_samples: int, pool_size: int,
                               weights=None, *, generator=None, device=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sampling without replacement (reference rng.cuh:369
    sampleWithoutReplacement), by Gumbel-top-k: log-weights perturbed by
    Gumbel noise, the ``n_samples`` largest kept. Returns (indices,
    their weights)."""
    gen, dev = _resolve(state, generator, device, weights)
    if weights is None:
        logw = torch.zeros(pool_size, dtype=torch.float32, device=dev)
        w = torch.ones(pool_size, dtype=torch.float32, device=dev)
    else:
        w = as_tensor(weights, dev).float()
        logw = torch.log(torch.clamp_min(w, 1e-38))
    g = -torch.log(-torch.log(_tiny_open(gen, pool_size, torch.float32,
                                         dev)))
    _, idx = top_k_smallest(-(logw + g), n_samples)
    return idx, w[idx]


def permute(state, n: int, x=None, row_major: bool = True, *,
            generator=None, device=None):
    """A random permutation of ``n``; with ``x``, also ``x``'s rows (or
    columns) gathered by it (reference detail/permute.cuh)."""
    gen, dev = _resolve(state, generator, device, x)
    perm = torch.randperm(n, generator=gen, device=dev)
    if x is None:
        return perm, None
    x = as_tensor(x, dev)
    return perm, torch.index_select(x, 0 if row_major else x.dim() - 1, perm)
