"""Random number generation and dataset generators of the port — the
counterpart of ``raft_tpu.random`` (analog of raft/random: the
counter-based generators, the distributions, make_blobs,
make_regression, multi_variable_gaussian, permute and
sample_without_replacement).

:class:`RngState` keeps the reference's (seed, subsequence) state; each
draw derives a ``torch.Generator`` on the call's device from it (JAX's
threefry streams cannot be reproduced in torch). Every function also
takes ``generator=``.
"""

from raft_tpu_torch.random.rng import (
    RngState,
    GenPhilox,
    GenPC,
    uniform,
    uniform_int,
    normal,
    normal_int,
    normal_table,
    fill,
    bernoulli,
    scaled_bernoulli,
    gumbel,
    lognormal,
    logistic,
    exponential,
    rayleigh,
    laplace,
    discrete,
    custom_distribution,
    sample_without_replacement,
    permute,
)
from raft_tpu_torch.random.make_blobs import make_blobs
from raft_tpu_torch.random.make_regression import make_regression
from raft_tpu_torch.random.multi_variable_gaussian import (
    multi_variable_gaussian,
)

__all__ = [k for k in dir() if not k.startswith("_")]
