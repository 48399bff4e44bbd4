"""PyTorch port of the pairwise-distance layer (raft_tpu_torch.distance)
against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages. On integer-exact
inputs every f32 sum is exact in any order, so the L2, L1, Linf, inner
product and Hamming distances must match bitwise; L2 roots are compared
with the correctly rounded root of the JAX package's squared distance
(ROADMAP note R4: f32 sqrt on the CPU is not correctly rounded, in XLA or
in PyTorch, and the port takes its l2 roots through f64). Metrics with
divisions, logs or transcendental functions are held to rtol 1e-5
(f32 rounding in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.distance import pairwise as jpw
from raft_tpu.distance.distance_type import (
    DISTANCE_NAMES as J_NAMES,
    DistanceType as JDistanceType,
)
from raft_tpu_torch.distance import (
    DISTANCE_NAMES,
    DistanceType,
    distance,
    pairwise_distance,
    resolve_metric,
    row_norm_sq,
)
from raft_tpu_torch.distance import pairwise as tpw

torch.set_num_threads(1)

CPU = "cpu"

# metrics whose values are exact sums of exact terms on integer inputs
_EXACT = {"l1", "cityblock", "manhattan", "taxicab", "linf", "chebyshev",
          "sqeuclidean", "l2_expanded", "inner_product", "hamming"}
_ROOTS = {"l2": "sqeuclidean", "euclidean": "sqeuclidean",
          "l2_sqrt_expanded": "l2_expanded"}


def _inputs(name, rng, m=13, n=17, d=9):
    metric = DISTANCE_NAMES[name]
    if metric == DistanceType.Haversine:
        def pts(k):
            return np.stack([rng.uniform(-1.5, 1.5, k),
                             rng.uniform(-3.1, 3.1, k)], 1).astype(np.float32)
        return pts(m), pts(n)
    if metric in (DistanceType.JaccardExpanded, DistanceType.DiceExpanded,
                  DistanceType.RusselRaoExpanded):
        return (rng.integers(0, 2, (m, d)).astype(np.float32),
                rng.integers(0, 2, (n, d)).astype(np.float32))
    if metric in (DistanceType.KLDivergence, DistanceType.JensenShannon,
                  DistanceType.HellingerExpanded):
        x = rng.random((m, d)).astype(np.float32) + 0.05
        y = rng.random((n, d)).astype(np.float32) + 0.05
        return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    return (rng.integers(-8, 8, (m, d)).astype(np.float32),
            rng.integers(-8, 8, (n, d)).astype(np.float32))


def test_name_tables_match_jax():
    assert {k: int(v) for k, v in DISTANCE_NAMES.items()} == \
        {k: int(v) for k, v in J_NAMES.items()}
    assert [(m.name, int(m)) for m in DistanceType] == \
        [(m.name, int(m)) for m in JDistanceType]
    assert resolve_metric("L2-Expanded") == DistanceType.L2Expanded
    assert resolve_metric(6) == DistanceType.InnerProduct
    with pytest.raises(ValueError, match="unknown metric"):
        resolve_metric("nope")


@pytest.mark.parametrize("name", sorted(DISTANCE_NAMES))
def test_pairwise_distance_matches_jax(name, rng_np):
    x, y = _inputs(name, rng_np)
    got = pairwise_distance(x, y, name, device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == (13, 17)
    got = got.numpy()
    if name in _ROOTS:
        sq = np.asarray(jpw.pairwise_distance(jnp.asarray(x), jnp.asarray(y),
                                              _ROOTS[name]))
        np.testing.assert_array_equal(got, np.sqrt(sq))
        return
    want = np.asarray(jpw.pairwise_distance(jnp.asarray(x), jnp.asarray(y),
                                            name))
    if name in _EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_minkowski_p_blocking_and_fin_op(rng_np):
    x = rng_np.standard_normal((21, 6)).astype(np.float32)
    y = rng_np.standard_normal((11, 6)).astype(np.float32)
    want = np.asarray(jpw.pairwise_distance(jnp.asarray(x), jnp.asarray(y),
                                            "minkowski", p=3.0))
    got = pairwise_distance(x, y, "minkowski", p=3.0, device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # pow rounds by position (vector body vs scalar tail), so a blocked
    # evaluation agrees to an ulp, not bitwise
    blocked = pairwise_distance(x, y, "minkowski", p=3.0, block_m=4,
                                device=CPU).numpy()
    np.testing.assert_allclose(blocked, got, rtol=1e-6)
    # the unexpanded tile rule: a tile budget smaller than one row block
    small = tpw._TILE_ELEMS
    try:
        tpw._TILE_ELEMS = 6 * 5
        tiled = pairwise_distance(x, y, "l1", device=CPU).numpy()
    finally:
        tpw._TILE_ELEMS = small
    np.testing.assert_array_equal(
        tiled, pairwise_distance(x, y, "l1", device=CPU).numpy())
    fin = pairwise_distance(x, y, "sqeuclidean", fin_op=lambda d: d <= 4.0,
                            device=CPU)
    assert fin.dtype == torch.bool
    alias = distance(x, y, "sqeuclidean", device=CPU)
    np.testing.assert_array_equal(
        fin.numpy(), alias.numpy() <= 4.0)
    with pytest.raises(ValueError, match="p > 0"):
        pairwise_distance(x, y, "minkowski", p=0.0, device=CPU)
    with pytest.raises(ValueError, match="feature dims"):
        pairwise_distance(x, y[:, :5], device=CPU)


def test_bf16_inputs_and_row_norms(rng_np):
    """bf16 operands: the gram is exact-product f32 in both packages."""
    x = rng_np.integers(-8, 8, (9, 16)).astype(np.float32)
    y = rng_np.integers(-8, 8, (7, 16)).astype(np.float32)
    want = np.asarray(jpw.pairwise_distance(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
        "l2_expanded"))
    got = pairwise_distance(torch.as_tensor(x).bfloat16(),
                            torch.as_tensor(y).bfloat16(), "l2_expanded")
    np.testing.assert_array_equal(got.numpy(), want)
    rn = row_norm_sq(torch.as_tensor(x))
    np.testing.assert_array_equal(rn.numpy(),
                                  np.asarray(jpw.row_norm_sq(jnp.asarray(x))))
    rb = row_norm_sq(torch.as_tensor(x).bfloat16())
    assert rb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        rb.float().numpy(),
        np.asarray(jpw.row_norm_sq(jnp.asarray(x, jnp.bfloat16)),
                   np.float32))


def test_tensors_keep_their_device_and_cuda_is_the_default():
    x = torch.zeros((2, 3))
    assert pairwise_distance(x, x).device.type == "cpu"
    assert pairwise_distance(np.zeros((2, 3)), np.ones((4, 3)),
                             device=CPU).dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pairwise_distance(np.zeros((2, 3)), np.ones((4, 3)))
