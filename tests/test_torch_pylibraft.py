"""PyTorch port of the pylibraft facade and ``utils`` (raft_tpu_torch/
pylibraft, raft_tpu_torch/utils): every case of
tests/test_pylibraft_facade.py run against the port, side by side with
the JAX package, on the CPU (a ``Handle(device="cpu")``: the facade's
default handle is CUDA and raises without it).
"""

import numpy as np
import pytest
import torch

from raft_tpu import pylibraft as jlib
from raft_tpu import utils as jutils
import raft_tpu_torch
from raft_tpu_torch import pylibraft as tlib
from raft_tpu_torch import utils as tutils
from raft_tpu_torch.spatial import brute_force_knn
from raft_tpu_torch.spatial.ann import ivf_flat_search
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def h():
    return tlib.Handle(device="cpu")


def test_handle_stream(h):
    for lib, kw in ((jlib, {}), (tlib, {"device": "cpu"})):
        hd = lib.Handle(n_streams=4, **kw)
        assert hd.n_lanes == 4
        s = lib.Stream("work")
        s.sync()
        hd.sync()
    assert tlib.DeviceResources is tlib.Handle
    assert isinstance(h, raft_tpu_torch.Resources)
    assert tlib.Stream("x").stream is None     # no card here
    with pytest.raises(RuntimeError, match="CUDA"):
        tlib.Handle()


def test_pairwise_distance_facade(rng_np, h):
    X = rng_np.standard_normal((20, 8)).astype(np.float32)
    Y = rng_np.standard_normal((15, 8)).astype(np.float32)
    want = np.sqrt(((X[:, None] - Y[None]) ** 2).sum(-1))
    jout = np.zeros((20, 15), np.float32)
    jD = np.asarray(jlib.distance.pairwise_distance(X, Y, jout,
                                                    metric="euclidean"))
    out = np.zeros((20, 15), np.float32)
    D = tlib.distance.pairwise_distance(X, Y, out, metric="euclidean",
                                        handle=h)
    assert isinstance(D, torch.Tensor)
    np.testing.assert_allclose(D.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)  # written
    np.testing.assert_allclose(D.numpy(), jD, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out, D.numpy())
    # a tensor out is filled in place; a read-only array is left alone
    tout = torch.zeros((20, 15))
    D2 = tlib.distance.distance(torch.as_tensor(X), Y, tout, handle=h)
    assert torch.equal(tout, D2) and torch.equal(D2, D)
    ro = np.zeros((20, 15), np.float32)
    ro.flags.writeable = False
    tlib.distance.pairwise_distance(X, Y, ro, handle=h)
    assert not ro.any()
    assert tlib.distance.SUPPORTED_DISTANCES == \
        jlib.distance.SUPPORTED_DISTANCES


def test_fused_argmin_facade(rng_np, h):
    X = rng_np.standard_normal((12, 6)).astype(np.float32)
    Y = rng_np.standard_normal((9, 6)).astype(np.float32)
    idx = tlib.distance.fused_l2_nn_argmin(X, Y, handle=h).numpy()
    want = ((X[:, None] - Y[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(
        idx, np.asarray(jlib.distance.fused_l2_nn_argmin(X, Y)))


def _blobs(seed):
    """Three tight, well-separated blobs (tests/test_pylibraft_facade.py
    draws its own with raft_tpu.random.make_blobs)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-10, 10, (3, 6))
    return (centres[rng.integers(0, 3, 300)]
            + 0.3 * rng.standard_normal((300, 6))).astype(np.float32)


def test_cluster_facade(h):
    X = _blobs(2)
    out = {}
    for name, lib, kw in (("jax", jlib, {}), ("torch", tlib, {"handle": h})):
        cents, labels, inertia, n_iter = lib.cluster.fit(X, 3, seed=1, **kw)
        assert tuple(cents.shape) == (3, 6)
        pred = np.asarray(lib.cluster.predict(X, cents, **kw))
        np.testing.assert_array_equal(pred, np.asarray(labels))
        assert float(lib.cluster.cluster_cost(X, cents, **kw)) == \
            pytest.approx(float(inertia), rel=1e-4)
        out[name] = (np.asarray(cents), float(inertia))
    # the seeds draw different inits; the blobs give one clustering
    jc, tc = (out[n][0][np.lexsort(out[n][0].T[::-1])]
              for n in ("jax", "torch"))
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    assert out["torch"][1] == pytest.approx(out["jax"][1], rel=1e-4)


def test_neighbors_facade(rng_np, h):
    X = rng_np.standard_normal((500, 16)).astype(np.float32)
    q = X[:10]
    d, i = tlib.neighbors.brute_force.knn(X, q, 5, handle=h)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(10))
    jd, ji = jlib.neighbors.brute_force.knn(X, q, 5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    _assert_ids_equal_up_to_ties(np.asarray(jd), np.asarray(ji), i.numpy())
    bd, bi = brute_force_knn(torch.as_tensor(X), torch.as_tensor(q), 5,
                             metric="l2")
    assert torch.equal(d, bd) and torch.equal(i, bi)
    params = tlib.neighbors.ivf_flat.IndexParams(n_lists=8)
    index = tlib.neighbors.ivf_flat.build(X, params, handle=h)
    assert index.centroids.device.type == "cpu"
    d2, i2 = tlib.neighbors.ivf_flat.search(index, q, 5, n_probes=8,
                                            handle=h)
    np.testing.assert_array_equal(i2.numpy()[:, 0], np.arange(10))
    e2 = ivf_flat_search(index, torch.as_tensor(q), 5, n_probes=8)
    assert torch.equal(d2, e2[0]) and torch.equal(i2, e2[1])
    pq = tlib.neighbors.ivf_pq.build(
        X, tlib.neighbors.ivf_pq.IndexParams(n_lists=8, pq_dim=4), handle=h)
    d3, i3 = tlib.neighbors.ivf_pq.search(pq, q, 5, n_probes=8, handle=h)
    assert tuple(i3.shape) == (10, 5) and bool(torch.isfinite(d3).all())


def test_seive():
    for mod in (jutils, tutils):
        s = mod.Seive(100)
        assert s.is_prime(97)
        assert not s.is_prime(91)
        np.testing.assert_array_equal(s.primes()[:5], [2, 3, 5, 7, 11])
    np.testing.assert_array_equal(tutils.Seive(1000).primes(),
                                  jutils.Seive(1000).primes())


def test_pow2():
    for mod in (jutils, tutils):
        p = mod.Pow2(16)
        assert p.round_up(17) == 32
        assert p.round_down(17) == 16
        assert p.mod(19) == 3
        assert p.div(32) == 2
        assert p.is_aligned(48)
        with pytest.raises(ValueError):
            mod.Pow2(12)
        assert mod.round_up_safe(10, 3) == 12
        assert mod.round_down_safe(10, 3) == 9
        assert mod.div_rounding_up(10, 3) == 4


def test_lazy_submodules():
    assert raft_tpu_torch.pylibraft.Handle is tlib.Handle
    assert raft_tpu_torch.cluster.kmeans_transform is not None
    assert raft_tpu_torch.utils.Seive is tutils.Seive
    with pytest.raises(AttributeError):
        raft_tpu_torch.nonexistent_module
