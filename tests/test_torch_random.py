"""PyTorch port of the random package (raft_tpu_torch.random) on the
CPU.

JAX's threefry streams cannot be reproduced in torch, so parity is
statistical, as ``tests/test_random.py`` asserts for the JAX package:
moments within stated bounds over 20,000 draws (the same bounds as the
JAX tests), shapes, supports and the generators' invariants (round-robin
label counts, given centres, exact linear models). Then the port's own
contract: the same ``RngState`` gives the same bits, a state advances,
``generator=`` decides the draws.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch import random as rr
from raft_tpu_torch.random import RngState

torch.set_num_threads(1)

N = 20000
TOL = 0.05
CPU = "cpu"


def _np(t):
    return t.numpy()


class TestDistributions:
    def test_uniform_moments(self):
        x = _np(rr.uniform(RngState(1), (N,), low=-2.0, high=4.0,
                           device=CPU))
        assert abs(x.mean() - 1.0) < TOL * 6
        assert x.min() >= -2 and x.max() < 4 and x.dtype == np.float32

    def test_normal_moments(self):
        x = _np(rr.normal(RngState(2), (N,), mu=1.5, sigma=2.0, device=CPU))
        assert abs(x.mean() - 1.5) < 0.1 and abs(x.std() - 2.0) < 0.1

    def test_lognormal(self):
        x = _np(rr.lognormal(RngState(3), (N,), mu=0.0, sigma=0.5,
                             device=CPU))
        assert (x > 0).all() and abs(x.mean() - np.exp(0.125)) < 0.1

    def test_exponential(self):
        x = _np(rr.exponential(RngState(4), (N,), lam=2.0, device=CPU))
        assert (x >= 0).all() and abs(x.mean() - 0.5) < 0.05

    def test_rayleigh(self):
        x = _np(rr.rayleigh(RngState(5), (N,), sigma=1.5, device=CPU))
        assert abs(x.mean() - 1.5 * np.sqrt(np.pi / 2)) < 0.1

    def test_laplace_gumbel_logistic(self):
        for fn in (rr.laplace, rr.logistic):
            x = _np(fn(RngState(6), (N,), 0.5, 1.0, device=CPU))
            assert np.isfinite(x).all() and abs(x.mean() - 0.5) < 0.1
        lap = _np(rr.laplace(RngState(6), (N,), 0.0, 1.0, device=CPU))
        assert abs(lap.var() - 2.0) < 0.15
        g = _np(rr.gumbel(RngState(7), (N,), mu=0.0, beta=1.0, device=CPU))
        assert np.isfinite(g).all() and abs(g.mean() - 0.5772) < 0.1

    def test_bernoulli(self):
        x = _np(rr.bernoulli(RngState(8), (N,), 0.3, dtype=torch.float32,
                             device=CPU))
        assert abs(x.mean() - 0.3) < 0.02
        assert rr.bernoulli(RngState(8), (3,), 0.3, device=CPU).dtype == \
            torch.bool

    def test_scaled_bernoulli(self):
        x = _np(rr.scaled_bernoulli(RngState(9), (N,), 0.25, 2.0,
                                    device=CPU))
        assert set(np.unique(x)) == {-2.0, 2.0}
        assert abs((x < 0).mean() - 0.25) < 0.02

    def test_uniform_int(self):
        x = _np(rr.uniform_int(RngState(10), (N,), 3, 9, device=CPU))
        assert x.min() == 3 and x.max() == 8 and x.dtype == np.int32

    def test_normal_int(self):
        x = _np(rr.normal_int(RngState(10), (N,), 5.0, 2.0, device=CPU))
        assert x.dtype == np.int32 and abs(x.mean() - 5.0) < 0.1

    def test_normal_table(self):
        mu = np.array([0.0, 10.0, -5.0], np.float32)
        sigma = np.array([1.0, 2.0, 0.5], np.float32)
        x = _np(rr.normal_table(RngState(11), N, mu, sigma, device=CPU))
        np.testing.assert_allclose(x.mean(0), mu, atol=0.15)
        np.testing.assert_allclose(x.std(0), sigma, atol=0.15)

    def test_fill(self):
        np.testing.assert_array_equal(
            _np(rr.fill(RngState(12), (5,), 7.0, device=CPU)),
            np.full(5, 7.0, np.float32))

    def test_discrete(self):
        probs = np.array([0.1, 0.6, 0.3])
        x = _np(rr.discrete(RngState(13), (N,), probs, device=CPU))
        np.testing.assert_allclose(np.bincount(x, minlength=3) / N, probs,
                                   atol=0.03)
        x = _np(rr.discrete(RngState(13), (4, 5), [0.0, 1.0, 0.0],
                            device=CPU))
        assert x.shape == (4, 5) and (x == 1).all()

    def test_custom_distribution(self):
        x = _np(rr.custom_distribution(
            RngState(14), (N,), lambda u: -torch.log1p(-u * (1 - 1e-7)),
            device=CPU))
        assert abs(x.mean() - 1.0) < 0.05

    def test_state_advance_determinism(self):
        s1 = RngState(42)
        a = _np(rr.uniform(s1, (10,), device=CPU))
        b = _np(rr.uniform(s1, (10,), device=CPU))
        assert not np.allclose(a, b)             # the state advanced
        assert s1.base_subsequence == 2
        a2 = _np(rr.uniform(RngState(42), (10,), device=CPU))
        np.testing.assert_array_equal(a, a2)     # reproducible
        s3 = RngState(42)
        s3.advance()
        np.testing.assert_array_equal(_np(rr.uniform(s3, (10,), device=CPU)),
                                      b)


@pytest.mark.parametrize("fn,args", [
    (rr.uniform, ((64, 3),)), (rr.normal, ((64,),)),
    (rr.uniform_int, ((50,), 0, 100)), (rr.gumbel, ((40,),)),
    (rr.laplace, ((40,),)), (rr.logistic, ((40,),)),
    (rr.exponential, ((40,),)), (rr.rayleigh, ((40,),)),
    (rr.lognormal, ((40,),)), (rr.bernoulli, ((40,), 0.5)),
    (rr.discrete, ((40,), [0.2, 0.8])),
])
def test_same_seed_same_bits_and_generator(fn, args):
    """The same state gives the same bits, another seed other bits; a
    ``generator=`` decides the draws and the device."""
    a = fn(RngState(7), *args, device=CPU)
    b = fn(RngState(7), *args, device=CPU)
    c = fn(RngState(8), *args, device=CPU)
    assert torch.equal(a, b) and a.device.type == "cpu"
    assert not torch.equal(a, c)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    assert torch.equal(fn(None, *args, generator=g1),
                       fn(RngState(99), *args, generator=g2))


class TestSampling:
    def test_sample_without_replacement_unique(self):
        idx, w = rr.sample_without_replacement(RngState(1), 50, 100,
                                               device=CPU)
        idx = _np(idx)
        assert len(np.unique(idx)) == 50 and idx.min() >= 0 and idx.max() < 100
        assert (w.numpy() == 1.0).all()

    def test_sample_weighted_bias(self):
        w = np.ones(100, np.float32)
        w[7] = 10000.0
        hits = sum(int(7 in _np(rr.sample_without_replacement(
            RngState(seed), 10, 100, weights=w, device=CPU)[0]))
            for seed in range(20))
        assert hits >= 19

    def test_permute(self):
        x = np.random.default_rng(0).standard_normal((30, 4)).astype(
            np.float32)
        perm, out = rr.permute(RngState(3), 30, x, device=CPU)
        perm = _np(perm)
        assert sorted(perm.tolist()) == list(range(30))
        np.testing.assert_array_equal(_np(out), x[perm])
        perm_c, out_c = rr.permute(RngState(3), 4, torch.as_tensor(x),
                                   row_major=False)
        np.testing.assert_array_equal(_np(out_c), x[:, _np(perm_c)])
        assert rr.permute(RngState(3), 5, device=CPU)[1] is None


class TestGenerators:
    def test_make_blobs_recovery(self):
        data, labels = rr.make_blobs(2000, 8, n_clusters=4,
                                     state=RngState(0), cluster_std=0.3,
                                     device=CPU)
        data, labels = _np(data), _np(labels)
        assert data.shape == (2000, 8) and labels.dtype == np.int32
        # round-robin counts, shuffled
        assert np.bincount(labels).tolist() == [500] * 4
        assert not (labels == np.arange(2000) % 4).all()
        centers = np.stack([data[labels == c].mean(0) for c in range(4)])
        for c in range(4):
            spread = np.linalg.norm(data[labels == c] - centers[c],
                                    axis=1).mean()
            assert spread < 0.3 * np.sqrt(8) * 2
        assert np.linalg.norm(centers[0] - centers[1]) > 1.0
        assert (np.abs(centers) <= 10.5).all()

    def test_make_blobs_given_centers_and_stds(self):
        centers = np.array([[0.0, 0.0], [100.0, 100.0]], np.float32)
        data, labels = rr.make_blobs(20000, 2, state=RngState(1),
                                     centers=centers,
                                     cluster_std=[0.1, 2.0], shuffle=False,
                                     device=CPU)
        data, labels = _np(data), _np(labels)
        np.testing.assert_array_equal(labels, np.arange(20000) % 2)
        np.testing.assert_allclose(data[labels == 1].mean(0), [100, 100],
                                   atol=0.1)
        np.testing.assert_allclose(data[labels == 0].std(0), [0.1, 0.1],
                                   rtol=0.05)
        np.testing.assert_allclose(data[labels == 1].std(0), [2.0, 2.0],
                                   rtol=0.05)

    def test_make_blobs_center_box_and_bits(self):
        a = rr.make_blobs(500, 3, n_clusters=6, state=RngState(4),
                          center_box=(50.0, 60.0), cluster_std=0.01,
                          device=CPU)
        b = rr.make_blobs(500, 3, n_clusters=6, state=RngState(4),
                          center_box=(50.0, 60.0), cluster_std=0.01,
                          device=CPU)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert (a[0].numpy() > 49.9).all() and (a[0].numpy() < 60.1).all()

    def test_make_regression_exact(self):
        x, y, w = rr.make_regression(300, 10, n_informative=5,
                                     state=RngState(2), noise=0.0,
                                     shuffle=True, coef=True, device=CPU)
        x, y, w = _np(x), _np(y), _np(w)
        np.testing.assert_allclose(y, x @ w, rtol=1e-3, atol=1e-2)
        assert (np.abs(w) > 1e-6).sum() == 5

    def test_make_regression_lowrank_and_targets(self):
        x, y = rr.make_regression(100, 40, n_informative=10,
                                  state=RngState(3), effective_rank=5,
                                  tail_strength=0.1, device=CPU)
        s = np.linalg.svd(_np(x), compute_uv=False)
        assert s[10] < 0.2 * s[0]
        x, y, w = rr.make_regression(50, 6, 3, state=RngState(3),
                                     n_targets=2, bias=1.5, noise=0.0,
                                     coef=True, device=CPU)
        assert y.shape == (50, 2) and w.shape == (6, 2)
        np.testing.assert_allclose(_np(y), _np(x) @ _np(w) + 1.5,
                                   rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("method", ["cholesky", "eigh"])
    def test_multi_variable_gaussian(self, method):
        cov = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)
        mu = np.array([1.0, -1.0], np.float32)
        x = _np(rr.multi_variable_gaussian(RngState(4), 30000, mu, cov,
                                           method=method, device=CPU))
        assert x.shape == (2, 30000)
        np.testing.assert_allclose(x.mean(1), mu, atol=0.05)
        np.testing.assert_allclose(np.cov(x), cov, atol=0.1)


def test_device_rule_and_names():
    import raft_tpu.random as jr

    assert set(n for n in jr.__all__ if not n[0].isupper()
               and n not in ("rng",)) <= set(rr.__all__)
    for name in jr.__all__:
        assert hasattr(rr, name), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rr.uniform(RngState(0), (3,))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rr.make_blobs(10, 2)
    # a tensor argument decides the device
    x = rr.normal_table(RngState(1), 4, torch.zeros(2), torch.ones(2))
    assert x.device.type == "cpu"
