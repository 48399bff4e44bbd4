"""PyTorch port of the stats package (raft_tpu_torch.stats) against the
JAX package, on the CPU.

The same numpy inputs (from seeds) go through both packages. Tolerances,
and why:

* counts, sums, extrema, histograms, contingency matrices and accuracy
  on integer-valued data are exact in f32 in any order: bitwise;
* trustworthiness on integer rows with the squared L2 metric is bitwise
  (integer ranks from the same stable sort and the same top-k order);
* everything that divides, takes logs or roots, or sums non-integers in
  another order (variances, covariance, the information metrics,
  silhouettes, r2, the criteria) within 1e-5 relative (1e-6 absolute):
  XLA's CPU log and the reduction orders differ from torch's in the
  last bits.
"""

import numpy as np
import pytest
import torch

import raft_tpu.stats as js
import raft_tpu_torch.stats as ts

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)


def _eq(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _eq(g, w)
        return
    np.testing.assert_array_equal(torch.as_tensor(got).numpy(),
                                  np.asarray(want))


def _close(got, want, **kw):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, **kw)
        return
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               np.asarray(want), **(kw or TOL))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xi = rng.integers(-20, 21, (300, 7)).astype(np.float32)
    xg = rng.standard_normal((300, 7)).astype(np.float32) * 3 + 1
    w = rng.random(300).astype(np.float32)
    wc = rng.random(7).astype(np.float32)
    return xi, xg, w, wc


# -- summary -------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_summary_exact_on_integers(data, axis):
    xi = data[0]
    t = torch.as_tensor(xi)
    _eq(ts.mean(t, axis=axis), js.mean(xi, axis=axis))
    _eq(ts.mean(t, axis=axis, sample=True), js.mean(xi, axis=axis,
                                                    sample=True))
    _eq(ts.sum_(t, axis=axis), js.sum_(xi, axis=axis))
    _eq(ts.minmax(t, axis=axis), js.minmax(xi, axis=axis))
    _eq(ts.mean_center(t, axis=axis), js.mean_center(xi, axis=axis))
    mu = js.mean(xi, axis=axis)
    _eq(ts.mean_add(t, torch.as_tensor(np.array(mu)), axis=axis),
        js.mean_add(xi, mu, axis=axis))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sample", [True, False])
def test_summary_moments(data, axis, sample):
    for x in data[:2]:
        t = torch.as_tensor(x)
        _close(ts.vars_(t, axis=axis, sample=sample),
               js.vars_(x, axis=axis, sample=sample))
        _close(ts.stddev(t, axis=axis, sample=sample),
               js.stddev(x, axis=axis, sample=sample))
        _close(ts.meanvar(t, axis=axis, sample=sample),
               js.meanvar(x, axis=axis, sample=sample))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("sample", [True, False])
def test_cov(data, stable, sample):
    for x in data[:2]:
        got = ts.cov(torch.as_tensor(x), sample=sample, stable=stable)
        want = js.cov(x, sample=sample, stable=stable)
        _close(got, want, rtol=1e-5, atol=1e-4)
    mu = np.zeros(7, np.float32)
    _close(ts.cov(data[1], mu, stable=stable, device=CPU),
           js.cov(data[1], mu, stable=stable), rtol=1e-5, atol=1e-4)


def test_cov_keeps_f64():
    x = np.random.default_rng(1).standard_normal((50, 3))
    got = ts.cov(torch.as_tensor(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.cov(x.T), rtol=1e-12)


@pytest.mark.parametrize("n_bins", [1, 7, 32])
def test_histogram_bitwise(data, n_bins):
    xi, xg = data[:2]
    _eq(ts.histogram(torch.as_tensor(xi), n_bins),
        js.histogram(xi, n_bins))
    _eq(ts.histogram(torch.as_tensor(xg), n_bins),
        js.histogram(xg, n_bins))
    _eq(ts.histogram(torch.as_tensor(xg[:, 0]), n_bins, lower=-2.0,
                     upper=3.0),
        js.histogram(xg[:, 0], n_bins, lower=-2.0, upper=3.0))


def test_weighted_means(data):
    xi, xg, w, wc = data
    for x in (xi, xg):
        t = torch.as_tensor(x)
        _close(ts.weighted_mean(t, torch.as_tensor(w)),
               js.weighted_mean(x, w))
        _close(ts.col_weighted_mean(t, torch.as_tensor(w)),
               js.col_weighted_mean(x, w))
        _close(ts.row_weighted_mean(t, torch.as_tensor(wc)),
               js.row_weighted_mean(x, wc))


# -- clustering metrics --------------------------------------------------------

@pytest.fixture(scope="module")
def labelings():
    rng = np.random.default_rng(2)
    truth = rng.integers(0, 6, 500).astype(np.int32)
    noisy = np.where(rng.random(500) < 0.3, rng.integers(0, 6, 500),
                     truth).astype(np.int32)
    return truth, noisy, rng.permutation(6).astype(np.int32)[truth]


def test_contingency_bitwise(labelings):
    a, b, _ = labelings
    _eq(ts.contingency_matrix(torch.as_tensor(a), torch.as_tensor(b), 6),
        js.contingency_matrix(a, b, 6))
    _eq(ts.contingency_matrix(a, b, 6, 9, device=CPU),
        js.contingency_matrix(a, b, 6, 9))


@pytest.mark.parametrize("which", [1, 2])
def test_pair_and_information_metrics(labelings, which):
    a = labelings[0]
    b = labelings[which]
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for name in ("adjusted_rand_index", "mutual_info_score",
                 "homogeneity_score", "completeness_score", "v_measure"):
        got = getattr(ts, name)(ta, tb, 6)
        assert got.dim() == 0, name
        _close(got, getattr(js, name)(a, b, 6))
    _close(ts.v_measure(ta, tb, 6, beta=2.0), js.v_measure(a, b, 6,
                                                           beta=2.0))
    _close(ts.rand_index(ta, tb), js.rand_index(a, b))
    _close(ts.entropy(ta, 6), js.entropy(a, 6))
    if which == 2:
        # a relabeling: every score is 1
        for name in ("adjusted_rand_index", "v_measure",
                     "homogeneity_score"):
            assert abs(float(getattr(ts, name)(ta, tb, 6)) - 1.0) < 1e-6


@pytest.mark.parametrize("metric", ["sqeuclidean", "l2_sqrt_expanded",
                                    "l1"])
def test_silhouettes(metric):
    rng = np.random.default_rng(3)
    x = rng.integers(-5, 6, (180, 4)).astype(np.float32)
    x[:60] += 12
    lab = np.repeat(np.arange(3), 60).astype(np.int32)
    lab[5] = 3                      # a singleton cluster: s = 0 there
    t, tl = torch.as_tensor(x), torch.as_tensor(lab)
    _close(ts.silhouette_samples(t, tl, 5, metric),
           js.silhouette_samples(x, lab, 5, metric))
    _close(ts.silhouette_score(t, tl, 5, metric),
           js.silhouette_score(x, lab, 5, metric))
    for bs in (64, 4096):
        _close(ts.batched_silhouette_score(t, tl, 5, metric, batch_size=bs),
               js.batched_silhouette_score(x, lab, 5, metric,
                                           batch_size=bs))
    _close(ts.batched_silhouette_score(t, tl, 5, metric, batch_size=64),
           ts.silhouette_score(t, tl, 5, metric))


def test_dispersion_and_kl():
    rng = np.random.default_rng(4)
    c = rng.standard_normal((5, 3)).astype(np.float32)
    sizes = rng.integers(1, 50, 5).astype(np.int32)
    _close(ts.dispersion(torch.as_tensor(c), torch.as_tensor(sizes)),
           js.dispersion(c, sizes))
    g = np.ones(3, np.float32)
    _close(ts.dispersion(c, sizes, g, device=CPU), js.dispersion(c, sizes, g))
    p = rng.random(20).astype(np.float32)
    q = rng.random(20).astype(np.float32)
    p[3] = q[7] = 0.0
    _close(ts.kl_divergence(torch.as_tensor(p), torch.as_tensor(q)),
           js.kl_divergence(p, q))


# -- regression metrics --------------------------------------------------------

@pytest.mark.parametrize("n", [101, 100])
def test_regression_metrics(n):
    rng = np.random.default_rng(n)
    y = rng.standard_normal(n).astype(np.float32)
    yh = y + rng.standard_normal(n).astype(np.float32) * 0.3
    ty, tyh = torch.as_tensor(y), torch.as_tensor(yh)
    _close(ts.r2_score(ty, tyh), js.r2_score(y, yh))
    _close(ts.mean_squared_error(ty, tyh, 2.0),
           js.mean_squared_error(y, yh, 2.0))
    got = ts.regression_metrics(ty, tyh)
    want = js.regression_metrics(y, yh)
    assert isinstance(got, ts.RegressionMetrics)
    for g, w in zip(got, want):
        _close(g, w)
    yi = rng.integers(0, 3, n).astype(np.int32)
    yj = rng.integers(0, 3, n).astype(np.int32)
    _eq(ts.accuracy(torch.as_tensor(yi), torch.as_tensor(yj)),
        js.accuracy(yi, yj))


@pytest.mark.parametrize("ic", list(ts.CriterionType))
def test_information_criterion(ic):
    ll = np.array([-120.5, -80.25, -300.0], np.float32)
    _close(ts.information_criterion(torch.as_tensor(ll), ic, 4, 57),
           js.information_criterion(ll, int(ic), 4, 57))


# -- trustworthiness -----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5])
def test_trustworthiness_bitwise_integer(k):
    rng = np.random.default_rng(5 + k)
    x = rng.integers(-8, 9, (120, 6)).astype(np.float32)
    emb = x[:, :2] + rng.integers(-1, 2, (120, 2)).astype(np.float32)
    got = ts.trustworthiness_score(torch.as_tensor(x), torch.as_tensor(emb),
                                   k, "sqeuclidean")
    want = js.trustworthiness_score(x, emb, k, "sqeuclidean")
    _eq(got, want)
    assert got.dtype == torch.float32 and 0.0 < float(got) <= 1.0


def test_trustworthiness_default_metric():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((150, 10)).astype(np.float32)
    proj = rng.standard_normal((10, 3)).astype(np.float32)
    emb = x @ proj
    _close(ts.trustworthiness_score(torch.as_tensor(x), torch.as_tensor(emb)),
           js.trustworthiness_score(x, emb))
    # an embedding that is the data itself is perfectly trustworthy
    assert float(ts.trustworthiness_score(torch.as_tensor(x),
                                          torch.as_tensor(x))) == 1.0


def test_names_and_device_rule():
    for name in js.__all__:
        assert hasattr(ts, name), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.mean(np.ones((3, 2), np.float32))
    assert ts.mean(np.ones((3, 2), np.float32), device=CPU).device == CPU
