"""PyTorch port of the rest of k-means (``kmeans_transform``, ``kmeans``,
``KMeans``) and of ``fused_l2_nn``'s ``sqrt`` / ``block_n`` /
``mask_op`` and ``fused_l2_nn_argmin`` against the JAX package, on the
CPU.

Rows are integer, so every squared distance is exact in f32 in both
packages: minima and squared transforms bitwise, the roots against
``np.sqrt`` of JAX's squares (the port roots through f64, ROADMAP note
R4). The seeded k-means init draws from JAX's PRNG, which torch cannot
replay, so both packages' k-means++ init is patched to hand back the
same centroids; labels then agree up to ties and inertia to 1e-5
relative.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.distance import fused_l2_nn as j_fused
from raft_tpu.distance import fused_l2_nn_argmin as j_argmin
from raft_tpu_torch.cluster import KMeans, kmeans, kmeans_transform
from raft_tpu_torch.distance import fused_l2_nn, fused_l2_nn_argmin

# the modules (their packages export functions of the same names)
jkm = importlib.import_module("raft_tpu.cluster.kmeans")
tkm = importlib.import_module("raft_tpu_torch.cluster.kmeans")
tfused_mod = importlib.import_module("raft_tpu_torch.distance.fused_l2_nn")

torch.set_num_threads(1)


def _blobs(seed, n=900, d=8, k=6, spread=3):
    """Integer rows around k well-separated integer centres."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(-80, 80, (k, d))
    lab = rng.integers(0, k, n)
    x = (centres[lab] + rng.integers(-spread, spread + 1, (n, d))).astype(
        np.float32)
    return x, centres.astype(np.float32)


@pytest.mark.parametrize("sqrt", [False, True])
def test_kmeans_transform_matches_jax(sqrt):
    x, c = _blobs(1)
    j = np.asarray(jkm.kmeans_transform(x, c, sqrt=False))
    t = kmeans_transform(torch.as_tensor(x), torch.as_tensor(c), sqrt=sqrt)
    assert tuple(t.shape) == (x.shape[0], c.shape[0])
    np.testing.assert_array_equal(t.numpy(), np.sqrt(j) if sqrt else j)


@pytest.fixture
def injected(monkeypatch):
    """Both packages' k-means++ init patched to return the same integer
    centroids: rows 0, 150, ... of the data."""
    def pick(x, k):
        return np.asarray(x)[np.arange(k) * 150]

    monkeypatch.setattr(jkm, "kmeans_plus_plus_init",
                        lambda x, k, key: jnp.asarray(pick(x, k)))
    monkeypatch.setattr(tkm, "kmeans_plus_plus_init",
                        lambda x, k, gen: torch.as_tensor(pick(x, k)))


def _same_labels(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("max_iter", [1, 4, 300])
def test_kmeans_matches_jax_from_the_same_init(injected, max_iter):
    x, _ = _blobs(2)
    jl, ji, jn = jkm.kmeans(x, 6, tol=1e-4, max_iter=max_iter, seed=3)
    tl, ti, tn = kmeans(torch.as_tensor(x), 6, tol=1e-4, max_iter=max_iter,
                        seed=3)
    assert tl.dtype == torch.int32
    _same_labels(jl, tl)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    assert int(tn) == int(jn)


def test_kmeans_estimator_matches_jax(injected):
    x, _ = _blobs(4)
    q, _ = _blobs(5, n=200)
    jm = jkm.KMeans(n_clusters=6, max_iter=20).fit(x)
    tm = KMeans(n_clusters=6, max_iter=20).fit(torch.as_tensor(x))
    np.testing.assert_allclose(tm.cluster_centers_.numpy(),
                               np.asarray(jm.cluster_centers_), rtol=1e-5,
                               atol=1e-5)
    _same_labels(jm.labels_, tm.labels_)
    np.testing.assert_allclose(float(tm.inertia_), float(jm.inertia_),
                               rtol=1e-5)
    _same_labels(jm.predict(q), tm.predict(torch.as_tensor(q)))
    tt = tm.transform(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(tt, np.asarray(jm.transform(q)), rtol=1e-5,
                               atol=1e-4)
    # the transform's argmin is the prediction up to ties
    pred = tm.predict(torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(
        tt[np.arange(len(q)), pred], tt.min(axis=1))


def test_kmeans_estimator_places_arrays_on_its_device():
    x, _ = _blobs(6)
    tm = KMeans(n_clusters=4, max_iter=3, device="cpu").fit(x)
    assert tm.cluster_centers_.device.type == "cpu"
    with pytest.raises(TypeError):
        KMeans(n_clusters=4, no_such_knob=1)


def _colour_masks(n_rows, n_cols, seed):
    """The connect-components same-colour exclusion: a pair is admissible
    only when its row and column have different colours."""
    rng = np.random.default_rng(seed)
    rc = rng.integers(0, 3, n_rows)
    cc = rng.integers(0, 3, n_cols)
    jr, jcol = jnp.asarray(rc), jnp.asarray(cc)
    tr, tcol = torch.as_tensor(rc), torch.as_tensor(cc)
    return (lambda r, c: jr[r] != jcol[c]), (lambda r, c: tr[r] != tcol[c])


@pytest.mark.parametrize("block_n", [None, 16, 100])
@pytest.mark.parametrize("row_block", [1 << 16, 37])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_l2_nn_options_match_jax(monkeypatch, block_n, row_block,
                                       masked):
    """``block_n``, a ``mask_op`` on global indices and the port's row
    blocks (``_ROW_BLOCK`` cut to 37 so the mask crosses block
    boundaries) change nothing: minima bitwise, ids equal (ties to the
    lowest column), roots those of the squares."""
    monkeypatch.setattr(tfused_mod, "_ROW_BLOCK", row_block)
    x, _ = _blobs(7, n=300)
    y, _ = _blobs(8, n=250)
    y[10] = y[3]                 # an exact tie, to the lowest column
    jmask, tmask = _colour_masks(300, 250, 9) if masked else (None, None)
    jd, ji = j_fused(x, y, block_n=block_n, mask_op=jmask)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    td, ti = fused_l2_nn(tx, ty, block_n=block_n, mask_op=tmask)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    sd, si = fused_l2_nn(tx, ty, sqrt=True, block_n=block_n, mask_op=tmask)
    np.testing.assert_array_equal(sd.numpy(), np.sqrt(np.asarray(jd)))
    assert torch.equal(si, ti)
    np.testing.assert_array_equal(
        fused_l2_nn_argmin(tx, ty, block_n=block_n, mask_op=tmask).numpy(),
        np.asarray(j_argmin(x, y, block_n=block_n, mask_op=jmask)))


def test_fully_masked_rows_give_inf_and_zero():
    x, _ = _blobs(10, n=20)
    y, _ = _blobs(11, n=30)
    jd, ji = j_fused(x, y, mask_op=lambda r, c: (r % 2 == 0) & (c >= 0))
    td, ti = fused_l2_nn(torch.as_tensor(x), torch.as_tensor(y),
                         mask_op=lambda r, c: (r % 2 == 0) & (c >= 0))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.isinf(td.numpy()[1::2]).all() and (ti.numpy()[1::2] == 0).all()


def test_fused_l2_nn_rejects_a_bad_block():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="block_n"):
        fused_l2_nn(x, x, block_n=0)
