"""PyTorch port of random ball cover (raft_tpu_torch/spatial/ann/
ball_cover.py) against the JAX package, on the CPU.

The JAX package draws its landmarks from JAX's PRNG (k-means for l2, a
sample for haversine), which torch cannot replay. So the tests carry a
JAX-built index across whole (``interop.ball_cover_index_from_arrays``)
and query it in both packages, and rebuild the port's index from the JAX
landmarks and labels (``ball_cover._assemble``, which the port's own
build runs too). The l2 rows are integer (``_int_dataset``) and the
carried index's landmarks are rounded to integers, so every squared
distance is exact in both packages and the l2 distances differ only by
the root, which the port takes through f64 (ROADMAP note R4): 1e-6
relative. The haversine rows are the JAX test's radian pairs: 1e-5
relative. Ids up to ties. The exactness certificates must agree except
where the deciding margin ``d(q, L) - radius - kth`` is within a few ulp
of zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.spatial.ann import ball_cover as jbc
from raft_tpu.spatial.knn import haversine_knn as j_haversine_knn
from raft_tpu_torch.spatial import brute_force_knn
from raft_tpu_torch.spatial.ann import (
    ball_cover_index_from_arrays,
    rbc_all_knn_query,
    rbc_build_index,
    rbc_knn_query,
)
from raft_tpu_torch.spatial.ann import ball_cover as tbc
from raft_tpu_torch.spatial.knn import haversine_knn
from tests.test_torch_ivf_flat import (
    _assert_ids_equal_up_to_ties,
    _int_dataset,
)

torch.set_num_threads(1)

K = 5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def l2_data():
    """Clustered integer rows and queries: squared distances are exact
    in f32 in any summation order."""
    x, q = _int_dataset(13, n=2000, nq=50)
    return x, q


@pytest.fixture(scope="module")
def geo_data():
    """(lat, lon) radian pairs clustered around hubs (tests/test_ann.py's
    ``geo_dataset``)."""
    rng = np.random.default_rng(4)
    hubs = np.deg2rad(
        rng.uniform([-60, -170], [70, 170], size=(25, 2))).astype(np.float32)
    pts = hubs[rng.integers(0, 25, 3000)] + rng.normal(
        0, 0.02, (3000, 2)).astype(np.float32)
    pts[:, 0] = np.clip(pts[:, 0], -np.pi / 2, np.pi / 2)
    q = pts[rng.integers(0, 3000, 200)] + rng.normal(
        0, 0.01, (200, 2)).astype(np.float32)
    q[:, 0] = np.clip(q[:, 0], -np.pi / 2, np.pi / 2)
    return pts, q.astype(np.float32)


def _arrays(j):
    s = j.storage
    return {
        "landmarks": np.asarray(j.landmarks),
        "radii": np.asarray(j.radii),
        "data_sorted": np.asarray(j.data_sorted),
        "storage.sorted_ids": np.asarray(s.sorted_ids),
        "storage.list_offsets": np.asarray(s.list_offsets),
        "storage.list_index": np.asarray(s.list_index),
        "storage.list_sizes": np.asarray(s.list_sizes),
        "storage.n": s.n,
        "storage.max_list": s.max_list,
        "metric": j.metric,
    }


def _labels(j):
    """Each row's ball, read back from the JAX index's storage."""
    s = j.storage
    lab = np.empty(s.n, np.int64)
    lab[np.asarray(s.sorted_ids)] = np.repeat(
        np.arange(j.landmarks.shape[0]), np.asarray(s.list_sizes))
    return lab


@pytest.fixture(scope="module")
def jax_built(l2_data, geo_data):
    """{metric: (data, queries, the JAX package's own index)}."""
    return {metric: (x, q, jbc.rbc_build_index(x, metric=metric, **kw))
            for metric, (x, q), kw in (
                ("l2", l2_data, dict(n_landmarks=40, seed=0)),
                ("haversine", geo_data, dict(n_landmarks=40, seed=1)))}


@pytest.fixture(scope="module")
def pairs(jax_built):
    """{metric: (data, queries, JAX index, the port's carried copy)}, the
    l2 index's landmarks rounded to integers."""
    out = {}
    for metric, (x, q, j) in jax_built.items():
        if metric == "l2":
            j = dataclasses.replace(j, landmarks=jnp.round(j.landmarks))
        t = ball_cover_index_from_arrays(_arrays(j), device="cpu")
        out[metric] = (x, q, j, t)
    return out


def _margin(index, q, dists, k):
    """Per query, the smallest d(q, L) - radius_L - kth over the balls
    not among the probed ones, in f64 (the certificate's deciding
    margin), given the probed set of the n_probes nearest landmarks."""
    lm = np.asarray(index.landmarks, np.float64)
    qq = np.asarray(q, np.float64)
    if index.metric == "haversine":
        s1 = np.sin(0.5 * (qq[:, None, 0] - lm[None, :, 0]))
        s2 = np.sin(0.5 * (qq[:, None, 1] - lm[None, :, 1]))
        a = s1 ** 2 + np.cos(qq[:, None, 0]) * np.cos(lm[None, :, 0]) * s2 ** 2
        ld = 2.0 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))
    else:
        ld = np.sqrt(((qq[:, None, :] - lm[None]) ** 2).sum(-1))
    return ld - np.asarray(index.radii, np.float64)[None] - np.asarray(
        dists, np.float64)[:, k - 1:k]


@pytest.mark.parametrize("metric", ["l2", "haversine"])
@pytest.mark.parametrize("n_probes", [4, 10, 40])
def test_query_on_carried_index_matches_jax(pairs, metric, n_probes):
    """Distances to the stated tolerance, ids up to ties, the exactness
    masks equal but for flips at an ulp-scale margin (named in the
    failure message if one is not)."""
    x, q, j, t = pairs[metric]
    jd, ji, jex = (np.asarray(a) for a in
                   jbc.rbc_knn_query(j, jnp.asarray(q), K,
                                     n_probes=n_probes))
    td, ti, tex = rbc_knn_query(t, torch.as_tensor(q), K, n_probes=n_probes)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    rtol = 1e-6 if metric == "l2" else 1e-5
    np.testing.assert_allclose(td.numpy(), jd, rtol=rtol, atol=1e-7)
    _assert_ids_equal_up_to_ties(jd, ji, ti.numpy())
    flips = np.nonzero(tex.numpy() != jex)[0]
    if flips.size:
        m = _margin(j, q, jd, K)
        for qi in flips:
            # the deciding margin among balls whose side differs
            near = np.min(np.abs(m[qi]))
            assert near <= 4 * np.spacing(np.float32(jd[qi, K - 1])), (
                f"certificate flip at query {qi}: margin {near}")
    if n_probes == 40:
        assert tex.all() and jex.all()


@pytest.mark.parametrize("metric", ["l2", "haversine"])
def test_assembly_from_jax_landmarks_and_labels(jax_built, metric):
    """The build's assembly step fed JAX's landmarks and labels gives
    JAX's storage and sorted rows bitwise and its radii to an ulp (l2:
    the port's root is correctly rounded, JAX's f32 root may not be)."""
    x, _, j = jax_built[metric]
    t = tbc._assemble(torch.as_tensor(x), torch.as_tensor(
        np.array(j.landmarks)), torch.as_tensor(_labels(j)), metric)
    for f in ("sorted_ids", "list_offsets", "list_index", "list_sizes"):
        np.testing.assert_array_equal(getattr(t.storage, f).numpy(),
                                      np.asarray(getattr(j.storage, f)), f)
    assert (t.storage.n, t.storage.max_list) == (j.storage.n,
                                                 j.storage.max_list)
    np.testing.assert_array_equal(t.data_sorted.numpy(),
                                  np.asarray(j.data_sorted))
    if metric == "l2":
        lm = np.asarray(j.landmarks)
        d2 = ((x - lm[_labels(j)]) ** 2).sum(1, dtype=np.float32)
        want = np.zeros(lm.shape[0], np.float32)
        np.maximum.at(want, _labels(j), np.sqrt(np.maximum(d2, 0)))
        np.testing.assert_array_max_ulp(t.radii.numpy(), want, maxulp=1)
        np.testing.assert_array_max_ulp(t.radii.numpy(),
                                        np.asarray(j.radii), maxulp=2)
    else:
        np.testing.assert_allclose(t.radii.numpy(), np.asarray(j.radii),
                                   rtol=1e-6, atol=1e-8)
    assert t.metric == metric


def test_full_probing_certifies_every_query(pairs):
    """n_probes = n_landmarks is exhaustively exact: all certified,
    recall 1.0 against brute force."""
    x, q, j, t = pairs["l2"]
    n_land = t.landmarks.shape[0]
    d, i, ex = rbc_knn_query(t, torch.as_tensor(q), K, n_probes=n_land)
    assert ex.all()
    bd, bi = brute_force_knn(torch.as_tensor(x), torch.as_tensor(q), K,
                             metric="l2")
    np.testing.assert_allclose(d.numpy(), bd.numpy(), rtol=1e-5, atol=1e-5)
    _assert_ids_equal_up_to_ties(bd.numpy(), bi.numpy(), i.numpy())


@pytest.mark.parametrize("metric", ["l2", "haversine"])
def test_all_knn_first_neighbour_is_itself(pairs, metric):
    x, _, j, t = pairs[metric]
    n_land = t.landmarks.shape[0]
    d, i, ex = rbc_all_knn_query(t, 3, n_probes=n_land)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(len(x)))
    assert ex.all() and (d.numpy()[:, 0] == 0).all()
    jd, ji, _ = jbc.rbc_all_knn_query(j, 3, n_probes=n_land)
    np.testing.assert_array_equal(np.asarray(ji)[:, 0], np.arange(len(x)))


def test_validation_errors_in_both():
    for mod, kw in ((jbc, {}), (tbc, {"device": "cpu"})):
        with pytest.raises(Exception, match="haversine"):
            mod.rbc_build_index(np.zeros((10, 3), np.float32),
                                metric="haversine", **kw)
        with pytest.raises(Exception, match="metric"):
            mod.rbc_build_index(np.zeros((10, 2), np.float32),
                                metric="cosine", **kw)
    with pytest.raises(ValueError, match="candidate pool"):
        x = np.random.default_rng(0).standard_normal((50, 4)).astype(
            np.float32)
        t = rbc_build_index(x, n_landmarks=25, device="cpu")
        rbc_knn_query(t, x[:2], 50, n_probes=1)


@pytest.mark.parametrize("metric", ["l2", "haversine"])
def test_query_blocks_give_the_one_block_answer(monkeypatch, pairs,
                                                metric):
    """The internal query blocking (the candidate gather held under
    ``_GATHER_BYTES``) answers as one block does."""
    _, q, _, t = pairs[metric]
    tq = torch.as_tensor(q)
    whole = rbc_knn_query(t, tq, K, n_probes=10)
    per_q = 10 * t.storage.max_list * q.shape[1] * 4
    monkeypatch.setattr(tbc, "_GATHER_BYTES", 7 * per_q)
    blocked = rbc_knn_query(t, tq, K, n_probes=10)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_ports_own_l2_build_certifies_against_brute_force(l2_data):
    """The port's build (k-means landmarks from its own generator): a
    certified query's answer is brute force's, and most certify with 20
    of ~44 balls probed (the JAX test's bar for its Gaussian rows)."""
    x, q = l2_data
    t = rbc_build_index(x, seed=0, device="cpu")
    assert t.landmarks.shape[0] == int(np.sqrt(len(x)))
    d, i, ex = rbc_knn_query(t, q, K, n_probes=20)
    bd, bi = brute_force_knn(torch.as_tensor(x), torch.as_tensor(q), K,
                             metric="l2")
    exn = ex.numpy()
    np.testing.assert_allclose(d.numpy()[exn], bd.numpy()[exn], rtol=1e-5,
                               atol=1e-5)
    assert exn.mean() > 0.7, exn.mean()


def test_ports_own_haversine_build_matches_the_oracle(geo_data):
    """Sampled data-point landmarks; every certified query equals the
    port's haversine_knn oracle (and JAX's) within 1e-5 relative."""
    x, q = geo_data
    t = rbc_build_index(x, n_landmarks=40, seed=1, metric="haversine",
                        device="cpu")
    lm = t.landmarks.numpy()
    assert (lm[:, None, :] == x[None]).all(-1).any(1).all()
    d, i, ex = rbc_knn_query(t, q, K, n_probes=10)
    od, oi = haversine_knn(torch.as_tensor(x), torch.as_tensor(q), K)
    jd, _ = j_haversine_knn(x, q, K)
    exn = ex.numpy()
    assert exn.mean() > 0.5
    np.testing.assert_allclose(d.numpy()[exn], od.numpy()[exn], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(od.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-7)
    _assert_ids_equal_up_to_ties(od.numpy()[exn], oi.numpy()[exn],
                                 i.numpy()[exn])
    d2, i2, ex2 = rbc_knn_query(t, q, K, n_probes=40)
    assert ex2.all()
    np.testing.assert_allclose(d2.numpy(), od.numpy(), rtol=1e-5, atol=1e-7)
