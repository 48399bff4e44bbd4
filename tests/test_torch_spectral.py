"""PyTorch port of spectral partitioning (raft_tpu_torch.spectral) against
the JAX package, on the CPU.

Graphs come from numpy and go to both packages (the port's CSR carried
across from JAX's with ``csr_from_arrays``). Tolerances, and why:

* the Laplacian / modularity matvecs and ``analyze_partition`` /
  ``analyze_modularity`` on given labels are bitwise equal on
  integer-valued graphs (every sum exact; the modularity's divisions
  divide equal f32 numbers) — on the bridged clique graphs, whose
  weights are not integers, within 1e-4;
* ``partition`` / ``modularity_maximization``: k-means seeds from a
  ``torch.Generator`` where JAX uses a key, and Lanczos starts from
  different draws, so labels are compared up to a permutation of the
  cluster ids, eigenvalues within 1e-4 relative (1e-5 absolute floor),
  and ``analyze_partition``'s cut within 1e-4.
"""

import numpy as np
import pytest
import torch

from raft_tpu import spectral as js
from raft_tpu.sparse import coo_from_dense as j_coo_from_dense
from raft_tpu.sparse import csr_from_coo as j_csr_from_coo
from raft_tpu_torch import spectral as ts
from raft_tpu_torch.sparse import csr_from_arrays

torch.set_num_threads(1)

CPU = torch.device("cpu")


def two_clique_graph(n_per=8, bridge_w=0.01):
    """tests/test_label_lap_cache_spectral.py's graph: two cliques and
    one bridge."""
    n = 2 * n_per
    dense = np.zeros((n, n), np.float32)
    for grp in (range(n_per), range(n_per, n)):
        for i in grp:
            for j in grp:
                if i != j:
                    dense[i, j] = 1.0
    dense[n_per - 1, n_per] = dense[n_per, n_per - 1] = bridge_w
    return dense


def _csrs(dense):
    j = j_csr_from_coo(j_coo_from_dense(dense))
    t = csr_from_arrays({"indptr": np.asarray(j.indptr),
                         "indices": np.asarray(j.indices),
                         "data": np.asarray(j.data),
                         "nnz": np.asarray(j.nnz), "shape": j.shape},
                        device=CPU)
    return j, t


def _same_split(a, b):
    """Labels equal up to a permutation of the ids."""
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _int_graph(seed, n=20):
    rng = np.random.default_rng(seed)
    d = np.triu(np.where(rng.random((n, n)) < 0.3,
                         rng.integers(1, 5, (n, n)), 0), 1)
    return (d + d.T).astype(np.float32)


def test_configs_match():
    for cls in ("EigenSolverConfig", "ClusterSolverConfig"):
        assert vars(getattr(ts, cls)(3)) == vars(getattr(js, cls)(3))
    assert set(ts.__all__) == set(js.__all__)


@pytest.mark.parametrize("seed", [0, 1])
def test_operator_matvecs_bitwise(seed):
    dense = _int_graph(seed)
    j, t = _csrs(dense)
    v = np.random.default_rng(seed).integers(-3, 4, 20).astype(np.float32)
    vt = torch.as_tensor(v)
    np.testing.assert_array_equal(
        ts.LaplacianMatrix(t).matvec(vt).numpy(),
        np.asarray(js.LaplacianMatrix(j).matvec(v)))
    np.testing.assert_array_equal(
        ts.LaplacianMatrix(t).degree.numpy(), dense.sum(1))
    tm, jm = ts.ModularityMatrix(t), js.ModularityMatrix(j)
    assert float(tm.edge_sum) == float(jm.edge_sum)
    np.testing.assert_allclose(tm.matvec(vt).numpy(),
                               np.asarray(jm.matvec(v)), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_analyze_bitwise_on_given_labels(seed):
    dense = _int_graph(seed)
    j, t = _csrs(dense)
    labels = np.random.default_rng(seed).integers(0, 3, 20).astype(np.int32)
    got = ts.analyze_partition(t, torch.as_tensor(labels), 3)
    want = js.analyze_partition(j, labels, 3)
    assert float(got[0]) == float(want[0])
    assert float(got[1]) == float(want[1])
    assert float(ts.analyze_modularity(t, labels)) == float(
        js.analyze_modularity(j, labels))


@pytest.mark.parametrize("n_per,bridge_w", [(8, 0.01), (12, 0.05)])
def test_partition_splits_the_cliques(n_per, bridge_w):
    dense = two_clique_graph(n_per, bridge_w)
    j, t = _csrs(dense)
    eig = (js.EigenSolverConfig(n_eig_vecs=2), ts.EigenSolverConfig(2))
    clu = (js.ClusterSolverConfig(n_clusters=2), ts.ClusterSolverConfig(2))
    want = js.partition(j, eig[0], clu[0])
    info = {}
    got = ts.partition(t, eig[1], clu[1], info=info)
    _same_split(got.labels.numpy(), np.asarray(want.labels))
    truth = np.repeat([0, 1], n_per)
    _same_split(got.labels.numpy(), truth)
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-4,
                               atol=1e-5)
    cut_t, cost_t = ts.analyze_partition(t, got.labels, 2)
    cut_j, cost_j = js.analyze_partition(j, want.labels, 2)
    np.testing.assert_allclose(float(cut_t), float(cut_j), atol=1e-4)
    np.testing.assert_allclose(float(cut_t), bridge_w, atol=1e-4)
    assert float(cost_t) == float(cost_j)
    assert info["residuals"].shape == (2,) and info["restarts"] >= 0


@pytest.mark.parametrize("bridge_w", [0.5, 0.2])
def test_modularity_maximization_same_split(bridge_w):
    dense = two_clique_graph(bridge_w=bridge_w)
    j, t = _csrs(dense)
    want = js.modularity_maximization(j, js.EigenSolverConfig(2),
                                      js.ClusterSolverConfig(2))
    got = ts.modularity_maximization(t, ts.EigenSolverConfig(2),
                                     ts.ClusterSolverConfig(2))
    _same_split(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-4,
                               atol=1e-5)
    q_t = float(ts.analyze_modularity(t, got.labels))
    q_j = float(js.analyze_modularity(j, want.labels))
    np.testing.assert_allclose(q_t, q_j, atol=1e-4)
    assert q_t > 0.3


def test_partition_is_deterministic_from_its_seeds():
    """Lanczos and k-means draw from generators seeded by the configs, so
    two calls give the same eigenvectors and labels."""
    _, t = _csrs(two_clique_graph())
    a = ts.partition(t, ts.EigenSolverConfig(2), ts.ClusterSolverConfig(2))
    b = ts.partition(t, ts.EigenSolverConfig(2), ts.ClusterSolverConfig(2))
    assert torch.equal(a.eigenvectors, b.eigenvectors)
    assert torch.equal(a.labels, b.labels)
