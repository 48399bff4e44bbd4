"""PyTorch port of the label, LAP and matrix packages
(raft_tpu_torch.label, .lap, .matrix) against the JAX package, on the
CPU; and the import guard of the sparse distances, the capture and
the random, stats, label, LAP and matrix packages.

Tolerances, and why:

* labels, matrix helpers: bitwise (integer work, gathers, copies, the
  same f32 elementwise ops);
* the auction: ``_auction_round`` is held to the JAX round op for op,
  bitwise, on the same state. Whole solves are bitwise (assignments and
  objectives; the prices too until the port's epsilon floor, below,
  rises above the schedule) once both packages run the same epsilon
  schedule: the schedule's f32 ``exp`` / ``log`` are XLA's
  CPU approximations in the JAX package, torch's here, which differ in
  the last bit on some inputs, so the tests hand the port JAX's
  schedule. With its own schedule the port's assignments equal JAX's on
  integer costs with a unique optimum, and its objectives scipy's
  exactly; f32 integer costs in [0, 1000] at 64 and 1,024, where the
  JAX package's auction stalls, end at scipy's objective exactly (the
  port floors each phase's epsilon at the prices' spacing);
* float costs (``tests/test_label_lap_cache_spectral.py``'s cases):
  objectives within 1e-3 of the brute-force optimum, as there.
"""

import itertools
import subprocess
import sys

import numpy as np
import pytest
import torch

import raft_tpu.matrix as jm
from raft_tpu.label import classlabels as jl
from raft_tpu.lap import lap as jlap
import raft_tpu_torch.matrix as tm
from raft_tpu_torch.label import classlabels as tl
from raft_tpu_torch.lap import lap as tlap

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _eq(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    np.testing.assert_array_equal(torch.as_tensor(got).numpy(),
                                  np.asarray(want))


# -- label ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unique_and_monotonic_bitwise(seed):
    rng = np.random.default_rng(seed)
    labels = rng.choice([-4, 0, 3, 7, 7, 19, 250], 300).astype(np.int32)
    t = torch.as_tensor(labels)
    _eq(tl.get_unique_labels(t), jl.get_unique_labels(labels))
    _eq(tl.get_unique_labels(t, capacity=10),
        jl.get_unique_labels(labels, capacity=10))
    _eq(tl.get_unique_labels(t, capacity=3),
        jl.get_unique_labels(labels, capacity=3))
    _eq(tl.make_monotonic(t), jl.make_monotonic(labels))
    for target in (7, 5):
        _eq(tl.get_ovr_labels(t, target), jl.get_ovr_labels(labels, target))


def test_label_cases_of_the_jax_tests():
    labels = np.array([3, 1, 3, 7, 1, 9], np.int32)
    uniq, n = tl.get_unique_labels(labels, capacity=6, device=CPU)
    assert int(n) == 4 and uniq[:4].tolist() == [1, 3, 7, 9]
    assert tl.make_monotonic(labels, device=CPU).tolist() == [1, 0, 1, 2, 0,
                                                              3]
    a = np.array([0, 0, 1, 1, 2], np.int32)
    b = np.array([0, 1, 1, 2, 3], np.int32)
    assert tl.merge_labels(a, b, device=CPU).tolist() == [0, 0, 0, 0, 4]
    mask = np.array([True, False, False, True, True])
    assert tl.merge_labels(a, b, mask, device=CPU).tolist() == [0, 0, 2, 2,
                                                                4]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_merge_labels_bitwise(seed, masked):
    rng = np.random.default_rng(seed)
    n = 400
    a = rng.integers(0, 120, n).astype(np.int32)
    b = rng.integers(0, 150, n).astype(np.int32)
    mask = rng.random(n) < 0.6 if masked else None
    got = tl.merge_labels(torch.as_tensor(a), torch.as_tensor(b),
                          None if mask is None else torch.as_tensor(mask))
    _eq(got, jl.merge_labels(a, b, mask))
    assert got.dtype == torch.int32


# -- LAP -----------------------------------------------------------------------

def _jax_eps(costs, maximize=False):
    """The JAX package's epsilon schedule of each problem, as its
    ``solve_lap`` computes it."""
    import jax.numpy as jnp

    out = []
    for c in np.asarray(costs, np.float32).reshape(-1, *costs.shape[-2:]):
        benefits = jnp.asarray(c if maximize else -c)
        n = c.shape[0]
        spread = jnp.maximum(jnp.max(benefits) - jnp.min(benefits), 1.0)
        eps0 = spread / 2.0
        factor = jnp.exp(jnp.log((1e-4 / n) / eps0) / 9)
        out.append(np.asarray(eps0 * factor ** jnp.arange(10)))
    return torch.as_tensor(np.stack(out))


def _with_jax_eps(monkeypatch, costs, maximize=False):
    eps = _jax_eps(costs, maximize)
    monkeypatch.setattr(tlap, "_phase_eps", lambda benefits: eps.to(
        benefits.dtype))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auction_round_op_for_op(seed):
    """Rounds from the same state, bitwise: assignments both ways and
    prices, through a phase."""
    rng = np.random.default_rng(seed)
    n = 9
    benefits = -rng.integers(0, 12, (n, n)).astype(np.float32)
    import jax.numpy as jnp

    jstate = jlap._AuctionState(jnp.full(n, -1, jnp.int32),
                                jnp.full(n, -1, jnp.int32),
                                jnp.zeros(n, jnp.float32), jnp.float32(0.37))
    benefits = jnp.asarray(benefits)
    tstate = tlap._AuctionState(torch.full((1, n), -1, dtype=torch.int32),
                                torch.full((1, n), -1, dtype=torch.int32),
                                torch.zeros((1, n)),
                                torch.full((1, 1), 0.37))
    tb = torch.as_tensor(np.array(benefits))[None]
    for _ in range(40):
        jstate = jlap._auction_round(benefits, jstate)
        tstate = tlap._auction_round(tb, tstate)
        for f in ("row_to_col", "col_to_row", "prices"):
            np.testing.assert_array_equal(getattr(tstate, f)[0].numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f)
        if (np.asarray(jstate.row_to_col) >= 0).all():
            break
    assert (tstate.row_to_col >= 0).all()


@pytest.mark.parametrize("n,hi", [(4, 9), (8, 20), (16, 30), (24, 60)])
def test_solve_lap_bitwise_on_integer_costs(monkeypatch, n, hi):
    rng = np.random.default_rng(n)
    cost = rng.integers(0, hi + 1, (n, n)).astype(np.float32)
    _with_jax_eps(monkeypatch, cost)
    info = {}
    rows, total = tlap.solve_lap(torch.as_tensor(cost), info=info)
    jrows, jtotal = jlap.solve_lap(cost)
    _eq(rows, jrows)
    _eq(total, jtotal)
    assert rows.dtype == torch.int32
    assert info["syncs"] == info["rounds"] + 10
    from scipy.optimize import linear_sum_assignment

    r, c = linear_sum_assignment(cost)
    assert float(total) == cost[r, c].sum()


def test_solve_lap_maximize_bitwise(monkeypatch):
    rng = np.random.default_rng(11)
    cost = rng.integers(0, 15, (10, 10)).astype(np.float32)
    _with_jax_eps(monkeypatch, cost, maximize=True)
    _eq(tlap.solve_lap(cost, maximize=True, device=CPU),
        jlap.solve_lap(cost, maximize=True))


def test_solve_lap_batched_bitwise(monkeypatch):
    """The batch as one tensor with a per-problem active mask: JAX's
    vmapped solve bitwise, and each problem's own solve bitwise."""
    rng = np.random.default_rng(12)
    costs = rng.integers(0, 25, (5, 12, 12)).astype(np.float32)
    costs[2] = np.eye(12, dtype=np.float32) * -5 + 10   # solved in 1 phase
    _with_jax_eps(monkeypatch, costs)
    info = {}
    rows, objs = tlap.solve_lap_batched(torch.as_tensor(costs), info=info)
    _eq((rows, objs), jlap.solve_lap_batched(costs))
    for b in range(5):
        _with_jax_eps(monkeypatch, costs[b])
        r1, o1 = tlap.solve_lap(torch.as_tensor(costs[b]))
        assert torch.equal(r1, rows[b]) and torch.equal(o1, objs[b])
    assert info["rounds"] > 0


@pytest.mark.parametrize("n", [32, 48])
def test_solve_lap_own_schedule_unique_optimum(n):
    """The port's own epsilon schedule: on integer costs with a unique
    optimum (a planted permutation of zeros, every other entry >= 10)
    the assignment is JAX's and scipy's, the objective exact."""
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(n)
    cost = rng.integers(10, 60, (n, n)).astype(np.float32)
    plant = rng.permutation(n)
    cost[np.arange(n), plant] = 0.0
    rows, total = tlap.solve_lap(cost, device=CPU)
    jrows, jtotal = jlap.solve_lap(cost)
    r, c = linear_sum_assignment(cost)
    assert float(total) == float(jtotal) == cost[r, c].sum() == 0.0
    np.testing.assert_array_equal(rows.numpy(), plant)
    np.testing.assert_array_equal(np.asarray(jrows), plant)


def test_solve_lap_f64_computes_in_f64():
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(13)
    cost = rng.integers(0, 1001, (64, 64)).astype(np.float64)
    rows, total = tlap.solve_lap(torch.as_tensor(cost))
    assert total.dtype == torch.float64
    r, c = linear_sum_assignment(cost)
    assert float(total) == cost[r, c].sum()
    assert sorted(rows.tolist()) == list(range(64))


@pytest.mark.parametrize("n,cap", [(64, 5_000), (1024, 40_000)])
def test_solve_lap_f32_ends_at_scale(monkeypatch, n, cap):
    """f32 integer costs in [0, 1000], where the prices' spacing passes
    the schedule's last epsilons (at 64, seed 0, the JAX package's solve
    stalls in phase 8): the port's floored epsilon ends the auction,
    under a round cap that raises rather than hangs, with scipy's
    objective."""
    from scipy.optimize import linear_sum_assignment

    run = tlap._Rounds.run
    done = [0]

    def capped(self):
        done[0] += 1
        if done[0] > cap:
            raise RuntimeError(f"the auction passed {cap} rounds")
        run(self)

    monkeypatch.setattr(tlap._Rounds, "run", capped)
    cost = np.random.default_rng(0).integers(0, 1001, (n, n)).astype(
        np.float32)
    info = {}
    rows, total = tlap.solve_lap(torch.as_tensor(cost), info=info)
    assert total.dtype == torch.float32
    assert sorted(rows.tolist()) == list(range(n))
    r, c = linear_sum_assignment(cost)
    assert float(total) == cost[r, c].sum()
    assert info["syncs"] == info["rounds"] + 10 == done[0] + 10


def _brute(cost):
    n = cost.shape[0]
    return min(cost[np.arange(n), list(p)].sum()
               for p in itertools.permutations(range(n)))


@pytest.mark.parametrize("n", [3, 5, 7])
def test_lap_cases_of_the_jax_tests(n):
    rng = np.random.default_rng(n)
    for _ in range(3):
        cost = rng.random((n, n)).astype(np.float32)
        assign, total = tlap.solve_lap(cost, device=CPU)
        assert sorted(assign.tolist()) == list(range(n))
        np.testing.assert_allclose(float(total), _brute(cost), rtol=1e-3,
                                   atol=1e-3)
    cost = rng.random((6, 6)).astype(np.float32)
    _, total = tlap.solve_lap(cost, maximize=True, device=CPU)
    np.testing.assert_allclose(float(total), -_brute(-cost), rtol=1e-3,
                               atol=1e-3)
    eye = np.ones((8, 8), np.float32) * 10 - 9 * np.eye(8, dtype=np.float32)
    assign, total = tlap.solve_lap(eye, device=CPU)
    assert assign.tolist() == list(range(8)) and float(total) == 8.0
    costs = rng.random((4, 5, 5)).astype(np.float32)
    rows, objs = tlap.solve_lap_batched(costs, device=CPU)
    for b in range(4):
        np.testing.assert_allclose(float(objs[b]), _brute(costs[b]),
                                   rtol=1e-3, atol=1e-3)
    lp = tlap.LinearAssignmentProblem(5, 4)
    rows2, objs2 = lp.solve(costs, device=CPU)
    assert torch.equal(objs, objs2) and torch.equal(rows, rows2)
    assert lp.row_assignments is rows2


# -- matrix --------------------------------------------------------------------

@pytest.fixture(scope="module")
def mat():
    rng = np.random.default_rng(20)
    x = rng.integers(-3, 4, (37, 23)).astype(np.float32)   # many ties
    return x, rng


def test_matrix_helpers_bitwise(mat):
    x, rng = mat
    t = torch.as_tensor(x)
    idx = rng.integers(0, 37, 50).astype(np.int32)
    _eq(tm.copy_rows(t, torch.as_tensor(idx)), jm.copy_rows(x, idx))
    _eq(tm.slice_matrix(t, 2, 3, 20, 17), jm.slice_matrix(x, 2, 3, 20, 17))
    _eq(tm.truncate_zero_origin(t, 5, 9), jm.truncate_zero_origin(x, 5, 9))
    _eq(tm.col_reverse(t), jm.col_reverse(x))
    _eq(tm.row_reverse(t), jm.row_reverse(x))
    _eq(tm.get_diagonal(t), jm.get_diagonal(x))
    vec = rng.standard_normal(40).astype(np.float32)
    _eq(tm.set_diagonal(t, torch.as_tensor(vec)), jm.set_diagonal(x, vec))
    nz = x + 10.0
    _eq(tm.invert_diagonal(torch.as_tensor(nz)), jm.invert_diagonal(nz))
    for axis in (0, 1):
        _eq(tm.argmax(t, axis), jm.argmax(x, axis))
        _eq(tm.argmin(t, axis), jm.argmin(x, axis))
        _eq(tm.ratio(torch.as_tensor(nz), axis), jm.ratio(nz, axis))
    _eq(tm.ratio(torch.as_tensor(nz)), jm.ratio(nz))
    _eq(tm.copy_upper_triangular(t), jm.copy_upper_triangular(x))
    for neg in (False, True):
        _eq(tm.seq_root(t, 2.5, neg), jm.seq_root(x, 2.5, neg))
    small = x * 1e-16
    _eq(tm.zero_small_values(torch.as_tensor(small), 2e-16),
        jm.zero_small_values(small, 2e-16))
    for asc in (True, False):
        _eq(tm.sort_cols_per_row(t, asc), jm.sort_cols_per_row(x, asc))
    # the originals are untouched (the helpers are functional)
    np.testing.assert_array_equal(t.numpy(), x)


def test_matrix_ties_first_index_and_stable_sort():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 0.0]])
    assert tm.argmax(x).tolist() == [1] and tm.argmin(x).tolist() == [3]
    vals, idx = tm.sort_cols_per_row(x)
    assert idx.tolist() == [[3, 4, 0, 1, 2]]
    vals, idx = tm.sort_cols_per_row(x, ascending=False)
    assert idx.tolist() == [[1, 2, 0, 3, 4]]
    assert vals.tolist() == [[3.0, 3.0, 1.0, 0.0, 0.0]]


def test_names_match_the_jax_modules():
    import raft_tpu.label as jlabel
    import raft_tpu.lap as jlap_pkg
    import raft_tpu_torch.label as tlabel
    import raft_tpu_torch.lap as tlap_pkg

    for jmod, tmod in ((jlabel, tlabel), (jlap_pkg, tlap_pkg)):
        assert set(jmod.__all__) <= set(tmod.__all__)
    jnames = {k for k, v in vars(jm).items()
              if callable(v) and not k.startswith("_")
              and getattr(v, "__module__", "") == jm.__name__}
    assert len(jnames) == 15 and jnames <= set(tm.__all__)


# -- the import guard ---------------------------------------------------------

def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import raft_tpu_torch\n"
        "assert 'torch' not in sys.modules\n"
        "for name in ('random', 'stats', 'label', 'lap', 'matrix'):\n"
        "    assert name in raft_tpu_torch.__all__, name\n"
        "import raft_tpu_torch.sparse.distance, raft_tpu_torch.obs.capture\n"
        "import raft_tpu_torch.random, raft_tpu_torch.stats\n"
        "import raft_tpu_torch.label, raft_tpu_torch.lap\n"
        "import raft_tpu_torch.matrix\n"
        "from raft_tpu_torch import random, stats, label, lap, matrix\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'raft_tpu' or m.startswith('raft_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
