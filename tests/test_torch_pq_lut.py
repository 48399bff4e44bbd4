"""The IVF-PQ ADC table build, ``pq_kernel.pq_lut_rows``, on the CPU.

Its plain version must equal, bit for bit, a numpy f32 reference that
spells the order the CUDA kernel fixes (``csrc/pq_scan.cu``) in scalar
operations; the wrapper must refuse what the kernel does not take; and
the rows may differ from the einsum formula they replaced only by that
formula's own f32 rounding order. The kernel itself is held against the
plain version in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.spatial.ann import pq_kernel as tpq

torch.set_num_threads(1)

F = np.float32


def _bf16_bits(x):
    """Round-to-nearest-even f32 -> bf16, as uint16 bits (finite x)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    return b.astype(np.uint16)


def _reference(queries, cents, cb, cb_n, lists, qids):
    """The kernel's order in numpy f32 scalars: r_j = Q - C; n = r_0 r_0
    then n + r_j r_j; g = r_0 B_0 then g + r_j B_j (ascending j); the
    entry bf16((n + B_n) - 2 g). Returns (P, M*K) uint16 bf16 bits."""
    m_dim, k_dim, ds = cb.shape
    out = np.zeros((len(lists), m_dim * k_dim), np.float32)
    for i, (li, qi) in enumerate(zip(lists, qids)):
        for m in range(m_dim):
            r = [F(queries[qi, m * ds + j]) - F(cents[li, m * ds + j])
                 for j in range(ds)]
            n = r[0] * r[0]
            for j in range(1, ds):
                n = n + r[j] * r[j]
            for k in range(k_dim):
                g = r[0] * F(cb[m, k, 0])
                for j in range(1, ds):
                    g = g + r[j] * F(cb[m, k, j])
                out[i, m * k_dim + k] = (n + F(cb_n[m, k])) - F(2.0) * g
    return _bf16_bits(out)


def _case(seed, m_dim, k_dim, ds, n_pairs, nq=5, n_lists=6):
    """Gaussian queries (the last row the zero pad row, as the one-hot
    engine passes it), centroids and codebooks; ids that repeat and
    include the pad row."""
    rng = np.random.default_rng(seed)
    d = m_dim * ds
    queries = rng.standard_normal((nq + 1, d)).astype(np.float32)
    queries[nq] = 0.0
    cents = rng.standard_normal((n_lists, d)).astype(np.float32)
    cb = rng.standard_normal((m_dim, k_dim, ds)).astype(np.float32)
    cb_n = (cb.astype(np.float64) ** 2).sum(2).astype(np.float32)
    lists = rng.integers(0, n_lists, n_pairs)
    qids = rng.integers(0, nq + 1, n_pairs)
    if n_pairs > 2:
        lists[1], qids[1] = lists[0], qids[0]          # a repeated pair
        qids[2] = nq                                    # the pad row
    return queries, cents, cb, cb_n, lists, qids


def _torch(queries, cents, cb, cb_n, lists, qids):
    return (torch.as_tensor(queries), torch.as_tensor(cents),
            torch.as_tensor(cb), torch.as_tensor(cb_n),
            torch.as_tensor(lists, dtype=torch.int64),
            torch.as_tensor(qids, dtype=torch.int64))


@pytest.mark.parametrize("n_pairs", [0, 1, 7])
@pytest.mark.parametrize("k_dim", [16, 256])
@pytest.mark.parametrize("ds", [1, 3, 4, 8])
def test_lut_rows_equal_numpy_reference_bitwise(ds, k_dim, n_pairs):
    m_dim = 3 if k_dim == 16 else 2
    case = _case(100 * ds + k_dim + n_pairs, m_dim, k_dim, ds, n_pairs)
    before = tpq.LUT_LAUNCHES
    got = tpq.pq_lut_rows(*_torch(*case))
    assert tpq.LUT_LAUNCHES == before          # the CPU runs no kernel
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (n_pairs, m_dim * k_dim)
    want = _reference(*case)
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          want)
    plain = tpq.pq_lut_rows_plain(*_torch(*case))
    assert torch.equal(got.view(torch.int16), plain.view(torch.int16))


def _args():
    return list(_torch(*_case(7, 4, 16, 3, 5)))


def _replaced(i, t):
    a = _args()
    a[i] = t
    return a


@pytest.mark.parametrize("bad", [
    lambda: _replaced(0, _args()[0].double()),             # f64 queries
    lambda: _replaced(2, _args()[2].half()),               # f16 codebooks
    lambda: _replaced(4, _args()[4].int()),                # int32 ids
    lambda: _replaced(0, _args()[0][:, :-1]),              # d != M*ds
    lambda: _replaced(1, _args()[1][:, :-3]),              # centroid width
    lambda: _replaced(3, _args()[3][:, :-1]),              # cb_norms shape
    lambda: _replaced(0, _args()[0].flatten()),            # queries 1-d
    lambda: _replaced(5, _args()[5][:-1]),                 # id counts
    lambda: _replaced(0, torch.zeros((12, 6)).t()),        # not contiguous
    lambda: _replaced(1, _args()[1].to("meta")),           # mixed devices
    lambda: [torch.zeros((2, 257)), torch.zeros((3, 257)),
             torch.zeros((1, 300, 257)), torch.zeros((1, 300)),
             torch.zeros(1, dtype=torch.int64),
             torch.zeros(1, dtype=torch.int64)],           # K > 256
])
def test_lut_rows_wrapper_refuses_what_the_kernel_does_not_take(bad):
    before = tpq.LUT_LAUNCHES
    with pytest.raises(ValueError, match="pq_lut_rows"):
        tpq.pq_lut_rows(*bad())
    assert tpq.LUT_LAUNCHES == before


def _einsum_rows(queries, cents, cb, cb_n, lists, qids):
    # the f32 PyTorch chain the kernel replaced
    m_dim, _, ds = cb.shape
    res = (queries[qids] - cents[lists]).reshape(-1, m_dim, ds)
    dots = torch.einsum("pmd,mkd->pmk", res, cb)
    res_n = torch.sum(res * res, dim=2)
    return (res_n[..., None] + cb_n[None] - 2.0 * dots).flatten(1).to(
        torch.bfloat16)


@pytest.mark.parametrize("ds", [1, 4, 8])
def test_lut_rows_near_the_einsum_formula(ds):
    """The new rows against the einsum chain they replaced. The two may
    sum the norm n and the dot g in different f32 orders (the CPU's
    einsum happens to add in ascending j too; cuBLAS need not): each
    differs from
    the exact value by at most (ds + 1) u of its own magnitude (u =
    2^-24), and (n + B_n) - 2g by a few u of n + B_n + 2|g|, which
    cancellation can make large against the entry itself; one bf16
    rounding of each then adds at most one bf16 ulp (2^-7 of the
    larger magnitude). The bound is that sum, with the f32 part doubled."""
    case = _case(11 + ds, 24, 256, ds, 64, nq=40, n_lists=30)
    args = _torch(*case)
    new = tpq.pq_lut_rows(*args).double()
    old = _einsum_rows(*args).double()
    queries, cents, cb, cb_n, lists, qids = case
    m_dim, k_dim, _ = cb.shape
    r = (queries[qids].astype(np.float64)
         - cents[lists]).reshape(-1, m_dim, 1, ds)
    scale = ((r ** 2).sum(3) + cb_n[None].astype(np.float64)
             + 2 * np.abs(r * cb[None].astype(np.float64)).sum(3))
    scale = torch.as_tensor(scale.reshape(len(lists), -1))
    tol = (2.0 ** -7 * torch.maximum(new.abs(), old.abs())
           + 2 * (ds + 4) * 2.0 ** -24 * scale)
    assert ((new - old).abs() <= tol).all()
