"""The two-level coarse probe of the PyTorch port
(``raft_tpu_torch/spatial/ann/common.py``: ``CoarseIndex``,
``build_coarse_index``, ``probe_flop_accounting`` and the ``coarse=``
eager probes of the qcap resolution; ``.../coarse.py``:
``two_level_probe`` on both engines and ``coarse_probe_recall``) against
the JAX package, on the CPU.

The same numpy inputs go to both packages. A JAX ``CoarseIndex`` is
carried across with ``coarse_index_from_arrays``; the build is compared
from the same super clustering (JAX's k-means labels and supers fed to
the port's packing), because torch cannot replay JAX's random streams.
The port's kernel engine runs the flat scan's plain versions here; the
JAX kernel engine runs in interpret mode, as its own tests run it.
Probes are compared up to ties (ROADMAP R1); distances bitwise on an
integer-exact centroid set, within 1e-5 relative on Gaussian ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.cluster.kmeans import KMeansParams as JKMeansParams
from raft_tpu.cluster.kmeans import kmeans_fit as j_kmeans_fit
from raft_tpu.serving.result_cache import CentroidSigner as JCentroidSigner
from raft_tpu.spatial.ann import common as jc
from raft_tpu_torch.serving.result_cache import CentroidSigner
from raft_tpu_torch.spatial.ann import coarse as tco
from raft_tpu_torch.spatial.ann import common as tc
from raft_tpu_torch.spatial.ann import flat_kernel as tfk
from raft_tpu_torch.spatial.ann import interop

torch.set_num_threads(1)


def _carry(jci):
    """The port's CoarseIndex from a JAX one's leaves (the archive's
    ``coarse.`` field names), on the CPU."""
    return interop.coarse_index_from_arrays({
        "coarse.super_cents": np.asarray(jci.super_cents),
        "coarse.member_ids": np.asarray(jci.member_ids),
        "coarse.cents_padded": np.asarray(jci.cents_padded),
        "coarse.n_cents": jci.n_cents,
        "coarse.n_super": jci.n_super,
        "coarse.max_members": jci.max_members,
        "coarse.build_args": jci.build_args,
    }, device="cpu")


def _args(ci):
    return (ci.super_cents, ci.member_ids, ci.cents_padded, ci.n_cents)


def _assert_probes_equal_up_to_ties(d, a, b):
    """Per row, the probe sets agree except inside the tie group cut by
    the n_probes boundary; interior tie groups hold the same id set."""
    d, a, b = (np.asarray(t) for t in (d, a, b))
    for r in range(d.shape[0]):
        start, k = 0, d.shape[1]
        for end in range(1, k + 1):
            if end == k or d[r, end] != d[r, start]:
                if end < k or start == 0:
                    assert set(a[r, start:end].tolist()) == \
                        set(b[r, start:end].tolist()), f"row {r}"
                start = end


def _int_centroids(seed, n=2048, d=12):
    """Integer-exact clustered centroids (the ``_int_dataset`` recipe):
    every squared distance and partial sum is exact in f32, and every
    value in bf16."""
    rng = np.random.default_rng(seed)
    hubs = rng.integers(-60, 60, (64, d))
    return (hubs[rng.integers(0, 64, n)]
            + rng.integers(-6, 7, (n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def centroid_set():
    rng = np.random.default_rng(11)
    return rng.standard_normal((300, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def jcoarse(centroid_set):
    return jc.build_coarse_index(centroid_set, seed=0)


@pytest.fixture(scope="module")
def coarse(jcoarse):
    return _carry(jcoarse)


@pytest.fixture(scope="module")
def built(centroid_set):
    """The port's own build of the centroid set."""
    return tc.build_coarse_index(centroid_set, seed=0, device="cpu")


@pytest.fixture(scope="module")
def int_case():
    """An integer-exact centroid set and its JAX coarse index with the
    supers rounded to integers (routing keys only: the members stay a
    partition), carried across; integer queries."""
    cents = _int_centroids(3)
    jci = jc.build_coarse_index(cents, seed=1)
    jci = dataclasses.replace(
        jci, super_cents=jnp.round(jci.super_cents))
    rng = np.random.default_rng(4)
    q = (cents[rng.integers(0, cents.shape[0], 40)]
         + rng.integers(-3, 4, (40, cents.shape[1]))).astype(np.float32)
    return cents, q, jci, _carry(jci)


class TestBuild:
    def test_members_partition_the_centroids(self, built, centroid_set):
        n = centroid_set.shape[0]
        m = built.member_ids.numpy()
        real = m[m < n]
        assert sorted(real.tolist()) == list(range(n))
        assert (m[m >= n] == n).all()
        assert built.n_cents == n
        assert built.member_ids.dtype == torch.int32

    def test_no_empty_super_clusters(self, built, centroid_set):
        m = built.member_ids.numpy()
        assert ((m < centroid_set.shape[0]).sum(axis=1) >= 1).all()
        assert built.n_super == built.super_cents.shape[0] == m.shape[0]

    def test_padded_blocks_carry_member_rows(self, built, centroid_set):
        n = centroid_set.shape[0]
        m = built.member_ids.numpy()
        valid = m < n
        assert np.array_equal(built.cents_padded.numpy()[valid],
                              centroid_set[m[valid]])
        # members first in each padded row
        assert (np.diff(valid.astype(np.int8), axis=1) <= 0).all()

    def test_member_cap_bounds_max_members(self, centroid_set):
        ci = tc.build_coarse_index(centroid_set, member_cap=16, seed=0,
                                   device="cpu")
        assert ci.max_members <= 16
        m = ci.member_ids.numpy()
        assert sorted(m[m < 300].tolist()) == list(range(300))
        assert ci.build_args == (None, 16, 10, 0)

    def test_geometry_defaults(self):
        ns, cap = tc.default_coarse_geometry(65792)
        assert ns == 256
        assert cap == -(-3 * -(-65792 // ns) // 2)
        for n in (1, 2, 7, 300, 2048, 65792, 100_003):
            assert tc.default_coarse_geometry(n) == \
                jc.default_coarse_geometry(n)

    def test_overprobe_below_one_rejected(self):
        with pytest.raises(ValueError):
            tc.n_super_probes(8, 64, overprobe=0.5)
        for p, ns, op in ((8, 64, 2.0), (16, 256, 2.0), (8, 5, 1.0),
                          (3, 40, 1.7)):
            assert tc.n_super_probes(p, ns, op) == \
                jc.n_super_probes(p, ns, op)

    @pytest.mark.parametrize("n_super,member_cap", [
        (None, None), (None, 16), (40, None)])
    def test_packing_from_the_same_super_clustering_matches_jax(
            self, centroid_set, n_super, member_cap):
        """JAX's k-means labels and supers through the port's packing
        (split at the cap, empty supers dropped, members first) give the
        JAX build's arrays exactly."""
        jci = jc.build_coarse_index(centroid_set, n_super=n_super,
                                    member_cap=member_cap, seed=0)
        ns_d, cap_d = jc.default_coarse_geometry(centroid_set.shape[0])
        out = j_kmeans_fit(jnp.asarray(centroid_set), JKMeansParams(
            n_clusters=ns_d if n_super is None else n_super, max_iter=10,
            seed=0, init="random", compute_dtype="bfloat16"))
        ci = tc.coarse_index_from_labels(
            torch.as_tensor(centroid_set), np.asarray(out.labels),
            np.asarray(out.centroids),
            cap_d if member_cap is None else member_cap, jci.build_args)
        for f in ("super_cents", "member_ids", "cents_padded"):
            assert np.array_equal(getattr(ci, f).numpy(),
                                  np.asarray(getattr(jci, f))), f
        assert (ci.n_cents, ci.n_super, ci.max_members, ci.build_args) == \
            (jci.n_cents, jci.n_super, jci.max_members, jci.build_args)

    def test_carry_checks_shapes(self, jcoarse):
        arrays = {"coarse.super_cents": np.asarray(jcoarse.super_cents),
                  "coarse.member_ids": np.asarray(jcoarse.member_ids)[:, 1:],
                  "coarse.cents_padded": np.asarray(jcoarse.cents_padded),
                  "coarse.n_cents": jcoarse.n_cents}
        with pytest.raises(ValueError, match="do not fit"):
            interop.coarse_index_from_arrays(arrays, device="cpu")
        with pytest.raises(ValueError, match="missing"):
            interop.coarse_index_from_arrays(
                {"coarse.super_cents": arrays["coarse.super_cents"]},
                device="cpu")


class TestProbe:
    def test_full_cover_matches_flat_scan(self, coarse, centroid_set):
        """S = n_super reranks every centroid: the probe set equals the
        flat scan's."""
        rng = np.random.default_rng(3)
        q = torch.as_tensor(rng.standard_normal((32, 16)),
                            dtype=torch.float32)
        flat, _ = tc.coarse_probe(q, torch.as_tensor(centroid_set), 8)
        two, d2 = tco.two_level_probe(q, *_args(coarse), 8, coarse.n_super)
        assert np.array_equal(np.sort(flat.numpy(), 1),
                              np.sort(two.numpy(), 1))
        assert torch.isfinite(d2).all()

    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_probe_respects_query_blocking(self, coarse, use_kernel):
        """block_q smaller than nq changes no probe, on either engine."""
        rng = np.random.default_rng(4)
        q = rng.standard_normal((21, 16)).astype(np.float32)
        args = _args(coarse) + (6, coarse.n_super)
        a, da = tco.two_level_probe(q, *args, 256, use_kernel=use_kernel)
        b, db = tco.two_level_probe(q, *args, 4, use_kernel=use_kernel)
        # the CPU's f32 products may sum in another order at another
        # batch size, so distances agree to rounding
        assert torch.equal(a, b)
        torch.testing.assert_close(da, db, rtol=1e-6, atol=1e-6)

    def test_legacy_engine_matches_jax(self, jcoarse, coarse):
        rng = np.random.default_rng(5)
        q = rng.standard_normal((130, 16)).astype(np.float32)
        S = tc.n_super_probes(8, coarse.n_super, 2.0)
        jp, jd = jc.two_level_probe(q, *_args(jcoarse), 8, S)
        tp, td = tco.two_level_probe(q, *_args(coarse), 8, S)
        _assert_probes_equal_up_to_ties(jd, jp, tp.numpy())
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("block_q", [256, 16])
    def test_integer_exact_engines_bitwise_vs_jax(self, int_case, block_q):
        """On integer-exact centroids, supers and queries every engine of
        both packages returns bitwise-equal distances, probes up to
        ties."""
        _, q, jci, ci = int_case
        S = tc.n_super_probes(8, ci.n_super, 2.0)
        assert ci.n_super > S, "premise: the probe is sub-linear here"
        got = {(pkg, k): None for pkg in ("jax", "torch")
               for k in (False, True)}
        for k in (False, True):
            p, d = jc.two_level_probe(q, *_args(jci), 8, S, block_q,
                                      use_pallas=k, pallas_interpret=k)
            got["jax", k] = (np.asarray(p), np.asarray(d))
            p, d = tco.two_level_probe(q, *_args(ci), 8, S, block_q,
                                       use_kernel=k)
            got["torch", k] = (p.numpy(), d.numpy())
        ref_p, ref_d = got["jax", False]
        for key, (p, d) in got.items():
            assert np.array_equal(d, ref_d), key
            _assert_probes_equal_up_to_ties(ref_d, ref_p, p)

    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_recall_guardrail_on_clustered_data(self, use_kernel):
        """Clustered centroids (the bench regime): the two-level probe's
        recall against the flat scan stays high at the default
        overprobe, for the port's own build, and equals the JAX audit on
        a JAX build carried across."""
        rng = np.random.default_rng(9)
        hubs = 8.0 * rng.standard_normal((64, 12)).astype(np.float32)
        cents = (np.repeat(hubs, 32, axis=0)
                 + rng.standard_normal((2048, 12)).astype(np.float32))
        q = cents[::97][:20] + 0.1 * rng.standard_normal(
            (20, 12)).astype(np.float32)
        ci = tc.build_coarse_index(cents, seed=1, device="cpu")
        assert ci.n_super > tc.n_super_probes(8, ci.n_super)
        assert tco.coarse_probe_recall(q, cents, ci, 8,
                                       use_kernel=use_kernel) >= 0.95
        jci = jc.build_coarse_index(cents, seed=1)
        assert tco.coarse_probe_recall(q, cents, _carry(jci), 8,
                                       use_kernel=use_kernel) == \
            jc.coarse_probe_recall(q, cents, jci, 8)

    def test_flop_acceptance_at_deployment_geometry(self):
        """>= 4x fewer centroid-scoring FLOPs than the flat scan at ~65k
        centroids, at the worst geometry the defaults allow (blocks full
        to the cap, the super count inflated by every possible split)."""
        n_cents, d, n_probes = 65792, 96, 16
        ns, cap = tc.default_coarse_geometry(n_cents)
        worst_ns = ns + -(-n_cents // cap)
        worst = tc.CoarseIndex(
            super_cents=torch.zeros((worst_ns, d)),
            member_ids=torch.zeros((worst_ns, cap), dtype=torch.int32),
            cents_padded=torch.zeros((worst_ns, cap, d)),
            n_cents=n_cents, n_super=worst_ns, max_members=cap)
        acc = tc.probe_flop_accounting(worst, n_probes)
        assert acc["ratio"] >= 4.0, acc

    def test_flop_accounting_matches_jax(self, jcoarse, coarse):
        for p, op in ((8, 2.0), (4, 1.0), (16, 3.0)):
            assert tc.probe_flop_accounting(coarse, p, overprobe=op) == \
                jc.probe_flop_accounting(jcoarse, p, overprobe=op)
        acc = tc.probe_flop_accounting(coarse, 8)
        S = tc.n_super_probes(8, coarse.n_super, 2.0)
        assert acc["two_level"] == 2.0 * (
            coarse.n_super + S * coarse.max_members) * 16

    def test_centroid_signer_from_coarse_matches_jax(self, jcoarse, coarse):
        rows = np.random.default_rng(2).standard_normal(
            (12, 16)).astype(np.float32)
        for p in (1, 2, 5):
            ts = CentroidSigner.from_coarse(coarse, n_probes=p)
            js = JCentroidSigner.from_coarse(jcoarse, n_probes=p)
            assert np.array_equal(ts.super_ids(rows), js.super_ids(rows))
            assert np.array_equal(ts(rows, b"k4"), js(rows, b"k4"))


def test_auto_qcap_routes_through_two_level_probe(centroid_set, coarse,
                                                  jcoarse, monkeypatch):
    """With ``coarse`` given, the qcap=None auto path probes the super
    set only, never the flat centroid set, and sizes the same qcap from
    the same probes as the JAX package."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    jqc, jprobes = jc.resolve_qcap_arg(None, q, jnp.asarray(centroid_set),
                                       300, 4, coarse=jcoarse)
    seen = []
    orig = tc.coarse_probe

    def recording(qf, cents, n_probes):
        seen.append(int(cents.shape[0]))
        return orig(qf, cents, n_probes)

    monkeypatch.setattr(tc, "coarse_probe", recording)
    qc, probes = tc.resolve_qcap_arg(None, torch.as_tensor(q),
                                     torch.as_tensor(centroid_set), 300, 4,
                                     coarse=coarse)
    assert isinstance(qc, int) and qc == jqc
    assert seen and all(s == coarse.n_super for s in seen), seen
    _assert_probes_equal_up_to_ties(
        tco.two_level_probe(q, *_args(coarse), 4, tc.n_super_probes(
            4, coarse.n_super))[1].numpy(), np.asarray(jprobes),
        probes.numpy())
    # an int qcap passes through with a coarse index too
    assert tc.resolve_qcap_arg(8, torch.as_tensor(q),
                               torch.as_tensor(centroid_set), 300, 4,
                               coarse=coarse) == (8, None)


def test_two_level_probe_plays_with_throughput_audit(centroid_set, coarse,
                                                     monkeypatch):
    """The throughput audit sizes qcap from the flat probe without a
    coarse index and from the two-level probe with one."""
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.standard_normal((16, 16)), dtype=torch.float32)
    cents = torch.as_tensor(centroid_set)
    qc, probes = tc.resolve_qcap_arg("throughput", q, cents, 300, 4)
    assert qc == jc.throughput_qcap(16, 4, 300) and qc >= 1
    assert torch.equal(probes, tc.coarse_probe(q, cents, 4)[0])
    seen = []
    orig = tc.coarse_probe

    def recording(qf, c, n_probes):
        seen.append(int(c.shape[0]))
        return orig(qf, c, n_probes)

    monkeypatch.setattr(tc, "coarse_probe", recording)
    qc2, probes2 = tc.resolve_qcap_arg("throughput", q, cents.clone(), 300,
                                       4, coarse=coarse)
    assert qc2 == qc and seen == [coarse.n_super]
    assert probes2.shape == (16, 4)


class TestKernelizedProbe:
    """The kernel engine: the super scan as one flat-scan launch over the
    batch (stage 1), the member rerank as the IVF-Flat grouped body over
    a mini index whose lists are the supers (stage 2)."""

    def test_kernel_probe_matches_legacy_and_jax(self, jcoarse, coarse):
        rng = np.random.default_rng(5)
        q = rng.standard_normal((130, 16)).astype(np.float32)
        S = tc.n_super_probes(8, coarse.n_super, 2.0)
        assert tco.two_level_probe_kernel_supported(
            16, 130, 8, coarse.n_super, coarse.max_members, S)
        assert jc.two_level_probe_kernel_supported(
            16, 130, 8, coarse.n_super, coarse.max_members, S)
        p0, d0 = tco.two_level_probe(q, *_args(coarse), 8, S)
        p1, d1 = tco.two_level_probe(q, *_args(coarse), 8, S,
                                     use_kernel=True)
        _assert_probes_equal_up_to_ties(d0.numpy(), p0.numpy(), p1.numpy())
        np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=1e-5,
                                   atol=1e-4)
        jp, jd = jc.two_level_probe(q, *_args(jcoarse), 8, S,
                                    use_pallas=True, pallas_interpret=True)
        _assert_probes_equal_up_to_ties(jd, jp, p1.numpy())
        np.testing.assert_allclose(d1.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)

    def test_kernel_probe_full_cover_degeneration(self, coarse,
                                                  centroid_set):
        rng = np.random.default_rng(6)
        q = torch.as_tensor(rng.standard_normal((32, 16)),
                            dtype=torch.float32)
        flat, _ = tc.coarse_probe(q, torch.as_tensor(centroid_set), 8)
        two, d2 = tco.two_level_probe(q, *_args(coarse), 8, coarse.n_super,
                                      use_kernel=True)
        assert np.array_equal(np.sort(flat.numpy(), 1),
                              np.sort(two.numpy(), 1))
        assert torch.isfinite(d2).all()

    def test_kernel_engine_scans_once_a_stage(self, coarse, monkeypatch):
        """One flat-scan call for stage 1 over the whole batch, whatever
        block_q, and one list-scan call for stage 2, at the shapes the
        JAX window rule gives."""
        calls = []
        for name in ("flat_scan_subchunk_min", "flat_scan_lists"):
            real = getattr(tfk, name)

            def rec(*a, _real=real, _name=name):
                calls.append((_name, tuple(a[0].shape), tuple(a[1].shape)))
                return _real(*a)

            monkeypatch.setattr(tfk, name, rec)
        rng = np.random.default_rng(7)
        q = rng.standard_normal((70, 16)).astype(np.float32)
        S = tc.n_super_probes(4, coarse.n_super, 2.0)
        tco.two_level_probe(q, *_args(coarse), 4, S, 16, use_kernel=True)
        ns = coarse.n_super
        assert calls == [
            ("flat_scan_subchunk_min", (1, 70, 16), (1, 16, 128)),
            ("flat_scan_lists", (71, 16), (ns, tco._probe_qcap(70, S, ns))),
        ], calls

    def test_unsupported_geometry_serves_legacy_and_is_counted(
            self, jcoarse, coarse, caplog):
        """use_kernel=True where the kernel engine does not apply (a
        stage-1 query block past the flat scan's window plan) serves the
        legacy engine, as the JAX package does, counted in
        COARSE_ENGINE_FALLBACKS and warned about once per geometry."""
        assert not tco.two_level_probe_kernel_supported(
            1 << 20, 32, 8, coarse.n_super, coarse.max_members, 16)
        nq = 20_000
        q = np.random.default_rng(8).standard_normal(
            (nq, 16)).astype(np.float32)
        for mod in (tco, jc):
            assert not mod.two_level_probe_kernel_supported(
                16, nq, 4, coarse.n_super, coarse.max_members, 2, nq)
        before = tco.COARSE_ENGINE_FALLBACKS
        with caplog.at_level("WARNING", logger="raft_tpu_torch"):
            outs = [tco.two_level_probe(q, *_args(coarse), 4, 2, nq,
                                        use_kernel=True) for _ in range(2)]
        assert tco.COARSE_ENGINE_FALLBACKS == before + 2
        assert len([r for r in caplog.records
                    if "legacy engine" in r.getMessage()]) <= 1
        p0, d0 = tco.two_level_probe(q, *_args(coarse), 4, 2, nq)
        assert all(torch.equal(p, p0) and torch.equal(d, d0)
                   for p, d in outs)
        jp, jd = jc.two_level_probe(q, *_args(jcoarse), 4, 2, nq,
                                    use_pallas=True, pallas_interpret=True)
        _assert_probes_equal_up_to_ties(jd, jp, p0.numpy())
        np.testing.assert_allclose(d0.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)

    def test_pinned_precision_selects_legacy(self, coarse, monkeypatch):
        """A pinned precision routes to the legacy engine, as in the JAX
        package, and is not an engine fallback."""
        def boom(*a, **k):
            raise AssertionError("the kernel engine ran")

        monkeypatch.setattr(tco, "_two_level_probe_kernel", boom)
        before = tco.COARSE_ENGINE_FALLBACKS
        q = np.random.default_rng(9).standard_normal(
            (8, 16)).astype(np.float32)
        p, _ = tco.two_level_probe(q, *_args(coarse), 4, 8,
                                   precision="highest", use_kernel=True)
        assert torch.equal(p, tco.two_level_probe(q, *_args(coarse), 4,
                                                  8)[0])
        assert tco.COARSE_ENGINE_FALLBACKS == before

    def test_recall_audit_covers_kernelized_probe(self, coarse,
                                                  centroid_set):
        rng = np.random.default_rng(17)
        q = rng.standard_normal((96, 16)).astype(np.float32)
        r_legacy = tco.coarse_probe_recall(q, centroid_set, coarse, 8)
        r_kernel = tco.coarse_probe_recall(q, centroid_set, coarse, 8,
                                           use_kernel=True)
        assert abs(r_kernel - r_legacy) <= 0.01, (r_kernel, r_legacy)
