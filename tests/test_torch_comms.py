"""PyTorch port of the comms layer (raft_tpu_torch/comms: comms,
self_test, multihost) and of the shard-health and failover pieces of
raft_tpu_torch/resilience (health, degraded, replica) against the JAX
package, on the CPU.

Inputs are made from a numpy seed and fed to JAX on the 8-device virtual
CPU mesh (tests/conftest.py) and to the port's in-process form at P = 8
(one thread per rank, every rank on the CPU). Every collective, and
``hierarchical_allreduce`` on a 2 x 4 mesh, is held bitwise on
integer-valued f32; the host-side health, placement and routing objects
must equal JAX's on the same inputs. The in-process form's failure path
(a rank that raises, a rank that never arrives) must reach the caller
within a timeout and leave no thread behind. The torch.distributed form
is exercised in tests/test_torch_mnmg_ivf_flat.py (two gloo processes).
"""

import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu import errors as jerrors
from raft_tpu.comms import build_comms as j_build_comms
from raft_tpu.comms import build_comms_hierarchical as j_build_hier
from raft_tpu.comms import multihost as jmh
from raft_tpu.comms import self_test as jst
from raft_tpu.obs import metrics as jobsm
from raft_tpu.resilience import degraded as jdeg
from raft_tpu.resilience import health as jhealth
from raft_tpu.resilience import replica as jrep
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.comms import (
    build_comms,
    build_comms_hierarchical,
    comms_levels,
    dcn_merge_accounting,
    hierarchical_merge_select_k,
    host_aware_offset,
    host_rank_mask,
    inject_comms,
    run_all_self_tests,
)
from raft_tpu_torch.comms import multihost as tmh
from raft_tpu_torch.comms import self_test as tst
from raft_tpu_torch.obs import metrics as tobsm
from raft_tpu_torch.resilience import degraded as tdeg
from raft_tpu_torch.resilience import health as thealth
from raft_tpu_torch.resilience import replica as trep

torch.set_num_threads(1)

P8 = 8


@pytest.fixture(scope="module")
def jcomms():
    return j_build_comms(jax.devices()[:P8])


@pytest.fixture(scope="module")
def tcomms():
    return build_comms(["cpu"] * P8, timeout_s=60.0)


@pytest.fixture(scope="module")
def jhier():
    return j_build_hier(jax.devices()[:P8], mesh_shape=(2, 4))


@pytest.fixture(scope="module")
def thier():
    return build_comms_hierarchical(["cpu"] * P8, mesh_shape=(2, 4),
                                    timeout_s=60.0)


def _int_f32(seed, shape, lo=-20, hi=21):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def jax_ranks(comms, body, x):
    """``body(ax, block)`` on every rank of the JAX mesh; returns each
    rank's output stacked (np) — a tuple when the body returns one."""
    ax = comms.device_comms()

    def sm_body(xb):
        out = body(ax, xb[0])
        if isinstance(out, tuple):
            return tuple(o[None] for o in out)
        return out[None]

    out = comms.shard_map(sm_body, in_specs=P(comms.axis),
                          out_specs=P(comms.axis))(jnp.asarray(x))
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def torch_ranks(comms, body, x):
    out = comms.run(body, sharded=(torch.as_tensor(x),), out="stacked")
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _mtuple(out):
    return out if isinstance(out, tuple) else (out,)


def assert_bitwise(j, t):
    for a, b in zip(_mtuple(j), _mtuple(t)):
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_array_equal(b, a.astype(b.dtype))
        if a.dtype.kind == "f":
            assert a.tobytes() == b.astype(a.dtype).tobytes()


# (name, per-rank input shape, body) — the body uses only the facade's
# methods, so one body runs on both packages' ranks
COLLECTIVES = [
    ("allreduce_sum", (4, 3), lambda ax, x: ax.allreduce(x)),
    ("allreduce_max", (4, 3), lambda ax, x: ax.allreduce(x, "max")),
    ("allreduce_min", (4, 3), lambda ax, x: ax.allreduce(x, "min")),
    ("allreduce_prod", (5,), lambda ax, x: ax.allreduce(x * 0 + 2, "prod")),
    ("bcast_root3", (4, 3), lambda ax, x: ax.bcast(x, root=3)),
    ("reduce", (4, 3), lambda ax, x: ax.reduce(x, root=2)),
    ("allgather", (4, 3), lambda ax, x: ax.allgather(x)),
    ("allgather_axis1", (4, 3), lambda ax, x: ax.allgather(x, axis=1)),
    ("allgather_tiled", (4, 3),
     lambda ax, x: ax.allgather(x, axis=1, tiled=True)),
    ("gather", (4, 3), lambda ax, x: ax.gather(x, root=1)),
    ("reducescatter", (8, 3), lambda ax, x: ax.reducescatter(x)),
    ("reducescatter_tiled", (16, 3),
     lambda ax, x: ax.reducescatter(x, tiled=True)),
    ("reducescatter_max_tiled", (16, 3),
     lambda ax, x: ax.reducescatter(x, op="max", tiled=True)),
    ("alltoall", (8, 2, 3), lambda ax, x: ax.alltoall(x)),
    ("sendrecv", (4, 3),
     lambda ax, x: ax.sendrecv(x, [(0, 3), (3, 0), (5, 6)])),
    ("ring_shift", (4, 3), lambda ax, x: ax.ring_shift(x, 3)),
    ("multicast", (4, 3),
     lambda ax, x: ax.device_multicast_sendrecv(x, [1, 4, 6], 2)),
]


@pytest.mark.parametrize("name,shape,body", COLLECTIVES,
                         ids=[c[0] for c in COLLECTIVES])
def test_collective_bitwise(jcomms, tcomms, name, shape, body):
    x = _int_f32(zlib.crc32(name.encode()) % 1000, (P8,) + shape)
    assert_bitwise(jax_ranks(jcomms, body, x), torch_ranks(tcomms, body, x))


def test_allgatherv_bitwise(jcomms, tcomms):
    """Rank r's first r + 1 rows, in max_count = 8 slots with counts."""
    x = _int_f32(3, (P8, 8, 2))

    def jbody(ax, xb):
        cnt = ax.get_rank() + 1
        mine = jnp.where(jnp.arange(8)[:, None] < cnt, xb, 0.0)
        return ax.allgatherv(mine, cnt, max_count=8)

    def tbody(ax, xb):
        cnt = ax.get_rank() + 1
        return ax.allgatherv(xb[:cnt], cnt, max_count=8)

    assert_bitwise(jax_ranks(jcomms, jbody, x), torch_ranks(tcomms, tbody, x))


@pytest.mark.parametrize("name", list(tst.SELF_TESTS))
def test_self_test_matches_jax(jcomms, tcomms, name):
    assert tst.SELF_TESTS[name](tcomms) is True
    assert jst.SELF_TESTS[name](jcomms) is True


def test_run_all_self_tests_both_levels(tcomms, thier):
    assert run_all_self_tests(tcomms) == {n: True for n in tst.SELF_TESTS}
    assert run_all_self_tests(thier) == {n: True for n in tst.SELF_TESTS}


@pytest.mark.parametrize("rows", [8, 5])
def test_hierarchical_allreduce_2x4(jhier, thier, rows):
    """Reduce-scatter within the host, allreduce across, allgather back:
    bitwise JAX's, and equal to the flat allreduce; 5 rows pads and
    slices (5 % 4 != 0)."""
    x = _int_f32(11 + rows, (P8, rows, 3))

    def jbody(ax, xb):
        return jhier.hierarchical_allreduce(xb), ax.allreduce(xb)

    def tbody(ax, xb):
        return thier.hierarchical_allreduce(ax, xb), ax.allreduce(xb)

    j, t = jax_ranks(jhier, jbody, x), torch_ranks(thier, tbody, x)
    assert_bitwise(j, t)
    np.testing.assert_array_equal(t[0], t[1])
    np.testing.assert_array_equal(t[0][5], x.sum(0))


def test_hierarchical_levels(jhier, thier):
    """Inner collectives stay within a host; outer ones cross hosts."""
    x = np.arange(1, 9, dtype=np.float32).reshape(8, 1)

    def jbody(ax, xb):
        return (jhier.inner_comms().allreduce(xb),
                jhier.outer_comms().allreduce(xb),
                jhier.inner_comms().get_rank() + 0 * xb.astype(jnp.int32))

    def tbody(ax, xb):
        return (thier.inner_comms(ax).allreduce(xb),
                thier.outer_comms(ax).allreduce(xb),
                torch.full_like(xb, ax.level("ici").get_rank(),
                                dtype=torch.int32))

    j, t = jax_ranks(jhier, jbody, x), torch_ranks(thier, tbody, x)
    assert_bitwise(j, t)
    np.testing.assert_array_equal(t[1].ravel(), [6, 8, 10, 12] * 2)
    assert [thier.host_of(r) for r in range(8)] == [0] * 4 + [1] * 4
    assert (thier.inner_size, thier.outer_size) == (4, 2)


# ------------------------------------------------------------ P2PBatch
def _p2p_body(lib):
    stack = jnp.stack if lib == "jax" else torch.stack

    def body(ax, x):
        p2p = ax.p2p_batch()
        p2p.isend(x * 10, src=0, dest=3, tag=0)
        p2p.irecv(src=0, dest=3, tag=0)
        p2p.isend(x * 20, src=1, dest=2, tag=0)
        p2p.irecv(src=1, dest=2, tag=0)
        # tag 1: source 4 sends twice (a second round)
        p2p.isend(x + 1, src=4, dest=5, tag=1)
        p2p.irecv(src=4, dest=5, tag=1)
        p2p.isend(x + 2, src=4, dest=6, tag=1)
        p2p.irecv(src=4, dest=6, tag=1)
        got = p2p.waitall()
        return stack([got[(0, 3, 0)], got[(1, 2, 0)], got[(4, 5, 1)],
                      got[(4, 6, 1)]])
    return body


def test_p2p_batch_tagged(jcomms, tcomms):
    x = np.arange(1, 9, dtype=np.float32).reshape(8, 1)
    j = jax_ranks(jcomms, _p2p_body("jax"), x)
    t = torch_ranks(tcomms, _p2p_body("torch"), x)
    assert_bitwise(j, t)
    assert t[3, 0, 0] == 10.0 and t[2, 1, 0] == 40.0
    assert t[5, 2, 0] == 6.0 and t[6, 3, 0] == 7.0
    assert t[0, 0, 0] == 0.0 and t[3, 1, 0] == 0.0


def test_p2p_batch_unmatched_raises_and_retries(tcomms):
    """Validation failures raise and clear the batch: a corrected retry
    on the same batch succeeds (as in the JAX package)."""
    def body(ax, x):
        p2p = ax.p2p_batch()
        p2p.isend(x * 10, src=0, dest=3, tag=0)
        with pytest.raises(terrors.RaftException, match="unmatched"):
            p2p.waitall()
        p2p.isend(x * 10, src=0, dest=3, tag=0)
        p2p.irecv(src=0, dest=3, tag=0)
        return p2p.waitall()[(0, 3, 0)]

    x = np.arange(1, 9, dtype=np.float32).reshape(8, 1)
    out = torch_ranks(tcomms, body, x)
    assert out[3, 0] == 10.0 and out[0, 0] == 0.0


def test_precondition_errors(tcomms):
    with pytest.raises(ValueError, match="max_count"):
        tcomms.run(lambda ax, x: ax.allgatherv(x, 8, max_count=4),
                   sharded=(torch.ones(8, 8, 1),))
    for op in ("sum", "max"):
        with pytest.raises(ValueError, match="split"):
            tcomms.run(lambda ax, x: ax.reducescatter(x, op=op, tiled=True),
                       sharded=(torch.ones(8, 12),))


# -------------------------------------------------- the failure path
def _no_rank_threads():
    return not any(t.name.startswith("comms-rank")
                   for t in threading.enumerate())


def test_raising_rank_reaches_caller(tcomms):
    """A rank that raises aborts every rendezvous: the caller gets that
    exception (not the peers' broken-barrier errors) within the timeout,
    and no rank thread is left."""
    def body(ax, x):
        if ax.get_rank() == 5:
            raise KeyError("rank 5 lost its slab")
        return ax.allreduce(x) + ax.allgather(x).sum()

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 5"):
        tcomms.run(body, sharded=(torch.ones(8, 3),))
    assert time.monotonic() - t0 < 10.0
    assert _no_rank_threads()
    # the communicator serves the next run
    out = tcomms.run(lambda ax, x: ax.allreduce(x),
                     sharded=(torch.ones(8, 3),))
    assert out.tolist() == [8.0] * 3


def test_missing_rank_times_out():
    """A rank that never arrives at a collective breaks the rendezvous
    after the timeout: the run raises RaftTimeoutError, every thread
    joined."""
    def body(ax, x):
        if ax.get_rank() != 2:
            return ax.allreduce(x)
        return x

    t0 = time.monotonic()
    with pytest.raises(terrors.RaftTimeoutError):
        build_comms(["cpu"] * P8, timeout_s=0.5).run(
            body, sharded=(torch.ones(8, 3),))
    assert time.monotonic() - t0 < 10.0
    assert _no_rank_threads()


def test_at_once_rendezvous_matches_turns(tcomms, thier):
    """The all-at-once rendezvous that tools/profile_grouped.py times
    against the turn order runs every collective alike, on one level
    and on two."""
    from unittest import mock

    from raft_tpu_torch.comms import comms as tcm
    from raft_tpu_torch.tools.profile_grouped import _at_once_rendezvous

    x = torch.arange(P8 * 6, dtype=torch.float32).reshape(P8, 2, 3)

    def body(ax, xb):
        return ax.allgather(ax.allreduce(xb) + ax.get_rank())

    want = tcomms.run(body, sharded=(x,), out="stacked")
    at_once, group = _at_once_rendezvous()
    with mock.patch.object(tcm, "_Turns", at_once), \
            mock.patch.object(tcm, "_ThreadGroup", group):
        got = tcomms.run(body, sharded=(x,), out="stacked")
        assert run_all_self_tests(tcomms) == {n: True
                                              for n in tst.SELF_TESTS}
        assert run_all_self_tests(thier) == {n: True
                                             for n in tst.SELF_TESTS}
    assert torch.equal(got, want)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("comms-rank")]


def test_single_rank_runs_inline():
    c = build_comms(["cpu"])
    assert c.run(lambda ax, x: ax.allgather(x), sharded=(torch.ones(1, 2),),
                 out="stacked").shape == (1, 1, 2)
    assert run_all_self_tests(c) == {n: True for n in tst.SELF_TESTS}


def test_comm_split_and_inject(tcomms):
    subs = tcomms.comm_split([r % 3 for r in range(8)])
    assert {c: s.size for c, s in subs.items()} == {0: 3, 1: 3, 2: 2}
    assert all(tst.test_collective_allreduce(s) for s in subs.values())

    class Handle:
        pass

    h = Handle()
    inject_comms(h, tcomms)
    assert h.comms is tcomms


# ---------------------------------------------------------- multihost
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_hierarchical_merge_select_k(jhier, thier, wire):
    """The outer stage of the cross-host merge, bitwise JAX's on both
    wires (each host's (nq, kk) parts sorted; the bf16 wire's exact f32
    rerank tail included)."""
    rng = np.random.default_rng(5)
    vals = np.sort(rng.standard_normal((2, 6, 5)).astype(np.float32), -1)
    ids = rng.permutation(2 * 6 * 5).reshape(2, 6, 5).astype(np.int32)
    # each host's part, replicated on its four ranks
    xv = np.repeat(vals, 4, axis=0)
    xi = np.repeat(ids, 4, axis=0)
    both = np.concatenate([xv, xi.view(np.float32)], -1)

    def jbody(ax, b):
        v, i = b[:, :5], jax.lax.bitcast_convert_type(b[:, 5:], jnp.int32)
        return jmh.hierarchical_merge_select_k(jhier.outer_comms(), v, i,
                                               4, wire=wire)

    def tbody(ax, b):
        v, i = b[:, :5], b[:, 5:].contiguous().view(torch.int32)
        return hierarchical_merge_select_k(thier.outer_comms(ax), v, i, 4,
                                           wire=wire)

    assert_bitwise(jax_ranks(jhier, jbody, both),
                   torch_ranks(thier, tbody, both))


def test_multihost_host_helpers(jhier, thier, jcomms, tcomms):
    for kw in ({"wire": "bf16"}, {"wire": "f32"}):
        for geo in ((10, 2, 8), (10, 1, 8), (32, 4, 4)):
            assert dcn_merge_accounting(*geo, **kw) == \
                jmh.dcn_merge_accounting(*geo, **kw)
    np.testing.assert_array_equal(host_rank_mask([1, 0, 1], 4),
                                  jmh.host_rank_mask([1, 0, 1], 4))
    for args in ((8, 4, 2), (16, 4, 2), (16, 2, 3)):
        assert host_aware_offset(*args) == jmh.host_aware_offset(*args)
    assert comms_levels(thier) == jmh.comms_levels(jhier) == (2, 4)
    assert comms_levels(tcomms) == jmh.comms_levels(jcomms) == (1, 8)
    assert tmh.hier_axes(thier) == jmh.hier_axes(jhier.mesh, jhier.axis)
    assert tmh.hier_axes(tcomms) is None
    with pytest.raises(ValueError):
        host_aware_offset(8, 4, 3)


# -------------------------------------------------------------- health
def _health_pair(n=8):
    return (jhealth.ShardHealth(n, telemetry=False),
            thealth.ShardHealth(n, telemetry=False))


def test_shard_health_matches_jax():
    j, t = _health_pair()
    for op, r in (("mark_down", 3), ("mark_down", 3), ("mark_down", 6),
                  ("mark_up", 3), ("mark_down", 0)):
        getattr(j, op)(r)
        getattr(t, op)(r)
        np.testing.assert_array_equal(t.mask(), j.mask())
        assert (t.n_up, t.all_up, repr(t)) == (j.n_up, j.all_up, repr(j))
    with pytest.raises(ValueError):
        t.mark_down(8)


def test_health_monitor_matches_jax():
    clock = [0.0]
    j = jhealth.HealthMonitor(4, consecutive=2, cooldown_s=1.0,
                              clock=lambda: clock[0], telemetry=False)
    t = thealth.HealthMonitor(4, consecutive=2, cooldown_s=1.0,
                              clock=lambda: clock[0], telemetry=False)
    rng = np.random.default_rng(3)
    for step in range(200):
        clock[0] += float(rng.uniform(0.0, 0.4))
        r, up = int(rng.integers(0, 4)), bool(rng.integers(0, 2))
        assert t.observe(r, up) == j.observe(r, up), step
        if step % 37 == 0:
            t.force(r, not up)
            j.force(r, not up)
    assert t.transition_count == j.transition_count
    assert [t.is_up(r) for r in range(4)] == [j.is_up(r) for r in range(4)]
    report_j = jhealth.HealthReport({"hb": jhealth.HealthProbe(
        False, 0.0, (1, 2))})
    report_t = thealth.HealthReport({"hb": thealth.HealthProbe(
        False, 0.0, (1, 2))})
    for _ in range(3):
        clock[0] += 2.0
        assert t.observe_report(report_t) == j.observe_report(report_j)


def test_health_check_timed_sweep(tcomms):
    h = thealth.ShardHealth(8, telemetry=False)
    report = thealth.health_check(tcomms, health=h)
    assert report.ok and report.failed == []
    assert set(report.probes) == set(tst.SELF_TESTS)
    assert all(p.seconds >= 0 for p in report.probes.values())
    assert h.n_up == 8


def test_health_check_records_a_raise(tcomms, monkeypatch):
    def torn(_comms):
        raise RuntimeError("simulated torn group")

    monkeypatch.setitem(tst.SELF_TESTS, "allreduce", torn)
    h = thealth.ShardHealth(8, telemetry=False)
    report = thealth.health_check(tcomms, health=h)
    assert not report.ok and report.failed == ["allreduce"]
    assert h.n_up == 0
    with pytest.raises(terrors.RaftException, match="allreduce"):
        thealth.health_check(tcomms, raise_on_failure=True)


def test_resolve_shard_mask_matches_jax():
    jh, th = _health_pair()
    jh.mark_down(2)
    th.mark_down(2)
    rep_j = jhealth.HealthReport({"a": jhealth.HealthProbe(False, 0.1, (5,)),
                                  "b": jhealth.HealthProbe(True, 0.1)})
    rep_t = thealth.HealthReport({"a": thealth.HealthProbe(False, 0.1, (5,)),
                                  "b": thealth.HealthProbe(True, 0.1)})
    cases = [(True, True), (jh, th), (rep_j, rep_t),
             ([1, 0, 1, 1, 0, 1, 1, 1],) * 2,
             (np.array([0.0] * 8), torch.zeros(8))]
    for a, b in cases:
        np.testing.assert_array_equal(tdeg.resolve_shard_mask(b, 8),
                                      jdeg.resolve_shard_mask(a, 8))
    with pytest.raises(ValueError, match="shape"):
        tdeg.resolve_shard_mask([1, 1], 8)


def test_degraded_helpers_match_jax():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((6, 4)).astype(np.float32)
    q[2, 1] = np.nan
    q[4, 0] = np.inf
    jq, jv = jdeg.sanitize_query_rows(jnp.asarray(q))
    tq, tv = tdeg.sanitize_query_rows(torch.as_tensor(q))
    assert_bitwise((np.asarray(jq), np.asarray(jv)), (tq.numpy(), tv.numpy()))
    owner = rng.integers(-1, 8, (6, 5)).astype(np.int32)
    alive = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.int32)
    assert_bitwise(
        np.asarray(jdeg.probe_coverage(jnp.asarray(owner),
                                       jnp.asarray(alive), jv)),
        tdeg.probe_coverage(torch.as_tensor(owner), torch.as_tensor(alive),
                            tv).numpy())
    md = rng.standard_normal((6, 3)).astype(np.float32)
    mi = rng.integers(0, 99, (6, 3)).astype(np.int32)
    jm = jdeg.mask_invalid_rows(jnp.asarray(md), jnp.asarray(mi), jv)
    tm = tdeg.mask_invalid_rows(torch.as_tensor(md), torch.as_tensor(mi),
                                tv)
    assert_bitwise(tuple(np.asarray(a) for a in jm),
                   tuple(a.numpy() for a in tm))


# ------------------------------------------------- placement and failover
@pytest.mark.parametrize("n,r,off,inner", [
    (8, 2, None, None), (8, 3, None, None), (8, 2, 3, None),
    (8, 2, None, 4), (16, 2, None, 4), (8, 1, None, None),
])
def test_replica_placement_matches_jax(n, r, off, inner):
    j = jrep.ReplicaPlacement.striped(n, r, off, inner_size=inner)
    t = trep.ReplicaPlacement.striped(n, r, off, inner_size=inner)
    assert dataclasses_tuple(t) == dataclasses_tuple(j)
    for s in range(n):
        assert t.holders(s) == j.holders(s)
        assert t.segments(s) == j.segments(s)
        assert t.holder_hosts(s) == j.holder_hosts(s)
    assert (t.host_disjoint, t.memory_factor) == (j.host_disjoint,
                                                  j.memory_factor)


def dataclasses_tuple(p):
    return (p.n_ranks, p.replication, p.offset, p.inner_size)


def test_replica_placement_rejects_like_jax():
    for args in ((8, 2, 8), (8, 9, None), (8, 2, 0)):
        with pytest.raises(ValueError):
            jrep.ReplicaPlacement.striped(*args)
        with pytest.raises(ValueError):
            trep.ReplicaPlacement.striped(*args)


@pytest.mark.parametrize("down", [(), (3,), (3, 7), (0, 4), (1, 2, 5, 6)])
def test_failover_plan_matches_jax(down):
    jp = jrep.ReplicaPlacement.striped(8, 2)
    tp = trep.ReplicaPlacement.striped(8, 2)
    mask = np.ones(8, np.int32)
    mask[list(down)] = 0
    j = jrep.FailoverPlan.from_health(jp, mask)
    t = trep.FailoverPlan.from_health(tp, mask)
    np.testing.assert_array_equal(t.route, j.route)
    assert (t.fully_covered, t.unserved_shards, repr(t)) == \
        (j.fully_covered, j.unserved_shards, repr(j))
    np.testing.assert_array_equal(t.serving_load(), j.serving_load())
    for s in range(8):
        assert t.serving_rank(s) == j.serving_rank(s)
    load = np.random.default_rng(len(down)).uniform(0, 10, 8)
    np.testing.assert_array_equal(
        trep.FailoverPlan.load_balanced(tp, mask, load).route,
        jrep.FailoverPlan.load_balanced(jp, mask, load).route)
    for route_of in (lambda p: p, lambda p: p.route):
        np.testing.assert_array_equal(
            trep.resolve_route(route_of(t), 8, 2, tp.offset),
            jrep.resolve_route(route_of(j), 8, 2, jp.offset))
    np.testing.assert_array_equal(trep.resolve_route(None, 8, 2, 4),
                                  jrep.resolve_route(None, 8, 2, 4))


def test_failover_from_host_health_matches_jax():
    jp = jrep.ReplicaPlacement.striped(8, 2, inner_size=4)
    tp = trep.ReplicaPlacement.striped(8, 2, inner_size=4)
    for hosts in ([1, 0], [0, 1], [0, 0]):
        np.testing.assert_array_equal(
            trep.FailoverPlan.from_host_health(tp, hosts).route,
            jrep.FailoverPlan.from_host_health(jp, hosts).route)


def test_resolve_route_rejects_like_jax():
    jp = jrep.FailoverPlan.from_health(jrep.ReplicaPlacement.striped(8, 2),
                                       True)
    tp = trep.FailoverPlan.from_health(trep.ReplicaPlacement.striped(8, 2),
                                       True)
    for jarg, targ, r, off in ((jp, tp, 2, 3), ([0] * 4, [0] * 4, 2, 4),
                               ([2] * 8, [2] * 8, 2, 4)):
        with pytest.raises(jerrors.RaftException):
            jrep.resolve_route(jarg, 8, r, off)
        with pytest.raises(terrors.RaftException):
            trep.resolve_route(targ, 8, r, off)


@pytest.mark.parametrize("budget,r_min,r_max", [
    (16, 1, None), (20, 2, 4), (8, 1, 1), (13, 1, 3)])
def test_popularity_replication_matches_jax(budget, r_min, r_max):
    rng = np.random.default_rng(budget)
    for load in (rng.zipf(1.5, 8).astype(float), np.zeros(8),
                 np.arange(8.0)):
        np.testing.assert_array_equal(
            trep.popularity_replication(load, budget=budget, r_min=r_min,
                                        r_max=r_max),
            jrep.popularity_replication(load, budget=budget, r_min=r_min,
                                        r_max=r_max))


def test_failover_telemetry_gauges():
    """Building a plan sets the posture gauges in the default registry,
    as the JAX package's does."""
    tp = trep.ReplicaPlacement.striped(8, 2)
    jp = jrep.ReplicaPlacement.striped(8, 2)
    # rank 3 down: its shard fails over; ranks 3 and 7 down: shards 3
    # and 7 lose both copies
    for mask, moved, lost in (([1, 1, 1, 0, 1, 1, 1, 1], 1, 0),
                              ([1, 1, 1, 0, 1, 1, 1, 0], 0, 2)):
        trep.FailoverPlan.from_health(tp, mask)
        jrep.FailoverPlan.from_health(jp, mask)
        for reg in (tobsm.default_registry(), jobsm.default_registry()):
            assert reg.gauge("failover_rerouted_shards").value == moved
            assert reg.gauge("failover_unserved_shards").value == lost


# ------------------------------------------ MNMG kNN, k-means and the ring
def _int_knn_data(seed=4, n=1003, m=77, d=12):
    rng = np.random.default_rng(seed)
    x = rng.integers(-30, 31, (n, d)).astype(np.float32)
    q = rng.integers(-30, 31, (m, d)).astype(np.float32)
    return x, q


def _ids_up_to_ties(d, a, b):
    d, a, b = np.asarray(d), np.asarray(a), np.asarray(b)
    for r in range(d.shape[0]):
        runs = np.split(np.arange(d.shape[1]),
                        np.flatnonzero(np.diff(d[r])) + 1)
        for run in runs[:-1]:
            assert set(a[r, run]) == set(b[r, run]), r


@pytest.mark.parametrize("algo", ["mnmg_knn", "ring_knn"])
def test_sharded_knn_matches_jax(jcomms, tcomms, algo):
    """Brute-force kNN over row-sharded index rows (the allgather form
    and the ring, whose queries are sharded too; a ragged last shard):
    squared distances bitwise JAX's, ids up to ties."""
    import raft_tpu.comms as jc
    import raft_tpu_torch.comms as tcm

    x, q = _int_knn_data()
    jd, ji = getattr(jc, algo)(jcomms, x, q, 7, metric="l2_expanded")
    td, ti = getattr(tcm, algo)(tcomms, x, q, 7, metric="l2_expanded")
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    _ids_up_to_ties(jd, ji, ti.numpy())
    want = np.sort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :7]
    np.testing.assert_array_equal(td.numpy(), want)


def test_ring_pairwise_distance_matches_jax(jcomms, tcomms):
    from raft_tpu.comms import ring_pairwise_distance as j_rpd
    from raft_tpu_torch.comms import ring_pairwise_distance

    x, q = _int_knn_data(n=301, m=45)
    for metric in ("l2_expanded", "l1"):
        j = np.asarray(j_rpd(jcomms, q, x, metric=metric))
        t = ring_pairwise_distance(tcomms, q, x, metric=metric).numpy()
        assert t.shape == (45, 301) and t.tobytes() == j.tobytes(), metric


def test_mnmg_kmeans_matches_single_device_lloyd():
    """From the same initial centroids, the sharded Lloyd loop (local
    assignment, allreduced sums and counts) reaches the single-device
    k-means' labels, and its centroids within f32 summation order; from
    its own distributed k-means++ seeding it separates the blobs, as the
    JAX package's does."""
    from raft_tpu.comms import mnmg_kmeans_fit as j_mkm
    from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
    from raft_tpu_torch.comms import mnmg_kmeans_fit

    rng = np.random.default_rng(2)
    centers = rng.standard_normal((5, 8)).astype(np.float32) * 20
    lab = rng.integers(0, 5, 998)
    x = centers[lab] + rng.standard_normal((998, 8)).astype(np.float32)
    tc = build_comms(["cpu"] * 4)
    init = x[[0, 100, 200, 300, 400]]
    params = KMeansParams(n_clusters=5, max_iter=20, seed=3)
    single = kmeans_fit(torch.as_tensor(x), params,
                        centroids=torch.as_tensor(init))
    dist_ = mnmg_kmeans_fit(tc, x, params, centroids=init)
    np.testing.assert_array_equal(dist_.labels.numpy(),
                                  single.labels.numpy())
    np.testing.assert_allclose(dist_.centroids.numpy(),
                               single.centroids.numpy(), rtol=1e-5,
                               atol=1e-4)
    seeded = mnmg_kmeans_fit(tc, x, params)
    jout = j_mkm(j_build_comms(jax.devices()[:4]), x, n_clusters=5,
                 max_iter=20, seed=3)
    for labels in (seeded.labels.numpy(), np.asarray(jout.labels)):
        # every blob is one cluster
        assert all(len(set(labels[lab == c])) == 1 for c in range(5))
    assert seeded.labels.shape == (998,) and seeded.n_iter >= 1
