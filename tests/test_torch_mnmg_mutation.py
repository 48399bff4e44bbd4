"""PyTorch port of the sharded mutation tier (raft_tpu_torch/comms/
mnmg_mutation.py and the rank bodies' ``mutation=`` tail) against the
JAX package, on the CPU.

JAX runs on the 8-device virtual CPU mesh, the port in process at P = 8.
Both packages hold the same JAX-built index (carried across with
``interop.mnmg_index_from_arrays``; integer rows of ``_int_dataset``,
centroids rounded to integers) and get the same scripted upserts and
deletes. Upserted rows are integer and have no tie at their nearest
centroid, so both packages route them alike (``kmeans_predict`` breaks
ties lowest index first in both). After every write the per-rank
mutation state (row mask, delta rows, delta ids, delta counts) and the
acks must be bitwise JAX's, and searches give distances bitwise and ids
up to ties (ROADMAP note R1). The durable ingest's per-rank WAL frames
must be byte-identical to JAX's, and ``mnmg_recover``'s state and
frontiers equal to JAX's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.comms import build_comms as j_build_comms
from raft_tpu.comms import mnmg_ivf as jmi
from raft_tpu.comms import mnmg_ivf_flat as jmf
from raft_tpu.comms import mnmg_mutation as jmm
from raft_tpu.comms import place_index as j_place
from raft_tpu.resilience import FailoverPlan as JFailoverPlan
from raft_tpu.resilience import ReplicaPlacement as JPlacement
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import IVFPQParams as JIVFPQParams
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.comms import (
    MnmgMutableIndex,
    build_comms,
    mnmg_ivf_flat_search,
    mnmg_ivf_pq_search,
    place_index,
    recover_rank,
)
from raft_tpu_torch.comms import mnmg_mutation as tmm
from raft_tpu_torch.durability import wal as twal
from raft_tpu_torch.resilience import FailoverPlan, ReplicaPlacement
from raft_tpu_torch.spatial.ann import (
    mnmg_index_from_arrays,
    mnmg_mutation_state_from_arrays,
    save_index,
)
from tests.test_torch_ivf_flat import (
    _assert_ids_equal_up_to_ties,
    _int_dataset,
)

torch.set_num_threads(1)

P8 = 8
K = 5
N_PROBES = 6
CAP = 8
DEAD = 2
STATE = ("row_mask", "delta_vecs", "delta_ids", "delta_counts")


@pytest.fixture(scope="module")
def jc():
    return j_build_comms(jax.devices()[:P8])


@pytest.fixture(scope="module")
def tc():
    return build_comms(["cpu"] * P8, timeout_s=120.0)


@pytest.fixture(scope="module")
def dataset():
    return _int_dataset(11)


def _leaves(j):
    out = {}
    for f in dataclasses.fields(j):
        v = getattr(j, f.name)
        if f.name != "coarse":
            out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return out


def _np(t):
    if isinstance(t, (list, tuple)):
        return np.stack([_np(b) for b in t])
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def pair(jc, tc, dataset):
    """(JAX, port) replicated (R = 2) sharded IVF-Flat indexes: one JAX
    build, centroids rounded, carried across after the replication."""
    x, _ = dataset
    j = jmf.mnmg_ivf_flat_build(
        jc, x, JIVFFlatParams(n_lists=16, kmeans_n_iters=3,
                              kmeans_init="random", seed=2),
        metric="sqeuclidean")
    j = dataclasses.replace(j, centroids=jnp.round(j.centroids),
                            local_cents=jnp.round(j.local_cents))
    j = j_place(jc, j, replication=2)
    return j, mnmg_index_from_arrays(_leaves(j), comms=tc)


def _untied(x, cents, rows):
    """The rows (integer vectors) whose nearest centroid is unique."""
    d2 = ((rows[:, None, :] - cents[None]) ** 2).sum(-1)
    s = np.sort(d2, axis=1)
    return rows[s[:, 0] < s[:, 1]]


@pytest.fixture(scope="module")
def fresh(dataset, pair):
    """Integer upsert rows far from the data's rows, each with a unique
    nearest centroid."""
    x, _ = dataset
    rng = np.random.default_rng(3)
    rows = (x[rng.integers(0, x.shape[0], 200)]
            + rng.integers(-3, 4, (200, x.shape[1])) * 3).astype(np.float32)
    return _untied(x, np.asarray(pair[0].centroids), rows)


def assert_state_equal(jmw, tmw):
    for f in STATE:
        a = np.asarray(getattr(jmw.state, f))
        b = _np(getattr(tmw.state, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert jmw.state.cap == tmw.state.cap


def assert_same_answer(jout, tout):
    jd, ji = (np.asarray(a) for a in jout)
    td, ti = (_np(a) for a in tout)
    assert td.tobytes() == jd.astype(np.float32).tobytes()
    _assert_ids_equal_up_to_ties(jd, ji, ti)


def _search(pkg, comms, mw, q, **kw):
    kw.setdefault("qcap", q.shape[0])
    kw.setdefault("n_probes", N_PROBES)
    if pkg == "jax":
        return jmm.mnmg_mutable_search(comms, mw, jnp.asarray(q), K, **kw)
    return tmm.mnmg_mutable_search(comms, mw, torch.as_tensor(q), K, **kw)


def _script(pkg, comms, index, fresh, x):
    """The same write script in either package; returns the final
    wrapper and every step's acks."""
    mod = jmm if pkg == "jax" else tmm
    mw = mod.wrap_mnmg_mutable(comms, index, delta_cap=CAP)
    acks = []
    ids_a = np.arange(9000, 9010, dtype=np.int32)
    mw, acc = mod.mnmg_upsert(comms, mw, fresh[:10], ids_a)
    acks.append(acc)
    # supersede two main-slab rows and one fresh row; a negative id
    ids_b = np.array([5, 17, 9001, -3], np.int32)
    mw, acc = mod.mnmg_upsert(comms, mw, fresh[10:14], ids_b)
    acks.append(acc)
    # delete main rows, a fresh row, a superseded id, a missing id, a
    # negative id and a repeated id
    victims = np.array([40, 41, 9002, 5, 123456, -1, 40, 9001], np.int32)
    mw, found = mod.mnmg_delete(comms, mw, victims)
    acks.append(found)
    # a write while rank DEAD is down: acked on the live holders only
    alive = np.ones(P8, np.int32)
    alive[DEAD] = 0
    mw, acc = mod.mnmg_upsert(comms, mw, fresh[14:30],
                              np.arange(9100, 9116, dtype=np.int32),
                              alive=alive)
    acks.append(acc)
    return mw, acks


@pytest.fixture(scope="module")
def scripted(jc, tc, pair, fresh, dataset):
    j, t = pair
    jmw, jacks = _script("jax", jc, j, fresh, dataset[0])
    tmw, tacks = _script("torch", tc, t, fresh, dataset[0])
    return jmw, jacks, tmw, tacks


def test_scripted_writes_state_and_acks_bitwise(scripted):
    jmw, jacks, tmw, tacks = scripted
    assert isinstance(tmw, MnmgMutableIndex)
    assert_state_equal(jmw, tmw)
    for a, b in zip(jacks, tacks):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert tacks[0].all() and tacks[3].all()
    assert not tacks[1][3]                      # the negative id
    assert tacks[2].tolist() == [True, True, True, True, False, False,
                                 False, True]


@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
def test_mutable_search_matches_jax(jc, tc, dataset, fresh, scripted,
                                    engine):
    """Healthy, and rank DEAD down with a FailoverPlan at replication 2:
    distances bitwise JAX's, ids up to ties; each live fresh row its own
    top-1 at distance 0, no deleted id anywhere."""
    jmw, _, tmw, _ = scripted
    _, q = dataset
    qq = np.concatenate([q[:32], fresh[14:30]])
    assert_same_answer(_search("jax", jc, jmw, qq),
                       _search("torch", tc, tmw, qq, use_kernel=engine))
    mask = np.ones(P8, np.int32)
    mask[DEAD] = 0
    jplan = JFailoverPlan.from_health(JPlacement.striped(P8, 2), mask)
    tplan = FailoverPlan.from_health(ReplicaPlacement.striped(P8, 2), mask)
    jres = _search("jax", jc, jmw, qq, shard_mask=mask, failover=jplan)
    tres = _search("torch", tc, tmw, qq, shard_mask=mask, failover=tplan,
                   use_kernel=engine)
    assert_same_answer((jres.distances, jres.ids),
                       (tres.distances, tres.ids))
    np.testing.assert_array_equal(tres.coverage.numpy(), 1.0)
    ids = tres.ids.numpy()
    np.testing.assert_array_equal(ids[32:, 0], np.arange(9100, 9116))
    assert (tres.distances.numpy()[32:, 0] == 0).all()
    assert not np.isin(ids, [40, 41, 9002, 5, 9001]).any()


def test_mutation_state_carried_from_jax(jc, tc, dataset, pair, scripted):
    """JAX's state as numpy arrays (``mnmg_mutation_state_from_arrays``)
    wrapped around the port's index answers as JAX's wrapper."""
    jmw, _, _, _ = scripted
    _, t = pair
    state = mnmg_mutation_state_from_arrays(
        {f: np.asarray(getattr(jmw.state, f)) for f in STATE}, comms=tc)
    assert state.cap == CAP
    tmw = tmm.MnmgMutableIndex(index=t, state=state)
    _, q = dataset
    assert_same_answer(_search("jax", jc, jmw, q),
                       _search("torch", tc, tmw, q))
    # the search's mutation= takes the state or the wrapper alike
    a = mnmg_ivf_flat_search(tc, t, torch.as_tensor(q), K,
                             n_probes=N_PROBES, qcap=q.shape[0],
                             mutation=state)
    b = mnmg_ivf_flat_search(tc, t, torch.as_tensor(q), K,
                             n_probes=N_PROBES, qcap=q.shape[0],
                             mutation=tmw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_rejected_upsert_is_a_strict_noop(jc, tc, dataset, pair):
    """A capacity-rejected upsert leaves every replica copy of the id's
    previous version serving, and the state untouched (as JAX's)."""
    j, t = pair
    _, q = dataset
    out = {}
    for pkg, comms, index, mod in (("jax", jc, j, jmm), ("torch", tc, t, tmm)):
        mw = mod.wrap_mnmg_mutable(comms, index, delta_cap=1)
        c = np.asarray(_np(index.centroids))[2:3]
        mw, acc = mod.mnmg_upsert(comms, mw, c, np.array([8300], np.int32))
        assert acc.all()
        before = np.asarray(_np(_search(pkg, comms, mw, q)[1]))
        victim = int(before[0, 0])
        mw2, acc2 = mod.mnmg_upsert(comms, mw, c,
                                    np.array([victim], np.int32))
        assert not acc2.any()
        after = np.asarray(_np(_search(pkg, comms, mw2, q)[1]))
        np.testing.assert_array_equal(before, after)
        out[pkg] = mw2
    assert_state_equal(out["jax"], out["torch"])


def _wreck_mutation(tmw, rank):
    """Rank ``rank``'s mutation slabs lost: empty deltas, all-live
    mask."""
    rm, dv, di, dc = (np.array(_np(getattr(tmw.state, f))) for f in STATE)
    rm[rank], dv[rank], di[rank], dc[rank] = 1, 0, -1, 0
    return rm, dv, di, dc


def test_failed_rank_recover_and_resync(jc, tc, dataset, pair, scripted,
                                        tmp_path):
    """Rank DEAD missed the degraded write and lost its slabs: acked
    writes serve through the failover route; then ``recover_rank`` (main
    slabs from the archive) and ``resync_rank`` (mutation slabs from the
    live replica) give JAX's resynced state bitwise, and the healthy
    mesh serves every acked write."""
    j, t = pair
    jmw, _, tmw, _ = scripted
    _, q = dataset
    path = tmp_path / "base.npz"
    save_index(_host(t), path)
    rm, dv, di, dc = _wreck_mutation(tmw, DEAD)
    wrecked_idx = dataclasses.replace(
        t, vectors_sorted=t.vectors_sorted.clone(),
        sorted_ids=t.sorted_ids.clone())
    wrecked_idx.vectors_sorted[DEAD] = 0
    wrecked_idx.sorted_ids[DEAD] = 0
    lost = tmm.MnmgMutableIndex(
        index=wrecked_idx,
        state=tmm._place_state(tc, rm, dv, di, dc, CAP))
    healed = dataclasses.replace(
        lost, index=recover_rank(tc, lost.index, path, DEAD))
    healed = tmm.resync_rank(tc, healed, DEAD)
    jhealed = jmm.resync_rank(jc, jmw, DEAD)
    assert_state_equal(jhealed, healed)
    assert_same_answer(_search("jax", jc, jhealed, q),
                       _search("torch", tc, healed, q))
    with pytest.raises(ValueError, match="unreplicated"):
        tmm.resync_rank(tc, tmm.wrap_mnmg_mutable(
            tc, place_index(tc, t, replication=1)), DEAD)


def _host(t):
    kw = {f.name: getattr(t, f.name).numpy() for f in dataclasses.fields(t)
          if f.init and isinstance(getattr(t, f.name), torch.Tensor)}
    return dataclasses.replace(t, **kw)


def _dyadic_sq(j):
    """The sharded SQ index whose int8 codes ARE the flat index's integer
    rows (vmin -128, vscale 1): every decoded distance is exact."""
    return jmf.MnmgIVFSQIndex(
        centroids=j.centroids, owner=j.owner, local_id=j.local_id,
        local_cents=j.local_cents,
        codes_sorted=jnp.asarray(j.vectors_sorted).astype(jnp.int8),
        vmin=jnp.full((16,), -128.0, jnp.float32),
        vscale=jnp.ones((16,), jnp.float32), sorted_ids=j.sorted_ids,
        list_offsets=j.list_offsets, list_sizes=j.list_sizes,
        n_pad=j.n_pad, nl_pad=j.nl_pad, max_list=j.max_list,
        n_rows=j.n_rows, replication=j.replication,
        replica_offset=j.replica_offset)


def test_sq_and_pq_rounds_match_jax(jc, tc, dataset, fresh, pair):
    """One upsert / delete round on sharded IVF-SQ (the dyadic codes of
    the replicated flat index) and IVF-PQ indexes carried from JAX, both
    engines (PQ at a saturated refine pool): states bitwise, searches
    bitwise in distances, ids up to ties."""
    x, q = dataset
    jsq = _dyadic_sq(pair[0])
    jpq = jmi.mnmg_ivf_pq_build(jc, x, JIVFPQParams(
        n_lists=16, pq_dim=4, pq_bits=4, kmeans_n_iters=3,
        kmeans_init="random", seed=1))
    for j0 in (jsq, jpq):
        j = dataclasses.replace(j0, centroids=jnp.round(j0.centroids),
                                local_cents=jnp.round(j0.local_cents))
        t = mnmg_index_from_arrays(_leaves(j), comms=tc)
        rows = _untied(x, np.asarray(j.centroids), fresh)[:6]
        ids = np.arange(7000, 7006, dtype=np.int32)
        victims = np.array([7001, 3, 4], np.int32)
        jmw = jmm.wrap_mnmg_mutable(jc, j, delta_cap=4)
        tmw = tmm.wrap_mnmg_mutable(tc, t, delta_cap=4)
        jmw, ja = jmm.mnmg_upsert(jc, jmw, rows, ids)
        tmw, ta = tmm.mnmg_upsert(tc, tmw, rows, ids)
        jmw, jf = jmm.mnmg_delete(jc, jmw, victims)
        tmw, tf = tmm.mnmg_delete(tc, tmw, victims)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tf, jf)
        assert_state_equal(jmw, tmw)
        qq = np.concatenate([q[:16], rows])
        kw = {}
        if j0 is jpq:
            kw["refine_ratio"] = float(N_PROBES * j.max_list) / K + 1.0
        want = _search("jax", jc, jmw, qq, **kw)
        for engine in (False, True):
            got = _search("torch", tc, tmw, qq, use_kernel=engine, **kw)
            assert_same_answer(want, got)
            live = ~np.isin(ids, victims)
            np.testing.assert_array_equal(got[1].numpy()[16:, 0][live],
                                          ids[live])


def test_mutation_operands_checked(tc, pair, scripted):
    """A state made for another geometry is refused."""
    _, t = pair
    _, _, tmw, _ = scripted
    other = place_index(tc, t, replication=1)
    with pytest.raises(ValueError, match="mutation state"):
        mnmg_ivf_flat_search(tc, other, torch.zeros((4, 16)), K,
                             n_probes=N_PROBES, qcap=4, mutation=tmw)
    with pytest.raises(ValueError, match="mutation state"):
        mnmg_ivf_pq_search(tc, _pq_like(other), torch.zeros((4, 16)), K,
                           n_probes=N_PROBES, qcap=4, mutation=tmw)


def _pq_like(t):
    """A PQ index over ``t``'s layout (codes all zero): only its geometry
    is read before the mutation check."""
    from raft_tpu_torch.comms import MnmgIVFPQIndex

    P = t.sorted_ids.shape[0]
    return MnmgIVFPQIndex(
        centroids=t.centroids, codebooks=torch.zeros((4, 16, 4)),
        owner=t.owner, local_id=t.local_id, local_cents=t.local_cents,
        codes_sorted=torch.zeros((P, t.n_pad + 1, 4), dtype=torch.uint8),
        vectors_sorted=t.vectors_sorted, sorted_ids=t.sorted_ids,
        list_offsets=t.list_offsets, list_sizes=t.list_sizes, pq_dim=4,
        pq_bits=4, n_pad=t.n_pad, nl_pad=t.nl_pad, max_list=t.max_list,
        n_rows=t.n_rows)


# ------------------------------------------------------------ durability
def _frames(root):
    """Every rank's WAL segment bytes, keyed by rank directory and
    segment name."""
    out = {}
    for r in range(P8):
        d = os.path.join(root, f"rank-{r:02d}")
        for p in twal.segment_paths(d):
            with open(p, "rb") as f:
                out[(r, os.path.basename(p))] = f.read()
    return out


def _durable_script(pkg, comms, index, fresh, root):
    mod = jmm if pkg == "jax" else tmm
    mw = mod.wrap_mnmg_mutable(comms, index, delta_cap=CAP)
    ing = mod.MnmgDurableIngest(comms, mw, root, flush_interval_s=0.0005)
    ids = np.arange(8200, 8206, dtype=np.int32)
    out = {"acked1": ing.upsert(fresh[:6], ids), "fr1": ing.frontiers()}
    holders = mod._row_holders(mw.index, mw.placement, fresh[:6])
    dead = sorted({int(r) for r in np.unique(holders) if r >= 0})[0]
    ing._wals[dead].close()
    out["acked2"] = ing.upsert(fresh[:6] + 1.0, ids)
    out["deleted"] = ing.delete(ids[:1])
    out["fr2"] = ing.frontiers()
    out["dead"] = dead
    out["live"] = ing.mindex
    ing.close()
    fresh_mw = mod.wrap_mnmg_mutable(comms, index, delta_cap=CAP)
    out["rec"], out["frontiers"], out["n"] = mod.mnmg_recover(
        comms, fresh_mw, root)
    return out


def test_durable_quorum_frames_and_recovery(jc, tc, pair, fresh, tmp_path):
    """Quorum acks with one holder's WAL dead (R = 2, quorum 1: rows it
    holds lose their ack, a mesh-wide delete still acks), the lagging
    frontier, the per-rank WAL frames byte-identical to JAX's, and
    ``mnmg_recover`` rebuilding the live state with JAX's frontiers."""
    j, t = pair
    jo = _durable_script("jax", jc, j, fresh, str(tmp_path / "j"))
    to = _durable_script("torch", tc, t, fresh, str(tmp_path / "t"))
    for key in ("acked1", "acked2", "deleted"):
        np.testing.assert_array_equal(to[key], jo[key], err_msg=key)
    for key in ("fr1", "fr2", "dead", "frontiers", "n"):
        assert to[key] == jo[key], key
    assert to["acked1"].all() and not to["acked2"].all()
    assert to["fr2"][to["dead"]] < max(to["fr2"].values())
    jf, tf = _frames(str(tmp_path / "j")), _frames(str(tmp_path / "t"))
    assert sorted(jf) == sorted(tf) and jf == tf
    assert_state_equal(jo["live"], to["live"])
    assert_state_equal(jo["rec"], to["rec"])
    assert_state_equal(to["live"], to["rec"])


def test_durable_delete_below_quorum_and_validation(tc, pair, fresh,
                                                    tmp_path):
    _, t = pair
    mw = tmm.wrap_mnmg_mutable(tc, t, delta_cap=CAP)
    ing = tmm.MnmgDurableIngest(tc, mw, str(tmp_path / "m"),
                                flush_interval_s=0.0005)
    ids = np.arange(8300, 8302, dtype=np.int32)
    assert ing.upsert(fresh[:2], ids).all()
    ing._wals[3].close()
    alive = np.zeros(P8, bool)
    alive[3] = True
    assert not ing.delete(ids, alive=alive).any()
    ing.close()
    with pytest.raises(terrors.RaftLogicError):
        tmm.MnmgDurableIngest(tc, mw, str(tmp_path / "x"), quorum=5)
