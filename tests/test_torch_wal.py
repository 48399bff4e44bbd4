"""PyTorch port of the durability tier (raft_tpu_torch durability/wal,
testing/crash, serving/ingest_rows) and of the mutation tier's archives
against the JAX package, on the CPU.

WAL frames must be byte-identical to JAX's for the same records, and a
log written by either package must replay in the other to the same
state. The mutable states come from tests/test_torch_mutation.py's
integer-exact fixture (carried across with
``interop.mutable_index_from_arrays``), so replayed states match
bitwise. Full v4 ``mutable_ivf`` archives and ``mutation-delta``
checkpoints are cross-read both ways. The ingest rows are checked for
shape and accounting only, never for a rate (ROADMAP note R8).
"""

import json
import os
import shutil
import threading
import zlib

import numpy as np
import pytest
import torch

from raft_tpu.durability import wal as jwal
from raft_tpu.spatial.ann import mutation as jmut
from raft_tpu.spatial.ann.serialize import load_index as j_load_index
from raft_tpu.spatial.ann.serialize import save_index as j_save_index
from raft_tpu.testing.faults import corrupt_bytes
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.durability import wal
from raft_tpu_torch.spatial.ann import interop
from raft_tpu_torch.spatial.ann import mutation as tmut
from raft_tpu_torch.testing import crash
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties
from tests.test_torch_mutation import (
    CAP,
    D,
    KINDS,
    _assert_state,
    _carry,
    _int_rows,
    _jax_index,
    _leaves,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset():
    return _int_rows(5)


@pytest.fixture(scope="module")
def jax_indexes(dataset):
    return {kind: _jax_index(kind, dataset[0]) for kind in KINDS}


def _ops(x, seed=3):
    """A mixed upsert/delete stream on integer rows: fresh ids, a
    re-upsert, deletes of main and delta rows."""
    rng = np.random.default_rng(seed)
    v = lambda m: (x[rng.integers(0, x.shape[0], m)]  # noqa: E731
                   + rng.integers(-3, 4, (m, D))).astype(np.float32)
    return [
        ("upsert", (v(6), np.arange(9000, 9006, dtype=np.int32))),
        ("delete", (np.asarray([9000, 3, 4, 77777], np.int32),)),
        ("upsert", (v(3), np.asarray([9001, 5, 9010], np.int32))),
        ("delete", (np.asarray([9002], np.int32),)),
        ("upsert", (v(2), np.asarray([9011, 9012], np.int32))),
    ]


def _frame_cases(rng):
    for b, d in ((1, 8), (5, 16), (0, 4)):
        vecs = rng.standard_normal((b, d)).astype(np.float32)
        ids = rng.integers(-1, 1 << 30, b).astype(np.int32)
        yield vecs, ids


def test_frames_and_payloads_byte_identical():
    rng = np.random.default_rng(0)
    for vecs, ids in _frame_cases(rng):
        up = wal.encode_upsert(vecs, ids)
        assert up == jwal.encode_upsert(vecs, ids)
        dl = wal.encode_delete(ids)
        assert dl == jwal.encode_delete(ids)
        for lsn, epoch, op, payload in ((1, 0, wal.OP_UPSERT, up),
                                        ((1 << 40) + 3, 7, wal.OP_DELETE, dl),
                                        (2, 1 << 33, 9, b"")):
            assert (wal.encode_frame(lsn, epoch, op, payload)
                    == jwal.encode_frame(lsn, epoch, op, payload))
        v2, i2 = wal.decode_upsert(up)
        np.testing.assert_array_equal(v2, vecs)
        np.testing.assert_array_equal(i2, ids)
        np.testing.assert_array_equal(wal.decode_delete(dl), ids)
    assert (wal.OP_UPSERT, wal.OP_DELETE, wal.WAL_VERSION) == (
        jwal.OP_UPSERT, jwal.OP_DELETE, jwal.WAL_VERSION)
    with pytest.raises(ValueError, match="header says"):
        wal.decode_delete(
            wal.encode_delete(np.arange(3, dtype=np.int32))[:-1])


def _ingest(mod, mindex, path, ops):
    """Run ``ops`` through ``mod``'s DurableIngest over a WAL at ``path``;
    returns the live state and the acks."""
    w = mod.WalWriter(path, flush_interval_s=0.0005)
    ing = mod.DurableIngest(mindex, w)
    acks = [getattr(ing, op)(*args) for op, args in ops]
    live = ing.mindex
    ing.close()
    return live, acks


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_replays_in_the_other_package(tmp_path, dataset, jax_indexes,
                                          writer):
    """A log written by one package's DurableIngest replays through the
    other's recover_mutable to the writer's live state, bitwise (delta,
    mask, epoch, dirty lists, journal); the segment bytes are the same
    whichever package wrote them."""
    x, _ = dataset
    ops = _ops(x)
    jm = jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP)
    jlive, jacks = _ingest(jwal, jm, str(tmp_path / "j"), ops)
    tlive, tacks = _ingest(wal, _carry(jm), str(tmp_path / "t"), ops)
    for a, b in zip(jacks, tacks):
        np.testing.assert_array_equal(a, b)
    _assert_state(jlive, tlive)
    jsegs = jwal.segment_paths(str(tmp_path / "j"))
    tsegs = wal.segment_paths(str(tmp_path / "t"))
    assert [os.path.basename(s) for s in jsegs] == [
        os.path.basename(s) for s in tsegs]
    for a, b in zip(jsegs, tsegs):
        assert open(a, "rb").read() == open(b, "rb").read()
    path = str(tmp_path / ("j" if writer == "jax" else "t"))
    if writer == "jax":
        rec, frontier, n = wal.recover_mutable(_carry(jm), path, name="r")
        _assert_state(jlive, rec)
    else:
        rec, frontier, n = jwal.recover_mutable(
            jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP), path,
            name="r")
        _assert_state(rec, tlive)
    assert (frontier, n) == (len(ops), len(ops))


def test_checkpoint_plus_tail_and_no_checkpoint_recover_bitwise(
        tmp_path, dataset, jax_indexes):
    """Checkpoint midway + WAL tail, and the whole log without a
    checkpoint, both rebuild the live delta and mask bitwise and answer
    a batch with identical distances and ids; the checkpoint carries the
    LSN watermark and recovery replays only the tail, its epoch counting
    on from the fresh wrap's as JAX's does."""
    x, q = dataset
    ops = _ops(x)
    base = _carry(jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP))
    d = str(tmp_path / "w")
    ckpt = str(tmp_path / "delta.ckpt")
    w = wal.WalWriter(d, flush_interval_s=0.0005)
    ing = wal.DurableIngest(base, w)
    for op, args in ops[:3]:
        getattr(ing, op)(*args)
    wm = ing.checkpoint(ckpt, prune=False)
    assert wm == 3 and tmut.delta_checkpoint_watermark(ckpt) == 3
    for op, args in ops[3:]:
        getattr(ing, op)(*args)
    live = ing.mindex
    ing.close()
    fresh = tmut.wrap_mutable(base.index, delta_cap=CAP)
    rec, frontier, n = wal.recover_mutable(fresh, d, checkpoint_path=ckpt,
                                           name="rec")
    assert (frontier, n) == (len(ops), len(ops) - 3)
    for f in ("vecs", "ids", "live", "counts"):
        assert torch.equal(getattr(rec.delta, f), getattr(live.delta, f))
    assert torch.equal(rec.row_mask, live.row_mask)
    # the epoch counts on from the fresh wrap's, as JAX's recovery of the
    # same checkpoint and log does
    jrec, _, _ = jwal.recover_mutable(
        jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP), d,
        checkpoint_path=ckpt, name="jrec")
    assert rec.epoch == jrec.epoch == len(ops) - 3
    assert rec._epoch_journal == jrec._epoch_journal
    for a, b in zip(tmut.mutable_search(rec, q, 5, n_probes=4),
                    tmut.mutable_search(live, q, 5, n_probes=4)):
        assert torch.equal(a, b)
    rec0, frontier, n = wal.recover_mutable(
        tmut.wrap_mutable(base.index, delta_cap=CAP), d, name="rec0")
    assert (frontier, n) == (len(ops), len(ops))
    # the checkpoint cleared the live state's dirty set; the rest agrees
    rec0.dirty_lists = set(live.dirty_lists)
    _assert_state(live, rec0)


def _recover_after_checkpoint(tmp_path, jax_indexes, ops):
    """``ops`` through each package's DurableIngest with a delta
    checkpoint after all but the last, then each package's
    recover_mutable from its checkpoint plus the tail onto a fresh wrap.
    Returns the live and recovered states, JAX's first."""
    jm = jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP)
    out = []
    for name, mod, m0 in (("j", jwal, jm), ("t", wal, _carry(jm))):
        d, ckpt = str(tmp_path / name), str(tmp_path / f"{name}.ckpt")
        ing = mod.DurableIngest(m0, mod.WalWriter(
            d, flush_interval_s=0.0005))
        for op, args in ops[:-1]:
            getattr(ing, op)(*args)
        assert ing.checkpoint(ckpt, prune=False) == len(ops) - 1
        getattr(ing, ops[-1][0])(*ops[-1][1])
        live = ing.mindex
        ing.close()
        fresh = (jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP)
                 if mod is jwal else _carry(jm))
        rec, frontier, n = mod.recover_mutable(fresh, d, checkpoint_path=ckpt,
                                               name=f"c1-{name}")
        assert (frontier, n) == (len(ops), 1)
        out.append((live, rec))
    return out


def test_checkpoint_plus_tail_recovers_the_reference_epoch(
        tmp_path, dataset, jax_indexes):
    """ROADMAP C1: three writes, a delta checkpoint after the second,
    then checkpoint-plus-tail recovery in both packages. Delta, mask and
    dirty lists are bitwise equal, and so are the epoch and the journal:
    both count on from the fresh wrap's epoch 0 (the stamped epochs in
    the frames are not read), so the recovered epoch is 1 where the live
    one is 3."""
    x, _ = dataset
    (jlive, jrec), (tlive, trec) = _recover_after_checkpoint(
        tmp_path, jax_indexes, _ops(x)[:3])
    _assert_state(jrec, trec)
    _assert_state(jlive, tlive)
    assert trec.epoch == 1 and tlive.epoch == 3
    assert [e for e, _ in trec._epoch_journal] == [1]


def test_tier_syncs_a_recovered_state_as_the_reference(
        tmp_path, dataset, jax_indexes):
    """A tier that saw the live epoch (3) syncs onto the recovered state
    (epoch 1) in both packages alike: the journal answers an empty set
    for the step back, the mask is re-published all the same, and the
    recovered epoch is adopted — changed set, seen epoch and view mask
    equal, and no recovered tombstone surfaces."""
    from raft_tpu.obs import metrics as jobsm
    from raft_tpu.tier import TieredListStore as JStore
    from raft_tpu_torch.obs import metrics as tobsm
    from raft_tpu_torch.tier import TieredListStore

    x, q = dataset
    (jlive, jrec), (tlive, trec) = _recover_after_checkpoint(
        tmp_path, jax_indexes, _ops(x)[:3])
    j = JStore(jax_indexes["flat"], n_slots=12,
               registry=jobsm.MetricRegistry())
    t = TieredListStore(trec.index, n_slots=12,
                        registry=tobsm.MetricRegistry())
    seen, answers = [], []
    for s, live, rec in ((j, jlive, jrec), (t, tlive, trec)):
        s.promote(range(12))
        first = s.sync_mutations(live)
        v0 = s.runtime()["tier"].version
        again = s.sync_mutations(rec)
        seen.append((first, again, s.stats().epoch,
                     s.runtime()["tier"].version - v0))
        answers.append([np.asarray(a) for a in s.search(q, 5, n_probes=4)])
    assert seen[1] == seen[0]
    assert seen[1][1:] == (set(), 1, 1) and trec.epoch == 1
    np.testing.assert_array_equal(
        t.runtime()["tier"].row_mask.numpy(),
        np.asarray(j.runtime()["tier"].row_mask))
    (jd, ji), (td, ti) = answers
    assert td.tobytes() == jd.tobytes()
    _assert_ids_equal_up_to_ties(jd, ji, ti)
    dead = np.nonzero(trec.row_mask.numpy()[:-1] == 0)[0]
    dead_ids = set(trec.index.storage.sorted_ids.numpy()[dead].tolist())
    assert dead_ids and not dead_ids & set(ti.ravel().tolist())


def _write_log(path, n=6, d=4, seed=7, mod=wal, **kw):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, 1, d)).astype(np.float32)
    ids = np.arange(100, 100 + n, dtype=np.int32)
    w = mod.WalWriter(path, flush_interval_s=0.0005, **kw)
    for k in range(n):
        ack = w.append(mod.OP_UPSERT, mod.encode_upsert(vecs[k], ids[k:k + 1]),
                       epoch=k)
        assert ack.wait(10.0)
    w.close()
    return vecs, ids


def test_torn_tail_repaired_as_the_reference_repairs(tmp_path):
    """A segment torn mid-frame, and a later segment past the tear: the
    port's repair leaves the same files and bytes as JAX's on a copy,
    and the intact prefix reads back."""
    d = str(tmp_path / "w")
    _write_log(d, n=8, segment_bytes=90)
    segs = wal.segment_paths(d)
    assert len(segs) >= 3
    torn = segs[1]
    with open(torn, "rb+") as f:
        f.truncate(os.path.getsize(torn) - 5)
    dj = str(tmp_path / "j")
    shutil.copytree(d, dj)
    recs, frontier = wal.repair_wal(d, name="t")
    jrecs, jfrontier = jwal.repair_wal(dj, name="t")
    assert frontier == jfrontier and [r.lsn for r in recs] == [
        r.lsn for r in jrecs]
    assert [os.path.basename(s) for s in wal.segment_paths(d)] == [
        os.path.basename(s) for s in jwal.segment_paths(dj)]
    for a, b in zip(wal.segment_paths(d), jwal.segment_paths(dj)):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert wal.read_records(d)[1] == frontier < 8
    # a flipped byte inside a frame is caught by its CRC
    with open(segs[0], "rb+") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0xFF]))
    _, _, damage = wal.scan_segment(segs[0])
    assert damage == "crc-mismatch"


def test_future_wal_version_refuses_to_scan(tmp_path):
    d = str(tmp_path / "w")
    _write_log(d, n=2)
    seg = wal.segment_paths(d)[0]
    data = bytearray(open(seg, "rb").read())
    data[4:6] = (wal.WAL_VERSION + 1).to_bytes(2, "little")
    open(seg, "wb").write(bytes(data))
    with pytest.raises(terrors.CorruptIndexError) as e:
        wal.scan_segment(seg)
    assert e.value.field == "__header__"


def test_prune_honours_watermark_and_active(tmp_path):
    d = str(tmp_path / "w")
    w = wal.WalWriter(d, segment_bytes=120, flush_interval_s=0.0005)
    for k in range(10):
        assert w.append(wal.OP_DELETE,
                        wal.encode_delete(np.array([k], np.int32))).wait(10)
    segs = wal.segment_paths(d)
    assert len(segs) >= 3
    assert w.prune(2) == []          # the covering segment survives
    first = [int(os.path.basename(s)[4:-4]) for s in segs]
    assert w.prune(first[1] - 1) == [segs[0]]
    records, frontier = wal.read_records(d)
    assert frontier == 10
    assert [r.lsn for r in records] == list(range(first[1], 11))
    w.prune(10)                      # the active segment never goes
    assert len(wal.segment_paths(d)) >= 1
    assert w.append(wal.OP_DELETE,
                    wal.encode_delete(np.array([99], np.int32))).wait(10)
    w.close()
    assert wal.wal_frontier(d) == 11


def test_ack_never_precedes_fsync(tmp_path):
    """An ack parked behind a gated fsync is not durable and times out;
    once the fsync returns it resolves."""
    armed, release, entered = (threading.Event() for _ in range(3))

    def gated_fsync(fd):
        if armed.is_set():
            entered.set()
            assert release.wait(10.0)
        os.fsync(fd)

    w = wal.WalWriter(str(tmp_path / "w"), flush_interval_s=0.0005,
                      fsync=gated_fsync)
    armed.set()
    ack = w.append(wal.OP_DELETE, wal.encode_delete(np.array([1], np.int32)))
    assert entered.wait(10.0)
    assert not ack.durable and w.durable_lsn < ack.lsn
    assert ack.wait(0.05) is False
    release.set()
    assert ack.wait(10.0) and ack.durable
    armed.clear()
    w.close()


def test_io_error_latches_and_fails_acks(tmp_path, dataset, jax_indexes):
    """A flusher IO error fails the pending ack and latches: the writer
    refuses appends, and a DurableIngest over it refuses its state."""
    boom = threading.Event()

    def failing_fsync(fd):
        if boom.is_set():
            raise OSError(5, "injected EIO")
        os.fsync(fd)

    w = wal.WalWriter(str(tmp_path / "w"), flush_interval_s=0.0005,
                      fsync=failing_fsync)
    ing = wal.DurableIngest(
        _carry(jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP)), w)
    x, _ = dataset
    assert ing.upsert(x[:2], np.asarray([9500, 9501], np.int32)).all()
    boom.set()
    with pytest.raises(OSError):
        ing.upsert(x[2:4], np.asarray([9502, 9503], np.int32))
    with pytest.raises(terrors.CorruptIndexError):
        ing.mindex
    with pytest.raises(terrors.RaftLogicError):     # the writer is dead
        w.append(wal.OP_DELETE, wal.encode_delete(np.array([3], np.int32)))


def _assert_crash_cycle(r):
    assert set(r["acked"]) <= set(r["recovered"]), "acked write lost"
    assert len(r["recovered"]) <= r["submitted"]
    lsns = [lsn for lsn, _ in r["recovered"]]
    assert lsns == list(range(1, len(lsns) + 1))
    gids = [g for _, g in r["recovered"]]
    assert gids == [100000 + k for k in range(len(gids))]


def test_kill9_fast_leg_loses_no_acked_record(tmp_path):
    for i, after in enumerate((1, 5, 17)):
        r = crash.run_crash_ingest_cycle(
            str(tmp_path / f"w{i}"), kill_after_acks=after, n_records=40,
            d=8, seed=20 + i)
        assert r["returncode"] == -9
        assert len(r["acked"]) == after
        _assert_crash_cycle(r)


def test_kill9_completion_leg_and_the_jax_reader(tmp_path):
    """The child runs to its end; its log reads the same in JAX."""
    d = str(tmp_path / "w")
    r = crash.run_crash_ingest_cycle(d, kill_after_acks=999, n_records=12,
                                     d=8, seed=9)
    assert r["returncode"] == 0
    assert r["frontier"] == 12 and len(r["recovered"]) == 12
    _assert_crash_cycle(r)
    jrecs, jfrontier = jwal.read_records(d)
    assert jfrontier == 12 and [(x.lsn, x.epoch) for x in jrecs] == [
        (k + 1, k) for k in range(12)]
    assert crash.main(["too", "few"]) == 64


def _header(path):
    with np.load(path) as npz:
        return json.loads(bytes(npz["__header__"]).decode("utf-8"))


@pytest.mark.parametrize("kind", KINDS)
def test_v4_mutable_archive_cross_read_both_ways(tmp_path, dataset,
                                                 jax_indexes, kind):
    """A mutable state's full v4 archive: the port's header equals JAX's,
    JAX loads the port's archive and the port JAX's as the same state;
    the frozen payload of the same index stays at its lowest version."""
    x, _ = dataset
    jm = jmut.wrap_mutable(jax_indexes[kind], delta_cap=CAP)
    tm = _carry(jm)
    for op, args in _ops(x):
        jm = getattr(jmut, op)(jm, *args)[0]
        tm = getattr(tmut, op)(tm, *args)[0]
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_save_index(jm, jp)
    interop.save_index(tm, tp)
    assert _header(tp) == _header(jp) and _header(tp)["version"] == 4
    from_jax = interop.load_index(jp, device="cpu")
    from_port = j_load_index(tp)
    for a, b in ((from_jax, jm), (tm, from_port)):
        ja = _leaves(b, "", {})
        ta = _leaves_port(a)
        assert set(ta) == set(ja)
        for key, v in ja.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(ta[key], v, key)
            else:
                assert ta[key] == v, key
    assert from_jax.epoch == 0 and not from_jax.dirty_lists
    interop.save_index(tm.index, tp)
    assert _header(tp)["version"] == 2


def _leaves_port(tm):
    """A port MutableIndex's leaves keyed as the v4 archive keys them."""
    out = {}

    def walk(obj, prefix):
        for name in interop._FIELDS[type(obj)]:
            v = getattr(obj, name)
            if type(v) in interop._FIELDS:
                walk(v, prefix + name + ".")
            elif isinstance(v, torch.Tensor):
                out[prefix + name] = v.numpy()
            else:
                out[prefix + name] = v

    walk(tm, "")
    return out


def test_v4_archive_damage_and_future_version(tmp_path, jax_indexes):
    tm = _carry(jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP))
    path = str(tmp_path / "m.npz")
    interop.save_index(tm, path)
    field = corrupt_bytes(path, field="delta.vecs", n_bytes=4)
    with pytest.raises(terrors.CorruptIndexError, match="CRC32") as e:
        interop.load_index(path, device="cpu")
    assert e.value.field == field == "delta.vecs"
    interop.save_index(tm, path)
    with np.load(path) as npz:
        arrays = {k: npz[k] for k in npz.files}
    header = json.loads(bytes(arrays.pop("__header__")).decode("utf-8"))
    header["version"] = 6
    with open(path, "wb") as f:
        np.savez(f, __header__=np.frombuffer(
            json.dumps(header).encode("utf-8"), dtype=np.uint8), **arrays)
    with pytest.raises(terrors.CorruptIndexError) as e:
        interop.load_index(path, device="cpu")
    assert e.value.field == "__header__" and "6" in str(e.value)


def test_delta_checkpoints_cross_read_both_ways(tmp_path, dataset,
                                                jax_indexes):
    """mutation-delta v4 checkpoints of the dirty lists: headers equal,
    each package splices the other's file into a fresh wrap to the same
    state (idempotently); damage and a geometry mismatch are named."""
    x, _ = dataset
    jm = jmut.wrap_mutable(jax_indexes["sq"], delta_cap=CAP)
    tm = _carry(jm)
    base_j, base_t = jm, _carry(jm)
    for op, args in _ops(x):
        jm = getattr(jmut, op)(jm, *args)[0]
        tm = getattr(tmut, op)(tm, *args)[0]
    jp, tp = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    lj = jmut.save_delta_checkpoint(jm, jp, wal_lsn=11)
    lt = tmut.save_delta_checkpoint(tm, tp, wal_lsn=11)
    assert lt == lj and not tm.dirty_lists and lt
    assert _header(tp) == _header(jp)
    with np.load(tp) as a, np.load(jp) as b:
        assert a.files == b.files
        for key in a.files:
            assert a[key].tobytes() == b[key].tobytes(), key
    applied_t = tmut.apply_delta_checkpoint(base_t, jp)
    applied_t = tmut.apply_delta_checkpoint(applied_t, jp)   # idempotent
    applied_j = jmut.apply_delta_checkpoint(base_j, tp)
    for f in ("vecs", "ids", "live", "counts"):
        np.testing.assert_array_equal(getattr(applied_t.delta, f).numpy(),
                                      np.asarray(getattr(tm.delta, f)))
        np.testing.assert_array_equal(np.asarray(getattr(applied_j.delta, f)),
                                      np.asarray(getattr(tm.delta, f)))
    assert torch.equal(applied_t.row_mask, tm.row_mask)
    assert tmut.delta_checkpoint_watermark(jp) == 11
    field = corrupt_bytes(tp, field="counts", n_bytes=1, skip_header_bytes=0)
    with pytest.raises(terrors.CorruptIndexError) as e:
        tmut.apply_delta_checkpoint(base_t, tp)
    assert e.value.field == field
    other = tmut.wrap_mutable(base_t.index, delta_cap=CAP + 1)
    with pytest.raises(terrors.CorruptIndexError, match="geometry"):
        tmut.apply_delta_checkpoint(other, jp)


def test_ingest_rows_shape_and_accounting(jax_indexes, dataset):
    """The tiny mixed-ingest and durable-ingest rows: their keys, the
    ack and visibility results, and the WAL sweep's accounting (no rate
    is asserted)."""
    from raft_tpu_torch.serving.ingest_rows import (
        durable_ingest_row, mixed_ingest_row,
    )

    _, q = dataset
    idx = _carry(jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP)).index
    qb = torch.as_tensor(q[:8])
    row = mixed_ingest_row(idx, qb, k=5, n_probes=4, ingest_batch=16,
                           delta_cap=8, chain=(1, 2), escalate=0)
    assert row["scenario"] == "mixed_ingest" and row["nq"] == 8
    assert row["ingest_batch"] == 16 and isinstance(row["qcap"], int)
    if "error" not in row:
        assert "upsert_visible_ms" in row and "delete_masked_ms" in row
        for key in ("frozen_qps", "mixed_search_qps"):
            if key in row:
                assert row[key] > 0
    row = durable_ingest_row(idx, qb, ingest_batch=8, n_batches=3,
                             delta_cap=8, fsync_intervals_ms=(0.0, 1.0))
    assert row["scenario"] == "durable_ingest" and row["n_batches"] == 3
    assert [s["fsync_interval_ms"] for s in row["fsync_sweep"]] == [0.0, 1.0]
    assert all(s["n_fsyncs"] >= 1 and s["durable_qps"] > 0
               for s in row["fsync_sweep"])
    assert row["durable_qps"] == max(s["durable_qps"]
                                     for s in row["fsync_sweep"])
    assert row["durability_ratio"] == pytest.approx(
        row["durable_qps"] / row["nondurable_qps"])


def test_crc_rule_matches_zlib():
    arr = np.arange(12, dtype=np.int8).reshape(3, 4)[:, ::2]
    assert interop._array_crc(arr) == zlib.crc32(
        np.ascontiguousarray(arr).tobytes())
