"""Durable mutation WAL — the port of ``raft_tpu/durability/wal.py``:
crash-consistent ingest for the mutation tier. Checkpoints bound what a
crash loses to "everything since the last flush"; the write-ahead log
closes that window to "nothing acked".

The log is an append-only directory of CRC32-framed segments, byte for
byte the JAX package's format (either package replays the other's log):

* **Frame** — ``crc32 · payload-length · lsn · mutation-epoch · op ·
  payload`` (little-endian; the CRC covers everything after itself),
  with the payload codecs of the two mutation ops
  (:func:`encode_upsert` / :func:`encode_delete`).
* **Group commit** — :class:`WalWriter` buffers frames under one lock;
  a flusher thread batches ``write → flush → fsync`` by bytes or by
  interval, with all file IO outside the lock, and an ack
  (:class:`WalAck`) resolves only after its frame's fsync returned. An
  IO error latches: every later append or wait raises it.
* **Rotation + retention** — segments are named by their first LSN
  (``wal-<lsn>.log``) and rotate past ``segment_bytes``;
  :meth:`WalWriter.prune` deletes segments made wholly redundant by a
  delta checkpoint's LSN watermark
  (:func:`raft_tpu_torch.spatial.ann.mutation.save_delta_checkpoint`'s
  ``wal_lsn``), never the active one.
* **Torn-tail recovery** — :func:`repair_wal` truncates at the first
  damaged frame (later segments go with it).
* **Idempotent replay** — :func:`replay_into` applies records in LSN
  order with a monotone-LSN dedupe. Recovery is
  :func:`recover_mutable`: the latest delta checkpoint plus the WAL
  tail.

Host-side throughout: replay calls the mutation ops, which run on the
wrapped index's device. Metrics (``wal_fsync_ms``, ``wal_bytes_total``,
``wal_replay_records_total``, ``wal_torn_tail_total`` and the
``wal_torn_tail`` flight event) ride the process registry.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import typing
import zlib

import numpy as np

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.obs import crash as obs_crash
from raft_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "OP_DELETE",
    "OP_UPSERT",
    "WAL_VERSION",
    "DurableIngest",
    "WalAck",
    "WalRecord",
    "WalWriter",
    "decode_delete",
    "decode_upsert",
    "encode_delete",
    "encode_frame",
    "encode_upsert",
    "read_records",
    "recover_mutable",
    "repair_wal",
    "replay_into",
    "scan_segment",
    "segment_paths",
    "series",
    "wal_frontier",
]


def _mutation():
    # the mutation ops import torch; the log itself needs only numpy, so
    # a process that only journals (the kill-9 child) starts fast
    from raft_tpu_torch.spatial.ann import mutation

    return mutation


# ------------------------------------------------------------ telemetry
# WAL telemetry: fsync batch
# latency (the group-commit knob's direct readout), bytes appended,
# records replayed at recovery, and torn-tail repairs. Labeled
# ``wal=<name>`` — a process may run one WAL per rank — and cached per
# name like mutation's ``_mseries``. RAFT_TPU_OBS=off no-ops them all.
_series_cache: dict = {}
_series_lock = lockcheck.make_lock("wal._series_lock")


def series(name: str) -> dict:
    """The cached ``wal=<name>``-labeled instrument handles (public so
    a sharded tier's recovery can stamp the same replay counter)."""
    s = _series_cache.get(name)
    if s is not None:
        return s
    reg = obs_metrics.default_registry()
    with _series_lock:
        if name not in _series_cache:
            _series_cache[name] = {
                "fsync_ms": reg.histogram("wal_fsync_ms", wal=name),
                "bytes": reg.counter("wal_bytes_total", wal=name),
                "replayed": reg.counter("wal_replay_records_total",
                                        wal=name),
                "torn": reg.counter("wal_torn_tail_total", wal=name),
            }
        return _series_cache[name]


# ---------------------------------------------------------- frame codec
_MAGIC = b"RWAL"
WAL_VERSION = 1
_FILE_HEADER = _MAGIC + struct.pack("<HH", WAL_VERSION, 0)
_HEADER_LEN = len(_FILE_HEADER)                     # 8
_CRC = struct.Struct("<I")
_BODY_HEAD = struct.Struct("<IQQB")                 # len, lsn, epoch, op
_FRAME_OVERHEAD = _CRC.size + _BODY_HEAD.size       # 25
_MAX_PAYLOAD = 1 << 28

OP_UPSERT = 1
OP_DELETE = 2


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded log record: the mutation-epoch the writer stamped,
    the op, and its opaque payload, totally ordered by ``lsn``."""

    lsn: int
    epoch: int
    op: int
    payload: bytes


def encode_frame(lsn: int, epoch: int, op: int, payload: bytes) -> bytes:
    """One on-disk frame: ``crc32(body) · body`` where ``body`` =
    payload-length · lsn · epoch · op · payload (all little-endian)."""
    errors.expects(
        0 <= len(payload) <= _MAX_PAYLOAD,
        "encode_frame: payload of %d bytes exceeds the %d frame cap",
        len(payload), _MAX_PAYLOAD,
    )
    body = _BODY_HEAD.pack(len(payload), lsn, epoch, op) + payload
    return _CRC.pack(zlib.crc32(body)) + body


def encode_upsert(vectors, ids) -> bytes:
    """Payload for an upsert batch: ``B · d · ids(int32) · vecs(f32)``."""
    v = np.ascontiguousarray(np.asarray(vectors, np.float32))
    i = np.ascontiguousarray(np.asarray(ids, np.int32)).reshape(-1)
    errors.expects(
        v.ndim == 2 and v.shape[0] == i.shape[0],
        "encode_upsert: vectors (%s) and ids (%s) disagree",
        tuple(v.shape), tuple(i.shape),
    )
    return (struct.pack("<II", v.shape[0], v.shape[1])
            + i.tobytes() + v.tobytes())


def decode_upsert(payload: bytes):
    """Inverse of :func:`encode_upsert` → ``(vectors, ids)``."""
    b, d = struct.unpack_from("<II", payload, 0)
    want = 8 + 4 * b + 4 * b * d
    errors.expects(
        len(payload) == want,
        "decode_upsert: payload is %d bytes, header says %d",
        len(payload), want,
    )
    i = np.frombuffer(payload, np.int32, b, 8)
    v = np.frombuffer(payload, np.float32, b * d, 8 + 4 * b)
    return v.reshape(b, d), i


def encode_delete(ids) -> bytes:
    """Payload for a delete batch: ``B · ids(int32)``."""
    i = np.ascontiguousarray(np.asarray(ids, np.int32)).reshape(-1)
    return struct.pack("<I", i.shape[0]) + i.tobytes()


def decode_delete(payload: bytes):
    """Inverse of :func:`encode_delete` → ``ids``."""
    (b,) = struct.unpack_from("<I", payload, 0)
    errors.expects(
        len(payload) == 4 + 4 * b,
        "decode_delete: payload is %d bytes, header says %d",
        len(payload), 4 + 4 * b,
    )
    return np.frombuffer(payload, np.int32, b, 4)


# ------------------------------------------------------------- segments
def _segment_name(first_lsn: int) -> str:
    return f"wal-{first_lsn:020d}.log"


def _segment_first_lsn(path) -> int:
    return int(os.path.basename(path)[4:-4])


def segment_paths(path) -> list:
    """The directory's segment files, sorted — zero-padded first-LSN
    names make name order equal LSN order."""
    if not os.path.isdir(path):
        return []
    return [os.path.join(path, n) for n in sorted(os.listdir(path))
            if n.startswith("wal-") and n.endswith(".log")]


def _fsync_dir(path, fsync) -> None:
    # directory fsync makes segment creation itself durable (a rotated
    # frame is not recoverable if its segment's dirent is lost)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        fsync(fd)
    finally:
        os.close(fd)


def scan_segment(path):
    """Decode one segment → ``(records, good_end, damage)`` where
    ``good_end`` is the byte offset after the last intact frame and
    ``damage`` is None or why decoding stopped (``bad-header`` /
    ``short-frame`` / ``short-payload`` / ``crc-mismatch``). Never
    modifies the file; a FUTURE format version raises
    :class:`~raft_tpu_torch.errors.CorruptIndexError` instead of being
    mistaken for damage and truncated away."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _HEADER_LEN or data[:4] != _MAGIC:
        return [], 0, "bad-header"
    (version,) = struct.unpack_from("<H", data, 4)
    if version > WAL_VERSION:
        raise errors.CorruptIndexError(
            f"scan_segment: {os.path.basename(path)} is WAL format "
            f"v{version}, this release reads up to v{WAL_VERSION}; "
            "upgrade before recovering", field="__header__",
        )
    records: list = []
    off = _HEADER_LEN
    n = len(data)
    while off < n:
        if off + _FRAME_OVERHEAD > n:
            return records, off, "short-frame"
        (crc,) = _CRC.unpack_from(data, off)
        length, lsn, epoch, op = _BODY_HEAD.unpack_from(
            data, off + _CRC.size)
        end = off + _FRAME_OVERHEAD + length
        if length > _MAX_PAYLOAD or end > n:
            return records, off, "short-payload"
        if zlib.crc32(data[off + _CRC.size:end]) != crc:
            return records, off, "crc-mismatch"
        records.append(WalRecord(lsn=lsn, epoch=epoch, op=op,
                                 payload=data[end - length:end]))
        off = end
    return records, off, None


def _scan_wal(path):
    """All segments → ``(records, frontier, repairs)``: records in LSN
    order with the monotone dedupe applied, the highest LSN seen, and
    the repair plan (``(segment, action, good_end, reason)`` tuples —
    ``repair_wal`` executes it, ``read_records`` ignores it)."""
    records: list = []
    last = 0
    repairs: list = []
    damaged = False
    for seg in segment_paths(path):
        if damaged:
            # frames past a tear are not replayable (an LSN gap would
            # fabricate state) — later segments go with the tail
            repairs.append((seg, "remove", 0, "past-tear"))
            continue
        recs, good_end, damage = scan_segment(seg)
        for r in recs:
            if r.lsn > last:
                records.append(r)
                last = r.lsn
        if damage is not None:
            damaged = True
            if damage == "bad-header":
                repairs.append((seg, "remove", 0, damage))
            else:
                repairs.append((seg, "truncate", good_end, damage))
    return records, last, repairs


def read_records(path):
    """Read-only scan of a WAL directory → ``(records, frontier)``;
    stops at the first damaged frame without repairing anything."""
    records, last, _ = _scan_wal(path)
    return records, last


def wal_frontier(path) -> int:
    """The highest intact LSN in the directory (0 = empty log)."""
    return read_records(path)[1]


def repair_wal(path, *, name: str = "wal", flight=None):
    """Scan + REPAIR a WAL directory after a crash: truncate the torn
    segment at its last intact frame (a header-torn segment is removed
    whole — rotation fsyncs the header before any frame, so one can
    hold nothing durable) and drop segments past the tear. Returns
    ``(records, frontier)``. fsync ordering guarantees the truncation
    never reaches a durably-acked frame. Counted in
    ``wal_torn_tail_total`` plus a ``wal_torn_tail`` flight event."""
    records, last, repairs = _scan_wal(path)
    for seg, action, good_end, _reason in repairs:
        if action == "remove":
            os.remove(seg)
        else:
            with open(seg, "rb+") as f:
                f.truncate(good_end)
    if repairs:
        series(name)["torn"].inc()
        if flight is not None:
            seg, _action, good_end, reason = repairs[0]
            flight.record(
                "wal_torn_tail", wal=name,
                segment=os.path.basename(seg), reason=reason,
                offset=good_end, dropped=len(repairs) - 1,
                frontier=last,
            )
    return records, last


# --------------------------------------------------------- group commit
class WalAck:
    """The durability future :meth:`WalWriter.append` returns: the
    frame is on the buffer when the handle exists, DURABLE only once
    :meth:`wait` returns True (strictly after its batch's fsync)."""

    __slots__ = ("lsn", "_writer")

    def __init__(self, lsn: int, writer: "WalWriter"):
        self.lsn = lsn
        self._writer = writer

    def wait(self, timeout: typing.Optional[float] = None) -> bool:
        """Block until the frame is fsync-durable (True) or ``timeout``
        elapses (False). Re-raises the writer's IO error if the flusher
        died — a lost disk must fail the ack, not hang it."""
        return self._writer.wait_durable(self.lsn, timeout)

    @property
    def durable(self) -> bool:
        return self._writer.durable_lsn >= self.lsn


class WalWriter:
    """Append-only segment writer with host-side group commit.

    ``append`` assigns the LSN and buffers the frame under the lock; a
    dedicated flusher thread swaps the buffer out and runs the
    ``write → flush → fsync`` OUTSIDE the lock, batching by
    ``flush_bytes`` or ``flush_interval_s`` (whichever trips first —
    the interval bounds ack latency, the byte cap bounds batch size).
    ``clock`` and ``fsync`` are injectable so tests can prove the
    ordering contract (an ack NEVER resolves before its fsync
    returned) without a real disk.

    Reopening a directory never appends into an existing segment: the
    constructor runs :func:`repair_wal` first (appending past an
    unrepaired tear would put durably-acked frames into segments a
    later repair classifies as past-tear and deletes), then starts a
    fresh segment at the repaired ``frontier + 1``.
    A flusher IO failure latches: every later ``append``/``wait``
    re-raises it (durability can not be silently downgraded).
    """

    def __init__(self, path, *,
                 segment_bytes: int = 4 << 20,
                 flush_bytes: int = 256 << 10,
                 flush_interval_s: float = 0.002,
                 name: str = "wal",
                 flight=None,
                 clock=time.monotonic,
                 fsync=os.fsync):
        errors.expects(
            segment_bytes > 0 and flush_bytes > 0
            and flush_interval_s >= 0,
            "WalWriter: segment_bytes=%d flush_bytes=%d "
            "flush_interval_s=%s must be positive",
            segment_bytes, flush_bytes, flush_interval_s,
        )
        self.path = path
        self.name = name
        self.segment_bytes = int(segment_bytes)
        self.flush_bytes = int(flush_bytes)
        self.flush_interval_s = float(flush_interval_s)
        self._clock = clock
        self._fsync = fsync
        self._flight = flight
        self._series = series(name)
        os.makedirs(path, exist_ok=True)
        # Repair BEFORE computing the frontier: the scan stops at a
        # tear, so appending at scan-frontier + 1 would land acked
        # frames in a segment that sorts after the damaged one — a
        # later repair_wal would call it past-tear and delete it.
        _, frontier = repair_wal(path, name=name, flight=flight)
        self._lock = lockcheck.make_lock("WalWriter._lock")
        self._cv = lockcheck.make_condition(self._lock)
        self._buf: list = []
        self._buf_bytes = 0
        self._buf_t0 = 0.0
        self._last_buffered = frontier
        self._durable_lsn = frontier
        self._next_lsn = frontier + 1
        self._closed = False
        self._io_error: typing.Optional[BaseException] = None
        # the file handle is flusher-owned: only the flusher thread
        # touches it after construction, so it needs no lock at all
        self._active_seg = os.path.join(
            path, _segment_name(frontier + 1))
        if os.path.exists(self._active_seg):
            # post-repair this can only be a record-free shell (a
            # header-only segment left by a no-append open); records
            # here mean LSNs the scan missed — refuse to truncate them
            if scan_segment(self._active_seg)[0]:
                raise errors.CorruptIndexError(
                    f"WalWriter({name}): segment "
                    f"{os.path.basename(self._active_seg)} holds "
                    f"records although the repaired frontier is "
                    f"{frontier}; refusing to overwrite it",
                    field="__frontier__",
                )
        self._file = open(self._active_seg, "wb")
        self._file.write(_FILE_HEADER)
        self._file.flush()
        self._fsync(self._file.fileno())
        _fsync_dir(path, self._fsync)
        obs_crash.install_excepthook()
        self._thread = threading.Thread(
            target=self._run, name=f"wal-flusher-{name}", daemon=True)
        self._thread.start()

    # -- write side ----------------------------------------------------
    def append(self, op: int, payload: bytes, *,
               epoch: int = 0,
               lsn: typing.Optional[int] = None) -> WalAck:
        """Frame + buffer one record; returns its :class:`WalAck`.
        ``lsn`` (optional) lets a coordinator drive a global LSN stream
        across several per-rank writers (gaps are fine — replay is
        monotone, not contiguous); it must exceed every LSN this writer
        already assigned."""
        data = bytes(payload)
        with self._lock:
            errors.expects(
                not self._closed, "WalWriter(%s): append after close",
                self.name,
            )
            if self._io_error is not None:
                raise self._io_error
            if lsn is None:
                lsn = self._next_lsn
            errors.expects(
                lsn >= self._next_lsn,
                "WalWriter(%s): lsn %d not monotone (next is %d)",
                self.name, lsn, self._next_lsn,
            )
            self._next_lsn = lsn + 1
            frame = encode_frame(lsn, int(epoch), int(op), data)
            if self._buf_bytes == 0:
                self._buf_t0 = self._clock()
            self._buf.append(frame)
            self._buf_bytes += len(frame)
            self._last_buffered = lsn
            self._cv.notify_all()
        self._series["bytes"].inc(len(frame))
        return WalAck(lsn, self)

    def wait_durable(self, lsn: int,
                     timeout: typing.Optional[float] = None) -> bool:
        """Block until ``durable_lsn >= lsn`` (True) or ``timeout``
        elapses (False); re-raises a latched flusher IO error."""
        deadline = (None if timeout is None
                    else self._clock() + float(timeout))
        with self._lock:
            while self._durable_lsn < lsn:
                if self._io_error is not None:
                    raise self._io_error
                if deadline is None:
                    self._cv.wait(0.05)
                    continue
                left = deadline - self._clock()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
            return True

    @property
    def durable_lsn(self) -> int:
        """The highest LSN whose fsync has returned."""
        with self._lock:
            return self._durable_lsn

    @property
    def last_lsn(self) -> int:
        """The highest LSN assigned (durable or still buffered)."""
        with self._lock:
            return self._last_buffered

    def close(self, timeout_s: float = 30.0) -> None:
        """Drain the buffer (one final fsync), stop the flusher, close
        the segment. Idempotent; appends after close raise."""
        with self._lock:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout_s)
        errors.expects(
            not self._thread.is_alive(),
            "WalWriter(%s): flusher still running after %.1fs",
            self.name, timeout_s,
        )

    # -- retention -----------------------------------------------------
    def prune(self, watermark_lsn: int) -> list:
        """Delete segments made wholly redundant by a checkpoint at
        ``watermark_lsn``: a segment goes only when the NEXT segment's
        first LSN is ≤ ``watermark + 1`` (so every record it holds is
        ≤ the watermark), and the active segment never goes. Returns
        the removed paths."""
        with self._lock:
            active = self._active_seg
        segs = segment_paths(self.path)
        removed = []
        for i, seg in enumerate(segs[:-1]):
            if seg == active:
                continue
            if _segment_first_lsn(segs[i + 1]) <= int(watermark_lsn) + 1:
                os.remove(seg)
                removed.append(seg)
        return removed

    # -- flusher (owns the file handle) --------------------------------
    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._buf and not self._closed:
                    self._cv.wait(0.05)
                if not self._buf and self._closed:
                    break
                # group window: linger for more frames until the byte
                # or interval trigger trips (close flushes immediately)
                while (self._buf_bytes < self.flush_bytes
                       and not self._closed):
                    left = self.flush_interval_s - (
                        self._clock() - self._buf_t0)
                    if left <= 0:
                        break
                    self._cv.wait(min(left, 0.05))
                batch = b"".join(self._buf)
                last = self._last_buffered
                self._buf.clear()
                self._buf_bytes = 0
            # ALL file IO outside the lock: appenders keep enqueueing
            # while the disk syncs (blocking-call-under-lock gates this)
            try:
                t0 = time.perf_counter()
                self._file.write(batch)
                self._file.flush()
                self._fsync(self._file.fileno())
                dt_ms = (time.perf_counter() - t0) * 1e3
            except BaseException as e:
                with self._lock:
                    self._io_error = e
                    self._closed = True
                    self._cv.notify_all()
                break
            self._series["fsync_ms"].observe(dt_ms)
            with self._lock:
                self._durable_lsn = last
                self._cv.notify_all()
            if self._file.tell() >= self.segment_bytes:
                self._rotate(last + 1)
        self._file.close()

    def _rotate(self, next_lsn: int) -> None:
        # flusher-only; the new segment's header AND its dirent are
        # durable before any frame lands in it
        self._file.close()
        path = os.path.join(self.path, _segment_name(next_lsn))
        f = open(path, "wb")
        f.write(_FILE_HEADER)
        f.flush()
        self._fsync(f.fileno())
        _fsync_dir(self.path, self._fsync)
        self._file = f
        with self._lock:
            self._active_seg = path


# --------------------------------------------------------------- replay
def replay_into(mindex, records, *, start_lsn: int = 0,
                name: typing.Optional[str] = None):
    """Idempotently replay decoded records into a
    :class:`~raft_tpu_torch.spatial.ann.mutation.MutableIndex`: records at or
    below ``start_lsn`` (the checkpoint watermark) and non-monotone
    LSNs are skipped, so duplicated segments replay once. Returns
    ``(mindex, last_lsn, n_applied)``. Replay re-runs the SAME
    acceptance logic the live path ran from the same state, so the
    reconstruction is exact — including the rejections.

    The epoch counts on from the base state's, as the JAX package's
    replay does: each applied write advances it as the live write did,
    and the epoch stamped in each frame (kept so the bytes match the
    JAX writer's) is not read. A delta checkpoint stores no epoch, so a
    checkpoint-plus-tail recovery can land below the live epoch."""
    last = int(start_lsn)
    n = 0
    for rec in records:
        if rec.lsn <= last:
            continue
        if rec.op == OP_UPSERT:
            vecs, ids = decode_upsert(rec.payload)
            mindex, _ = _mutation().upsert(mindex, vecs, ids)
        elif rec.op == OP_DELETE:
            mindex, _ = _mutation().delete(
                mindex, decode_delete(rec.payload))
        else:
            raise errors.CorruptIndexError(
                f"replay_into: unknown op {rec.op} at lsn {rec.lsn}",
                field="op",
            )
        last = rec.lsn
        n += 1
    series(name or mindex.name)["replayed"].inc(n)
    return mindex, last, n


def recover_mutable(mindex, wal_dir, *,
                    checkpoint_path=None,
                    name: typing.Optional[str] = None,
                    flight=None):
    """Crash recovery = latest delta checkpoint + WAL tail replay.

    ``mindex`` is the BASE state (a fresh wrap of the last FULL
    checkpoint); ``checkpoint_path`` (optional) is the newest delta
    checkpoint, whose ``wal_lsn`` watermark tells replay where to
    start. Repairs the WAL's torn tail first, then replays every
    record past the watermark. Pure upsert/delete streams keep the
    main slabs and ``id_to_pos`` constant, so the reconstruction is
    exact up to the last durable frame. Returns
    ``(mindex, frontier_lsn, n_replayed)``."""
    watermark = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        mut = _mutation()
        mindex = mut.apply_delta_checkpoint(mindex, checkpoint_path)
        wm = mut.delta_checkpoint_watermark(checkpoint_path)
        watermark = 0 if wm is None else int(wm)
    nm = name or mindex.name
    records, frontier = repair_wal(wal_dir, name=nm, flight=flight)
    mindex, last, n = replay_into(
        mindex, records, start_lsn=watermark, name=nm)
    return mindex, max(last, frontier), n


# ------------------------------------------------------- durable ingest
class DurableIngest:
    """The single-chip crash-consistent ingest front end: WAL-first
    apply with durable acks.

    Each op journals the batch, applies it to the in-memory
    :class:`MutableIndex` (journal and apply are atomic under one
    lock, so LSN order IS apply order), then waits for durability
    OUTSIDE the lock before returning — the return value is the ack.
    A crash loses the in-memory state wholesale, so apply-before-fsync
    is safe: recovery (:func:`recover_mutable`) rebuilds exactly the
    durable prefix, which covers every acked batch and never a torn
    one. :meth:`checkpoint` stamps the applied LSN into the delta
    checkpoint and prunes the WAL behind it.

    A durability failure (the writer latched an IO error, or an ack
    timed out) latches HERE too: the in-memory state is now ahead of
    the durable log, so :attr:`mindex` and every later op raise —
    serving it would expose rows that were never durable and vanish on
    restart. Discard the front end and re-run
    :func:`recover_mutable`."""

    def __init__(self, mindex, wal: WalWriter, *,
                 applied_lsn: typing.Optional[int] = None):
        self._lock = lockcheck.make_lock("DurableIngest._lock")
        # the mutation tier's metric series of this index, made here:
        # the first upsert or delete would make them under self._lock,
        # an acquisition (-> mutation._mseries_lock) no path of the
        # pinned lock order takes
        _mutation()._mseries(mindex.name)
        self._mindex = mindex
        self._wal = wal
        self._applied_lsn = int(
            wal.durable_lsn if applied_lsn is None else applied_lsn)
        self._failed: typing.Optional[BaseException] = None

    def _require_live(self) -> None:
        # under self._lock
        if self._failed is not None:
            raise errors.CorruptIndexError(
                "DurableIngest: a durability ack failed "
                f"({self._failed!r}); the in-memory state is ahead of "
                "the durable log — discard this front end and re-run "
                "recover_mutable", field="__wal__",
            ) from self._failed

    def _await_durable(self, ack: WalAck):
        # outside self._lock: parks behind the disk
        try:
            ok = ack.wait()
            errors.expects(
                ok, "DurableIngest: ack for lsn %d timed out", ack.lsn)
        except BaseException as e:
            with self._lock:
                if self._failed is None:
                    self._failed = e
            raise

    @property
    def mindex(self):
        """The current (search-servable) index state; raises once a
        durability ack has failed (the state is no longer durable)."""
        with self._lock:
            self._require_live()
            return self._mindex

    @property
    def applied_lsn(self) -> int:
        with self._lock:
            return self._applied_lsn

    @property
    def wal(self) -> WalWriter:
        with self._lock:
            return self._wal

    def upsert(self, vectors, ids):
        """Journal + apply one upsert batch; returns the accepted mask
        only after the batch is fsync-durable."""
        v = np.asarray(vectors, np.float32)
        i = np.asarray(ids, np.int32)
        payload = encode_upsert(v, i)
        with self._lock:
            self._require_live()
            ack = self._wal.append(
                OP_UPSERT, payload, epoch=self._mindex.epoch)
            self._mindex, accepted = _mutation().upsert(self._mindex, v, i)
            self._applied_lsn = ack.lsn
        self._await_durable(ack)
        return accepted

    def delete(self, ids):
        """Journal + apply one delete batch; returns the found mask
        only after the batch is fsync-durable."""
        i = np.asarray(ids, np.int32)
        payload = encode_delete(i)
        with self._lock:
            self._require_live()
            ack = self._wal.append(
                OP_DELETE, payload, epoch=self._mindex.epoch)
            self._mindex, found = _mutation().delete(self._mindex, i)
            self._applied_lsn = ack.lsn
        self._await_durable(ack)
        return found

    def checkpoint(self, path, *, prune: bool = True) -> int:
        """Write a delta checkpoint stamped with the applied LSN (the
        retention watermark) and prune segments behind it. Returns the
        watermark.

        The recovery contract is "LATEST checkpoint + WAL tail", so
        this writes every list with delta content (not just the
        incremental dirty set — an earlier checkpoint to the same path
        would have cleared it and the overwrite would lose those
        lists)."""
        with self._lock:
            self._require_live()
            m = self._mindex
            lsn = self._applied_lsn
            w = self._wal
        lists = np.nonzero(m.delta.counts.cpu().numpy())[0].tolist()
        _mutation().save_delta_checkpoint(m, path, lists=lists,
                                          wal_lsn=lsn)
        if prune:
            w.prune(lsn)
        return lsn

    def close(self) -> None:
        with self._lock:
            w = self._wal
        w.close()
