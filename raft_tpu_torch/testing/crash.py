"""The kill-9 leg of the durability gate — the port of
``raft_tpu/testing/crash_child.py`` and
``raft_tpu/testing/chaos.py:run_crash_ingest_cycle``.

:func:`run_crash_ingest_cycle` spawns a real subprocess (this module run
as ``python -m raft_tpu_torch.testing.crash <wal_dir> <n> <d> <seed>
<flush_ms>``, :func:`main`) that appends ``n`` seeded single-row upsert
records through a :class:`~raft_tpu_torch.durability.wal.WalWriter` and
prints ``ACK <lsn> <id>`` — flushed, one per line — strictly after each
record's ``ack.wait()`` returned, i.e. after its fsync. The parent
SIGKILLs the child the moment it has read the chosen number of acks (no
cleanup, no atexit, no flush), then repairs and rereads the WAL, so a
test can assert that no acked record was lost and no torn frame
applied. Record ids are ``100000 + k``.

The child journals on the host only: it imports numpy and the WAL, not
torch, so it starts in well under a second.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Dict, List, Tuple

from raft_tpu_torch import errors

__all__ = ["main", "run_crash_ingest_cycle"]


def main(argv=None) -> int:
    """The scripted ingest victim (see the module docstring)."""
    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) != 5:
        print("usage: python -m raft_tpu_torch.testing.crash <wal_dir> <n> "
              "<d> <seed> <flush_ms>", file=sys.stderr)
        return 64
    wal_dir = args[0]
    n, d, seed = int(args[1]), int(args[2]), int(args[3])
    flush_ms = float(args[4])

    import numpy as np

    from raft_tpu_torch.durability import wal

    rng = np.random.default_rng(seed)
    writer = wal.WalWriter(wal_dir, flush_interval_s=flush_ms / 1e3,
                           name="crash-child")
    for k in range(n):
        vec = rng.standard_normal((1, d)).astype(np.float32)
        gid = 100000 + k
        payload = wal.encode_upsert(vec, np.asarray([gid], np.int32))
        ack = writer.append(wal.OP_UPSERT, payload, epoch=k)
        if not ack.wait(30.0):
            return 2   # fsync wedged: never claim durability
        print(f"ACK {ack.lsn} {gid}", flush=True)
    writer.close()
    return 0


def run_crash_ingest_cycle(wal_dir, *, kill_after_acks: int,
                           n_records: int = 64, d: int = 8,
                           seed: int = 0, flush_ms: float = 1.0,
                           timeout_s: float = 120.0) -> Dict[str, object]:
    """One seeded point of the kill-9 gate: crash a real ingest process
    mid-flight, recover, and report what survived.

    Returns ``acked`` — ``[(lsn, id), ...]`` the child proved durable
    before the kill (the contract: ``set(acked) <= set(recovered)``);
    ``recovered`` — ``[(lsn, id), ...]`` readable after the repair (it
    may exceed ``acked``, never ``submitted``); ``frontier`` — the
    highest intact LSN after the repair; ``submitted`` — ``n_records``;
    ``returncode`` — the child's (``-9`` when the kill landed, 0 when it
    finished first). With ``kill_after_acks >= n_records`` the child
    completes: the zero-fault leg of the same gate."""
    errors.expects(kill_after_acks >= 1,
                   "run_crash_ingest_cycle: kill_after_acks=%s < 1",
                   kill_after_acks)
    # the child imports this package from the same checkout
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "raft_tpu_torch.testing.crash",
           str(wal_dir), str(int(n_records)), str(int(d)),
           str(int(seed)), str(float(flush_ms))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env)
    watchdog = threading.Timer(timeout_s, proc.kill)
    watchdog.daemon = True
    watchdog.start()
    acked: List[Tuple[int, int]] = []
    try:
        assert proc.stdout is not None
        for line in proc.stdout:
            parts = line.split()
            if len(parts) != 3 or parts[0] != "ACK":
                continue
            acked.append((int(parts[1]), int(parts[2])))
            if len(acked) >= kill_after_acks:
                proc.kill()   # SIGKILL: no cleanup, no flush
                break
        proc.wait(timeout=timeout_s)
    finally:
        watchdog.cancel()
        if proc.poll() is None:  # pragma: no cover - watchdog race
            proc.kill()
            proc.wait(timeout=10.0)
    from raft_tpu_torch.durability import wal as _wal

    records, frontier = _wal.repair_wal(wal_dir, name="crash-cycle")
    recovered: List[Tuple[int, int]] = []
    for r in records:
        if r.op == _wal.OP_UPSERT:
            _vecs, ids = _wal.decode_upsert(r.payload)
            for gid in ids:
                recovered.append((int(r.lsn), int(gid)))
    return {
        "acked": acked,
        "recovered": recovered,
        "frontier": int(frontier),
        "submitted": int(n_records),
        "returncode": proc.returncode,
    }


if __name__ == "__main__":
    sys.exit(main())
