"""The mixed read/write and durable-ingest rows — the port of
``bench/bench_serving.py``'s ``mixed_ingest_row`` and
``durable_ingest_row``, over the port's mutation tier
(:mod:`raft_tpu_torch.spatial.ann.mutation`) and WAL
(:mod:`raft_tpu_torch.durability.wal`).

Both rows return dicts of measured numbers; they assert nothing about
rates (timing depends on the host). Throughputs come from
:func:`~raft_tpu_torch.serving.open_loop.chained_dispatch_stats`, as the
open-loop row's program rate does.
"""

from __future__ import annotations

import math
import os
import tempfile
import time

import numpy as np
import torch

from raft_tpu_torch.serving.open_loop import _sync, chained_dispatch_stats

__all__ = ["durable_ingest_row", "mixed_ingest_row"]


def _ingest_rows(qb, ingest_batch: int):
    """``ingest_batch`` rows made by tiling the query batch."""
    return qb.repeat(math.ceil(ingest_batch / qb.shape[0]), 1)[:ingest_batch]


def mixed_ingest_row(idx, qb, *, k: int = 10, n_probes: int = 16,
                     ingest_batch: int = 256, delta_cap: int = 64,
                     chain=(2, 8), escalate: int = 1) -> dict:
    """The sustained mixed read/write row over an IVF-Flat index ``idx``
    and a query batch ``qb``: search queries/s while every dispatch also
    ingests an ``ingest_batch``-row upsert into the mutable tier
    (``mixed_search_qps``), beside the frozen index's queries/s at the
    same configuration (``frozen_qps``, so ``qps_ratio_vs_frozen`` prices
    the whole tier: tombstone fold, delta scan and ingest), the ingest
    program alone (``ingest_qps``, rows/s), and two latencies measured
    through the acked path: ``upsert_visible_ms`` (ack one batch whose
    first row is the probe query, then serve it back as its own top-1)
    and ``delete_masked_ms`` (delete it, serve, it is gone).

    The three throughputs are chained-dispatch quotients; the ingest and
    mixed chains run ``_upsert_impl`` without an ack (state threaded
    through, no host sync). A delta that fills up over a long chain
    rejects through the same program, so the quotient is unaffected."""
    from raft_tpu_torch.spatial.ann.ivf_flat import ivf_flat_search_grouped
    from raft_tpu_torch.spatial.ann.mutation import (
        _upsert_impl, _with, delete, mutable_search, mutable_warmup, upsert,
        wrap_mutable,
    )

    dev = idx.device
    qb = torch.as_tensor(qb, device=dev).float()
    nq = qb.shape[0]
    mw = wrap_mutable(idx, delta_cap=delta_cap)
    qcap = mutable_warmup(mw, nq, k=k, n_probes=n_probes,
                          ingest_batch=ingest_batch)
    row = {
        "engine": "ivf_flat", "scenario": "mixed_ingest", "nq": int(nq),
        "ingest_batch": int(ingest_batch), "qcap": int(qcap),
    }

    # frozen-index reference: the plain engine at the identical config
    idx.warmup(nq, k=k, n_probes=n_probes, qcap=qcap)

    def run_frozen(qq):
        return ivf_flat_search_grouped(idx, qq, k, n_probes=n_probes,
                                       qcap=qcap)

    st_f = chained_dispatch_stats(
        lambda s: qb * (1.0 + 1e-6 * s), run_frozen,
        n1=chain[0], n2=chain[1], escalate=escalate, device=dev,
    )

    # ingest only: the upsert program, state threaded through a cell
    ing_ids = torch.arange(10_000_000, 10_000_000 + ingest_batch,
                           dtype=torch.int32, device=dev)
    cell = {"delta": mw.delta, "rm": mw.row_mask}

    def run_ingest(vb):
        nd, nrm, acc, _, _ = _upsert_impl(
            idx.centroids, cell["delta"], cell["rm"], mw.id_to_pos, vb,
            ing_ids, mw.canon)
        cell["delta"], cell["rm"] = nd, nrm
        return acc

    vb0 = _ingest_rows(qb, ingest_batch)
    run_ingest(vb0)
    st_i = chained_dispatch_stats(
        lambda s: vb0 * (1.0 + 1e-6 * s), run_ingest,
        n1=chain[0], n2=chain[1], escalate=escalate, device=dev,
    )

    # mixed: every dispatch ingests one batch AND serves one search
    cell["delta"], cell["rm"] = mw.delta, mw.row_mask

    def run_mixed(qq):
        nd, nrm, _, _, _ = _upsert_impl(
            idx.centroids, cell["delta"], cell["rm"], mw.id_to_pos,
            _ingest_rows(qq, ingest_batch), ing_ids, mw.canon)
        cell["delta"], cell["rm"] = nd, nrm
        cur = _with(mw, delta=nd, row_mask=nrm)
        return mutable_search(cur, qq, k, n_probes=n_probes, qcap=qcap)

    run_mixed(qb)
    st_m = chained_dispatch_stats(
        lambda s: qb * (1.0 + 1e-6 * s), run_mixed,
        n1=chain[0], n2=chain[1], escalate=escalate, device=dev,
    )

    if st_f is not None:
        row["frozen_qps"] = nq / (st_f["ms"] / 1e3)
    if st_i is not None:
        row["ingest_qps"] = ingest_batch / (st_i["ms"] / 1e3)
    if st_m is not None:
        row["mixed_search_qps"] = nq / (st_m["ms"] / 1e3)
        row["spread"] = st_m["spread"]
        row["repeats"] = st_m["repeats"]
        row["escalations"] = st_m.get("escalations", 0)
        if st_f is not None:
            row["qps_ratio_vs_frozen"] = (row["mixed_search_qps"]
                                          / row["frozen_qps"])
    if st_f is None and st_m is None:
        row["error"] = "jitter-dominated"
        return row

    # upsert -> visible, on a warmed 1-row search and 1-row delete
    mw2 = wrap_mutable(idx, delta_cap=delta_cap)
    qc1 = mutable_warmup(mw2, 1, k=k, n_probes=n_probes)
    delete(mw2, np.array([-1], np.int32))
    probe = qb[:1] * 1.001
    vis_batch = torch.cat([probe, vb0[1:]])
    vis_ids = np.arange(20_000_000, 20_000_000 + ingest_batch,
                        dtype=np.int32)
    _sync(dev)
    t0 = time.perf_counter()
    mw3, acc = upsert(mw2, vis_batch, vis_ids)
    iv = mutable_search(mw3, probe, k, n_probes=n_probes,
                        qcap=qc1)[1].cpu().numpy()
    vis_ms = (time.perf_counter() - t0) * 1e3
    if bool(acc[0]) and int(iv[0, 0]) == int(vis_ids[0]):
        row["upsert_visible_ms"] = vis_ms
    # delete -> masked: tombstone it and serve; the row must be gone
    t0 = time.perf_counter()
    mw4, found = delete(mw3, vis_ids[:1])
    iv2 = mutable_search(mw4, probe, k, n_probes=n_probes,
                         qcap=qc1)[1].cpu().numpy()
    del_ms = (time.perf_counter() - t0) * 1e3
    if bool(found[0]) and int(vis_ids[0]) not in iv2[0].tolist():
        row["delete_masked_ms"] = del_ms
    return row


def durable_ingest_row(idx, qb, *, ingest_batch: int = 128,
                       n_batches: int = 24, delta_cap: int = 64,
                       fsync_intervals_ms=(0.0, 2.0)) -> dict:
    """The durable-WAL ingest row: acked-ingest rows/s through
    :class:`~raft_tpu_torch.durability.wal.DurableIngest` (journal, apply
    and an fsync-durable ack per batch) beside the non-durable arm (the
    same acked ``upsert``, no journal), so ``durability_ratio`` prices
    the WAL alone: encode, group commit and fsync wait.

    ``fsync_intervals_ms`` sweeps the group-commit flush interval (0 =
    flush at once); ``durable_qps`` / ``fsync_interval_ms`` /
    ``fsync_p50_ms`` / ``wal_mb_per_s`` come from the best interval and
    the whole sweep is in ``fsync_sweep``. Each WAL lives in a temporary
    directory removed with the row; every batch has fresh ids."""
    from raft_tpu_torch.durability import wal as wal_mod
    from raft_tpu_torch.spatial.ann.mutation import upsert, wrap_mutable

    dev = idx.device
    qb = torch.as_tensor(qb, device=dev).float()
    vb0 = _ingest_rows(qb, ingest_batch).cpu().numpy()
    row = {
        "engine": "ivf_flat", "scenario": "durable_ingest",
        "ingest_batch": int(ingest_batch), "n_batches": int(n_batches),
    }

    def batches(base):
        for b in range(n_batches):
            ids = np.arange(base + b * ingest_batch,
                            base + (b + 1) * ingest_batch, dtype=np.int32)
            yield vb0 * np.float32(1.0 + 1e-6 * (b + 1)), ids

    # non-durable arm: the same acked upsert (one host copy per batch)
    mw = wrap_mutable(idx, delta_cap=delta_cap)
    upsert(mw, vb0, np.arange(ingest_batch, dtype=np.int32))    # warm
    t0 = time.perf_counter()
    for vb, ids in batches(30_000_000):
        mw, _ = upsert(mw, vb, ids)
    nd_s = time.perf_counter() - t0
    row["nondurable_qps"] = n_batches * ingest_batch / nd_s

    # durable arm, one run per swept fsync interval
    sweep = []
    for iv_ms in fsync_intervals_ms:
        fsync_ms = []

        def timed_fsync(fd, _lat=fsync_ms):
            t = time.perf_counter()
            os.fsync(fd)
            _lat.append((time.perf_counter() - t) * 1e3)

        with tempfile.TemporaryDirectory() as td:
            w = wal_mod.WalWriter(td, flush_interval_s=iv_ms / 1e3,
                                  name="bench-wal", fsync=timed_fsync)
            ing = wal_mod.DurableIngest(
                wrap_mutable(idx, delta_cap=delta_cap), w)
            ing.upsert(vb0, np.arange(ingest_batch, dtype=np.int32))
            fsync_ms.clear()
            t0 = time.perf_counter()
            for vb, ids in batches(40_000_000):
                ing.upsert(vb, ids)
            du_s = time.perf_counter() - t0
            wal_bytes = sum(os.path.getsize(s)
                            for s in wal_mod.segment_paths(td))
            ing.close()
        sweep.append({
            "fsync_interval_ms": float(iv_ms),
            "durable_qps": n_batches * ingest_batch / du_s,
            "fsync_p50_ms": (float(np.median(fsync_ms)) if fsync_ms
                             else 0.0),
            "n_fsyncs": len(fsync_ms),
            "wal_mb_per_s": wal_bytes / du_s / 1e6,
        })

    best = max(sweep, key=lambda s: s["durable_qps"])
    row.update({key: best[key] for key in (
        "durable_qps", "fsync_interval_ms", "fsync_p50_ms", "wal_mb_per_s",
    )})
    row["durability_ratio"] = row["durable_qps"] / row["nondurable_qps"]
    row["fsync_sweep"] = sweep
    return row
