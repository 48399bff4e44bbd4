"""The self-healing supervisor row — the port of
``bench/bench_serving.py``'s ``self_heal_row``: one scripted kill ->
reroute -> heal -> reintegrate cycle against a live open-loop Zipf
stream through a :class:`~raft_tpu_torch.serving.ServingExecutor`, with
the :class:`~raft_tpu_torch.resilience.ServingSupervisor` doing all the
recovery.

The row builds its own R-way replicated sharded IVF-Flat index over the
communicator's ranks, wraps it for mutation (the heal runs
``recover_rank`` from an archive, then ``resync_rank``), and serves it
through a mutable-index cell behind a lock: the dispatch closure reads
the cell once a batch, the heal actions and the kill swap it, each swap
published only after the device work that made it is done (the
executor's stream reads the cell's tensors; the swap's own copies run on
the caller's stream). The schedule flips the scripted health truth the
supervisor's probe reads — and wrecks the dead rank's slabs at the kill,
so the reroute is load-bearing — and may oscillate another rank's probe
on the way.

The row returns measured numbers and the evidence the caller checks:
``detection_ms`` (kill -> confirmed down), ``route_convergence_ms``
(kill -> the route push), ``reintegration_ms`` (heal signal -> heal
done), the per-request p99 split by submit time into healthy / degraded
/ healed, the answers submitted after the route push that differ from
their template's healthy answer (distances bitwise, ids up to ties),
the requests submitted after the push and the requests that failed
(their submit or their answer raised; none is skipped silently),
and the chaos report of the schedule's invariants (route pushes never
above confirmed transitions, the route converging within a second of
each confirmed down, no engine fallback).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

__all__ = ["self_heal_row"]

# the reference row's settings: R = 2, 32 Zipf(1.1) templates, at most
# 65,536 rows, a monitor confirming after 2 agreeing probes with a 0.1 s
# cooldown, 16 delta rows a list
REPLICATION, N_TEMPLATES, ZIPF_S, MAX_ROWS = 2, 32, 1.1, 65_536
CONSECUTIVE, COOLDOWN_S, DELTA_CAP = 2, 0.1, 16


def _p99(ms) -> float:
    return float(np.percentile(np.asarray(ms), 99.0))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tie_bad(d, a, b) -> bool:
    """Whether ids ``b`` differ from ``a`` beyond equal-distance runs
    (interior runs must hold the same id set; the run cut by k is
    checked for distance only)."""
    k = d.shape[0]
    start = 0
    for end in range(1, k + 1):
        if end == k or d[end] != d[start]:
            if (end < k or start == 0) and (
                    set(a[start:end].tolist()) != set(b[start:end].tolist())):
                return True
            start = end
    return False


def self_heal_row(comms, x, qall, *, k: int = 10, n_probes: int = 16,
                  n_lists: int = 32, request_size: int = 8,
                  kill_at_s: float = 0.6, heal_at_s: float = 2.0,
                  duration_s: float = 4.0, oscillate=None,
                  seed: int = 43) -> dict:
    """One supervisor-driven kill -> reroute -> heal cycle (see the
    module docstring) over ``comms``' ranks: the first ``MAX_ROWS`` rows
    of ``x`` in an ``n_lists``-list index at ``REPLICATION``, requests of
    ``request_size`` rows from ``N_TEMPLATES`` Zipf(``ZIPF_S``)
    templates drawn from ``qall``, rank ``P // 2`` killed at
    ``kill_at_s`` and healed at ``heal_at_s`` (offsets into a
    ``duration_s`` schedule). ``oscillate=(rank, at_s, period_s,
    span_s)`` adds a flapping probe. The supervisor records into a fresh
    :class:`~raft_tpu_torch.obs.MetricRegistry`, read back as
    ``supervisor_heals_ok``. Returns the row (a dict; ``error`` set when
    the communicator has one rank)."""
    from raft_tpu_torch.comms import (
        mnmg_ivf_flat_build, mnmg_mutable_search, place_index, recover_rank,
        resync_rank, wrap_mnmg_mutable,
    )
    from raft_tpu_torch.obs.metrics import MetricRegistry
    from raft_tpu_torch.resilience import (
        FailoverPlan, HealActions, HealthMonitor, ReplicaPlacement,
        ServingSupervisor, ShardHealth,
    )
    from raft_tpu_torch.serving.executor import ServingExecutor
    from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat, save_index
    from raft_tpu_torch.testing import chaos, load

    row = {
        "engine": "ivf_flat", "scenario": "self_heal",
        "nq": int(request_size), "request_size": int(request_size),
        "zipf_s": ZIPF_S, "n_templates": N_TEMPLATES,
        "replication": REPLICATION,
    }
    n_ranks = comms.size
    if n_ranks < 2:
        row["error"] = "self_heal needs >= 2 ranks"
        return row
    row["n_ranks"] = n_ranks
    dev = comms.rank_device(comms.local_ranks[0])
    registry = MetricRegistry()
    xs = np.asarray(x, np.float32)[:MAX_ROWS]
    idx0 = mnmg_ivf_flat_build(
        comms, xs, IVFFlatParams(n_lists=n_lists, kmeans_n_iters=4,
                                 kmeans_init="random", seed=seed),
        metric="sqeuclidean")
    rep = place_index(comms, idx0, replication=REPLICATION)
    tmp = tempfile.mkdtemp(prefix="raft_tpu_torch_self_heal_")
    ckpt = os.path.join(tmp, "base.npz")
    try:
        save_index(rep, ckpt)
        cell = {"mw": wrap_mnmg_mutable(comms, rep, delta_cap=DELTA_CAP)}
        lock = threading.Lock()
        qcap = int(request_size)
        d = int(np.asarray(qall).shape[1])

        def dispatch(batch, shard_mask=None, failover=None, **_rt):
            with lock:
                mw = cell["mw"]
            return mnmg_mutable_search(
                comms, mw, batch, k, n_probes=n_probes, qcap=qcap,
                shard_mask=(shard_mask if shard_mask is not None
                            else np.ones(n_ranks, np.int32)),
                failover=failover)

        health = ShardHealth(n_ranks, telemetry=False)
        placement = ReplicaPlacement.of_index(rep)
        monitor = HealthMonitor(n_ranks, consecutive=CONSECUTIVE,
                                cooldown_s=COOLDOWN_S,
                                clock=time.perf_counter, telemetry=False)
        scripted = chaos.ScriptedHealth(n_ranks)
        dead = n_ranks // 2

        def publish(mw):
            # the swap's copies ran on this thread's stream; the
            # executor's stream reads the cell: publish when they are done
            _sync(dev)
            with lock:
                cell["mw"] = mw

        def recover(rank):
            with lock:
                mw = cell["mw"]
            rec = dataclasses.replace(
                mw, index=recover_rank(comms, mw.index, ckpt, rank))
            rec._id_loc = None
            publish(rec)

        def resync(rank):
            with lock:
                mw = cell["mw"]
            publish(resync_rank(comms, mw, rank))

        sup = ServingSupervisor(
            health, placement, scripted.probe,
            heal=HealActions(recover=recover, resync=resync),
            monitor=monitor, interval_s=0.01, step_deadline_s=120.0,
            registry=registry, clock=time.perf_counter, name="self-heal")

        # the templates, their healthy answers, and a warm splice (off
        # the clock, discarded), before any fault
        plan0 = FailoverPlan.load_balanced(placement, health)
        q_pool = np.asarray(qall, np.float32)
        rng = np.random.default_rng(seed)
        pool = np.stack([
            q_pool[rng.integers(0, q_pool.shape[0], size=request_size)]
            * np.float32(1.0 + 1e-6 * (t + 1))
            for t in range(N_TEMPLATES)])
        healthy = []
        for t in range(N_TEMPLATES):
            res = dispatch(torch.as_tensor(pool[t], device=dev),
                           shard_mask=health.mask(), failover=plan0)
            healthy.append((res.distances.cpu().numpy(),
                            res.ids.cpu().numpy()))
        recover_rank(comms, rep, ckpt, dead)
        lat = []
        for t in range(8):
            t0 = time.perf_counter()
            dispatch(torch.as_tensor(pool[t], device=dev),
                     shard_mask=health.mask(), failover=plan0)
            _sync(dev)
            lat.append(time.perf_counter() - t0)
        service_s = float(np.median(lat))
        rate_rps = max(4.0, 0.5 / max(service_s, 1e-4))
        n_requests = int(duration_s * rate_rps) + 1
        row.update(service_ms=service_s * 1e3, rate_rps=rate_rps,
                   n_requests=n_requests)

        ex = ServingExecutor(
            dispatch, (qcap,), dim=d, flush_age_s=0.0, max_in_flight=2,
            runtime_inputs={"shard_mask": health.mask(), "failover": plan0},
            device=dev, name="self-heal")
        sup.register(ex)
        pushes0 = sup.stats().route_pushes
        marks = {}

        def kill_fire():
            marks["kill"] = time.perf_counter()
            with lock:
                mw = cell["mw"]
            vs = mw.index.vectors_sorted.clone()
            si = mw.index.sorted_ids.clone()
            vs[dead] = 0
            si[dead] = 0
            wrecked = dataclasses.replace(mw, index=dataclasses.replace(
                mw.index, vectors_sorted=vs, sorted_ids=si))
            wrecked._id_loc = None
            publish(wrecked)
            scripted.set(dead, False)

        def heal_fire():
            marks["heal"] = time.perf_counter()
            scripted.set(dead, True)

        sched = chaos.ChaosSchedule(scripted=scripted, seed=seed)
        sched.at(kill_at_s, f"kill_rank_{dead}", kill_fire)
        if oscillate is not None:
            o_rank, o_at, o_period, o_span = oscillate
            sched.oscillate(o_at, o_rank, period_s=o_period,
                            duration_s=o_span)
        sched.at(heal_at_s, f"heal_rank_{dead}", heal_fire)

        arrivals = load.poisson_arrivals(
            rate_rps, n_requests, seed=seed, sizes=request_size,
            zipf_s=ZIPF_S, n_templates=N_TEMPLATES)
        done = {}
        dlock = threading.Lock()

        def submit(i, size):
            fut = ex.submit(pool[int(arrivals.template_ids[i])])

            def _stamp(_f, i=i):
                with dlock:
                    done[i] = time.perf_counter()

            fut.add_done_callback(_stamp)
            return fut

        out = {}

        def drive():
            out["res"], out["stamps"], out["lag"] = load.replay(
                arrivals, submit, clock=time.perf_counter)

        fallbacks0 = ivf_flat.ENGINE_FALLBACKS

        def n_confirms():
            return sum(1 for _, e, _ in sup.timeline()
                       if e == "confirmed_down")

        def n_pushes():
            return sup.stats().route_pushes - pushes0

        invariants = [
            chaos.BoundInvariant(
                "route-pushes-bounded-by-confirmed-transitions",
                lambda: n_pushes() - monitor.transition_count, 0),
            chaos.ConvergenceInvariant(
                "route-converges-within-deadline", n_confirms, n_pushes,
                deadline_s=1.0),
            chaos.BoundInvariant(
                "no-engine-fallback",
                lambda: ivf_flat.ENGINE_FALLBACKS - fallbacks0, 0),
        ]
        drv = threading.Thread(target=drive, daemon=True,
                               name="self-heal-load")
        drv.start()
        try:
            report = chaos.run_schedule(sched, duration_s=duration_s,
                                        invariants=invariants,
                                        tick=lambda t: sup.step())
            # settle: a slow host may cross the end mid-reintegration
            t_end = time.perf_counter() + 60.0
            while ((sup.stats().heals_ok < 1 or not health.all_up)
                   and time.perf_counter() < t_end):
                sup.step()
                time.sleep(0.005)
            drv.join(timeout=120.0)
        finally:
            ex.close()
            sup.close()
        row["chaos_ok"] = report.ok
        row["chaos_summary"] = report.summary()

        tl = sup.timeline()
        t_det = next((t for t, e, r in tl
                      if e == "confirmed_down" and r == dead), None)
        t_conv = next((t for t, e, _ in tl
                       if e == "route_pushed" and t >= marks["kill"]), None)
        t_heal_done = next((t for t, e, r in tl
                            if e == "heal_done" and r == dead), None)
        if t_det is not None:
            row["detection_ms"] = (t_det - marks["kill"]) * 1e3
        if t_conv is not None:
            row["route_convergence_ms"] = (t_conv - marks["kill"]) * 1e3
        if t_heal_done is not None and "heal" in marks:
            row["reintegration_ms"] = (t_heal_done - marks["heal"]) * 1e3

        phases = {"healthy": [], "degraded": [], "healed": []}
        n_after, bad, n_sub_after, failed = 0, 0, 0, 0
        stamps = out.get("stamps")
        for i, fut in enumerate(out.get("res", ())):
            t_sub = float(stamps[i])
            n_sub_after += t_conv is not None and t_sub >= t_conv
            if isinstance(fut, BaseException):
                failed += 1
                continue
            try:
                res = fut.result(timeout=120)
            except Exception:    # noqa: BLE001 — counted, the caller gates
                failed += 1
                continue
            while True:
                with dlock:
                    t_done = done.get(i)
                if t_done is not None:
                    break
                time.sleep(0.0002)
            if t_sub < marks["kill"]:
                phase = "healthy"
            elif t_heal_done is None or t_sub < t_heal_done:
                phase = "degraded"
            else:
                phase = "healed"
            phases[phase].append((t_done - t_sub) * 1e3)
            if t_conv is not None and t_sub >= t_conv:
                hd, hi = healthy[int(arrivals.template_ids[i])]
                n_after += 1
                got_d = np.asarray(res.distances)
                got_i = np.asarray(res.ids)
                if (got_d.tobytes() != hd.tobytes()
                        or any(_tie_bad(hd[r], hi[r], got_i[r])
                               for r in range(hd.shape[0]))):
                    bad += 1
        for phase, ms in phases.items():
            row[f"n_{phase}"] = len(ms)
            if len(ms) >= 5:
                row[f"p99_ms_{phase}"] = _p99(ms)
        row["answers_after_push"] = n_after
        row["answers_after_push_bad"] = bad
        row["submitted_after_push"] = n_sub_after
        row["failed_requests"] = failed
        st = sup.stats()
        row["route_pushes"] = st.route_pushes - pushes0
        row["heals_ok"] = st.heals_ok
        row["supervisor_heals_ok"] = registry.counter(
            "supervisor_heals_total", outcome="ok").value
        row["transitions"] = monitor.transition_count
        row["all_serving"] = bool(health.all_up and all(
            s == "serving" for s in st.states.values()))
        row["gen_lag_ms"] = out.get("lag", 0.0) * 1e3
        return row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
