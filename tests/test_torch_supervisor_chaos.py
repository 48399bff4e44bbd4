"""PyTorch port of the self-healing supervisor (raft_tpu_torch/resilience/
supervisor.py), the fault injectors (testing/faults.py) and the chaos
harness (testing/chaos.py) against the JAX package, on the CPU.

* The supervisor and chaos-engine cases of tests/test_chaos.py run the
  same script through BOTH packages on a fake clock — the monitor's
  debounce, the flap invariant, the heal pipeline's retry, rollback and
  resume, the thread-crash restart, the schedule engine and its
  checkers — and the port must behave as the JAX package does: the same
  assertions hold in each, and the traces (route pushes, transitions,
  states, timelines, heal-step calls) are equal.
* The file injectors give JAX's damage on the same archive (the same
  members damaged, the same bytes), ``inject_nonfinite`` / ``fail_rank``
  the same arrays; the readiness surrogates follow the port's protocol
  (``query()`` / ``.value``) and a deadline retries through them
  without rebuilding.
* End to end over the port's own P = 8 in-process index on the CPU: the
  supervisor drives recover -> resync while a writer keeps acking, the
  WAL-replay pipeline, and a scripted schedule (kill mid-ingest,
  straggler burst, heal, oscillating probe) against a live executor,
  its invariants asserted by the checker framework.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time
import types
import zipfile

import numpy as np
import pytest
import torch

import raft_tpu.errors as jerrors
import raft_tpu.resilience as jres
from raft_tpu.resilience.health import HealthProbe as JHealthProbe
from raft_tpu.resilience.health import HealthReport as JHealthReport
from raft_tpu.testing import chaos as jchaos
from raft_tpu.testing import faults as jfaults
from raft_tpu_torch import errors
from raft_tpu_torch import resilience as tres
from raft_tpu_torch.comms import (
    build_comms,
    mnmg_ivf_flat_build,
    mnmg_mutable_search,
    mnmg_upsert,
    place_index,
    recover_rank,
    resync_rank,
    wrap_mnmg_mutable,
)
from raft_tpu_torch.core.interruptible import (
    InterruptedException,
    Interruptible,
)
from raft_tpu_torch.obs import FlightRecorder
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.resilience import (
    STATE_QUARANTINED,
    STATE_RECOVERING,
    STATE_RESYNCING,
    STATE_SERVING,
    STATE_WARMING,
    FailoverPlan,
    HealActions,
    HealthMonitor,
    ReplicaPlacement,
    RetryPolicy,
    ServingSupervisor,
    ShardHealth,
    dispatch_with_deadline,
)
from raft_tpu_torch.resilience.health import HealthProbe, HealthReport
from raft_tpu_torch.serving import ServingExecutor
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    ivf_flat,
    ivf_flat_build,
    save_index,
)
from raft_tpu_torch.testing import chaos, crash, faults

torch.set_num_threads(1)

K = 5


def _ns(pkg):
    """One package's supervisor, monitor and chaos names."""
    if pkg == "jax":
        r, c, e = jres, jchaos, jerrors
        probe, report = JHealthProbe, JHealthReport
    else:
        r, c, e = tres, chaos, errors
        probe, report = HealthProbe, HealthReport
    return types.SimpleNamespace(
        ServingSupervisor=r.ServingSupervisor, HealActions=r.HealActions,
        HealthMonitor=r.HealthMonitor, ShardHealth=r.ShardHealth,
        ReplicaPlacement=r.ReplicaPlacement, RetryPolicy=r.RetryPolicy,
        SERVING=r.STATE_SERVING, QUARANTINED=r.STATE_QUARANTINED,
        chaos=c, errors=e, HealthProbe=probe, HealthReport=report)


PKGS = ("jax", "torch")


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class _RecordingExecutor:
    """set_runtime sink — counts the supervisor's route pushes."""

    def __init__(self):
        self.pushes = []

    def set_runtime(self, **updates):
        self.pushes.append(updates)


def _both(scenario):
    """Run ``scenario(ns)`` for each package; the traces must be equal."""
    traces = {pkg: scenario(_ns(pkg)) for pkg in PKGS}
    assert traces["torch"] == traces["jax"]
    return traces["torch"]


# ---------------------------------------------------------------------------
# HealthMonitor debounce
# ---------------------------------------------------------------------------

def _monitor_streaks(ns):
    m = ns.HealthMonitor(4, consecutive=3, cooldown_s=0.0, telemetry=False)
    out = [m.observe(1, v) for v in (False, False, True, False, False,
                                     False)]
    assert out[-1] == "down" and not m.is_up(1) and m.is_up(0)
    return out, m.transition_count


def _monitor_cooldown(ns):
    clk = _FakeClock()
    m = ns.HealthMonitor(2, consecutive=2, cooldown_s=1.0, clock=clk,
                         telemetry=False)
    out = [m.observe(0, False), m.observe(0, False)]
    out += [m.observe(0, True) for _ in range(3)]
    clk.advance(1.01)
    out.append(m.observe(0, True))      # the kept streak flips at once
    assert out == [None, "down", None, None, None, "up"]
    return out, m.transition_count


def _monitor_force(ns):
    clk = _FakeClock()
    m = ns.HealthMonitor(2, consecutive=1, cooldown_s=0.5, clock=clk,
                         telemetry=False)
    out = [m.observe(0, False)]
    clk.advance(1.0)
    out.append(m.observe(0, True))
    m.force(0, up=False)                # the rollback re-arm
    out += [m.is_up(0), m.transition_count, m.observe(0, True)]
    clk.advance(0.51)
    out.append(m.observe(0, True))
    assert out == ["down", "up", False, 2, None, "up"]
    return out


def _monitor_report(ns):
    m = ns.HealthMonitor(4, consecutive=1, cooldown_s=0.0, telemetry=False)
    rep = ns.HealthReport(probes={
        "allreduce": ns.HealthProbe(ok=True, seconds=0.01),
        "heartbeat": ns.HealthProbe(ok=False, seconds=0.01, ranks=(2,)),
    })
    a = m.observe_report(rep)
    rep2 = ns.HealthReport(probes={
        "allreduce": ns.HealthProbe(ok=False, seconds=0.01)})
    b = m.observe_report(rep2)
    assert a == {2: "down"} and set(b) == {0, 1, 3}
    return a, b


@pytest.mark.parametrize("scenario", [_monitor_streaks, _monitor_cooldown,
                                      _monitor_force, _monitor_report])
def test_health_monitor_as_jax(scenario):
    _both(scenario)


# ---------------------------------------------------------------------------
# The supervisor's state machine (fake executors, fake clock)
# ---------------------------------------------------------------------------

def _mini(ns, clk, scripted, *, n=8, consecutive=3, cooldown_s=10.0,
          heal=None, retry=None):
    health = ns.ShardHealth(n, telemetry=False)
    monitor = ns.HealthMonitor(n, consecutive=consecutive,
                               cooldown_s=cooldown_s, clock=clk,
                               telemetry=False)
    sup = ns.ServingSupervisor(
        health, ns.ReplicaPlacement.striped(n, 2), scripted.probe,
        heal=heal, monitor=monitor, retry=retry, clock=clk,
        sleep=clk.advance)
    return sup, health, monitor


def _route(push):
    return (np.asarray(push["shard_mask"]).tolist(),
            [int(r) for r in push["failover"].route])


def _flap(ns):
    """An oscillating probe never pushes; a confirmed transition pushes
    exactly once; the flap invariant as the checker spells it."""
    clk = _FakeClock()
    scripted = ns.chaos.ScriptedHealth(8)
    sup, health, monitor = _mini(ns, clk, scripted)
    ex = _RecordingExecutor()
    sup.register(ex)
    base = len(ex.pushes)
    for i in range(30):
        scripted.set(2, i % 2 == 0)
        sup.step()
        clk.advance(0.05)
    assert len(ex.pushes) == base and monitor.transition_count == 0
    scripted.set(2, False)
    for _ in range(5):
        sup.step()
        clk.advance(0.05)
    assert len(ex.pushes) == base + 1
    assert sup.state(2) == ns.QUARANTINED and not health.is_up(2)
    assert ex.pushes[-1]["failover"].fully_covered
    for i in range(30):
        scripted.set(2, i % 2 == 0)
        sup.step()
        clk.advance(0.05)
    clk.advance(11.0)
    scripted.set(2, True)
    for _ in range(5):
        sup.step()
        clk.advance(0.05)
    assert monitor.transition_count == 2 and len(ex.pushes) == base + 2
    assert sup.state(2) == ns.SERVING and health.is_up(2)
    flap = ns.chaos.BoundInvariant(
        "no-route-flap",
        lambda: (len(ex.pushes) - base) - monitor.transition_count, 0)
    flap.sample(clk.t)
    assert not flap.violations
    return ([_route(p) for p in ex.pushes], sup.timeline(),
            dataclasses.astuple(sup.stats()))


def _retry(ns):
    clk = _FakeClock()
    scripted = ns.chaos.ScriptedHealth(4)
    calls = {"resync": 0}

    def flaky_resync(rank):
        calls["resync"] += 1
        if calls["resync"] < 3:
            raise ns.errors.RaftTimeoutError("transient splice timeout")

    sup, health, _ = _mini(
        ns, clk, scripted, n=4, consecutive=1, cooldown_s=0.0,
        heal=ns.HealActions(resync=flaky_resync),
        retry=ns.RetryPolicy(max_attempts=3, base_delay_s=0.01))
    scripted.set(1, False)
    sup.step()
    scripted.set(1, True)
    sup.step()
    assert calls["resync"] == 3 and sup.state(1) == ns.SERVING
    assert sup.stats().heals_ok == 1 and sup.stats().heals_rolled_back == 0
    return calls, sup.timeline(), clk.t


def _rollback(ns):
    clk = _FakeClock()
    scripted = ns.chaos.ScriptedHealth(4)
    calls = {"recover": 0, "rollback": 0, "broken": True}

    def recover(rank):
        calls["recover"] += 1
        if calls["broken"]:
            raise ns.errors.CorruptIndexError("torn checkpoint")

    def rollback(rank):
        calls["rollback"] += 1

    sup, health, _ = _mini(
        ns, clk, scripted, n=4, consecutive=1, cooldown_s=0.0,
        heal=ns.HealActions(recover=recover, rollback=rollback),
        retry=ns.RetryPolicy(max_attempts=3, base_delay_s=0.01))
    ex = _RecordingExecutor()
    sup.register(ex)
    base = len(ex.pushes)
    scripted.set(2, False)
    sup.step()
    scripted.set(2, True)
    sup.step()
    # not retryable: one attempt, rollback, back to QUARANTINED, no push
    assert calls["recover"] == 1 and calls["rollback"] == 1
    assert sup.state(2) == ns.QUARANTINED and not health.is_up(2)
    assert sup.stats().heals_rolled_back == 1 and len(ex.pushes) == base + 1
    calls["broken"] = False
    sup.step()
    assert sup.state(2) == ns.SERVING and sup.stats().heals_ok == 1
    assert len(ex.pushes) == base + 2
    return dict(calls), [_route(p) for p in ex.pushes], sup.timeline()


def _resume(ns):
    class _Crash(BaseException):
        pass

    clk = _FakeClock()
    scripted = ns.chaos.ScriptedHealth(4)
    calls = {"recover": 0, "resync": 0, "crash": True}

    def recover(rank):
        calls["recover"] += 1

    def resync(rank):
        calls["resync"] += 1
        if calls["crash"]:
            calls["crash"] = False
            raise _Crash()

    sup, health, _ = _mini(
        ns, clk, scripted, n=4, consecutive=1, cooldown_s=0.0,
        heal=ns.HealActions(recover=recover, resync=resync))
    scripted.set(3, False)
    sup.step()
    scripted.set(3, True)
    with pytest.raises(_Crash):
        sup.step()
    assert calls["recover"] == 1 and sup.state(3) != ns.SERVING
    sup.step()                           # resumes after the recover step
    assert calls["recover"] == 1 and calls["resync"] == 2
    assert sup.state(3) == ns.SERVING and health.is_up(3)
    return dict(calls), sup.timeline()


@pytest.mark.parametrize("scenario", [_flap, _retry, _rollback, _resume])
def test_supervisor_as_jax(scenario):
    _both(scenario)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_thread_crash_surfaced_and_restartable():
    """A supervisor thread crash is counted in thread_uncaught_total
    (the port's crash excepthook) and start() restarts the loop from the
    object's state."""
    prev = obs_metrics.set_enabled(True)
    try:
        boom = {"on": False}

        def probe():
            if boom["on"]:
                raise RuntimeError("injected supervisor crash")
            return {r: True for r in range(4)}

        sup = ServingSupervisor(
            ShardHealth(4, telemetry=False), ReplicaPlacement.striped(4, 2),
            probe, interval_s=0.003, name="torch-sup-crash")
        sup.start()
        deadline = time.monotonic() + 10
        while sup.stats().ticks < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sup.stats().ticks >= 2
        boom["on"] = True
        while sup._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not sup._thread.is_alive()
        snap = obs_metrics.default_registry().snapshot()
        assert any(row["labels"].get("thread") == "torch-sup-crash"
                   for row in snap.get("thread_uncaught_total", []))
        boom["on"] = False
        ticks0 = sup.stats().ticks
        sup.start()
        while sup.stats().ticks <= ticks0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sup.stats().ticks > ticks0
        sup.close()
    finally:
        obs_metrics.set_enabled(prev)


def test_probe_shapes_and_metrics():
    """A HealthReport probe downs only its implicated ranks; a probe of
    another shape raises; the metrics name the state and the heals."""
    reg = obs_metrics.MetricRegistry()
    clk = _FakeClock()
    rep = {"r": HealthReport(probes={
        "heartbeat": HealthProbe(ok=False, seconds=0.01, ranks=(1,))})}
    sup = ServingSupervisor(
        ShardHealth(4, telemetry=False), ReplicaPlacement.striped(4, 2),
        lambda: rep["r"], monitor=HealthMonitor(
            4, consecutive=1, cooldown_s=0.0, clock=clk, telemetry=False),
        registry=reg, clock=clk, sleep=clk.advance)
    assert sup.step() == {1: "down"}
    assert reg.gauge("supervisor_state", rank=1).value == 1
    rep["r"] = {r: True for r in range(4)}
    sup.step()
    assert reg.counter("supervisor_heals_total", outcome="ok").value == 1
    assert reg.gauge("supervisor_state", rank=1).value == 0
    rep["r"] = [True] * 4
    with pytest.raises(errors.RaftException, match="probe"):
        sup.step()
    assert "heals_ok=1" in repr(sup)


# ---------------------------------------------------------------------------
# The schedule engine
# ---------------------------------------------------------------------------

def _engine_order(ns):
    clk = _FakeClock()
    fired = []
    sched = (ns.chaos.ChaosSchedule(seed=1)
             .at(0.03, "b", lambda: fired.append("b"))
             .at(0.01, "a", lambda: fired.append("a")))
    inv = ns.chaos.BoundInvariant("at-most-two", lambda: len(fired), 2)
    report = ns.chaos.run_schedule(sched, duration_s=0.05, invariants=[inv],
                                   check_interval_s=0.005, clock=clk,
                                   sleep=clk.advance)
    assert report.ok and fired == ["a", "b"]
    return report.fired, report.duration_s


def _engine_oscillate(ns):
    clk = _FakeClock()
    scripted = ns.chaos.ScriptedHealth(4)
    seen = []
    sched = ns.chaos.ChaosSchedule(scripted=scripted, seed=0)
    sched.oscillate(0.01, 2, period_s=0.01, duration_s=0.04)
    report = ns.chaos.run_schedule(
        sched, duration_s=0.08, tick=lambda t: seen.append(
            scripted.probe()[2]),
        check_interval_s=0.002, clock=clk, sleep=clk.advance)
    assert False in seen and True in seen and scripted.probe()[2] is True
    return seen, report.fired


def _engine_convergence(ns):
    trig, done = [0], [0]
    inv = ns.chaos.ConvergenceInvariant("conv", lambda: trig[0],
                                        lambda: done[0], 0.5)
    inv.sample(0.0)
    trig[0] = 1
    inv.sample(0.1)
    inv.sample(0.5)
    assert not inv.violations
    inv.sample(0.7)
    trig[0] = 2
    inv.sample(0.8)
    done[0] = 2
    inv.sample(0.9)
    inv.finish(1.0)
    assert len(inv.violations) == 1
    return [(v.t_s, v.invariant, v.message) for v in inv.violations]


def _engine_checkers(ns):
    state = {"ok": False}
    final = ns.chaos.FinalInvariant("final", lambda: state["ok"])
    final.sample(0.1)
    always = ns.chaos.AlwaysInvariant("always", lambda: state["ok"],
                                      detail=lambda: "not yet")
    always.sample(0.1)
    state["ok"] = True
    final.finish(0.2)
    always.finish(0.2)
    report = ns.chaos.ChaosReport(fired=((0.0, "x"),),
                                  violations=tuple(always.violations),
                                  duration_s=0.2)
    assert not final.violations and not report.ok
    return report.summary(), [v.message for v in always.violations]


def _engine_gate_and_crash(ns):
    calls = []

    def fn(x):
        calls.append(x)
        return x

    gate = ns.chaos.StragglerGate(fn, every=1, seconds=0.0)
    a = gate(1)
    gate.enable()
    gate(2)
    gate.disable()
    b = gate(3)
    assert a == 1 and b == 3 and gate.audit.calls == 1

    class _Store:
        def __init__(self):
            self.applied = []

        def apply_moves(self, moves, **kw):
            self.applied.append(moves)

    store = _Store()
    restore = ns.chaos.inject_worker_crash(store, times=2)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected fetcher"):
            store.apply_moves([(1, None)])
    store.apply_moves([(3, None)])
    restore()
    assert store.apply_moves.__self__ is store
    return calls, store.applied


@pytest.mark.parametrize("scenario", [
    _engine_order, _engine_oscillate, _engine_convergence,
    _engine_checkers, _engine_gate_and_crash])
def test_chaos_engine_as_jax(scenario):
    _both(scenario)


def test_kill9_composer_and_crash_leg(tmp_path):
    """``kill9`` SIGKILLs a subprocess at its offset; the kill-9 ingest
    cycle is the crash module's, re-exported, and one seeded point loses
    no acked record."""
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        sched = chaos.ChaosSchedule(seed=2).kill9(0.05, proc)
        report = chaos.run_schedule(sched, duration_s=0.1)
        assert [n for _, n in report.fired] == ["kill9"]
        assert proc.wait(timeout=30) == -9
    finally:
        if proc.poll() is None:
            proc.kill()
    assert chaos.run_crash_ingest_cycle is crash.run_crash_ingest_cycle
    r = chaos.run_crash_ingest_cycle(str(tmp_path / "w"), kill_after_acks=3,
                                     n_records=24, d=8, seed=5)
    assert r["returncode"] == -9 and len(r["acked"]) == 3
    assert set(r["acked"]) <= set(r["recovered"])


# ---------------------------------------------------------------------------
# The fault injectors
# ---------------------------------------------------------------------------

def _archive(path):
    rng = np.random.default_rng(0)
    np.savez(path, __header__=np.frombuffer(b'{"type": "x"}', np.uint8),
             sorted_ids=rng.integers(0, 1000, 500).astype(np.int32),
             centroids=rng.standard_normal((40, 8)).astype(np.float32),
             codes=rng.integers(0, 255, (300, 4)).astype(np.uint8))


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("field,seed,n_bytes",
                         [(None, 3, 1), ("centroids", 0, 5),
                          ("sorted_ids", 7, 2)])
def test_corrupt_bytes_as_jax(tmp_path, field, seed, n_bytes):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    _archive(a)
    _archive(b)
    ja = jfaults.corrupt_bytes(a, field=field, seed=seed, n_bytes=n_bytes)
    tb = faults.corrupt_bytes(b, field=field, seed=seed, n_bytes=n_bytes)
    assert ja == tb
    assert _members(a) == _members(b)
    with pytest.raises(ValueError, match="not in archive"):
        faults.corrupt_bytes(b, field="nope")


@pytest.mark.parametrize("mode,boundary", [("truncate", None),
                                           ("truncate", 1),
                                           ("duplicate", 2),
                                           ("duplicate", 0)])
def test_inject_partial_write_as_jax(tmp_path, mode, boundary):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    _archive(a)
    _archive(b)
    ja = jfaults.inject_partial_write(str(a), mode=mode, boundary=boundary)
    tb = faults.inject_partial_write(str(b), mode=mode, boundary=boundary)
    assert ja == tb
    assert os.path.getsize(a) == os.path.getsize(b)
    if mode == "duplicate":
        assert _members(a) == _members(b)
    else:
        with pytest.raises(zipfile.BadZipFile):
            zipfile.ZipFile(b)


def test_inject_partial_write_at_byte(tmp_path):
    p = tmp_path / "seg.log"
    p.write_bytes(bytes(range(200)))
    assert faults.inject_partial_write(str(p), at_byte=77) == "seg.log"
    assert p.read_bytes() == bytes(range(77))
    with pytest.raises(ValueError):
        faults.inject_partial_write(str(p), at_byte=500)
    with pytest.raises(ValueError):
        faults.inject_partial_write(str(p), mode="duplicate", at_byte=3)


def test_nonfinite_and_fail_rank_as_jax():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    for kind in ("nan", "inf", "-inf"):
        got = faults.inject_nonfinite(torch.as_tensor(x), [1, 4], kind=kind)
        np.testing.assert_array_equal(
            got, jfaults.inject_nonfinite(x, [1, 4], kind=kind))
    with pytest.raises(ValueError):
        faults.inject_nonfinite(x, [9])
    h = faults.fail_rank(8, 2, 5)
    np.testing.assert_array_equal(h.mask(), jfaults.fail_rank(8, 2, 5).mask())
    assert faults.fail_rank(h, 3) is h and not h.is_up(3)


def test_deadline_retry_without_rebuild():
    """Attempt 1 times out against the held-back identity; the retry
    re-dispatches it (one build, two executions) and returns the
    input."""
    fn, audit = faults.inject_delay(5.0, first_n=1)
    x = torch.arange(8.0)
    seen = []
    out = dispatch_with_deadline(
        fn, x, timeout_s=0.25,
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.01),
        on_retry=lambda a, e, s: seen.append((a, type(e).__name__)))
    np.testing.assert_array_equal(np.asarray(out), np.arange(8.0))
    assert (audit.traces, audit.dispatches, audit.calls) == (1, 2, 2)
    assert seen == [(1, "RaftTimeoutError")]
    slow, _ = faults.inject_delay(5.0)
    with pytest.raises(errors.RaftTimeoutError):
        dispatch_with_deadline(slow, x, timeout_s=0.1)


def test_delayed_ready_protocol_and_cancel():
    """``query()`` polls the host deadline and the wrapped work, never
    blocks; ``synchronize()`` blocks; ``.value`` is the result;
    ``cancel_after`` breaks a wait on it."""
    inner = {"done": False}

    class _Gate:
        def query(self):
            return inner["done"]

    v = faults.DelayedReady((torch.ones(3), _Gate()), time.monotonic())
    t0 = time.monotonic()
    assert not v.query() and time.monotonic() - t0 < 0.05
    inner["done"] = True
    assert v.query()
    w = faults.DelayedReady(torch.arange(3.0), time.monotonic() + 0.05)
    assert not w.query()
    assert w.synchronize() is w and w.query()
    np.testing.assert_array_equal(np.asarray(w), [0.0, 1.0, 2.0])
    slow = faults.DelayedReady(torch.zeros(2), time.monotonic() + 30.0)
    timer = faults.cancel_after(0.05)
    t0 = time.monotonic()
    with pytest.raises(InterruptedException):
        Interruptible.synchronize(slow)
    timer.cancel()
    assert time.monotonic() - t0 < 5.0
    wrapped, audit = faults.inject_straggler(lambda i: i, every=3,
                                             seconds=0.01)
    outs = [wrapped(i) for i in range(6)]
    assert audit.calls == 6 and audit.dispatches == 2
    assert isinstance(outs[2], faults.DelayedReady)
    assert not isinstance(outs[0], faults.DelayedReady)


# ---------------------------------------------------------------------------
# End to end over the port's P = 8 in-process index (CPU ranks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def comms8():
    return build_comms(["cpu"] * 8, timeout_s=120.0)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def replicated_r2(comms8, dataset):
    x, _ = dataset
    idx = mnmg_ivf_flat_build(
        comms8, x, IVFFlatParams(n_lists=8, kmeans_n_iters=3,
                                 kmeans_init="random", seed=2),
        metric="sqeuclidean")
    return place_index(comms8, idx, replication=2)


def _host(t):
    kw = {f.name: getattr(t, f.name).numpy() for f in dataclasses.fields(t)
          if f.init and isinstance(getattr(t, f.name), torch.Tensor)}
    return dataclasses.replace(t, **kw)


def _heal_actions(comms, cell, lock, health, ckpt):
    """The real reintegration actuators over a shared mutable-index
    cell. ``resync`` flips health up INSIDE its critical section, after
    the swapped-in state carries the donor's delta — so a writer that
    snapshots ``health.mask()`` under the same lock never acks a write
    that misses the healed copy."""

    def recover(rank):
        with lock:
            mw = cell["mw"]
            mw2 = dataclasses.replace(
                mw, index=recover_rank(comms, mw.index, ckpt, rank))
            mw2._id_loc = None
            cell["mw"] = mw2

    def resync(rank):
        with lock:
            cell["mw"] = resync_rank(comms, cell["mw"], rank)
            health.mark_up(rank)

    return HealActions(recover=recover, resync=resync)


def test_resync_racing_live_ingest_supervisor_driven(comms8, dataset,
                                                      replicated_r2,
                                                      tmp_path):
    """The supervisor drives recover -> resync while a writer keeps
    acking with ``alive=health.mask()``: no acked write is lost."""
    x, _ = dataset
    ckpt = tmp_path / "base.npz"
    save_index(_host(replicated_r2), ckpt)
    cell = {"mw": wrap_mnmg_mutable(comms8, replicated_r2, delta_cap=64)}
    lock = threading.Lock()
    health = ShardHealth(8, telemetry=False)
    scripted = chaos.ScriptedHealth(8)
    sup = ServingSupervisor(
        health, ReplicaPlacement.of_index(replicated_r2), scripted.probe,
        heal=_heal_actions(comms8, cell, lock, health, ckpt),
        monitor=HealthMonitor(8, consecutive=1, cooldown_s=0.0,
                              telemetry=False),
        step_deadline_s=120.0, name="torch-race")
    dead = 2
    far = (30.0 * x[:160]).astype(np.float32)
    acked = []

    def ingest():
        for i in range(40):
            ids = np.arange(21000 + 4 * i, 21004 + 4 * i, dtype=np.int32)
            with lock:
                mw2, acc = mnmg_upsert(comms8, cell["mw"],
                                       far[4 * i:4 * i + 4], ids,
                                       alive=health.mask())
                cell["mw"] = mw2
            acked.extend(int(v) for v in ids[np.asarray(acc)])
            time.sleep(0.002)

    writer = threading.Thread(target=ingest, daemon=True)
    writer.start()

    def settle(rank, state, timeout=120.0):
        deadline = time.monotonic() + timeout
        while sup.state(rank) != state and time.monotonic() < deadline:
            sup.step()
            time.sleep(0.002)
        assert sup.state(rank) == state

    sup.step()
    scripted.set(dead, False)
    settle(dead, STATE_QUARANTINED)
    time.sleep(0.05)
    scripted.set(dead, True)
    settle(dead, STATE_SERVING)
    writer.join(timeout=60)
    assert not writer.is_alive() and len(acked) >= 8
    assert health.all_up and sup.stats().heals_ok == 1
    mw = cell["mw"]
    ids_arr = np.array(sorted(set(acked)), dtype=np.int64)
    rows = far[ids_arr - 21000]
    for s in range(0, len(ids_arr), 12):
        chunk, idc = rows[s:s + 12], ids_arr[s:s + 12]
        pad = np.zeros((12 - chunk.shape[0], chunk.shape[1]), np.float32)
        res = mnmg_mutable_search(
            comms8, mw, torch.as_tensor(np.concatenate([chunk, pad])), K,
            n_probes=8, qcap=12, shard_mask=health.mask())
        assert float(res.coverage.min()) == 1.0
        np.testing.assert_array_equal(res.ids.numpy()[:chunk.shape[0], 0],
                                      idc)


def test_wal_replay_drives_the_recovering_pipeline(tmp_path, dataset):
    """A quarantined rank walks RECOVERING -> RESYNCING -> WARMING ->
    SERVING unassisted, with ``replay_wal`` doing a real
    ``recover_mutable`` first; the replayed state answers as the live
    one."""
    from raft_tpu_torch.durability import wal
    from raft_tpu_torch.spatial.ann import (
        mutable_search,
        wrap_mutable,
    )

    x, q = dataset
    index = ivf_flat_build(x, IVFFlatParams(n_lists=8, kmeans_n_iters=3,
                                            kmeans_init="random", seed=3),
                           metric="sqeuclidean", device="cpu")
    d = str(tmp_path / "w")
    ing = wal.DurableIngest(wrap_mutable(index, delta_cap=8),
                            wal.WalWriter(d, flush_interval_s=0.0005))
    ids = np.arange(9400, 9404, dtype=np.int32)
    assert ing.upsert(q[:4], ids).all()
    live = ing.mindex
    ing.close()
    clk = _FakeClock()
    cell, steps = {}, []
    fl = FlightRecorder()

    def replay_wal(rank):
        cell["mw"], _, _ = wal.recover_mutable(
            wrap_mutable(index, delta_cap=8), d, name="sup-rec")
        steps.append(("replay_wal", sup.state(rank)))

    def resync(rank):
        steps.append(("resync", sup.state(rank)))

    def warm(rank):
        steps.append(("warm", sup.state(rank)))

    scripted = chaos.ScriptedHealth(4)
    sup = ServingSupervisor(
        ShardHealth(4, telemetry=False), ReplicaPlacement.striped(4, 2),
        scripted.probe,
        heal=HealActions(replay_wal=replay_wal, resync=resync, warm=warm),
        monitor=HealthMonitor(4, consecutive=1, cooldown_s=0.0, clock=clk,
                              telemetry=False),
        clock=clk, sleep=clk.advance, flight=fl)
    scripted.set(1, False)
    sup.step()
    assert sup.state(1) == STATE_QUARANTINED
    scripted.set(1, True)
    sup.step()
    assert sup.state(1) == STATE_SERVING
    assert steps == [("replay_wal", STATE_RECOVERING),
                     ("resync", STATE_RESYNCING), ("warm", STATE_WARMING)]
    a = mutable_search(cell["mw"], q, K, n_probes=8, qcap=12)
    b = mutable_search(live, q, K, n_probes=8, qcap=12)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    trans = [e["state"] for e in fl.events(event="supervisor_transition")
             if e.get("rank") == 1]
    assert trans == [STATE_QUARANTINED, STATE_RECOVERING, STATE_RESYNCING,
                     STATE_WARMING, STATE_SERVING]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_scripted_chaos_schedule_end_to_end(comms8, dataset, replicated_r2,
                                            tmp_path):
    """Kill mid-ingest -> straggler burst -> heal -> oscillating probe,
    against one live executor, with no manual recovery call: coverage
    1.0 and bitwise the healthy answer whenever the loop has converged
    on the scripted truth, the route converging within its deadline,
    route pushes never above confirmed transitions, no engine fallback,
    no acked write lost, and every rank back to SERVING at drain."""
    x, q = dataset
    qcap = q.shape[0]
    ckpt = tmp_path / "base.npz"
    save_index(_host(replicated_r2), ckpt)
    cell = {"mw": wrap_mnmg_mutable(comms8, replicated_r2, delta_cap=64)}
    lock = threading.Lock()
    health = ShardHealth(8, telemetry=False)
    placement = ReplicaPlacement.of_index(replicated_r2)
    monitor = HealthMonitor(8, consecutive=2, cooldown_s=0.25,
                            telemetry=False)
    scripted = chaos.ScriptedHealth(8)

    def run(qq, shard_mask=None, failover=None):
        with lock:
            mw = cell["mw"]
        return mnmg_mutable_search(
            comms8, mw, qq, K, n_probes=8, qcap=qcap,
            shard_mask=(shard_mask if shard_mask is not None
                        else np.ones(8, np.int32)),
            failover=failover)

    plan0 = FailoverPlan.load_balanced(placement, health)
    ref = run(torch.as_tensor(q), shard_mask=health.mask(), failover=plan0)
    iref, vref = ref.ids.numpy(), ref.distances.numpy()
    fallbacks0 = ivf_flat.ENGINE_FALLBACKS
    gate = chaos.StragglerGate(run, every=2, seconds=0.02)
    recorder = FlightRecorder(2048, name="torch-chaos")
    ex = ServingExecutor(
        gate, (4, qcap), dim=q.shape[1], flush_age_s=0.0, max_in_flight=2,
        runtime_inputs={"shard_mask": health.mask(), "failover": plan0},
        flight=recorder, device="cpu")
    sup = ServingSupervisor(
        health, placement, scripted.probe,
        heal=_heal_actions(comms8, cell, lock, health, ckpt),
        monitor=monitor, interval_s=0.004, step_deadline_s=120.0,
        flight=recorder, name="torch-chaos-e2e")
    sup.register(ex)
    pushes0 = sup.stats().route_pushes
    dead = 3

    def wreck():
        # the dead rank's slabs are lost at the kill: only the replica and
        # the checkpoint hold its lists, so bit-identity proves the reroute
        with lock:
            mw = cell["mw"]
            vs, si = mw.index.vectors_sorted.clone(), \
                mw.index.sorted_ids.clone()
            vs[dead] = 0
            si[dead] = 0
            mw2 = dataclasses.replace(mw, index=dataclasses.replace(
                mw.index, vectors_sorted=vs, sorted_ids=si))
            mw2._id_loc = None
            cell["mw"] = mw2

    sched = chaos.ChaosSchedule(scripted=scripted, seed=18)
    sched.kill_rank(0.25, dead, wreck=wreck)
    sched.straggler_window(0.45, gate, duration_s=0.2)
    sched.heal_rank(0.9, dead)
    sched.oscillate(1.6, 5, period_s=0.05, duration_s=0.25)
    far = (30.0 * x[:160]).astype(np.float32)
    acked, results = [], []
    state = {"i": 0, "tick": 0}

    def ingest_batch():
        i = state["i"]
        if 4 * (i + 1) > far.shape[0]:
            return
        state["i"] = i + 1
        ids = np.arange(20000 + 4 * i, 20004 + 4 * i).astype(np.int32)
        with lock:
            mw2, acc = mnmg_upsert(comms8, cell["mw"], far[4 * i:4 * i + 4],
                                   ids, alive=health.mask())
            cell["mw"] = mw2
        acked.extend(int(v) for v in ids[np.asarray(acc)])

    def tick(t_s):
        state["tick"] += 1
        sup.step()
        if state["tick"] % 4 == 0:
            ingest_batch()
        truth = scripted.probe()
        converged = all(monitor.is_up(r) == truth[r] for r in range(8))
        results.append((converged, ex.submit(q).result(timeout=120)))

    def check_results():
        while results:
            converged, res = results.pop(0)
            if not converged:
                continue
            if float(np.min(res.coverage)) != 1.0:
                return False
            if not (np.array_equal(res.ids, iref)
                    and np.array_equal(res.distances, vref)):
                return False
        return True

    def n_down_confirms():
        return sum(1 for _, e, _ in sup.timeline() if e == "confirmed_down")

    def n_pushes():
        return sup.stats().route_pushes - pushes0

    def no_acked_lost():
        with lock:
            mw = cell["mw"]
        ids_arr = np.array(sorted(set(acked)), dtype=np.int64)
        rows = far[ids_arr - 20000]
        plan = FailoverPlan.load_balanced(placement, health)
        for s in range(0, len(ids_arr), qcap):
            chunk, idc = rows[s:s + qcap], ids_arr[s:s + qcap]
            pad = np.zeros((qcap - chunk.shape[0], chunk.shape[1]),
                           np.float32)
            res = mnmg_mutable_search(
                comms8, mw, torch.as_tensor(np.concatenate([chunk, pad])),
                K, n_probes=8, qcap=qcap, shard_mask=health.mask(),
                failover=plan)
            if float(res.coverage.min()) != 1.0 or not np.array_equal(
                    res.ids.numpy()[:chunk.shape[0], 0], idc):
                return False
        return True

    invariants = [
        chaos.AlwaysInvariant("coverage-1-and-bit-identity-when-converged",
                              check_results),
        chaos.ConvergenceInvariant("route-converges-within-deadline",
                                   n_down_confirms, n_pushes,
                                   deadline_s=1.0),
        chaos.BoundInvariant(
            "route-pushes-bounded-by-confirmed-transitions",
            lambda: n_pushes() - monitor.transition_count, 0),
        chaos.BoundInvariant(
            "no-engine-fallback",
            lambda: ivf_flat.ENGINE_FALLBACKS - fallbacks0, 0),
        chaos.FinalInvariant("zero-acked-writes-lost", no_acked_lost),
        chaos.FinalInvariant(
            "all-ranks-back-to-serving",
            lambda: health.all_up and all(
                s == STATE_SERVING for s in sup.stats().states.values())),
    ]
    report = chaos.run_schedule(sched, duration_s=4.0,
                                invariants=invariants, tick=tick,
                                check_interval_s=0.002)
    ex.close()
    sup.close()
    assert report.ok, report.summary()
    assert n_down_confirms() >= 1 and sup.stats().heals_ok >= 1
    assert len(acked) >= 8 and state["tick"] >= 10
    assert gate.audit.calls >= 1
    assert recorder.events(event="supervisor_route_push")
    assert recorder.events(event="supervisor_heal_step")


def test_self_heal_row_tiny_config(comms8, dataset):
    """The self-heal row end to end at a tiny CPU config, a flapping
    probe included: the acceptance stamps present and ordered, no
    request failed, every request submitted after the route push
    answered with its template's healthy answer, one heal, every rank
    back to SERVING, the schedule's invariants held."""
    from raft_tpu_torch.testing.heal_rows import self_heal_row

    x, q = dataset
    row = self_heal_row(comms8, x, q, k=K, n_probes=8, n_lists=8,
                        request_size=4, kill_at_s=0.4, heal_at_s=1.2,
                        duration_s=2.5, oscillate=(1, 0.8, 0.02, 0.1))
    assert row["scenario"] == "self_heal" and "error" not in row
    for key in ("detection_ms", "route_convergence_ms", "reintegration_ms"):
        assert row[key] >= 0.0, (key, row[key])
    assert row["route_convergence_ms"] >= row["detection_ms"]
    assert row["failed_requests"] == 0
    assert row["answers_after_push"] >= 1
    assert row["answers_after_push"] == row["submitted_after_push"]
    assert row["answers_after_push_bad"] == 0
    assert row["heals_ok"] >= 1 and row["all_serving"]
    assert 1 <= row["route_pushes"] <= row["transitions"]
    assert row["chaos_ok"], row["chaos_summary"]
