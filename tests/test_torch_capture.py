"""PyTorch port of the SLO-triggered profile capture
(raft_tpu_torch.obs.capture.ProfileTrigger) against the JAX package's,
on the CPU.

``tests/test_obs.py``'s six ``TestProfileTrigger`` cases run on the
port's metrics with the same injected fake trace; then the same
observation script drives both packages' triggers (equal check results,
captures and counters), and one real capture writes a ``torch.profiler``
Chrome trace.
"""

import glob
import json
import time

import pytest
import torch

from raft_tpu_torch.obs import FlightRecorder, MetricRegistry, ProfileTrigger
from raft_tpu_torch.obs import metrics as obsm

torch.set_num_threads(1)


@pytest.fixture
def reg():
    return MetricRegistry()


@pytest.fixture(autouse=True)
def _obs_on():
    """Recording on (the default), whatever the suite's state."""
    prev = obsm.set_enabled(True)
    yield
    obsm.set_enabled(prev)


class _FakeTrace:
    def __init__(self):
        self.started = []
        self.stopped = 0

    def start(self, log_dir):
        self.started.append(log_dir)

    def stop(self):
        self.stopped += 1


class TestProfileTrigger:
    def _trigger(self, reg, fr=None, **kw):
        h = reg.histogram("e2e_ms")
        tr = _FakeTrace()
        slept = []
        trig = ProfileTrigger(
            h, threshold_ms=10.0, log_dir="/tmp/prof", consecutive=2,
            capture_s=0.25, max_captures=1, cooldown_s=60.0,
            registry=reg, recorder=fr, start=tr.start, stop=tr.stop,
            sleep=slept.append, clock=lambda: 100.0, **kw,
        )
        return h, tr, slept, trig

    def test_fires_after_consecutive_breaches_only(self, reg):
        fr = FlightRecorder(16)
        h, tr, slept, trig = self._trigger(reg, fr)
        for _ in range(10):
            h.observe(50.0)
        assert trig.check() is None and tr.started == []
        for _ in range(10):
            h.observe(50.0)
        assert trig.check() == "/tmp/prof"
        assert tr.started == ["/tmp/prof"] and tr.stopped == 1
        assert slept == [0.25]
        assert trig.captures == 1
        c = reg.counter("profile_captures_total", trigger="e2e_ms")
        assert c.value == 1
        ev = fr.events(event="profile_capture")
        assert ev and ev[0]["path"] == "/tmp/prof"
        assert ev[0]["breached_ms"] > 10.0

    def test_windowed_not_lifetime_quantile(self, reg):
        h, tr, _, trig = self._trigger(reg)
        for _ in range(100):
            h.observe(50.0)
        assert trig.check() is None          # breach 1
        for _ in range(100):
            h.observe(1.0)
        assert trig.check() is None and tr.started == []
        for _ in range(10):
            h.observe(50.0)
        assert trig.check() is None          # breach 1 again, not 2

    def test_no_traffic_carries_no_evidence(self, reg):
        h, tr, _, trig = self._trigger(reg)
        for _ in range(10):
            h.observe(50.0)
        assert trig.check() is None          # breach 1
        assert trig.check() is None          # empty window: no advance
        for _ in range(10):
            h.observe(50.0)
        assert trig.check() == "/tmp/prof"   # breach 2 -> fires

    def test_failed_capture_rolls_back_the_budget(self, reg):
        h = reg.histogram("e2e_ms", t="rollback")

        def refusing_start(_d):
            raise RuntimeError("profiler already started")

        tr = _FakeTrace()
        trig = ProfileTrigger(
            h, threshold_ms=10.0, log_dir="/tmp/prof", consecutive=1,
            capture_s=0.1, max_captures=1, cooldown_s=60.0,
            registry=reg, start=refusing_start, stop=tr.stop,
            sleep=lambda s: None, clock=lambda: 100.0,
        )
        for _ in range(10):
            h.observe(50.0)
        with pytest.raises(RuntimeError):
            trig.check()
        assert trig.captures == 0            # budget intact
        trig._start = tr.start
        for _ in range(10):
            h.observe(50.0)
        assert trig.check() == "/tmp/prof"
        assert trig.captures == 1

    def test_max_captures_bounds_the_storm(self, reg):
        h, tr, _, trig = self._trigger(reg)
        for _ in range(4):
            for _ in range(10):
                h.observe(50.0)
            trig.check()
        assert len(tr.started) == 1          # max_captures=1

    def test_watch_thread_runs_and_stops(self, reg):
        h, tr, _, trig = self._trigger(reg)
        trig.watch(interval_s=0.01)
        for _ in range(10):
            h.observe(50.0)
        time.sleep(0.05)
        for _ in range(10):
            h.observe(50.0)
        deadline = time.monotonic() + 2.0
        while not tr.started and time.monotonic() < deadline:
            time.sleep(0.01)
        trig.stop()
        assert tr.started == ["/tmp/prof"]


def test_same_script_same_decisions_as_jax():
    """One observation script into both packages' triggers (a fake clock
    that moves, so the cooldown is exercised): the same check results,
    captures and counter values."""
    from raft_tpu.obs import metrics as jmetrics
    from raft_tpu.obs.capture import ProfileTrigger as JTrigger

    script = [[50.0] * 10, [50.0] * 10, [], [1.0] * 30, [80.0] * 5,
              [80.0] * 5, [80.0] * 5, [3.0, 90.0] * 20, [90.0] * 9,
              [90.0] * 9, [90.0] * 9, [90.0] * 9]
    runs = []
    for Trigger, Registry in ((ProfileTrigger, MetricRegistry),
                              (JTrigger, jmetrics.MetricRegistry)):
        reg = Registry()
        h = reg.histogram("e2e_ms")
        tr = _FakeTrace()
        now = [0.0]
        trig = Trigger(h, threshold_ms=10.0, log_dir="/tmp/prof",
                       quantile=90.0, consecutive=2, capture_s=0.25,
                       max_captures=2, cooldown_s=15.0, registry=reg,
                       start=tr.start, stop=tr.stop, sleep=lambda s: None,
                       clock=lambda: now[0])
        out = []
        for window in script:
            for v in window:
                h.observe(v)
            now[0] += 5.0
            out.append((trig.check(), trig.window_quantile()))
        runs.append((out, trig.captures, list(trig.capture_paths),
                     reg.counter("profile_captures_total",
                                 trigger="e2e_ms").value))
    assert runs[0] == runs[1]
    assert runs[0][1] == 2


def test_real_capture_writes_a_chrome_trace(tmp_path, reg):
    """The default start / stop: a torch.profiler capture over the
    window, written as a Chrome trace under ``log_dir``."""
    h = reg.histogram("e2e_ms", t="real")
    trig = ProfileTrigger(h, threshold_ms=1.0, log_dir=str(tmp_path),
                          consecutive=1, capture_s=0.05, registry=reg)
    x = torch.ones(64, 64)

    def busy(_s):
        for _ in range(3):
            x @ x

    trig._sleep = busy
    h.observe(5.0)
    assert trig.check() == str(tmp_path)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    h.observe(5.0)
    assert trig.check() is None             # max_captures=1
