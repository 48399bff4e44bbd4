"""The harness's spans and its one profiler capture.

Spans are the harness's own, around its calls into each layer of the
port: a host-clock interval always, and a ``torch.profiler``
``record_function`` range while the capture runs. The capture covers the
last part of a traced run's window (``trace_seconds`` of the mix), once
per process; the spans and counters that are read from the host clock
are taken before it starts, so the profiler's own cost stays out of them.
The trace is kept in memory and reduced here: the device's busy time (the
union of its activity intervals, as ``tools/profile_grouped.py``'s
``_busy_us`` takes it), the device time of the kernels launched inside
each span, the kernels that took most time, and the idle gaps between
device activity by the harness span the host was in.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import threading
import time

import torch

NO_SPAN = "no harness span"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def merged(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def op_name(name: str, limit: int = 160) -> str:
    """A device operation's name without its parameter list and return
    type, cut to ``limit`` characters."""
    depth, end = 0, len(name)
    for i in range(len(name) - 1, -1, -1):
        c = name[i]
        if c == ")":
            depth += 1
        elif c == "(":
            depth -= 1
            if depth == 0:
                end = i
                break
    head = name[:end] if end > 0 else name
    if head.startswith("void "):
        head = head[5:]
    return head[:limit]


def idle_pct(capture: dict | None) -> float | None:
    """The capture's device idle share, in percent."""
    if not capture or capture["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - capture["busy_s"] / capture["window_s"])


def gaps_by_span(busy: list, spans: list) -> dict:
    """Seconds of device idle between merged busy intervals, by the
    innermost harness span (latest start) that holds each gap's midpoint."""
    spans = sorted(spans)                     # (start, end, name)
    out: dict = collections.defaultdict(float)
    active: list = []                         # heap of (end, -start, name)
    j = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        while j < len(spans) and spans[j][0] <= mid:
            heapq.heappush(active, (spans[j][1], -spans[j][0], spans[j][2]))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = max(active, key=lambda t: -t[1])[2] if active else NO_SPAN
        out[name] += (b - a) / 1e6
    return out


class Trace:
    """Host-clock spans for a run, and (``enabled``) one profiler capture
    started by a loop at its chosen instant."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.active = False
        self.started = False
        self.t_start = self.t_stop = None
        self._prof = None
        self._lock = threading.Lock()
        self.host: dict = collections.defaultdict(list)     # name -> [(t0, t1)]
        self.kept: dict = collections.defaultdict(list)     # name -> [inputs]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if not self.enabled or self.started:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.started = True
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t_start = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        self._sync()
        self.t_stop = time.perf_counter()
        self.active = False
        self._prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.active:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        t1 = time.perf_counter()
        with self._lock:
            self.host[name].append((t0, t1))

    def keep(self, name: str, inputs) -> None:
        """Hold a launch's inputs while the capture runs, for its counts."""
        if self.active:
            with self._lock:
                self.kept[name].append(inputs)

    def host_durations(self, name: str, t_from: float = float("-inf")) -> list:
        """Durations (s) of the spans ``name`` that started at ``t_from`` or
        later and ended before the capture started."""
        with self._lock:
            spans = list(self.host.get(name, ()))
        t_cut = self.t_start if self.t_start is not None else float("inf")
        return [t1 - t0 for t0, t1 in spans if t0 >= t_from and t1 <= t_cut]

    def summary(self) -> dict | None:
        """The capture reduced: window_s, busy_s, device seconds by harness
        span, top device operations and idle gaps by span; None without a
        capture."""
        if self._prof is None:
            return None
        events = self._prof.events()
        device_events, spans = [], []
        span_device_us = collections.defaultdict(float)
        for e in events:
            mine = e.name.startswith("bench.")
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if mine:
                    # the device-side range of a harness span: from the
                    # first to the last kernel launched inside it
                    span_device_us[e.name] += e.time_range.end - e.time_range.start
                else:
                    device_events.append(e)
            elif mine:
                spans.append((e.time_range.start, e.time_range.end, e.name))
        intervals = [(e.time_range.start, e.time_range.end) for e in device_events]
        by_op = collections.defaultdict(float)
        for e in device_events:
            by_op[op_name(e.name)] += (e.time_range.end - e.time_range.start) / 1e6
        gaps = gaps_by_span(merged(intervals), spans)
        top = lambda d: [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {
            "window_s": self.t_stop - self.t_start,
            "busy_s": busy_us(intervals) / 1e6,
            "span_device_s": {n: v / 1e6 for n, v in span_device_us.items()},
            "device_ops": top(by_op),
            "idle_gaps": top(gaps),
            "n_device_events": len(device_events),
        }
