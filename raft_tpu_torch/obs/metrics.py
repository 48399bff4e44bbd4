"""Process-wide runtime metrics: counters, gauges, log2 latency
histograms — the port of ``raft_tpu/obs/metrics.py`` (pure Python, same
behaviour and the same exposition format).

The reference library's observability surface stops at NVTX ranges
(cpp/include/raft/core/nvtx.hpp): you can SEE a range on a profile you
captured by hand, but a serving tier at the ROADMAP's design point
(millions of users, bounded p99) needs numbers it can read while
serving — live shed rates, per-stage latency quantiles, delta fill,
dropped probe pairs. This module is that layer
(docs/observability.md):

* :class:`MetricRegistry` — the process-wide home of every series.
  A series is ``(name, frozenset(labels.items()))``: the same name with
  different labels (``stage="demux"``, ``bucket=8``) is a different
  series, exactly the Prometheus data model. Creation takes the
  registry lock ONCE; the returned instrument handle is cached by the
  caller and every hot-path update touches only the instrument's own
  lock (lock-cheap: ~100 ns under CPython, nothing global).
* :class:`Counter` / :class:`Gauge` — monotonic events and
  point-in-time levels.
* :class:`Histogram` — FIXED log2 buckets (one bucket per power of two
  between ``2**LOG2_LO`` and ``2**LOG2_HI``, plus under/overflow), so
  an observation is one ``frexp`` + one array increment and the
  streaming p50/p95/p99 are readable at ANY instant by walking ~50
  ints. Quantiles are linearly interpolated inside the winning bucket
  — the worst-case relative error of a log2 bucket is 2x, and the
  serving assertions that need exactness (bit-identity, zero-retrace)
  never read a histogram.
* Output surfaces: :meth:`MetricRegistry.snapshot` (plain dicts),
  :meth:`MetricRegistry.text_snapshot` (operator-readable),
  :meth:`MetricRegistry.exposition` (Prometheus text format, scrape it
  or dump it), and :meth:`MetricRegistry.start_emitter` (a daemon
  thread appending one JSON line per interval — the poor host's
  time-series database).
* :meth:`Counter.inc_deferred` — a count that is still on the device
  (the IVF searches' dropped (query, probe) pairs,
  :mod:`raft_tpu_torch.spatial.ann.search_obs`), folded into the
  counter when it is read, so recording it adds no host sync.

Everything honors the global enable gate: ``RAFT_TPU_OBS=off`` (or
``0``/``false``) in the environment, or :func:`set_enabled`, turns
every ``inc``/``set``/``observe``/``record`` into an attribute-load +
return — measured as ``obs_overhead_pct`` in the open-loop row
(:mod:`raft_tpu_torch.serving.open_loop`).

Every recorder call runs on the host and waits for no device: thread
loops, demux tails, the searches' counts.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

from raft_tpu_torch import errors

__all__ = [
    "MetricRegistry", "Counter", "Gauge", "Histogram",
    "default_registry", "enabled", "set_enabled",
    "quantile_from_counts", "merged_quantile",
]


def _env_enabled() -> bool:
    return os.environ.get("RAFT_TPU_OBS", "on").strip().lower() not in (
        "off", "0", "false", "no",
    )


# the ONE process-wide gate every instrument checks before touching its
# lock: a module-level list cell so instruments share it by reference
# (rebinding a bare bool would strand handles created earlier)
_ENABLED: List[bool] = [_env_enabled()]


def enabled() -> bool:
    """Is metric recording globally enabled? (``RAFT_TPU_OBS`` env at
    import; :func:`set_enabled` at runtime.)"""
    return _ENABLED[0]


def set_enabled(on: bool) -> bool:
    """Flip the global recording gate; returns the PREVIOUS state (so
    callers — the overhead bench, tests — can restore it)."""
    prev = _ENABLED[0]
    _ENABLED[0] = bool(on)
    return prev


def _label_key(labels: Mapping[str, Any]) -> frozenset:
    return frozenset((k, str(v)) for k, v in labels.items())


class _Instrument:
    """Shared shell: identity + the cheap enabled check."""

    __slots__ = ("name", "labels", "_lock")

    kind = "untyped"

    def __init__(self, name: str, labels: Mapping[str, str]):
        self.name = name
        self.labels = dict(labels)
        # deliberately a PLAIN lock, never lockcheck.make_lock: the
        # instrument lock is the terminal leaf of the lock-order graph
        # (everything may feed metrics while holding its own lock), and
        # the TracedLock release path itself observes lock_hold_ms —
        # tracing this lock would recurse through that feed
        self._lock = threading.Lock()

    def label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(
            f'{k}="{v}"' for k, v in sorted(self.labels.items())
        )
        return "{" + inner + "}"

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.name}"
                f"{self.label_str()})")


class Counter(_Instrument):
    """A monotonic event count. ``inc(n)`` adds a host count;
    ``inc_deferred(t)`` adds one still on a device."""

    __slots__ = ("_value", "_pending")

    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0
        self._pending: Dict[Any, Any] = {}     # device -> summed count

    def inc(self, n: int = 1) -> None:
        if not _ENABLED[0]:
            return
        with self._lock:
            self._value += n

    def inc_deferred(self, n) -> None:
        """Add a count that is still on its device (a 0-d integer
        tensor): it stays there, summed per device, and is folded into
        :attr:`value` when the value is read, so the caller adds no host
        sync."""
        if not _ENABLED[0]:
            return
        key = getattr(n, "device", None)
        with self._lock:
            acc = self._pending.get(key)
            self._pending[key] = n if acc is None else acc + n

    @property
    def value(self) -> int:
        with self._lock:
            pending, self._pending = self._pending, {}
        # read the device counts outside the lock: each read waits for
        # its device
        folded = sum(int(n) for n in pending.values())
        with self._lock:
            self._value += folded
            return self._value


class Gauge(_Instrument):
    """A point-in-time level: ``set`` to a value, ``add`` a delta."""

    __slots__ = ("_value",)

    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not _ENABLED[0]:
            return
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        if not _ENABLED[0]:
            return
        with self._lock:
            self._value += float(dv)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


# histogram bucket geometry: bucket 0 is the underflow [0, 2**LOG2_LO),
# bucket i (1 <= i <= LOG2_HI-LOG2_LO) spans one octave
# [2**(LOG2_LO+i-1), 2**(LOG2_LO+i)), and the last bucket is the
# overflow [2**LOG2_HI, inf). In milliseconds (the serving unit) that
# spans ~1 µs to ~4.6 hours — no serving latency falls off either end.
LOG2_LO = -10
LOG2_HI = 24
N_BUCKETS = (LOG2_HI - LOG2_LO) + 2


def bucket_index(v: float) -> int:
    """The fixed log2 bucket of ``v`` (non-negative finite values;
    negatives clamp into the underflow bucket)."""
    if v < 2.0 ** LOG2_LO:
        return 0
    if v >= 2.0 ** LOG2_HI:
        return N_BUCKETS - 1
    # frexp: v = m * 2**e with m in [0.5, 1) — so v lives in
    # [2**(e-1), 2**e), the octave bucket i = e - LOG2_LO (an exact
    # power 2**(e-1) has m == 0.5 and lands on its own LOWER edge,
    # which is the same formula)
    _m, e = math.frexp(v)
    return e - LOG2_LO


def bucket_edges(idx: int) -> Tuple[float, float]:
    """``[lo, hi)`` of bucket ``idx`` (underflow lo=0, overflow
    hi=inf)."""
    if idx <= 0:
        return 0.0, 2.0 ** LOG2_LO
    if idx >= N_BUCKETS - 1:
        return 2.0 ** LOG2_HI, math.inf
    e = idx + LOG2_LO
    return 2.0 ** (e - 1), 2.0 ** e


def _edge_hi(idx: int) -> float:
    return bucket_edges(idx)[1]


def quantile_from_counts(counts, q: float, *,
                         vmin: Optional[float] = None,
                         vmax: Optional[float] = None) -> Optional[float]:
    """The streaming quantile of a log2 bucket-count vector: find the
    bucket holding the ``q``-th observation and interpolate LINEARLY
    inside its ``[lo, hi)`` edges (clamped to the observed min/max when
    given — tightens the first/last bucket, where the log2 width is the
    whole error). ``None`` on an empty vector. Shared by
    :meth:`Histogram.quantile` and the windowed
    windowed delta reads."""
    errors.expects(0.0 <= q <= 100.0,
                   "quantile_from_counts: q=%s out of [0, 100]", q)
    total = sum(counts)
    if total == 0:
        return None
    target = (q / 100.0) * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        prev = cum
        cum += c
        if cum >= target:
            lo, hi = bucket_edges(i)
            if vmin is not None:
                lo = max(lo, min(vmin, hi))
            if vmax is not None and math.isfinite(hi):
                hi = min(hi, max(vmax, lo))
            elif not math.isfinite(hi):
                hi = vmax if vmax is not None else lo * 2.0
            frac = (target - prev) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    lo, hi = bucket_edges(len(counts) - 1)
    return vmax if vmax is not None else lo


class Histogram(_Instrument):
    """A fixed-bucket log2 latency histogram (unit chosen by the
    caller; the serving stages record MILLISECONDS). One ``observe`` is
    one bucket increment; p50/p95/p99 are readable at any instant."""

    __slots__ = ("_counts", "_count", "_sum", "_min", "_max")

    kind = "histogram"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._counts = [0] * N_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        if not _ENABLED[0]:
            return
        v = float(v)
        idx = bucket_index(v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self._sum / self._count if self._count else None

    def counts_snapshot(self) -> Tuple[int, ...]:
        """The bucket counts as an immutable snapshot — the windowed
        readers diff
        two snapshots to quantile only the observations BETWEEN them."""
        with self._lock:
            return tuple(self._counts)

    def quantile(self, q: float) -> Optional[float]:
        """Streaming quantile over everything observed so far (``q`` in
        [0, 100]); None when empty."""
        with self._lock:
            counts = list(self._counts)
            vmin = self._min if self._count else None
            vmax = self._max if self._count else None
        return quantile_from_counts(counts, q, vmin=vmin, vmax=vmax)

    @property
    def p50(self) -> Optional[float]:
        return self.quantile(50.0)

    @property
    def p95(self) -> Optional[float]:
        return self.quantile(95.0)

    @property
    def p99(self) -> Optional[float]:
        return self.quantile(99.0)


def merged_quantile(hists, q: float) -> Optional[float]:
    """The quantile of several histograms' POOLED observations (their
    bucket geometry is shared, so counts just add) — how
    ``ExecutorStats`` reads one per-stage quantile across that stage's
    per-bucket series. ``None`` when nothing was observed."""
    counts = [0] * N_BUCKETS
    vmin, vmax = math.inf, -math.inf
    total = 0
    for h in hists:
        with h._lock:
            for i, c in enumerate(h._counts):
                counts[i] += c
            total += h._count
            vmin = min(vmin, h._min)
            vmax = max(vmax, h._max)
    if total == 0:
        return None
    return quantile_from_counts(counts, q, vmin=vmin, vmax=vmax)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """The process-wide series store (thread-safe).

    ``counter``/``gauge``/``histogram`` get-or-create the series keyed
    on ``(name, frozenset(labels))`` — hold the returned handle; the
    handle's updates never touch the registry lock again. A name reused
    with a DIFFERENT instrument kind raises (one name, one type — the
    Prometheus rule).

    ``clock`` stamps emitter lines and is injectable for deterministic
    tests; it never gates recording (instruments stamp nothing — a
    histogram is a distribution, not a log).
    """

    def __init__(self, *, clock: Callable[[], float] = time.time):
        # plain on purpose, like _Instrument._lock: the registry is a
        # near-leaf of the lock-order graph (it only takes instrument
        # locks), and the runtime tracer lazily creates its own
        # histogram handles through this lock
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, frozenset], _Instrument] = {}
        # name -> kind, across ALL label sets: the one-name-one-type
        # rule is per NAME (exposition emits one `# TYPE` per name), so
        # a labels-differing series must not smuggle a second kind in
        self._kinds: Dict[str, str] = {}
        self._clock = clock
        self._emitters: List["JsonlEmitter"] = []

    # -- series creation -----------------------------------------------------
    def _get(self, kind: str, name: str, labels: Mapping[str, Any]):
        errors.expects(bool(name), "MetricRegistry: empty metric name")
        key = (name, _label_key(labels))
        with self._lock:
            known = self._kinds.setdefault(name, kind)
            errors.expects(
                known == kind,
                "MetricRegistry: %r is a %s, requested as %s",
                name, known, kind,
            )
            inst = self._series.get(key)
            if inst is None:
                inst = _KINDS[kind](name, {k: str(v)
                                           for k, v in labels.items()})
                self._series[key] = inst
            return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get("histogram", name, labels)

    # -- read surfaces -------------------------------------------------------
    def series(self, name: Optional[str] = None) -> Iterator[_Instrument]:
        """Iterate instruments (optionally only those named ``name``) —
        a SNAPSHOT list, safe against concurrent creation."""
        with self._lock:
            insts = list(self._series.values())
        for inst in insts:
            if name is None or inst.name == name:
                yield inst

    def snapshot(self) -> Dict[str, List[dict]]:
        """Plain-dict dump of every series: counters/gauges carry
        ``value``; histograms carry count/sum/p50/p95/p99 (the JSONL
        emitter's payload)."""
        out: Dict[str, List[dict]] = {}
        for inst in self.series():
            row: Dict[str, Any] = {
                "labels": dict(inst.labels), "type": inst.kind,
            }
            if isinstance(inst, Histogram):
                with inst._lock:
                    row.update(count=inst._count,
                               sum=round(inst._sum, 6))
                for q in (50, 95, 99):
                    v = inst.quantile(float(q))
                    if v is not None:
                        row[f"p{q}"] = round(v, 6)
            else:
                row["value"] = inst.value
            out.setdefault(inst.name, []).append(row)
        return out

    def text_snapshot(self) -> str:
        """Operator-readable one-line-per-series dump."""
        lines = []
        for name in sorted({i.name for i in self.series()}):
            for inst in self.series(name):
                if isinstance(inst, Histogram):
                    q = [inst.quantile(p) for p in (50.0, 95.0, 99.0)]
                    qs = "/".join(
                        "-" if v is None else f"{v:.3g}" for v in q
                    )
                    lines.append(
                        f"{name}{inst.label_str()} count={inst.count} "
                        f"p50/p95/p99={qs}"
                    )
                else:
                    lines.append(
                        f"{name}{inst.label_str()} {inst.value:g}"
                    )
        return "\n".join(lines)

    def exposition(self) -> str:
        """Prometheus text exposition (``# TYPE`` headers, cumulative
        ``_bucket{le=...}`` histogram series) — scrapeable as-is."""
        lines: List[str] = []
        for name in sorted({i.name for i in self.series()}):
            insts = list(self.series(name))
            lines.append(f"# TYPE {name} {insts[0].kind}")
            for inst in insts:
                if isinstance(inst, Histogram):
                    with inst._lock:
                        counts = list(inst._counts)
                        total, s = inst._count, inst._sum
                    cum = 0
                    for i, c in enumerate(counts):
                        cum += c
                        hi = _edge_hi(i)
                        le = "+Inf" if math.isinf(hi) else f"{hi:g}"
                        labels = dict(inst.labels, le=le)
                        inner = ",".join(
                            f'{k}="{v}"'
                            for k, v in sorted(labels.items())
                        )
                        lines.append(
                            f"{name}_bucket{{{inner}}} {cum}"
                        )
                    lines.append(
                        f"{name}_sum{inst.label_str()} {s:g}"
                    )
                    lines.append(
                        f"{name}_count{inst.label_str()} {total}"
                    )
                else:
                    lines.append(
                        f"{name}{inst.label_str()} {inst.value:g}"
                    )
        return "\n".join(lines) + "\n"

    # -- the periodic JSONL emitter ------------------------------------------
    def start_emitter(self, path: str, *,
                      interval_s: float = 10.0) -> "JsonlEmitter":
        """Start a daemon thread appending ``{"t": ..., "metrics":
        snapshot()}`` to ``path`` every ``interval_s`` — the flat-file
        time series the soak/bench runs graph. Call ``stop()`` (or let
        the process exit; the thread is a daemon and every line is
        written with flush)."""
        from raft_tpu_torch.obs import crash as _crash  # circular-safe here

        _crash.install_excepthook()
        em = JsonlEmitter(self, path, interval_s=interval_s)
        with self._lock:
            self._emitters.append(em)
        em.start()
        return em

    def stop_emitters(self) -> None:
        with self._lock:
            ems, self._emitters = self._emitters, []
        for em in ems:
            em.stop()


class JsonlEmitter:
    """The registry's periodic JSONL writer (one daemon thread)."""

    def __init__(self, registry: MetricRegistry, path: str, *,
                 interval_s: float = 10.0):
        errors.expects(interval_s > 0,
                       "JsonlEmitter: interval_s=%s <= 0", interval_s)
        self._reg = registry
        self.path = str(path)
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="obs-emitter", daemon=True,
        )

    def start(self) -> None:
        self._thread.start()

    def emit_once(self) -> None:
        """Append one snapshot line NOW (also used by the loop)."""
        line = json.dumps(
            {"t": self._reg._clock(), "metrics": self._reg.snapshot()},
            sort_keys=True,
        )
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.emit_once()
            except Exception:   # noqa: BLE001 — telemetry must not kill
                pass            # the process it observes
        try:
            self.emit_once()    # final flush on stop
        except Exception:   # noqa: BLE001
            pass

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout_s)


# ---------------------------------------------------------------- default
_DEFAULT = MetricRegistry()


def default_registry() -> MetricRegistry:
    """The process-wide registry every instrumented subsystem records
    into unless handed another one."""
    return _DEFAULT
