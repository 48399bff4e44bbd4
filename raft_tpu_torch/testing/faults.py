"""Deterministic fault injection for the resilience layer — the port of
``raft_tpu/testing/faults.py``.

Chaos engineering that replays: every injector here is seeded or fully
specified, so a failing chaos run reproduces bit for bit. The injectors
cover the serving failure model:

* :func:`inject_delay` — a straggler / slow-card surrogate: an identity
  dispatch whose readiness is held back on the host clock, with audit
  counters (proves a retry re-dispatches without rebuilding anything);
* :func:`inject_straggler` — every N-th result of a real dispatch
  function held back the same way;
* :func:`inject_nonfinite` — poison query rows with NaN / Inf;
* :func:`corrupt_bytes` — silent checkpoint corruption: flips payload
  bytes inside a ``.npz`` and REWRITES the archive so the zip container
  stays self-consistent — only the format-v2 CRC32 manifest can catch
  it (``load_index`` → ``CorruptIndexError``);
* :func:`inject_partial_write` — a partial delta-checkpoint flush
  (torn-write truncation or a duplicated / stale block) at a chosen
  member boundary, or (``at_byte=``) a raw tear at an ARBITRARY byte
  offset of any file — the mutation tier's mid-ingest crash model and
  the WAL torn-tail fuzz's cutter;
* :func:`cancel_after` — arm a delayed cross-thread cancel against an
  in-flight :meth:`~raft_tpu_torch.core.interruptible.Interruptible.synchronize`;
* :func:`fail_rank` — mark shard(s) down on a
  :class:`~raft_tpu_torch.resilience.health.ShardHealth` (the degraded
  search's mask).

Readiness follows the port's protocol (an object with ``query()`` and
its result in ``.value``, as the serving executor and
``Interruptible.synchronize`` poll it): a held-back value is ready once
the host clock passes its deadline AND the work that produced it is
done — a CUDA event recorded when it was wrapped, polled with
``query()`` and never waited on inside ``query()``; a CPU value is done
at once.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zipfile
from typing import Optional, Sequence, Union

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.interruptible import Interruptible, waitables
from raft_tpu_torch.resilience.health import ShardHealth

__all__ = [
    "FaultAudit",
    "DelayedReady",
    "inject_delay",
    "inject_straggler",
    "inject_nonfinite",
    "corrupt_bytes",
    "inject_partial_write",
    "cancel_after",
    "fail_rank",
]


@dataclasses.dataclass
class FaultAudit:
    """Audit counters for an injected-fault dispatch: ``traces`` counts
    the builds of the injected program (one per input signature: shape,
    dtype, device), ``dispatches`` counts actual executions (each
    attempt really re-ran, not read a kept value), ``calls`` counts
    invocations of the wrapper. A deadline retry that reuses the built
    program shows ``traces == 1, dispatches == attempts``."""

    traces: int = 0
    dispatches: int = 0
    calls: int = 0


class DelayedReady:
    """A straggler surrogate in the port's readiness protocol: wraps a
    dispatched ``value`` (its result in ``.value``) and reports
    ``query()`` False until a host-clock deadline, even after the real
    work finished — the dispatched-but-not-ready state a deadline must
    catch, modelled deterministically and independent of load (chaos
    runs replay). Past the deadline it is ready once the work that
    produced ``value`` is: the CUDA events recorded at wrap time (one
    per device holding a CUDA tensor of ``value``, on its current
    stream) and any readiness gate inside ``value``. ``query()`` only
    polls; :meth:`synchronize` blocks."""

    def __init__(self, value, ready_at: float):
        self.value = value
        self._ready_at = ready_at
        self._pending = waitables(value)

    def query(self) -> bool:
        if time.monotonic() < self._ready_at:
            return False
        self._pending = [w for w in self._pending if not w.query()]
        return not self._pending

    def synchronize(self) -> "DelayedReady":
        time.sleep(max(0.0, self._ready_at - time.monotonic()))
        for w in self._pending:
            wait = getattr(w, "synchronize", None)
            if callable(wait):
                wait()
            else:
                while not w.query():
                    time.sleep(0.0005)
        self._pending = []
        return self

    def __array__(self, dtype=None, copy=None):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=dtype)


def inject_delay(seconds: float, *, first_n: Optional[int] = None):
    """A slow-kernel surrogate: returns ``(fn, audit)`` where ``fn(x)``
    dispatches an identity over ``x`` (a device copy, audited) and
    returns a :class:`DelayedReady` that polls not-ready for
    ``seconds`` — exactly what ``Interruptible.synchronize`` /
    ``dispatch_with_deadline`` wait on, so a deadline expires against it
    as against a straggling card.

    ``first_n``: only the first N calls are slow (a transient straggler
    — the retry-succeeds scenario); None = always slow. ``audit`` counts
    builds and dispatches for the retry-without-rebuild proof.
    """
    errors.expects(seconds >= 0, "inject_delay: seconds=%s < 0", seconds)
    audit = FaultAudit()
    built: set = set()

    def ident(x):
        x = torch.as_tensor(x)
        sig = (tuple(x.shape), x.dtype, x.device)
        if sig not in built:
            built.add(sig)
            audit.traces += 1
        audit.dispatches += 1
        return x.clone()

    def fn(x):
        audit.calls += 1
        slow = first_n is None or audit.calls <= first_n
        return DelayedReady(
            ident(x), time.monotonic() + (seconds if slow else 0.0))

    return fn, audit


def inject_straggler(fn, *, every: int, seconds: float):
    """Wrap an arbitrary dispatch function so every ``every``-th call's
    result polls not-ready for ``seconds`` past dispatch — the periodic
    slow-card surrogate for tail-latency experiments (``dispatch_hedged``'s
    winner is deterministic against it because the straggle schedule is
    exactly periodic, not sampled).

    Unlike :func:`inject_delay` (which wraps its own audited identity),
    this wraps the caller's real ``fn``: the returned value is ``fn``'s
    output, wrapped in a :class:`DelayedReady` on straggling calls.
    Returns ``(wrapped, audit)``; ``audit.calls`` counts invocations
    (``audit.dispatches`` counts the straggled ones)."""
    errors.expects(every >= 1, "inject_straggler: every=%d < 1", every)
    errors.expects(seconds >= 0, "inject_straggler: seconds=%s < 0",
                   seconds)
    audit = FaultAudit()

    def wrapped(*args, **kwargs):
        audit.calls += 1
        out = fn(*args, **kwargs)
        if audit.calls % every == 0:
            audit.dispatches += 1
            return DelayedReady(out, time.monotonic() + seconds)
        return out

    return wrapped, audit


def inject_nonfinite(x, rows: Sequence[int], *,
                     kind: str = "nan") -> np.ndarray:
    """Return a float copy of ``x`` with the given rows poisoned
    (``kind`` ∈ {"nan", "inf", "-inf"}) — the bad-input batch the
    serving entry must neutralize (``shard_mask=`` searches report such
    rows via ``row_valid``)."""
    vals = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}
    errors.expects(
        kind in vals, "inject_nonfinite: kind=%r not in %s",
        kind, sorted(vals),
    )
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.array(x, dtype=np.float32, copy=True)
    idx = np.asarray(list(rows), dtype=np.int64)
    errors.expects(
        idx.size == 0 or (0 <= idx.min() and idx.max() < arr.shape[0]),
        "inject_nonfinite: rows out of range [0, %d)", arr.shape[0],
    )
    arr[idx] = vals[kind]
    return arr


def corrupt_bytes(path, *, field: Optional[str] = None, n_bytes: int = 1,
                  seed: int = 0, skip_header_bytes: int = 128) -> str:
    """Silently corrupt a saved index checkpoint (``.npz``) in place.

    Flips ``n_bytes`` bytes (XOR 0xFF) inside one array member's DATA
    region — past the first ``skip_header_bytes`` so the ``.npy``
    dtype/shape header still parses — then rewrites the archive, which
    refreshes the zip container's own CRCs to match the damaged payload.
    The result models bit-rot beneath the container's checksums (a torn
    write, a bad DMA): only ``load_index``'s format-v2 per-array CRC32
    manifest can detect it, raising
    :class:`raft_tpu_torch.errors.CorruptIndexError` naming the field.

    ``field``: the header-relative array key to damage (e.g.
    ``"sorted_ids"``); default picks one deterministically from
    ``seed``. Byte positions are drawn from ``seed``. Returns the
    damaged field name.
    """
    errors.expects(n_bytes >= 1, "corrupt_bytes: n_bytes=%d < 1", n_bytes)
    rng = np.random.default_rng(seed)
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        payload = {n: z.read(n) for n in names}
    candidates = sorted(n for n in names if n != "__header__.npy")
    errors.expects(
        bool(candidates), "corrupt_bytes: %s holds no array members", path
    )
    if field is None:
        target = candidates[int(rng.integers(len(candidates)))]
    else:
        target = field if field.endswith(".npy") else field + ".npy"
        errors.expects(
            target in payload,
            "corrupt_bytes: field %r not in archive (members: %s)",
            field, candidates,
        )
    buf = bytearray(payload[target])
    lo = min(skip_header_bytes, max(0, len(buf) - 1))
    errors.expects(
        len(buf) > lo,
        "corrupt_bytes: member %r too small (%d bytes) to damage past "
        "its header", target, len(buf),
    )
    positions = lo + rng.choice(
        len(buf) - lo, size=min(n_bytes, len(buf) - lo), replace=False
    )
    for p in positions:
        buf[int(p)] ^= 0xFF
    payload[target] = bytes(buf)
    # rewrite uncompressed, same member order: zipfile recomputes the
    # container CRCs, leaving a self-consistent archive whose bytes
    # disagree with the v2 integrity manifest
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for n in names:
            z.writestr(n, payload[n])
    return target[:-len(".npy")]


def inject_partial_write(path, *, mode: str = "truncate",
                         boundary: Optional[int] = None,
                         at_byte: Optional[int] = None,
                         seed: int = 0) -> str:
    """Model a PARTIAL flush of a delta-segment checkpoint
    (:func:`raft_tpu_torch.spatial.ann.mutation.save_delta_checkpoint`)
    — the mid-ingest crash the mutation tier's recovery story must
    survive:

    * ``mode="truncate"`` — a torn write: the file ends at the
      ``boundary``-th archive member's header offset plus half its
      stored bytes (headers before the boundary still parse; the zip
      central directory is gone). ``load``/``apply`` must fail with
      :class:`raft_tpu_torch.errors.CorruptIndexError`, never half-apply.
    * ``mode="duplicate"`` — a doubled/stale block write: the
      ``boundary``-th array member's payload is overwritten with the
      PREVIOUS member's bytes and the archive rewritten self-consistent
      (container CRCs match the damage) — only the v4 per-array CRC32
      manifest can catch it.

    ``boundary`` indexes the non-header members in archive order
    (default: the middle member, deterministic from ``seed`` when the
    archive has one candidate pair). Returns the damaged member name
    (without ``.npy``).

    ``at_byte`` (``mode="truncate"`` only) tears the RAW file at an
    ARBITRARY byte offset instead of a member boundary — no container
    parsing at all, so it works on any format (the WAL torn-tail fuzz
    cuts a segment log at EVERY offset). Returns the file's basename in
    that case.
    """
    errors.expects(
        mode in ("truncate", "duplicate"),
        "inject_partial_write: mode=%r not in ('truncate', 'duplicate')",
        mode,
    )
    if at_byte is not None:
        errors.expects(
            mode == "truncate",
            "inject_partial_write: at_byte requires mode='truncate', "
            "got %r", mode,
        )
        size = os.path.getsize(path)
        errors.expects(
            0 <= at_byte <= size,
            "inject_partial_write: at_byte=%d outside [0, %d]",
            at_byte, size,
        )
        with open(path, "rb+") as f:
            f.truncate(int(at_byte))
        return os.path.basename(path)
    with zipfile.ZipFile(path) as z:
        infos = z.infolist()
        payload = {i.filename: z.read(i.filename) for i in infos}
    members = [
        i.filename for i in infos if i.filename != "__header__.npy"
    ]
    errors.expects(
        bool(members),
        "inject_partial_write: %s holds no array members", path,
    )
    rng = np.random.default_rng(seed)
    if boundary is None:
        boundary = len(members) // 2 if len(members) > 1 else 0
    errors.expects(
        0 <= boundary < len(members),
        "inject_partial_write: boundary=%d out of range [0, %d)",
        boundary, len(members),
    )
    target = members[boundary]
    if mode == "duplicate":
        src = members[boundary - 1] if boundary > 0 else members[
            min(boundary + 1, len(members) - 1)
        ]
        if src == target and len(members) == 1:
            # single member: stale payload is a shuffled copy of itself
            buf = bytearray(payload[target])
            pos = 128 + rng.choice(max(len(buf) - 128, 1), size=1)[0]
            buf[int(pos)] ^= 0xFF
            payload[target] = bytes(buf)
        else:
            payload[target] = payload[src]
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
            for i in infos:
                z.writestr(i.filename, payload[i.filename])
        return target[:-len(".npy")]
    # torn write: rewrite uncompressed, then cut the FILE at the target
    # member's data midpoint — everything after (later members, central
    # directory) is simply gone
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for i in infos:
            z.writestr(i.filename, payload[i.filename])
    with zipfile.ZipFile(path) as z:
        info = next(i for i in z.infolist() if i.filename == target)
        cut = info.header_offset + max(
            1, (len(info.filename) + 30 + info.file_size) // 2
        )
    with open(path, "rb+") as f:
        f.truncate(cut)
    return target[:-len(".npy")]


def cancel_after(seconds: float, *,
                 thread_id: Optional[int] = None) -> threading.Timer:
    """Arm a delayed cross-thread cancel: after ``seconds``, the target
    thread's :class:`Interruptible` token is cancelled, breaking an
    in-flight ``synchronize`` with ``InterruptedException`` (the
    dispatched work still completes — cooperative semantics). Defaults
    to the CALLING thread. Returns the started ``threading.Timer``
    (``.cancel()`` it to disarm)."""
    tid = threading.get_ident() if thread_id is None else thread_id
    t = threading.Timer(seconds, Interruptible.cancel_thread, args=(tid,))
    t.daemon = True
    t.start()
    return t


def fail_rank(health: Union[ShardHealth, int], *ranks: int) -> ShardHealth:
    """Mark shard(s) down. ``health`` is an existing
    :class:`ShardHealth` (mutated in place) or a mesh size (a fresh
    tracker is created). Returns the tracker — pass it (or its
    ``mask()``) as the sharded searches' ``shard_mask=``."""
    h = health if isinstance(health, ShardHealth) else ShardHealth(health)
    for r in ranks:
        h.mark_down(r)
    return h
