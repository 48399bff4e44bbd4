"""Communicator facade — the port of ``raft_tpu/comms/comms.py`` (the
analog of ``raft::comms::comms_t``, cpp/include/raft/core/comms.hpp:
allreduce, bcast, reduce, allgather(v), gather(v), reducescatter,
alltoall, device_sendrecv, barrier, sync_stream, comm_split).

The design
==========

The JAX package runs one SPMD body per rank under ``shard_map`` and its
collectives are XLA ops over a named mesh axis. The port keeps that
shape — one per-rank body, written once — and runs it in two forms:

1. **In process** (:class:`Comms`, :class:`HierarchicalComms`): P ranks,
   each with a ``torch.device``; several ranks may share one device
   (P = 8 ranks on one card is the shape of the JAX tests' 8-device
   virtual mesh). :meth:`Comms.run` is the ``shard_map`` counterpart:
   it runs ``body(ax, *blocks, *replicated)`` once per rank, ``ax``
   being the rank's :class:`AxisComms` and ``blocks`` the rank's slice
   of each sharded operand, and returns the replicated outputs (rank
   0's copy) or the stacked per-rank outputs.

   * One Python thread per rank. The ranks meet at a rendezvous for
     every collective: each rank posts its tensor into the collective's
     record (one slot per rank) and, once every rank has posted, reads
     them all. ``allgather`` stacks the posted tensors in rank order;
     ``allreduce`` reduces them in rank order, so every rank computes
     the same bits and the result does not depend on thread timing;
     ``alltoall`` and ``sendrecv`` hand slices across.
   * The ranks take turns: one rank thread runs at a time, from its
     turn until it blocks at a collective that not every rank has
     reached, and then hands the turn to the next rank that can run,
     in rank order. In one interpreter, rank threads that ran at once
     would only contend for the GIL, every op's release and
     re-acquisition queueing behind the others: on an H100 (`NVIDIA
     H100 80GB HBM3, 700.00 W`), a sharded IVF-Flat batch of 8 queries
     at P = 8 took a median 72.6 ms of host time that way against 32.4
     ms taking turns, for 2.7 ms of device work (alternating pairs in
     one process: ``python3 -m raft_tpu_torch.tools.profile_grouped
     --kind sharded --rendezvous-pairs 4``). A device queues the ranks'
     work in the same order either way.
   * A rank that raises aborts the run: every waiting rank is woken and
     ends, so no rank hangs in a collective; the caller re-raises the
     first exception a rank raised (a rank that only saw the abort does
     not mask it). Every wait has a timeout (``timeout_s``): a rank that
     never reaches a collective its peers wait at ends the run with
     :class:`~raft_tpu_torch.errors.RaftTimeoutError`. Every rank
     thread is joined before ``run`` returns or raises.
   * On the card, the rank threads enqueue on the caller's current
     stream of their device (captured by ``run`` and made current in
     each thread). One stream orders every rank's launches with the
     collectives: a rank posts a tensor only after it has enqueued the
     work that produces it, so whatever a peer enqueues to read it
     comes later on the same stream — no event is needed. A caller
     that dispatches on a side stream (the serving executor) has the
     whole sharded search on that stream, and its event covers it.
     Ranks on different devices read each other's tensors with
     ``Tensor.to``, which orders the copy against both devices'
     current streams.

2. **torch.distributed** (:class:`DistComms`): one process per rank
   over a process group, gloo on the CPU and NCCL on the card. The
   same body runs once per process, on its own rank's blocks, and the
   :class:`DistAxisComms` methods map onto ``all_reduce``,
   ``all_gather_into_tensor``, ``broadcast``, ``reduce_scatter_tensor``,
   ``all_to_all_single`` and ``batch_isend_irecv``; ``comm_split``
   becomes ``new_group``, and :meth:`Comms.initialize_distributed`
   joins a process group through a ``file://`` init method (no port,
   no network). ``gatherv`` / ``allgatherv`` keep the reference's
   padded ``max_count`` contract in both forms.

An operand is "sharded" when its leading axis runs over the ranks this
process holds (``comms.local_ranks``: every rank in process, one rank
through torch.distributed); a list of per-rank tensors (each on its
rank's device) is accepted too. Collectives run inside ``run`` only.

Collectives ride (in process / torch.distributed):
    allreduce       -> rank-order reduction / all_reduce
    bcast           -> root's slot / broadcast
    reduce          -> allreduce (SPMD: every rank holds root's result)
    allgather       -> rank-order stack / all_gather_into_tensor
    allgatherv      -> allgather over max_count-padded slots + counts
    gather(v)       -> allgather(v) (every rank holds root's result)
    reducescatter   -> allreduce + slice / reduce_scatter_tensor
    alltoall        -> slot j of each rank / all_to_all_single
    sendrecv        -> (src, dst) pairs / batch_isend_irecv
    barrier         -> a rendezvous / all_reduce of a zero
    comm_split      -> sub-communicators / new_group
"""

from __future__ import annotations

import enum
import threading
import time
import warnings
from typing import Any, Optional, Sequence, Tuple

import torch

from raft_tpu_torch import errors

__all__ = [
    "AxisComms", "Comms", "DistAxisComms", "DistComms", "HierarchicalComms",
    "P2PBatch", "ReduceOp", "build_comms", "build_comms_hierarchical",
    "inject_comms",
]

# how long a rank waits at a rendezvous before the run is abandoned
DEFAULT_TIMEOUT_S = 300.0


class ReduceOp(enum.Enum):
    """Mirror of ``raft::comms::op_t`` (core/comms.hpp:81-87)."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


def _resolve_op(op) -> ReduceOp:
    if isinstance(op, ReduceOp):
        return op
    return ReduceOp(str(op).lower())


def _combine(a, b, op: ReduceOp):
    if op == ReduceOp.SUM:
        return a + b
    if op == ReduceOp.PROD:
        return a * b
    if op == ReduceOp.MIN:
        return torch.minimum(a, b)
    return torch.maximum(a, b)


def _pad_rows(x, max_count: int):
    errors.expects(
        x.shape[0] <= max_count,
        "allgatherv: contribution has %d rows > max_count=%d — every "
        "rank's slot is padded TO max_count, it cannot shrink to it",
        x.shape[0], max_count,
    )
    if x.shape[0] == max_count:
        return x
    pad = torch.zeros((max_count - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


class _Collectives:
    """The derived half of the facade, shared by both forms: each method
    here is written on the primitives a form provides (``allgather``,
    ``allreduce``, ``sendrecv``, ``get_rank``, ``get_size``)."""

    levels: dict

    def gather(self, x, root: int = 0, axis: int = 0):
        """comms.hpp:352; SPMD: every rank holds the result, root's is
        the valid one."""
        return self.allgather(x, axis=axis)

    def allgatherv(self, x, valid_count, max_count: int):
        """Variable-size allgather (comms.hpp:320) in the static-shape
        form: each rank contributes a (max_count, ...) slot plus its
        valid count; returns (stacked (size, max_count, ...), counts
        (size,))."""
        slot = _pad_rows(torch.as_tensor(x), max_count)
        count = torch.as_tensor(valid_count, device=slot.device)
        return self.allgather(slot), self.allgather(count.reshape(()))

    def gatherv(self, x, valid_count, max_count: int, root: int = 0):
        return self.allgatherv(x, valid_count, max_count)

    def reduce(self, x, root: int = 0, op=ReduceOp.SUM):
        """SPMD note: every rank computes the reduction; only root's copy
        is the valid one, matching the reference contract
        (comms.hpp:253)."""
        return self.allreduce(x, op)

    def ring_shift(self, x, shift: int = 1):
        """Ring permute: rank r's ``x`` goes to rank r + shift."""
        n = self.get_size()
        return self.sendrecv(x, [(i, (i + shift) % n) for i in range(n)])

    def p2p_batch(self) -> "P2PBatch":
        """Deferred tagged point-to-point batch (core/comms.hpp:440-508);
        see :class:`P2PBatch`."""
        return P2PBatch(self)

    def device_multicast_sendrecv(self, x, sources: Sequence[int],
                                  dest: int):
        """comms.hpp:570: gather several sources' buffers at ``dest``;
        the SPMD form returns the stacked sources on every rank."""
        g = self.allgather(x)
        return g[torch.as_tensor(list(sources), device=g.device)]

    def sync_stream(self):
        """Wait for this rank's work on its current stream (the
        reference's ``sync_stream``; a no-op on the CPU)."""
        dev = getattr(self, "device", None)
        if dev is not None and torch.device(dev).type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    # -- the levels of a two-level communicator ---------------------------
    def level(self, name: str) -> "_Collectives":
        """This rank's facade over one level (``"dcn"`` or ``"ici"``) of
        a two-level communicator (:class:`HierarchicalComms`)."""
        errors.expects(name in self.levels,
                       "communicator has no level %r (levels: %s)", name,
                       sorted(self.levels))
        return self.levels[name]


class AxisComms(_Collectives):
    """One rank's collective facade in the in-process form — the counterpart
    of the JAX ``AxisComms`` inside ``shard_map``: usable only inside the
    body :meth:`Comms.run` runs, where it is bound to a rank of a
    rendezvous group."""

    def __init__(self, axis, group: "_ThreadGroup", rank: int, device,
                 levels: Optional[dict] = None):
        self.axis = axis
        self._group = group
        self._rank = int(rank)
        self.device = torch.device(device)
        self.levels = levels or {}

    # -- topology ------------------------------------------------------------
    def get_size(self) -> int:
        return self._group.size

    def get_rank(self) -> int:
        return self._rank

    def _posted(self, x):
        """Every rank's ``x`` in rank order, on this rank's device."""
        got = self._group.exchange(self._rank, x)
        return [t.to(self.device) if isinstance(t, torch.Tensor) else t
                for t in got]

    # -- collectives -----------------------------------------------------------
    def allreduce(self, x, op=ReduceOp.SUM):
        """Reduction in rank order: every rank computes the same bits."""
        op = _resolve_op(op)
        xs = self._posted(torch.as_tensor(x))
        out = xs[0]
        for t in xs[1:]:
            out = _combine(out, t, op)
        return out.clone() if len(xs) == 1 else out

    def bcast(self, x, root: int = 0):
        """Every rank receives root's ``x`` (comms.hpp:208)."""
        return self._posted(torch.as_tensor(x))[root].clone()

    def allgather(self, x, axis: int = 0, tiled: bool = False):
        """Every rank's ``x`` in rank order, stacked on a new ``axis``
        (concatenated along it when ``tiled``) — comms.hpp:299."""
        xs = self._posted(torch.as_tensor(x))
        return torch.cat(xs, axis) if tiled else torch.stack(xs, axis)

    def reducescatter(self, x, op=ReduceOp.SUM, tiled: bool = False):
        """Each rank gets its slice of the reduction (comms.hpp:401):
        slot ``rank`` of a (size, ...) operand, or rows ``rank*c ..
        rank*c + c - 1`` of a (size*c, ...) one when ``tiled``."""
        sz = self.get_size()
        errors.expects(
            x.shape[0] % sz == 0 and (tiled or x.shape[0] == sz),
            "reducescatter: leading dim %d does not split into the "
            "communicator size %d", x.shape[0], sz,
        )
        red = self.allreduce(x, op)
        if not tiled:
            return red[self._rank]
        c = x.shape[0] // sz
        return red[self._rank * c:(self._rank + 1) * c]

    # -- p2p -------------------------------------------------------------------
    def sendrecv(self, x, perm: Sequence[Tuple[int, int]]):
        """Explicit (src, dst) pair exchange (comms.hpp:440-570); a rank
        named as no destination receives zeros."""
        x = torch.as_tensor(x)
        xs = self._posted(x)
        for s, d in perm:
            if d == self._rank:
                return xs[s].clone()
        return torch.zeros_like(x)

    def alltoall(self, x):
        """Each rank's ``x`` (size, chunk, ...) sends chunk ``j`` to rank
        ``j``; slot ``s`` of the result holds the chunk rank ``s`` sent
        here (MPI_Alltoall) — the row exchange of the distributed index
        build."""
        errors.expects(
            x.shape[0] == self.get_size(),
            "alltoall: leading dim %d != communicator size %d",
            x.shape[0], self.get_size(),
        )
        xs = self._posted(x)
        return torch.stack([t[self._rank] for t in xs])

    # -- control ---------------------------------------------------------------
    def barrier(self):
        """comms.hpp:170: every rank arrives before any leaves."""
        self._group.exchange(self._rank, None)
        return torch.zeros((), dtype=torch.int32)


class P2PBatch:
    """Tagged, deferred point-to-point transfers (core/comms.hpp:440-508).

    As in the JAX package, the pattern is declared collectively: every
    rank records the SAME (src, dst, tag) entries, each passing its
    local candidate value; ``waitall`` batches each tag's pairs into
    rounds of unique sources, destinations and one (shape, dtype), runs
    each round as one ``sendrecv``, and returns the delivered tensors
    keyed by (src, dst, tag). A rank that is not the destination of a
    transfer reads zeros for it. A validation failure clears the
    recorded state, so a corrected retry records from scratch."""

    def __init__(self, comms: _Collectives):
        self._comms = comms
        self._sends = []   # (src, dst, tag, value)
        self._recvs = []   # (src, dst, tag)

    def isend(self, x, src: int, dest: int, tag: int = 0) -> None:
        errors.expects(src != dest, "p2p: src == dest == %d", src)
        self._sends.append((int(src), int(dest), int(tag),
                            torch.as_tensor(x)))

    def irecv(self, src: int, dest: int, tag: int = 0) -> Tuple[int, int, int]:
        key = (int(src), int(dest), int(tag))
        self._recvs.append(key)
        return key

    def waitall(self):
        try:
            send_keys = [(s, d, t) for s, d, t, _ in self._sends]
            sends = set(send_keys)
            recvs = set(self._recvs)
            errors.expects(
                len(send_keys) == len(sends),
                "p2p waitall: duplicate (src, dst, tag) sends %s — use "
                "distinct tags per in-flight transfer",
                sorted(k for k in sends if send_keys.count(k) > 1),
            )
            errors.expects(
                len(self._recvs) == len(recvs),
                "p2p waitall: duplicate (src, dst, tag) recvs %s",
                sorted(k for k in recvs if self._recvs.count(k) > 1),
            )
            errors.expects(
                sends == recvs,
                "p2p waitall: unmatched transfers (sends-only %s, "
                "recvs-only %s)", sorted(sends - recvs),
                sorted(recvs - sends),
            )
        except Exception:
            self._sends, self._recvs = [], []
            raise
        rank = self._comms.get_rank()
        out = {}
        by_tag = {}
        for s, d, t, v in self._sends:
            by_tag.setdefault(t, []).append((s, d, v))
        for t, entries in sorted(by_tag.items()):
            remaining = list(entries)
            while remaining:
                round_entries, used_s, used_d, rest = [], set(), set(), []
                round_sig = None
                for s, d, v in remaining:
                    sig = (tuple(v.shape), v.dtype)
                    if (s in used_s or d in used_d
                            or (round_sig is not None and sig != round_sig)):
                        rest.append((s, d, v))
                    else:
                        round_entries.append((s, d, v))
                        used_s.add(s)
                        used_d.add(d)
                        round_sig = sig
                remaining = rest
                # each rank contributes the value of ITS send this round
                payload = torch.zeros_like(round_entries[0][2])
                for s, _, v in round_entries:
                    if rank == s:
                        payload = v
                delivered = self._comms.sendrecv(
                    payload, [(s, d) for s, d, _ in round_entries])
                for s, d, _ in round_entries:
                    out[(s, d, t)] = (delivered if rank == d
                                      else torch.zeros_like(delivered))
        self._sends, self._recvs = [], []
        return out


# ------------------------------------------------------------ in process
class _Aborted(Exception):
    """A rank's wait ended because the run was abandoned (a rank raised,
    or a wait timed out); never the exception the caller sees."""


class _Turns:
    """The turn order of one run's rank threads: one rank runs at a time,
    from its turn until it blocks at a collective whose peers have not
    all posted (or finishes); the turn then passes to the next rank, in
    rank order, that can run. Each rank sleeps on an event of its own,
    set only when the turn is handed to it, so a handoff wakes one
    thread. Every wait is bounded by ``timeout_s``; a wait that times
    out, or :meth:`abort`, breaks the run for every rank."""

    def __init__(self, size: int, timeout_s: float):
        self.lock = threading.Lock()
        self.wake = [threading.Event() for _ in range(size)]
        self.size = size
        self.timeout_s = timeout_s
        self.turn = 0
        self.done = [False] * size
        self.waits = [None] * size      # the record a blocked rank awaits
        self.broken = False
        self.timed_out = False
        self.progress = time.monotonic()

    def _runnable(self, k: int) -> bool:
        rec = self.waits[k]
        return not self.done[k] and (rec is None or rec.complete)

    def pass_turn(self, r: int) -> None:
        """Hand the turn on from rank ``r`` (the lock held)."""
        self.progress = time.monotonic()
        for j in range(1, self.size + 1):
            k = (r + j) % self.size
            if self._runnable(k):
                self.turn = k
                self.wake[k].set()
                return
        self.turn = -1

    def _break(self) -> None:
        self.broken = True
        for ev in self.wake:
            ev.set()

    def await_turn(self, r: int) -> None:
        """Block rank ``r`` until it holds the turn and can run (the lock
        held on entry and on return)."""
        deadline = time.monotonic() + self.timeout_s
        while not self.broken and not (self.turn == r
                                       and self._runnable(r)):
            self.lock.release()
            try:
                woke = self.wake[r].wait(max(0.0,
                                             deadline - time.monotonic()))
            finally:
                self.lock.acquire()
            self.wake[r].clear()
            if not woke and not self.broken:
                self.timed_out = True
                self._break()
        if self.broken:
            raise _Aborted()
        self.waits[r] = None

    def start(self, r: int) -> None:
        with self.lock:
            self.await_turn(r)

    def finish(self, r: int) -> None:
        with self.lock:
            self.done[r] = True
            self.pass_turn(r)

    def abort(self) -> None:
        with self.lock:
            self._break()


class _Record:
    """One collective's slots: every rank of the group posts into it and
    reads all of it."""

    __slots__ = ("slots", "posted", "read")

    def __init__(self, size: int):
        self.slots = [None] * size
        self.posted = 0
        self.read = 0

    @property
    def complete(self) -> bool:
        return self.posted == len(self.slots)


class _ThreadGroup:
    """The rendezvous of one group of rank threads (its members' global
    ranks, in group order). :meth:`exchange` posts a value and returns
    every member's, in group order; a rank whose peers have not all
    posted hands the turn on and waits for it to come back."""

    def __init__(self, members: Sequence[int], turns: _Turns):
        self.members = tuple(members)
        self.size = len(self.members)
        self.turns = turns
        self.gen = [0] * self.size
        self.records = {}

    def exchange(self, i: int, value):
        if self.size == 1:
            return [value]
        t = self.turns
        r = self.members[i]
        with t.lock:
            if t.broken:
                raise _Aborted()
            gen = self.gen[i]
            self.gen[i] += 1
            rec = self.records.get(gen)
            if rec is None:
                rec = self.records[gen] = _Record(self.size)
            rec.slots[i] = value
            rec.posted += 1
            t.progress = time.monotonic()
            if not rec.complete:
                t.waits[r] = rec
                t.pass_turn(r)
                t.await_turn(r)
            got = list(rec.slots)
            rec.read += 1
            if rec.read == self.size:
                del self.records[gen]
            return got


def _rank_block(x, i: int):
    """Rank ``i``'s block of a sharded operand (a tensor over the local
    ranks, or a list of per-rank tensors)."""
    return x[i]


def _stack_ranks(outs):
    """Per-rank outputs stacked on a new leading axis (a list when the
    ranks' tensors lie on different devices)."""
    if not isinstance(outs[0], torch.Tensor):
        return list(outs)
    if len({t.device for t in outs}) == 1:
        return torch.stack(outs)
    return list(outs)


def _collect(outs, out):
    """The caller's view of the per-rank outputs ``outs``: each output
    either ``"replicated"`` (rank 0's copy) or ``"stacked"``."""
    first = outs[0]
    multi = isinstance(first, tuple)
    specs = out if isinstance(out, tuple) else (
        (out,) * len(first) if multi else (out,))
    cols = list(zip(*outs)) if multi else [outs]
    errors.expects(len(specs) == len(cols),
                   "run: %d output specs for %d outputs", len(specs),
                   len(cols))
    res = []
    for spec, col in zip(specs, cols):
        errors.expects(spec in ("replicated", "stacked"),
                       "run: output spec %r (replicated | stacked)", spec)
        res.append(col[0] if spec == "replicated" else _stack_ranks(col))
    return tuple(res) if multi else res[0]


class Comms:
    """The in-process communicator: P ranks, each with a ``torch.device``
    (several ranks may share one) — the counterpart of the JAX ``Comms``
    over a one-axis mesh. :meth:`run` runs a per-rank body on every rank
    (see the module docstring for the design)."""

    def __init__(self, devices: Optional[Sequence] = None,
                 axis: str = "ranks", *,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if devices is None:
            errors.expects(
                torch.cuda.is_available(),
                "Comms: no CUDA device is available; pass devices= (for "
                "example ['cpu'] * 8) to run the ranks on the CPU",
            )
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = tuple(torch.device(d) for d in devices)
        errors.expects(len(self.devices) >= 1, "Comms: no ranks")
        self.axis = axis
        self.timeout_s = float(timeout_s)
        self._level_shape = None

    @staticmethod
    def initialize_distributed(init_file: str, world_size: int, rank: int,
                               *, backend: Optional[str] = None,
                               device=None, timeout_s: float = 120.0,
                               axis: str = "ranks") -> "DistComms":
        """Join a torch.distributed process group through the ``file://``
        init method at ``init_file`` (a path every process can reach; no
        port, no network) and return its :class:`DistComms` — the
        replacement of the reference's NCCL-uniqueId rendezvous.
        ``backend`` defaults to NCCL for a CUDA ``device`` and gloo
        otherwise."""
        import datetime

        import torch.distributed as dist

        dev = torch.device("cpu" if device is None else device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method="file://" + str(init_file),
            world_size=int(world_size), rank=int(rank),
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        return DistComms(device=dev, axis=axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The ranks this process runs: all of them, in process."""
        return tuple(range(self.size))

    @property
    def levels(self) -> Optional[Tuple[Any, Any, int, int]]:
        """``(outer_axis, inner_axis, n_outer, n_inner)`` of a two-level
        communicator, else None."""
        return self._level_shape

    def rank_device(self, rank: int) -> torch.device:
        return self.devices[rank]

    def comm_split(self, colors: Sequence[int],
                   keys: Optional[Sequence[int]] = None):
        """Partition ranks by color into sub-communicators (comms.hpp:189),
        ordered by key. Returns {color: Comms}."""
        if keys is None:
            keys = list(range(self.size))
        groups: dict = {}
        for dev, color, key in sorted(
            zip(self.devices, colors, keys), key=lambda t: (t[1], t[2])
        ):
            groups.setdefault(color, []).append(dev)
        return {c: Comms(devices=g, axis=f"{self.axis}_split{c}",
                         timeout_s=self.timeout_s)
                for c, g in groups.items()}

    # -- running a per-rank body ---------------------------------------------
    def _facades(self, turns: _Turns):
        """One :class:`AxisComms` per rank over a fresh rendezvous (plus
        the level groups of a two-level communicator)."""
        P = self.size
        full = _ThreadGroup(range(P), turns)
        levels = [dict() for _ in range(P)]
        if self._level_shape is not None:
            outer_ax, inner_ax, n_out, n_in = self._level_shape
            for o in range(n_out):
                g = _ThreadGroup([o * n_in + i for i in range(n_in)], turns)
                for i in range(n_in):
                    levels[o * n_in + i][inner_ax] = AxisComms(
                        inner_ax, g, i, self.devices[o * n_in + i])
            for i in range(n_in):
                g = _ThreadGroup([o * n_in + i for o in range(n_out)], turns)
                for o in range(n_out):
                    levels[o * n_in + i][outer_ax] = AxisComms(
                        outer_ax, g, o, self.devices[o * n_in + i])
        return [AxisComms(self.axis, full, r, self.devices[r], levels[r])
                for r in range(P)]

    def run(self, body, *, sharded: Sequence = (),
            replicated: Sequence = (), out="replicated"):
        """Run ``body(ax, *blocks, *replicated)`` on every rank — the
        ``shard_map`` counterpart. ``sharded`` operands are indexed by
        rank (a tensor over the ranks, or a list of per-rank tensors);
        ``replicated`` ones pass as they are. ``out`` is ``"replicated"``
        (return rank 0's output) or ``"stacked"`` (the per-rank outputs
        stacked on a new leading axis), or a tuple of those, one per
        output of a body that returns a tuple.

        A rank that raises aborts the run: every waiting rank ends, every
        rank thread is joined, and the first exception raised is
        re-raised here; a wait longer than ``timeout_s`` at a rendezvous
        raises :class:`~raft_tpu_torch.errors.RaftTimeoutError`."""
        timeout = self.timeout_s
        P = self.size
        turns = _Turns(P, timeout)
        axes = self._facades(turns)

        def args_of(r):
            return [_rank_block(s, r) for s in sharded] + list(replicated)

        if P == 1:
            return _collect([body(axes[0], *args_of(0))], out)
        # the caller's current stream of each device: the rank threads
        # enqueue there (see the module docstring)
        streams = {d: torch.cuda.current_stream(d)
                   for d in set(self.devices) if d.type == "cuda"}
        outs = [None] * P
        failures = []

        def rank_main(r):
            try:
                turns.start(r)
                dev = self.devices[r]
                if dev.type == "cuda":
                    with torch.cuda.device(dev), \
                            torch.cuda.stream(streams[dev]):
                        outs[r] = body(axes[r], *args_of(r))
                else:
                    outs[r] = body(axes[r], *args_of(r))
                turns.finish(r)
            except _Aborted:
                pass
            except BaseException as exc:   # noqa: BLE001 — re-raised below
                failures.append(exc)
                turns.abort()

        threads = [threading.Thread(target=rank_main, args=(r,),
                                    name=f"comms-rank{r}", daemon=True)
                   for r in range(P)]
        for t in threads:
            t.start()
        for t in threads:
            # every wait inside is bounded; past that, a rank that makes
            # no progress (stuck outside any collective) ends the run
            while t.is_alive():
                t.join(0.25)
                if time.monotonic() - turns.progress > timeout + 5.0:
                    turns.abort()
                    for u in threads:
                        u.join(1.0)
                    raise errors.RaftTimeoutError(
                        f"Comms.run: rank threads made no progress for "
                        f"{timeout + 5.0:.1f} s")
        if failures:
            raise failures[0]
        if turns.timed_out:
            raise errors.RaftTimeoutError(
                f"Comms.run: a rendezvous timed out after {timeout:.1f} s "
                "(a rank never reached a collective its peers wait at)")
        return _collect(outs, out)


class HierarchicalComms(Comms):
    """Two-level in-process communicator over an (outer, inner) rank grid —
    the multi-host topology: ``inner`` = chips of one host (``"ici"``),
    ``outer`` = across hosts (``"dcn"``). Ranks number row-major over
    (outer, inner). Inside :meth:`run`, ``ax`` spans both levels and
    ``ax.level(axes[0])`` / ``ax.level(axes[1])`` (or
    :meth:`outer_comms` / :meth:`inner_comms` of ``ax``) are the rank's
    facades over each level."""

    def __init__(self, devices=None, mesh_shape=None, axes=("dcn", "ici"),
                 *, timeout_s: float = DEFAULT_TIMEOUT_S):
        super().__init__(devices, axis=tuple(axes), timeout_s=timeout_s)
        if mesh_shape is None:
            mesh_shape = (1, self.size)
        errors.expects(
            len(mesh_shape) == len(axes) == 2,
            "mesh_shape %s must have one dim per axis %s", mesh_shape, axes,
        )
        errors.expects(
            int(mesh_shape[0]) * int(mesh_shape[1]) == self.size,
            "mesh_shape %s needs %d devices, got %d", mesh_shape,
            int(mesh_shape[0]) * int(mesh_shape[1]), self.size,
        )
        self.axes = tuple(axes)
        self.mesh_shape = (int(mesh_shape[0]), int(mesh_shape[1]))
        self._level_shape = (self.axes[0], self.axes[1], *self.mesh_shape)

    @property
    def inner_size(self) -> int:
        return self.mesh_shape[1]

    @property
    def outer_size(self) -> int:
        return self.mesh_shape[0]

    def host_of(self, rank: int) -> int:
        errors.expects(0 <= rank < self.size,
                       "rank %d out of range [0, %d)", rank, self.size)
        return rank // self.inner_size

    def inner_comms(self, ax: _Collectives) -> _Collectives:
        """``ax``'s facade over the chips of its host (ICI)."""
        return ax.level(self.axes[1])

    def outer_comms(self, ax: _Collectives) -> _Collectives:
        """``ax``'s facade across hosts (DCN)."""
        return ax.level(self.axes[0])

    def hierarchical_allreduce(self, ax: _Collectives, x):
        """See :func:`hierarchical_allreduce`."""
        return hierarchical_allreduce(ax, x, self.axes)


def hierarchical_allreduce(ax: _Collectives, x, axes=("dcn", "ici")):
    """The bandwidth-optimal two-level allreduce, stated explicitly:
    reduce-scatter within the host, allreduce the shards across hosts,
    allgather the result back within the host. A leading dim not
    divisible by the inner size is padded with zero rows and sliced
    back. Call inside ``run`` of a two-level communicator."""
    inner, outer = ax.level(axes[1]), ax.level(axes[0])
    inner_size = inner.get_size()
    n0 = x.shape[0]
    rem = n0 % inner_size
    if rem:
        pad = torch.zeros((inner_size - rem,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    shard = inner.reducescatter(x, tiled=True)
    shard = outer.allreduce(shard)
    out = inner.allgather(shard, tiled=True)
    return out[:n0] if rem else out


# ----------------------------------------------------- torch.distributed
_DIST_OPS = {
    ReduceOp.SUM: "SUM", ReduceOp.PROD: "PRODUCT",
    ReduceOp.MIN: "MIN", ReduceOp.MAX: "MAX",
}


def _wire(x):
    """A tensor as a collective carries it: contiguous, at least 1-D,
    bool as uint8 (NCCL has no bool). Returns (wire tensor, undo)."""
    x = torch.as_tensor(x)
    shape, dtype = tuple(x.shape), x.dtype
    w = x.reshape(-1) if x.dim() == 0 else x
    if dtype == torch.bool:
        w = w.to(torch.uint8)
    w = w.contiguous()

    def undo(t, lead=()):
        t = t.reshape(tuple(lead) + shape)
        return t.to(torch.bool) if dtype == torch.bool else t

    return w, undo


class DistAxisComms(_Collectives):
    """One process's collective facade over a torch.distributed process
    group — the :class:`AxisComms` methods mapped onto the group's
    collectives."""

    def __init__(self, axis, group, device, levels: Optional[dict] = None):
        import torch.distributed as dist

        self._dist = dist
        self.axis = axis
        self.group = group
        self.device = torch.device(device)
        self._size = dist.get_world_size(group)
        self._rank = dist.get_rank(group)
        self.levels = levels or {}

    def get_size(self) -> int:
        return self._size

    def get_rank(self) -> int:
        return self._rank

    def _global(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def _op(self, op):
        return getattr(self._dist.ReduceOp, _DIST_OPS[_resolve_op(op)])

    def allreduce(self, x, op=ReduceOp.SUM):
        w, undo = _wire(x)
        w = w.clone()
        self._dist.all_reduce(w, op=self._op(op), group=self.group)
        return undo(w)

    def bcast(self, x, root: int = 0):
        w, undo = _wire(x)
        w = w.clone()
        self._dist.broadcast(w, src=self._global(root), group=self.group)
        return undo(w)

    def allgather(self, x, axis: int = 0, tiled: bool = False):
        w, undo = _wire(x)
        outw = torch.empty((self._size * w.shape[0],) + tuple(w.shape[1:]),
                           dtype=w.dtype, device=w.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            self._dist.all_gather_into_tensor(outw, w, group=self.group)
        g = undo(outw, (self._size,))                # (size, *x.shape)
        if tiled:
            return torch.cat(list(g.unbind(0)), axis)
        return g if axis == 0 else torch.movedim(g, 0, axis)

    def reducescatter(self, x, op=ReduceOp.SUM, tiled: bool = False):
        sz = self._size
        errors.expects(
            x.shape[0] % sz == 0 and (tiled or x.shape[0] == sz),
            "reducescatter: leading dim %d does not split into the "
            "communicator size %d", x.shape[0], sz,
        )
        if _resolve_op(op) != ReduceOp.SUM:
            red = self.allreduce(x, op)
            if not tiled:
                return red[self._rank]
            c = x.shape[0] // sz
            return red[self._rank * c:(self._rank + 1) * c]
        c = x.shape[0] // sz
        w = x.contiguous()
        out = torch.empty((c,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            self._dist.reduce_scatter_tensor(out, w, group=self.group)
        return out if tiled else out[0]

    def alltoall(self, x):
        errors.expects(
            x.shape[0] == self._size,
            "alltoall: leading dim %d != communicator size %d",
            x.shape[0], self._size,
        )
        w, undo = _wire(x)
        out = torch.empty_like(w)
        self._dist.all_to_all_single(out, w, group=self.group)
        return undo(out)

    def sendrecv(self, x, perm: Sequence[Tuple[int, int]]):
        x = torch.as_tensor(x)
        w, undo = _wire(x)
        me = self._rank
        got = None
        ops = []
        for s, d in perm:
            if s == me and d == me:
                got = w.clone()
            elif s == me:
                ops.append(self._dist.P2POp(self._dist.isend, w,
                                            self._global(d), self.group))
            elif d == me:
                got = torch.empty_like(w)
                ops.append(self._dist.P2POp(self._dist.irecv, got,
                                            self._global(s), self.group))
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return torch.zeros_like(x) if got is None else undo(got)

    def barrier(self):
        z = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._dist.all_reduce(z, group=self.group)
        return z[0]


class DistComms:
    """The torch.distributed communicator: one process per rank over a
    process group (the default group when ``group`` is None). The same
    per-rank bodies as :class:`Comms` run through :meth:`run`, on this
    process's rank only. ``mesh_shape=(n_outer, n_inner)`` makes it
    two-level (ranks row-major over (outer, inner), as in
    :class:`HierarchicalComms`): every process creates the level groups
    in the same order, as ``new_group`` requires."""

    def __init__(self, group=None, device=None, axis="ranks", *,
                 mesh_shape=None, axes=("dcn", "ici")):
        import torch.distributed as dist

        errors.expects(dist.is_initialized(),
                       "DistComms: torch.distributed is not initialized "
                       "(Comms.initialize_distributed)")
        self._dist = dist
        self.group = group
        self.device = torch.device("cpu" if device is None else device)
        self.rank = dist.get_rank(group)
        self._size = dist.get_world_size(group)
        self.axis = axis
        self._level_shape = None
        self._level_groups = {}
        if mesh_shape is not None:
            n_out, n_in = int(mesh_shape[0]), int(mesh_shape[1])
            errors.expects(n_out * n_in == self._size,
                           "mesh_shape %s needs %d ranks, got %d",
                           mesh_shape, n_out * n_in, self._size)
            self.axes = tuple(axes)
            self.axis = self.axes
            self.mesh_shape = (n_out, n_in)
            self._level_shape = (self.axes[0], self.axes[1], n_out, n_in)
            members = self._members()
            me_o, me_i = divmod(self.rank, n_in)
            for o in range(n_out):
                g = dist.new_group([members[o * n_in + i]
                                    for i in range(n_in)])
                if o == me_o:
                    self._level_groups[self.axes[1]] = g
            for i in range(n_in):
                g = dist.new_group([members[o * n_in + i]
                                    for o in range(n_out)])
                if i == me_i:
                    self._level_groups[self.axes[0]] = g

    def _members(self):
        if self.group is None:
            return list(range(self._size))
        return [self._dist.get_global_rank(self.group, r)
                for r in range(self._size)]

    @property
    def size(self) -> int:
        return self._size

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The ranks this process runs: its own."""
        return (self.rank,)

    @property
    def levels(self):
        return self._level_shape

    def rank_device(self, rank: int) -> torch.device:
        return self.device

    def device_comms(self) -> DistAxisComms:
        levels = {name: DistAxisComms(name, g, self.device)
                  for name, g in self._level_groups.items()}
        return DistAxisComms(self.axis, self.group, self.device, levels)

    def comm_split(self, colors: Sequence[int],
                   keys: Optional[Sequence[int]] = None):
        """Partition ranks by color into sub-communicators (``new_group``,
        called by every process for every color in the same order).
        Returns {color: DistComms} for the colors this process is in."""
        if keys is None:
            keys = list(range(self._size))
        members = self._members()
        groups: dict = {}
        for r, color, key in sorted(zip(range(self._size), colors, keys),
                                    key=lambda t: (t[1], t[2])):
            groups.setdefault(color, []).append(members[r])
        out = {}
        for c, ranks in sorted(groups.items()):
            g = self._dist.new_group(ranks)
            if members[self.rank] in ranks:
                out[c] = DistComms(g, self.device, f"{self.axis}_split{c}")
        return out

    def run(self, body, *, sharded: Sequence = (),
            replicated: Sequence = (), out="replicated"):
        """Run ``body(ax, *blocks, *replicated)`` on this process's rank
        (its block is slot 0 of each sharded operand); outputs as in
        :meth:`Comms.run`. The process group's own timeout bounds every
        collective."""
        ax = self.device_comms()
        res = body(ax, *[_rank_block(s, 0) for s in sharded],
                   *replicated)
        return _collect([res], out)

    def hierarchical_allreduce(self, ax: _Collectives, x):
        return hierarchical_allreduce(ax, x, self.axes)


def build_comms(devices=None, axis: str = "ranks", *,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Comms:
    """An in-process communicator over ``devices`` (every CUDA device by
    default); analog of ``build_comms_nccl_only`` (helper.hpp:37-45)."""
    return Comms(devices=devices, axis=axis, timeout_s=timeout_s)


def build_comms_hierarchical(devices=None, mesh_shape=None,
                             axes=("dcn", "ici"), *,
                             timeout_s: float = DEFAULT_TIMEOUT_S
                             ) -> HierarchicalComms:
    """A two-level in-process communicator; see
    :class:`HierarchicalComms`."""
    return HierarchicalComms(devices=devices, mesh_shape=mesh_shape,
                             axes=axes, timeout_s=timeout_s)


def inject_comms(resources, comms) -> None:
    """Attach a communicator to a resources handle (the analog of
    ``inject_comms_on_handle`` → ``handle.set_comms``): its
    ``set_comms`` when it has one, and its ``comms`` attribute."""
    setter = getattr(resources, "set_comms", None)
    if callable(setter):
        setter(comms)
    resources.comms = comms
