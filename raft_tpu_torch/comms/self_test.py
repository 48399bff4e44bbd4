"""Built-in communicator round-trip self-tests — the port of
``raft_tpu/comms/self_test.py`` (the analog of
``raft::comms::test_collective_*``, cpp/include/raft/comms/detail/
test.hpp:41-544).

Each function runs a small collective through ``comms.run`` — the
in-process :class:`~raft_tpu_torch.comms.comms.Comms` or a
:class:`~raft_tpu_torch.comms.comms.DistComms` alike — and returns True
iff every rank observed the expected value: each rank folds its own
verdict into one ``MIN`` allreduce, so a rank that saw a wrong value
fails the test on every rank.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.comms.comms import ReduceOp

__all__ = [
    "test_collective_allreduce",
    "test_collective_broadcast",
    "test_collective_reduce",
    "test_collective_allgather",
    "test_collective_gather",
    "test_collective_gatherv",
    "test_collective_reducescatter",
    "test_collective_alltoall",
    "test_pointToPoint_simple_send_recv",
    "test_collective_comm_split",
    "SELF_TESTS",
    "run_all_self_tests",
]

# pytest must not collect these user-facing self-test helpers as test items
__test__ = False

_I32 = torch.int32


def _run(comms, check) -> bool:
    """Run ``check(ax) -> bool tensor`` on every rank; True iff every
    rank's check held."""
    def body(ax):
        ok = torch.as_tensor(check(ax), device=ax.device).to(_I32).reshape(())
        return ax.allreduce(ok, ReduceOp.MIN)

    return bool(int(comms.run(body)) == 1)


def _rank(ax):
    return torch.tensor(ax.get_rank(), dtype=_I32, device=ax.device)


def test_collective_allreduce(comms) -> bool:
    """Each rank contributes 1; expects size (reference test.hpp:41)."""
    def check(ax):
        val = ax.allreduce(torch.ones((), dtype=_I32, device=ax.device))
        return val == ax.get_size()

    return _run(comms, check)


def test_collective_broadcast(comms, root: int = 0) -> bool:
    """Root broadcasts its rank; all expect root (reference test.hpp:84)."""
    return _run(comms, lambda ax: ax.bcast(_rank(ax), root=root) == root)


def test_collective_reduce(comms, root: int = 0) -> bool:
    def check(ax):
        got = ax.reduce(torch.ones((), dtype=_I32, device=ax.device),
                        root=root)
        return got == ax.get_size()

    return _run(comms, check)


def _arange(ax):
    return torch.arange(ax.get_size(), dtype=_I32, device=ax.device)


def test_collective_allgather(comms) -> bool:
    """Each rank contributes its rank; expects [0..size) (test.hpp:162)."""
    def check(ax):
        g = ax.allgather(_rank(ax)[None])
        return torch.equal(g, _arange(ax)[:, None])

    return _run(comms, check)


def test_collective_gather(comms, root: int = 0) -> bool:
    def check(ax):
        g = ax.gather(_rank(ax)[None], root=root)
        return torch.equal(g, _arange(ax)[:, None])

    return _run(comms, check)


def test_collective_gatherv(comms, root: int = 0) -> bool:
    """Ragged gather: rank r contributes r+1 copies of r (test.hpp:251)."""
    def check(ax):
        size = ax.get_size()
        me = _rank(ax)
        count = me + 1
        ar = _arange(ax)
        mine = torch.where(ar < count, me, 0).to(_I32)
        slots, counts = ax.allgatherv(mine, count, max_count=size)
        ok_counts = torch.equal(counts, ar + 1)
        want = torch.where(ar[None, :] < (ar + 1)[:, None], ar[:, None], 0)
        return ok_counts and torch.equal(slots, want.to(_I32))

    return _run(comms, check)


def test_collective_reducescatter(comms) -> bool:
    """Each rank sends ones(size); each receives size (test.hpp:310)."""
    def check(ax):
        out = ax.reducescatter(
            torch.ones((ax.get_size(),), dtype=_I32, device=ax.device))
        return bool((out == ax.get_size()).all())

    return _run(comms, check)


def test_pointToPoint_simple_send_recv(comms) -> bool:
    """Ring exchange: rank r sends r to r+1; expects r-1 (test.hpp:341)."""
    def check(ax):
        me = _rank(ax)
        return ax.ring_shift(me, 1) == (me - 1) % ax.get_size()

    return _run(comms, check)


def test_collective_alltoall(comms) -> bool:
    """Rank r sends value r*size+j to rank j; slot s must read s*size+me
    (the MPI_Alltoall contract; the row exchange of the distributed
    index build)."""
    def check(ax):
        size = ax.get_size()
        me = _rank(ax)
        sent = me * size + _arange(ax)[:, None]
        got = ax.alltoall(sent)                            # (size, 1)
        return torch.equal(got, _arange(ax)[:, None] * size + me)

    return _run(comms, check)


def test_collective_comm_split(comms) -> bool:
    """Split into even/odd halves; allreduce inside each half
    (reference test_commsplit, test.hpp:477)."""
    n = comms.size
    colors = [i % 2 for i in range(n)]
    subs = comms.comm_split(colors)
    for color, sub in subs.items():
        if not test_collective_allreduce(sub):
            return False
        if sub.size != sum(1 for c in colors if c == color):
            return False
    return True


# the canonical ordered sweep: run_all_self_tests runs it whole; the
# serving health probe (raft_tpu_torch.resilience.health_check) walks it
# one collective at a time to attach per-collective timings
SELF_TESTS = {
    "allreduce": test_collective_allreduce,
    "broadcast": test_collective_broadcast,
    "reduce": test_collective_reduce,
    "allgather": test_collective_allgather,
    "gather": test_collective_gather,
    "gatherv": test_collective_gatherv,
    "reducescatter": test_collective_reducescatter,
    "alltoall": test_collective_alltoall,
    "sendrecv": test_pointToPoint_simple_send_recv,
    "comm_split": test_collective_comm_split,
}


def run_all_self_tests(comms) -> dict:
    """Run the full round-trip suite; returns {name: bool}."""
    return {name: fn(comms) for name, fn in SELF_TESTS.items()}
