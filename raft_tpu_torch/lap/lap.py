"""Linear assignment of the port — the counterpart of
``raft_tpu/lap/lap.py`` (analog of cpp/include/raft/lap/lap.cuh:44-192
``LinearAssignmentProblem``).

The JAX package's auction algorithm with epsilon scaling (Bertsekas):
every round is dense row-parallel work (each unassigned row's best and
second-best column, a max-scatter of the bids, the lowest-row winner by
a min-scatter). :func:`_auction_round` is the JAX package's round op for
op. Its ``lax.while_loop`` is a host loop here, with one host sync a
round (the "all assigned" test), inside a host loop over the ten
epsilon phases; on a card each round replays one CUDA graph; :func:`solve_lap_batched` runs the batch as one tensor
with a per-problem active mask, so a solved problem stays as it is
while the others go on (``vmap``'s semantics of a batched while loop).

f32 costs compute in f32, as on the JAX package's CPU; f64 costs compute
in f64 (the reference's double instantiation, which the JAX package
reaches only under x64).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import call_device

__all__ = ["solve_lap", "solve_lap_batched", "LinearAssignmentProblem"]

# epsilon scaling: geometric phases from half the benefit spread down to
# _TOL / n (optimal to within n * eps_final = _TOL, exactly optimal for
# integer costs)
_N_PHASES = 10
_TOL = 1e-4


class _AuctionState(NamedTuple):
    row_to_col: torch.Tensor   # (B, n) int32, -1 unassigned
    col_to_row: torch.Tensor   # (B, n) int32, -1 unassigned
    prices: torch.Tensor       # (B, n)
    eps: torch.Tensor          # (B, 1)


def _auction_round(benefits, state: _AuctionState) -> _AuctionState:
    """One round over a batch (B, n, n): each unassigned row bids for its
    best column; each column takes the highest bid, ties to the lowest
    row; the column's price rises by the bid."""
    bsz, n, _ = benefits.shape
    dev = benefits.device
    unassigned = state.row_to_col < 0
    rows = torch.arange(n, dtype=torch.int32, device=dev).expand(bsz, n)

    values = benefits - state.prices[:, None, :]
    best_val, best_col = torch.max(values, dim=2)
    masked = values.scatter(2, best_col[:, :, None], float("-inf"))
    second_val = torch.amax(masked, dim=2)
    second_val = torch.where(torch.isfinite(second_val), second_val, best_val)
    bid = best_val - second_val + state.eps

    # columns take the highest bid (max-scatter)
    ninf = torch.full((bsz, n), float("-inf"), dtype=benefits.dtype,
                      device=dev)
    col_bid = ninf.scatter_reduce(1, best_col, torch.where(
        unassigned, bid, ninf), "amax")
    got_bid = col_bid > float("-inf")
    # the winning row per column: among rows bidding the winning amount,
    # the lowest
    winner = torch.full((bsz, n), n, dtype=torch.int32,
                        device=dev).scatter_reduce(
        1, best_col, torch.where(
            unassigned & (bid == torch.gather(col_bid, 1, best_col)),
            rows, n), "amin")

    # columns with bids switch to their winner; row_to_col is rebuilt
    # from col_to_row (unassigned columns write to a dropped slot)
    new_col_to_row = torch.where(got_bid, winner, state.col_to_row)
    slot = torch.where(new_col_to_row >= 0, new_col_to_row, n).long()
    row_to_col = torch.full((bsz, n + 1), -1, dtype=torch.int32,
                            device=dev).scatter(1, slot, rows)[:, :n]
    prices = torch.where(got_bid, state.prices + col_bid, state.prices)
    return _AuctionState(row_to_col, new_col_to_row, prices, state.eps)


def _phase_eps(benefits):
    """The ten epsilon values of each problem (B, phases), in the cost
    type: from half the benefit spread down to _TOL / n, geometric."""
    bsz, n, _ = benefits.shape
    flat = benefits.reshape(bsz, -1)
    spread = torch.clamp_min(torch.amax(flat, 1) - torch.amin(flat, 1), 1.0)
    eps0 = spread / 2.0
    eps_final = _TOL / n
    factor = torch.exp(torch.log(eps_final / eps0) / (_N_PHASES - 1))
    steps = torch.arange(_N_PHASES, dtype=benefits.dtype,
                         device=benefits.device)
    return eps0[:, None] * factor[:, None] ** steps[None, :]


class _Rounds:
    """A batch's auction rounds on state tensors updated in place: each
    round moves the problems that still have an unassigned row (the
    others stay as they are) and refreshes their ``active`` flags. On a
    card the round is one CUDA graph, captured once a solve and replayed
    (the same kernels as the eager round, without a host dispatch of
    each: the loop's rounds are many and small); on the CPU it runs
    eagerly."""

    def __init__(self, benefits, prices):
        bsz, n, _ = benefits.shape
        dev = benefits.device
        self.benefits = benefits
        self.state = _AuctionState(
            torch.full((bsz, n), -1, dtype=torch.int32, device=dev),
            torch.full((bsz, n), -1, dtype=torch.int32, device=dev),
            prices.clone(), torch.zeros((bsz, 1), dtype=prices.dtype,
                                        device=dev))
        self.active = torch.ones(bsz, dtype=torch.bool, device=dev)
        self.graph = None
        if dev.type == "cuda":
            # every kernel of the round runs once before the capture
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _auction_round(benefits, _AuctionState(
                    *(t.clone() for t in self.state)))
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._step()

    def phase(self, eps):
        """Start a phase: every row unassigned, the prices kept."""
        self.state.row_to_col.fill_(-1)
        self.state.col_to_row.fill_(-1)
        self.state.eps.copy_(eps)
        self.active.fill_(True)

    def _step(self):
        nxt = _auction_round(self.benefits, self.state)
        keep = self.active[:, None]
        for dst, new in zip(self.state[:3], nxt[:3]):
            dst.copy_(torch.where(keep, new, dst))
        self.active.copy_(torch.any(self.state.row_to_col < 0, dim=1))

    def run(self):
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()


def _solve(cost, maximize: bool, info: Optional[dict]):
    """The batched auction over (B, n, n) costs: (assignments (B, n)
    int32, objectives (B,))."""
    bsz, n, _ = cost.shape
    benefits = cost if maximize else -cost
    epss = _phase_eps(benefits)
    rounds_ = _Rounds(benefits, torch.zeros((bsz, n), dtype=cost.dtype,
                                            device=cost.device))
    rounds = syncs = 0
    for ph in range(_N_PHASES):
        rounds_.phase(epss[:, ph:ph + 1])    # the prices persist
        while True:
            syncs += 1
            if not bool(torch.any(rounds_.active)):
                break
            rounds_.run()
            rounds += 1
    row_to_col = rounds_.state.row_to_col.clone()
    total = torch.sum(torch.gather(cost, 2, row_to_col.long()[:, :, None]),
                      dim=(1, 2))
    if info is not None:
        info.update(rounds=rounds, syncs=syncs)
    return row_to_col, total


def _costs(cost, device):
    """The costs as a tensor on the call's device, in their type promoted
    to at least f32 (f64 stays f64)."""
    cost = torch.as_tensor(cost, device=call_device(cost, device=device))
    return cost.to(torch.promote_types(cost.dtype, torch.float32))


def solve_lap(cost, *, maximize: bool = False, info: Optional[dict] = None,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve one n x n assignment. Returns (row assignment (n,) int32,
    total objective), as ``LinearAssignmentProblem::solve``. Computes in
    the cost type promoted to at least f32 (f64 stays f64). ``info``, a
    dict, receives ``rounds`` (auction rounds over the phases) and
    ``syncs`` (host syncs: one a round and one a phase's last test).
    Runs on ``device`` when given, else on ``cost``'s device if it is a
    tensor, else on CUDA."""
    cost = _costs(cost, device)
    errors.check_matrix(cost, "cost")
    errors.expects(cost.shape[0] == cost.shape[1],
                   "cost must be square, got %s", tuple(cost.shape))
    rows, total = _solve(cost[None], maximize, info)
    return rows[0], total[0]


def solve_lap_batched(costs, *, maximize: bool = False,
                      info: Optional[dict] = None, device=None):
    """A batch of assignments (B, n, n) in one tensor (reference lap.cuh
    batchsize dimension): each problem's rounds stop once it is solved,
    as ``vmap`` of the JAX package's loop leaves it. Returns
    (assignments (B, n) int32, objectives (B,))."""
    costs = _costs(costs, device)
    errors.expects(costs.dim() == 3 and costs.shape[1] == costs.shape[2],
                   "costs must be (batch, n, n), got %s", tuple(costs.shape))
    return _solve(costs, maximize, info)


class LinearAssignmentProblem:
    """API-parity wrapper (reference lap.cuh:44): construct with the size,
    call ``solve(cost_batch)``; keeps the row assignments and
    objectives."""

    def __init__(self, size: int, batchsize: int = 1):
        self.size = size
        self.batchsize = batchsize
        self.row_assignments = None
        self.obj_vals = None

    def solve(self, costs, maximize: bool = False, *, device=None):
        costs = _costs(costs, device).float()
        if costs.dim() == 2:
            costs = costs[None]
        rows, objs = solve_lap_batched(costs, maximize=maximize)
        self.row_assignments = rows
        self.obj_vals = objs
        return rows, objs
