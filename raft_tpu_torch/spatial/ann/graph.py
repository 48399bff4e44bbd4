"""Fixed-degree kNN-graph ANN index and batched beam search — the port
of ``raft_tpu/spatial/ann/graph.py`` (CAGRA-style; docs/graph_ann.md).

**Construction** (:func:`graph_build`): the kNN graph of the rows
(:func:`raft_tpu_torch.sparse.knn_graph.knn_graph`, symmetrized), a
degree-bounded occlusion prune, a reachability patch from seeded entry
points, and a static ``(n + 1, degree)`` int32 adjacency padded with
``-1`` (the extra row is the sentinel node's). The JAX package runs the
prune and the patch in numpy on the host; the port runs the prune in
torch on the index's device, blocked over rows, and the patch's
distances there too. Their results follow the JAX rules step for step;
on generic data the order of f32 sums may differ from numpy's, which
can flip a comparison that is tied to within a few ulp.

**Search** (:func:`graph_search`): the JAX package's one jitted program
becomes an eager loop of ``iters`` rounds over a fixed-width pool of
``P = max(k, beam) + beam`` (distance, id, expanded) slots per query.
Each round expands the ``beam`` best unexpanded entries, gathers their
neighbours, drops duplicates and visited ids (a hashed visited table of
``2^hash_bits + 1`` bytes per query), scores the new candidates and
keeps the best ``P`` of pool and candidates. Every selection is the
port's stable :func:`~raft_tpu_torch.spatial.selection.top_k_smallest`,
which breaks ties as ``lax.top_k`` does, so the walk expands and keeps
the same slots. Candidates are scored by one of two engines:

* the **kernel engine**: the hand-written CUDA scan
  (:mod:`.graph_kernel`) reads each candidate row once and writes the
  8-row sub-chunk minima of each query's padded candidate list (bf16
  operands) and every candidate's exact f32 distance; the top ``s``
  sub-chunks are kept with their exact distances;
* the **exact engine**: every candidate is scored exactly by
  :func:`~.common.score_l2_candidates`.

Both tails rescore the pool with :func:`~.common.score_l2_candidates`
(full f32), so returned distances are exact in both. The tombstone
``row_mask`` is folded only at the final rerank: a deleted row still
guides the walk and is never returned.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
import typing
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import (
    as_tensor, full_f32, hopper_device, resolve_device,
)
from raft_tpu_torch.distance.pairwise import relu0, sqrt_f64
from raft_tpu_torch.spatial.ann import graph_kernel as gk
from raft_tpu_torch.spatial.ann.common import score_l2_candidates
from raft_tpu_torch.spatial.ann.scan_core import LANE, SUBCHUNK, round_up
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = [
    "GraphParams", "GraphStorage", "GraphIndex", "graph_build",
    "graph_search", "graph_live_mask", "graph_delete", "graph_restore",
]

logger = logging.getLogger("raft_tpu_torch")

# Sentinel-row fill value: the padded data row every invalid candidate id
# gathers; its squared distance (~d * 1e30) orders after every real row
# and stays finite.
_SENTINEL_VAL = 1e15

# Knuth multiplicative hash constant (2^32 / phi) for the visited table.
_HASH_MULT = 2654435761

# searches of a CUDA index that use_kernel=None sent to the exact engine
# because the kernel cannot serve them
ENGINE_FALLBACKS = 0
_fallback_reasons_warned: set = set()

@dataclasses.dataclass(frozen=True)
class GraphParams:
    """Build knobs of the fixed-degree graph (CAGRA's graph_degree /
    intermediate_graph_degree pair)."""

    degree: int = 16
    # candidate pool per node handed to the occlusion prune (the
    # pre-prune kNN width); None = 2x degree
    intermediate_degree: typing.Optional[int] = None
    seed: int = 0
    # deterministic entry points seeding every walk
    n_entry: int = 4


@dataclasses.dataclass
class GraphStorage:
    """The graph half of the index."""

    adjacency: torch.Tensor   # (n + 1, degree) int32, -1 padded; row n all -1
    entries: torch.Tensor     # (n_entry,) int32, the seeded entry points

    @property
    def n(self) -> int:
        return self.adjacency.shape[0] - 1

    @property
    def degree(self) -> int:
        return self.adjacency.shape[1]


@dataclasses.dataclass
class GraphIndex:
    data_padded: torch.Tensor   # (n + 1, d) f32, the last row the sentinel
    storage: GraphStorage
    metric: str
    # graph_build's stages: seconds of the kNN graph, the prune and the
    # patch, the kNN-graph edges, the edges the patch wrote, the distinct
    # rows they point to and the unreached rows of each patch round
    build_stats: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.storage.n

    @property
    def device(self) -> torch.device:
        return self.data_padded.device

    def warmup(self, nq: int, *, k: int = 10, beam: int = 32,
               iters: typing.Optional[int] = None,
               hash_bits: typing.Optional[int] = None,
               use_kernel: typing.Optional[bool] = None,
               with_mask: bool = False) -> int:
        """Run one all-zeros (nq, d) batch through :func:`graph_search`
        (building the CUDA kernel and initialising the device libraries
        on first use) and return the resolved ``iters``
        (:func:`_auto_iters` when None), to pass on every serving
        dispatch. ``with_mask=True`` passes an all-live tombstone mask.
        The JAX package's ``audit=`` option (its jaxpr program auditor)
        has no counterpart in the port and is not offered."""
        it = _auto_iters(self.n) if iters is None else iters
        q0 = torch.zeros((nq, self.data_padded.shape[1]),
                         dtype=torch.float32, device=self.device)
        graph_search(self, q0, k, beam=beam, iters=it, hash_bits=hash_bits,
                     row_mask=graph_live_mask(self) if with_mask else None,
                     use_kernel=use_kernel)
        _sync(self.device)
        return it


def _auto_iters(n: int) -> int:
    """Default hop budget: O(log n) hops plus a margin of 4 for
    prune-induced detours."""
    return min(32, max(4, int(math.ceil(math.log2(max(n, 2)))) + 4))


def _auto_hash_bits(iters: int, beam: int, degree: int,
                    n_entry: int) -> int:
    """Visited-table width: ~8 slots per possible insertion, clamped so
    the per-query table stays between 1 KiB and 1 MiB."""
    marks = max(2, n_entry + iters * beam * degree)
    return min(20, max(10, int(math.ceil(math.log2(8 * marks)))))


def _resolve_beam_engine(use_kernel, d: int, c: int,
                         device: torch.device) -> bool:
    """Resolve the ``use_kernel`` knob of the beam search; ``c`` is the
    per-round candidate count (``beam * degree``).

    ``None``: the CUDA kernel engine on a capability-9.0 CUDA device
    whenever :func:`~.graph_kernel.beam_scan_supported` holds, the exact
    engine elsewhere; a CUDA index sent to the exact engine is counted in
    ``ENGINE_FALLBACKS`` and warned about once per reason. ``True``: the
    kernel engine, raising with the unmet requirement (on a CPU index it
    runs the scan's plain version). ``False``: the exact engine."""
    c_pad = round_up(c, LANE)
    if use_kernel is None:
        if device.type != "cuda":
            return False
        if not gk.beam_scan_supported(d, c_pad):
            reason = (f"d={d} does not fit the beam kernel's shared-memory "
                      "row tile")
        elif not hopper_device(device):
            reason = f"{device} is not a capability-9.0 (Hopper) card"
        else:
            return True
        global ENGINE_FALLBACKS
        ENGINE_FALLBACKS += 1
        if reason not in _fallback_reasons_warned:
            _fallback_reasons_warned.add(reason)
            logger.warning(
                "graph search of a CUDA index runs the exact engine, not "
                "the CUDA beam kernel: %s (use_kernel=False chooses it "
                "without this warning)", reason)
        return False
    if use_kernel:
        errors.expects(
            gk.beam_scan_supported(d, c_pad),
            "use_kernel=True unsupported at d=%d candidates=%d: the beam "
            "kernel's shared-memory row tile does not fit a block; use the "
            "exact engine (use_kernel=False)", d, c,
        )
        errors.expects(
            device.type == "cpu" or hopper_device(device),
            "use_kernel=True needs a capability-9.0 (Hopper) CUDA device "
            "for the sm_90a kernel; %s is not one", device,
        )
    return bool(use_kernel)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# construction


def graph_build(x, params: GraphParams = GraphParams(), *,
                metric: str = "l2", device=None) -> GraphIndex:
    """Build the fixed-degree graph index: kNN graph (reverse edges
    through ``symmetrize``) -> occlusion prune -> reachability patch ->
    static padded adjacency. Deterministic for a given (x, params); the
    entry points are the JAX package's (the same numpy draw). The rows are
    stored as f32. ``device`` defaults to CUDA and raises when no CUDA
    device is present; the stages' times and counts land in the index's
    ``build_stats``."""
    from raft_tpu_torch.sparse.knn_graph import knn_graph

    dev = resolve_device(device)
    x = as_tensor(x, dev)
    errors.check_matrix(x, "x", min_rows=2)
    x = x.float()
    n, d = x.shape
    deg = min(params.degree, n - 1)
    errors.expects(deg >= 1, "degree must be >= 1, got %d", params.degree)
    idg = params.intermediate_degree
    idg = 2 * deg if idg is None else idg
    idg = min(max(idg, deg), n - 1)

    t0 = time.perf_counter()
    g = knn_graph(x, idg, symmetrize=True)
    nnz = int(g.nnz)
    t1 = time.perf_counter()
    rows = g.rows[:nnz].long()
    cols = g.cols[:nnz].long()
    del g
    adjacency = _occlusion_prune(x, rows, cols, deg, 2 * idg)
    del rows, cols
    _sync(dev)
    t2 = time.perf_counter()

    rng = np.random.default_rng(params.seed)
    n_entry = max(1, min(params.n_entry, n))
    entries = np.sort(
        rng.choice(n, size=n_entry, replace=False)
    ).astype(np.int32)
    adjacency, patch = _patch_reachability(adjacency, entries, x)
    t3 = time.perf_counter()

    stats = dict(knn_graph_s=t1 - t0, prune_s=t2 - t1, patch_s=t3 - t2,
                 edges=nnz, **patch)
    logger.info("graph_build: %d rows, %d kNN-graph edges; kNN graph %.2f "
                "s, prune %.2f s, patch %.2f s (%d edges written to %d "
                "rows; unreached rows by round %s)", n, nnz, t1 - t0,
                t2 - t1, t3 - t2, patch["patch_edges"],
                patch["patched_rows"], patch["patch_misses"])
    adj_pad = torch.cat([
        adjacency, torch.full((1, deg), -1, dtype=torch.int32, device=dev)])
    data_padded = torch.cat([
        x, torch.full((1, d), _SENTINEL_VAL, device=dev)])
    storage = GraphStorage(adj_pad, torch.as_tensor(entries, device=dev))
    return GraphIndex(data_padded, storage, metric, stats)


def _prune_block_rows(m: int, d: int, dev: torch.device) -> int:
    """Rows per prune block: the (B, m, d) gathers and the (B, m, m)
    pairwise tile of a block stay within a byte budget (rows are
    independent, so the block size does not change the result)."""
    budget = (2 << 30) if dev.type == "cuda" else (64 << 20)
    return max(1, budget // (4 * m * (3 * d + 3 * m)))


@full_f32
def _occlusion_prune(xf: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, degree: int, m_cap: int,
                     block: typing.Optional[int] = None) -> torch.Tensor:
    """Degree-bounded rank/detour prune of a row-sorted COO edge list to
    a dense (n, degree) int32 adjacency, -1 padded, on ``xf``'s device.

    Per node ``u`` the candidates are the first ``m`` of its row in
    column order, ``m = min(max row count, max(degree, m_cap))``; they are
    visited in ascending d(u, ·) order, and ``v`` is kept unless an
    already-kept ``w`` occludes it (``d(w, v) < d(u, v)``). Slots left
    are back-filled with the nearest occluded candidates; rows pad with
    -1 only when a node has fewer candidates than slots. As in the JAX
    package, d(u, ·) is taken in difference form and d(w, v) in gram
    form, and every sort is stable."""
    n = xf.shape[0]
    dev = xf.device
    counts = torch.bincount(rows, minlength=n)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    m = min(max(int(counts.max()), 1), max(degree, m_cap))
    cand = torch.full((n, m), -1, dtype=torch.int64, device=dev)
    within = torch.arange(rows.shape[0], device=dev) - starts[rows]
    sel = within < m
    cand[rows[sel], within[sel]] = cols[sel]
    del counts, starts, within, sel

    out = torch.full((n, degree), -1, dtype=torch.int32, device=dev)
    block = block or _prune_block_rows(m, xf.shape[1], dev)
    inf = float("inf")  # a Python scalar: no host-to-device copy
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        nb = b1 - b0
        cb = cand[b0:b1]
        self_id = torch.arange(b0, b1, device=dev)[:, None]
        valid = (cb >= 0) & (cb != self_id)
        cv = torch.where(valid, cb, torch.zeros_like(cb))
        # drop duplicate ids (symmetrize combines, but stay safe): keep
        # the first occurrence in id order
        ido = torch.sort(
            cv + torch.where(valid, 0, n + 1), dim=1, stable=True)[1]
        sid = torch.gather(cv, 1, ido)
        dup_sorted = torch.zeros((nb, m), dtype=torch.bool, device=dev)
        dup_sorted[:, 1:] = sid[:, 1:] == sid[:, :-1]
        dup = torch.zeros_like(dup_sorted).scatter_(1, ido, dup_sorted)
        valid &= ~dup

        diff = xf[b0:b1, None, :] - xf[cv]                 # (B, m, d)
        cd = torch.sum(diff * diff, dim=2)
        del diff
        cd = torch.where(valid, cd, inf)
        order = torch.sort(cd, dim=1, stable=True)[1]      # by distance
        cs = torch.gather(cv, 1, order)
        cdist = torch.gather(cd, 1, order)
        vs = torch.gather(valid, 1, order)

        cvecs = xf[cs]                                     # (B, m, d)
        nn = torch.sum(cvecs * cvecs, dim=2)
        pw = (nn[:, :, None] + nn[:, None, :]
              - 2.0 * torch.bmm(cvecs, cvecs.transpose(1, 2)))
        del cvecs

        kept = torch.zeros((nb, m), dtype=torch.bool, device=dev)
        occl = ~vs
        kept_count = torch.zeros(nb, dtype=torch.int64, device=dev)
        rng_b = torch.arange(nb, device=dev)
        for _ in range(m):
            avail = ~occl & ~kept
            has = avail.any(dim=1) & (kept_count < degree)
            if not bool(has.any()):
                break
            first = torch.argmax(avail.to(torch.uint8), dim=1)
            kept[rng_b[has], first[has]] = True
            kept_count += has
            occl |= has[:, None] & (pw[rng_b, first] < cdist)
        # kept first, then occluded-but-valid back-fill, both in distance
        # order; invalid last
        klass = torch.where(kept, 0, torch.where(vs, 1, 2))
        fill = torch.sort(klass, dim=1, stable=True)[1][:, :degree]
        ids = torch.gather(cs, 1, fill)
        bad = torch.gather(klass, 1, fill) == 2
        out[b0:b1] = torch.where(bad, -1, ids).to(torch.int32)
    return out


def _reached(adj: np.ndarray, entries: np.ndarray) -> np.ndarray:
    """Rows reachable from ``entries`` over ``adj`` (breadth first)."""
    seen = np.zeros(adj.shape[0], bool)
    seen[entries] = True
    frontier = np.asarray(entries, np.int64)
    while frontier.size:
        nxt = adj[frontier].ravel()
        nxt = nxt[nxt >= 0]
        nxt = np.unique(nxt[~seen[nxt]])
        seen[nxt] = True
        frontier = nxt
    return seen


def _nearest_order(xf, us, rows, top: int):
    """The first ``top`` of each ``us`` row's ``rows`` by (squared
    distance in difference form, id): positions into ``rows`` (ascending
    ids), on the host."""
    dev = xf.device
    u_t = torch.as_tensor(us, device=dev)
    r_t = torch.as_tensor(rows, device=dev)
    diff = xf[r_t][None, :, :] - xf[u_t][:, None, :]
    _, order = top_k_smallest(torch.sum(diff * diff, dim=2), top)
    return order.cpu().numpy()


def _patch_reachability(adj: torch.Tensor, entries: np.ndarray,
                        xf: torch.Tensor, top: int = 64):
    """Make every row reachable from the seeded entries, as the JAX
    package does: each unreached row (ascending) overwrites the last
    unclaimed adjacency slot of its nearest reached row with an edge to
    it; then re-BFS and repeat, since new edges cascade (and overwritten
    ones can cut rows off). Each slot is claimed at most once.

    The JAX package scans every reached row in distance order per
    unreached row. The same choice — the nearest reached row that still
    has a slot, ties to the lower id — is made here from batches: the
    ``top`` nearest rows that had a slot when the batch began (distances
    on ``xf``'s device), a full rescan only when all of those filled
    since, and the round ends once no reached row has a slot. The walk
    and the claims run on the host. Returns the patched adjacency on
    ``adj``'s device and the patch's counts: the edges written, the
    distinct rows they point to, and the unreached rows of each round."""
    dev = xf.device
    adj_np = adj.cpu().numpy().copy()
    n, degree = adj_np.shape
    d = xf.shape[1]
    budget = (1 << 30) if dev.type == "cuda" else (64 << 20)
    claimed = np.zeros(n, np.int64)
    targets = np.zeros(n, bool)
    misses = []
    for _ in range(n):
        seen = _reached(adj_np, entries)
        miss = np.flatnonzero(~seen)
        if not miss.size:
            break
        misses.append(int(miss.size))
        free = np.flatnonzero(seen & (claimed < degree))
        progressed = False
        i = 0
        while i < miss.size and free.size:
            batch = max(1, budget // (4 * d * free.size))
            us = miss[i:i + batch]
            i += batch
            order = _nearest_order(xf, us, free, min(top, free.size))
            for j, u in enumerate(us):
                cands = free[order[j]]
                ok = claimed[cands] < degree
                if ok.any():
                    w = cands[np.argmax(ok)]
                elif cands.size < free.size:
                    # every near row filled within this batch: rescan
                    # the rows that still have a slot
                    left = free[claimed[free] < degree]
                    if not left.size:
                        break
                    w = left[_nearest_order(xf, [u], left, 1)[0, 0]]
                else:
                    break
                adj_np[w, degree - 1 - claimed[w]] = u
                claimed[w] += 1
                targets[u] = True
                progressed = True
            free = free[claimed[free] < degree]
        if not progressed:      # every reached row fully claimed —
            break               # degenerate; leave the remainder
    return torch.as_tensor(adj_np, device=adj.device), dict(
        patch_edges=int(claimed.sum()), patched_rows=int(targets.sum()),
        patch_misses=misses)


# ---------------------------------------------------------------------------
# mutation (tombstones): the mask is an operand of the search, folded at
# the exact tail only. True inserts rebuild the graph.


def graph_live_mask(index: GraphIndex) -> torch.Tensor:
    """All-live (n,) int8 tombstone mask for ``index``."""
    return torch.ones(index.n, dtype=torch.int8, device=index.device)


def _set_rows(row_mask, ids, value: int):
    out = row_mask.clone()
    out[torch.as_tensor(np.asarray(ids), device=out.device).long()] = value
    return out


def graph_delete(row_mask: torch.Tensor, ids) -> torch.Tensor:
    """Tombstone rows (a new mask): deleted rows still guide the walk and
    never appear in results."""
    return _set_rows(row_mask, ids, 0)


def graph_restore(row_mask: torch.Tensor, ids) -> torch.Tensor:
    """Un-tombstone rows (a new mask; the upsert-by-restore half of the
    mutation cycle)."""
    return _set_rows(row_mask, ids, 1)


# ---------------------------------------------------------------------------
# search


def graph_search(index: GraphIndex, queries, k: int, *, beam: int = 32,
                 iters: typing.Optional[int] = None,
                 hash_bits: typing.Optional[int] = None,
                 row_mask: typing.Optional[torch.Tensor] = None,
                 use_kernel: typing.Optional[bool] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy beam search. Returns (dists, ids) with original row
    ids, -1 where fewer than ``k`` reachable live rows exist; squared L2
    distances (the root, through f64, for metric='l2'), exact f32 through
    the shared rerank tail. ``use_kernel`` picks the candidate-scoring
    engine (:func:`_resolve_beam_engine`)."""
    q = torch.as_tensor(queries, device=index.device)
    errors.check_matrix(q, "queries")
    errors.check_same_cols(q, index.data_padded, "queries", "index")
    n = index.n
    errors.check_k(k, n, "k vs graph rows")
    errors.expects(beam >= 1, "beam must be >= 1, got %d", beam)
    it = _auto_iters(n) if iters is None else iters
    hb = _auto_hash_bits(it, beam, index.storage.degree,
                         index.storage.entries.shape[0]) \
        if hash_bits is None else hash_bits
    uk = _resolve_beam_engine(
        use_kernel, index.data_padded.shape[1],
        beam * index.storage.degree, index.device,
    )
    vals, ids = _beam_impl(index, q, k=k, beam=beam, iters=it,
                           hash_bits=hb, row_mask=row_mask, use_kernel=uk)
    if index.metric == "l2":
        vals = sqrt_f64(relu0(vals))
    return vals, ids


def _visited_hash(ids, n: int, hash_bits: int):
    """Visited-table slot of each id: the Knuth multiplicative hash of
    the id as a uint32, ``(id * 2654435761 mod 2^32) >> (32 -
    hash_bits)``, taken in int64 (a 31-bit id times the 32-bit constant
    fits); the sentinel ``n`` (and any id past it) goes to the dump slot
    ``2^hash_bits``."""
    h = ((ids.long() * _HASH_MULT) & 0xFFFFFFFF) >> (32 - hash_bits)
    return torch.where(ids < n, h, 1 << hash_bits)


@full_f32
def _beam_impl(index: GraphIndex, q, k: int, beam: int, iters: int,
               hash_bits: int, row_mask=None, use_kernel: bool = False,
               on_round=None):
    # Pool width P = max(k, beam) + beam (>= beam unexpanded slots survive
    # a full expansion round, >= k for the tail), candidate buffer
    # C = beam * degree, visited table 2^hash_bits + 1 bytes per query.
    # on_round(fids, pool_i, pool_d), when given, sees each round's
    # frontier and merged pool (a tracing hook: two walks can be compared
    # round by round).
    adjacency = index.storage.adjacency
    table = index.data_padded
    n = adjacency.shape[0] - 1
    degree = adjacency.shape[1]
    nq = q.shape[0]
    dev = q.device
    qf = q.float()
    P = max(k, beam) + beam
    C = beam * degree
    T = 1 << hash_bits
    i32 = torch.int32

    def _hash(ids):
        return _visited_hash(ids, n, hash_bits)

    def _score_exact(cand):
        return score_l2_candidates(qf, table[cand.long()].float(), cand < n)

    if use_kernel:
        # the kernel scores the candidate list padded with the sentinel to
        # the 128-id granule, all of it in range; the cover argument (the
        # top-s sub-chunks by minimum hold the top-s rows) makes s = P
        # sub-chunks enough for the pool merge, which takes the exact
        # distances the kernel computed from the same read of each row
        c_pad = round_up(C, LANE)
        bounds = torch.tensor([[0, c_pad]], dtype=i32,
                              device=dev).expand(nq, 2).contiguous()
        pad = torch.full((nq, c_pad - C), n, dtype=i32, device=dev)
        s = min(c_pad // SUBCHUNK, P)
        sub_rows = torch.arange(SUBCHUNK, device=dev)

        def _score_new(cand):
            cp = torch.cat([cand, pad], dim=1)
            mins, exact = gk.beam_scan_score(qf, table, cp, bounds, n)
            _, sub = top_k_smallest(mins, s)
            pos = (sub[:, :, None] * SUBCHUNK + sub_rows).reshape(
                nq, s * SUBCHUNK)
            return torch.gather(exact, 1, pos), torch.gather(cp, 1, pos)
    else:

        def _score_new(cand):
            return _score_exact(cand), cand

    # init: the seeded entries fill the first pool slots (scored exactly),
    # the rest hold the sentinel at +inf
    entries = index.storage.entries
    e = entries[: min(entries.shape[0], P)].to(i32)
    E = e.shape[0]
    pool_d = torch.full((nq, P), float("inf"), device=dev)
    pool_d[:, :E] = _score_exact(e[None, :].expand(nq, E))
    pool_i = torch.full((nq, P), n, dtype=i32, device=dev)
    pool_i[:, :E] = e
    pool_x = torch.zeros((nq, P), dtype=torch.bool, device=dev)
    visited = torch.zeros((nq, T + 1), dtype=torch.uint8, device=dev)
    visited[:, _hash(e)] = 1
    inf = float("inf")  # a Python scalar: no host-to-device copy
    no_x = torch.zeros((nq, C if not use_kernel else s * SUBCHUNK),
                       dtype=torch.bool, device=dev)
    first_col = torch.zeros((nq, 1), dtype=torch.bool, device=dev)

    for _ in range(iters):
        # frontier: the best `beam` unexpanded live entries
        sel_key = torch.where(pool_x | (pool_i >= n), inf, pool_d)
        key, sel = top_k_smallest(sel_key, beam)
        pool_x = pool_x.scatter(1, sel, True)
        fids = torch.where(torch.isfinite(key), torch.gather(pool_i, 1, sel),
                           n)
        # gather the neighbours (the sentinel row is all -1)
        cand = adjacency[fids.long()].reshape(nq, C)
        cand = torch.where(cand < 0, n, cand)
        # within-round dedup: sort, send repeated ids to the sentinel
        cand = torch.sort(cand, dim=1)[0]
        dup = torch.cat([first_col, cand[:, 1:] == cand[:, :-1]], dim=1)
        cand = torch.where(dup, n, cand)
        # visited filter, then mark (writing 1 is idempotent)
        seen = torch.gather(visited, 1, _hash(cand)) > 0
        cand = torch.where(seen, n, cand)
        visited.scatter_(1, _hash(cand), 1)
        # score + merge: keep the best P of pool and new
        new_d, new_i = _score_new(cand)
        all_d = torch.cat([pool_d, new_d], dim=1)
        all_i = torch.cat([pool_i, new_i.to(i32)], dim=1)
        all_x = torch.cat([pool_x, no_x], dim=1)
        pool_d, idx = top_k_smallest(all_d, P)
        pool_i = torch.gather(all_i, 1, idx)
        pool_x = torch.gather(all_x, 1, idx)
        if on_round is not None:
            on_round(fids, pool_i, pool_d)

    # exact tail: the only place tombstones fold
    live = pool_i < n
    if row_mask is not None:
        mask = torch.as_tensor(row_mask, device=dev)
        live &= mask[torch.clamp(pool_i, 0, n - 1).long()] > 0
    d2 = score_l2_candidates(qf, table[pool_i.long()].float(), live)
    vals, pos = top_k_smallest(d2, k)
    ids = torch.gather(pool_i, 1, pos)
    ids = torch.where(torch.isfinite(vals), ids, -1)
    return vals, ids.to(i32)
