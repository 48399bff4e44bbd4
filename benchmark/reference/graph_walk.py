"""The plain reference of the graph index (CAGRA-style): its build by the
stated rules and its beam walk, query by query, in numpy with float64
distances. It imports no kernel of the port and batches nothing; TF32
plays no part (no matrix product runs on a card).

The build (:func:`build`), for rows ``x`` (n, d), degree ``D`` and
intermediate degree ``I``:

1. the kNN graph: each row's ``I + 1`` nearest rows by (squared distance,
   id), the first dropped (the row itself, for rows that are distinct);
2. symmetrized: the union of those edges and their mirrors, each row's
   neighbours in ascending id;
3. the occlusion prune, node by node: the first ``m`` neighbours of
   ``u`` (``m`` the smaller of the widest row and ``max(D, 2 I)``), visited
   in ascending d(u, ·) (ties in id order); ``v`` is kept unless a kept
   ``w`` has d(w, v) < d(u, v), until ``D`` are kept; the slots left take
   the nearest occluded neighbours; -1 pads a row with fewer neighbours;
4. the entry points: ``n_entry`` distinct rows drawn by
   ``numpy.random.default_rng(seed).choice``, ascending;
5. the reachability patch: while some row is not reached from the entries
   (breadth first), each unreached row in ascending id overwrites the last
   unclaimed slot of its nearest reached row (ties to the lower id) that
   still has one; each slot is claimed once; a round that claims nothing
   ends the patch.

The walk (:func:`walk`) keeps a pool of ``P = max(k, beam) + beam``
(distance, id, expanded) slots, the entries first: each of ``iters``
rounds expands the ``beam`` best unexpanded slots, takes their
neighbours in ascending id, drops repeats and ids whose slot of the
visited table (the Knuth multiplicative hash of the id, ``hash_bits``
wide, every id past the rows in one extra slot) is marked, marks the
rest, scores them and keeps the best ``P`` of pool and candidates;
every selection is stable (equal distances keep their order, the pool
before the candidates). The tail re-scores the pool and returns the
best ``k``, -1 past the live rows.
"""

from __future__ import annotations

import math

import numpy as np

HASH_MULT = 2654435761


def _d2(rows: np.ndarray, v: np.ndarray) -> np.ndarray:
    diff = rows.astype(np.float64) - v.astype(np.float64)
    return np.einsum("md,md->m", diff, diff)


def _by_distance(d2: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """``ids`` ordered by (distance, id)."""
    return ids[np.lexsort((ids, d2))]


def knn_symmetrized(x: np.ndarray, k: int) -> list:
    """Steps 1 and 2: each row's neighbours in ascending id."""
    n = x.shape[0]
    ids = np.arange(n)
    nbrs = [set() for _ in range(n)]
    for i in range(n):
        for j in _by_distance(_d2(x, x[i]), ids)[1:k + 1]:
            nbrs[i].add(int(j))
            nbrs[int(j)].add(i)
    return [np.array(sorted(s), dtype=np.int64) for s in nbrs]


def occlusion_prune(x: np.ndarray, nbrs: list, degree: int, m_cap: int) -> np.ndarray:
    """Step 3: the (n, degree) adjacency, -1 padded."""
    n = x.shape[0]
    m = min(max(max(len(r) for r in nbrs), 1), max(degree, m_cap))
    out = np.full((n, degree), -1, np.int64)
    for u in range(n):
        cand = nbrs[u][:m]
        cand = cand[cand != u]
        if not cand.size:
            continue
        cd = _d2(x[cand], x[u])
        order = np.argsort(cd, kind="stable")
        kept, occluded = [], []
        for j in order:
            v = cand[j]
            if len(kept) < degree and not any(
                    _d2(x[[w]], x[v])[0] < cd[j] for w in kept):
                kept.append(v)
            else:
                occluded.append(v)
        row = (kept + occluded)[:degree]
        out[u, :len(row)] = row
    return out


def entry_points(n: int, n_entry: int, seed: int) -> np.ndarray:
    """Step 4."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=max(1, min(n_entry, n)), replace=False))


def reached(adj: np.ndarray, entries: np.ndarray) -> np.ndarray:
    seen = np.zeros(adj.shape[0], bool)
    seen[entries] = True
    frontier = list(entries)
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v >= 0 and not seen[v]:
                    seen[v] = True
                    nxt.append(int(v))
        frontier = nxt
    return seen


def patch(x: np.ndarray, adj: np.ndarray, entries: np.ndarray):
    """Step 5 on a copy of ``adj``; returns it and the counts: the slots
    written, the rows they point to, the unreached rows of each round."""
    adj = adj.copy()
    n, degree = adj.shape
    claimed = np.zeros(n, np.int64)
    targets = set()
    misses = []
    for _ in range(n):
        seen = reached(adj, entries)
        miss = np.flatnonzero(~seen)
        if not miss.size:
            break
        misses.append(int(miss.size))
        reach = np.flatnonzero(seen)
        progressed = False
        for u in miss:
            for w in _by_distance(_d2(x[reach], x[u]), reach):
                if claimed[w] < degree:
                    adj[w, degree - 1 - claimed[w]] = u
                    claimed[w] += 1
                    targets.add(int(u))
                    progressed = True
                    break
        if not progressed:
            break
    return adj, dict(patch_edges=int(claimed.sum()), patched_rows=len(targets),
                     patch_misses=misses)


def build(x: np.ndarray, degree: int, intermediate_degree: int, seed: int,
          n_entry: int):
    """Steps 1–5: (adjacency (n, degree) int64, entries, patch counts)."""
    n = x.shape[0]
    deg = min(degree, n - 1)
    idg = min(max(intermediate_degree, deg), n - 1)
    adj = occlusion_prune(x, knn_symmetrized(x, idg), deg, 2 * idg)
    entries = entry_points(n, n_entry, seed)
    adj, counts = patch(x, adj, entries)
    return adj, entries, counts


def hash_bits_for(iters: int, beam: int, degree: int, n_entry: int) -> int:
    """The visited table's width: about 8 slots a possible mark, between
    2^10 and 2^20."""
    marks = max(2, n_entry + iters * beam * degree)
    return min(20, max(10, int(math.ceil(math.log2(8 * marks)))))


def _hash(ids: np.ndarray, n: int, hash_bits: int) -> np.ndarray:
    h = ((ids.astype(np.int64) * HASH_MULT) & 0xFFFFFFFF) >> (32 - hash_bits)
    return np.where(ids < n, h, 1 << hash_bits)


def walk(x: np.ndarray, adj: np.ndarray, entries: np.ndarray, q: np.ndarray,
         k: int, beam: int, iters: int, hash_bits: int | None = None):
    """One query's walk: (squared distances (k,) float64, ids (k,)), -1 and
    +inf past the live rows."""
    n, degree = adj.shape
    if hash_bits is None:
        hash_bits = hash_bits_for(iters, beam, degree, len(entries))
    p = max(k, beam) + beam
    e = np.asarray(entries, np.int64)[:p]
    pool_d = np.full(p, np.inf)
    pool_i = np.full(p, n, np.int64)
    pool_x = np.zeros(p, bool)
    pool_d[:e.size] = _d2(x[e], q)
    pool_i[:e.size] = e
    visited = np.zeros((1 << hash_bits) + 1, bool)
    visited[_hash(e, n, hash_bits)] = True
    for _ in range(iters):
        key = np.where(pool_x | (pool_i >= n), np.inf, pool_d)
        sel = np.argsort(key, kind="stable")[:beam]
        pool_x[sel] = True
        fids = np.where(np.isfinite(key[sel]), pool_i[sel], n)
        cand = np.concatenate([adj[f] if f < n else np.full(degree, -1)
                               for f in fids])
        cand = np.sort(np.where(cand < 0, n, cand))
        cand[1:][cand[1:] == cand[:-1]] = n
        h = _hash(cand, n, hash_bits)
        cand = np.where(visited[h], n, cand)
        visited[_hash(cand, n, hash_bits)] = True
        live = cand < n
        new_d = np.full(cand.size, np.inf)
        new_d[live] = _d2(x[cand[live]], q)
        all_d = np.concatenate([pool_d, new_d])
        all_i = np.concatenate([pool_i, cand])
        all_x = np.concatenate([pool_x, np.zeros(cand.size, bool)])
        keep = np.argsort(all_d, kind="stable")[:p]
        pool_d, pool_i, pool_x = all_d[keep], all_i[keep], all_x[keep]
    live = pool_i < n
    d2 = np.full(p, np.inf)
    d2[live] = _d2(x[pool_i[live]], q)
    pos = np.argsort(d2, kind="stable")[:k]
    vals = d2[pos]
    return vals, np.where(np.isfinite(vals), pool_i[pos], -1)
