"""The sharded IVF engines' shared shard machinery and the sharded IVF-PQ
engine — the port of ``raft_tpu/comms/mnmg_ivf.py`` (the DEEP-100M
design: list-sharded PQ codes with exact refinement on each shard).

A sharded index shards its inverted lists by list id and replicates its
quantizer:

* **Shard lists, replicate the quantizers.** Greedy-LPT list
  ownership (:func:`_lpt_assign`: biggest list to the least-loaded
  rank); each rank's slab is a complete single-device inverted-list
  layout — contiguous rows (PQ codes and, for refinement, the raw rows),
  per-rank offsets and sizes, ``sorted_ids`` carrying GLOBAL row ids —
  plus one empty sentinel list at ``nl_pad - 1``. Coarse centroids and
  PQ codebooks replicate.
* **Queries replicate; lists never move.** Every rank probes the global
  centroid set, keeps the probes it owns (the sentinel list takes the
  rest) and runs the unchanged single-device grouped search on its
  shard (:func:`_rank_body`, shared by every engine): for IVF-PQ
  ``ivf_pq._pq_grouped_impl``, whose kernel engine launches the ADC
  scan on each rank, each rank refining its own candidates against its
  own raw rows.
* **Merge is a k-way top-k** over one (nq, k) allgather pair
  (:func:`_merge_across_shards`; two-stage across hosts on a two-level
  communicator).

The distributed builds (:func:`_train_coarse_distributed`, the engine's
per-rank assignment or encode, :func:`_exchange_and_assemble`) run as
per-rank bodies of ``comms.run``: a collective training subsample,
replicated k-means (and PQ codebooks), host O(n_lists) bookkeeping,
device-side routing of every row to its list's owner, and a
bounded-round ``alltoall`` with positional scatter into the slabs.
:func:`reshard_index`, :func:`replicate_index`, :func:`place_index` and
:func:`recover_rank` move a built index between rank counts, replica
layouts and devices on the host.

The mutation tier (:mod:`.mnmg_mutation`) rides every engine's rank
body: ``mutation=`` folds a per-rank tombstone mask into the shard's
scan and merges an exact scan of the rank's delta segments
(:func:`_merge_local_delta`) before the cross-shard merge.

An index's sharded fields (``_SHARDED_FIELDS``) carry a leading axis
over the ranks: every rank on the host (numpy), every local rank once
placed (a tensor on the ranks' device, or a list of per-rank tensors
when the ranks' devices differ). Through ``torch.distributed`` a placed
index holds its own rank's slab only.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
from raft_tpu_torch.comms.multihost import (
    comms_levels,
    hier_axes,
    hierarchical_merge_select_k,
    host_aware_offset,
)
from raft_tpu_torch.resilience.degraded import (
    PartialSearchResult,
    mask_invalid_rows,
    probe_coverage,
    resolve_shard_mask,
    sanitize_query_rows,
)
from raft_tpu_torch.resilience.replica import resolve_route
from raft_tpu_torch.spatial.ann import ivf_pq
from raft_tpu_torch.spatial.ann.common import (
    CoarseIndex,
    ListStorage,
    build_coarse_index,
    coarse_probe,
    n_super_probes,
    resolve_qcap_arg,
    static_qcap,
    two_level_probe,
)
from raft_tpu_torch.spatial.ann.ivf_pq import (
    IVFPQIndex,
    IVFPQParams,
    _encode_rows,
    _train_pq_codebooks,
)
from raft_tpu_torch.spatial.selection import merge_parts_select_k

__all__ = [
    "MnmgIVFPQIndex", "attach_coarse_index", "expand_probe_set",
    "mnmg_ivf_pq_build", "mnmg_ivf_pq_build_distributed",
    "mnmg_ivf_pq_search", "place_index", "recover_rank",
    "replicate_index", "reshard_index", "shard_rows",
]

# query-block size of the two-level probe's candidate rerank
_PROBE_BLOCK_Q = 256

# fields whose leading axis runs over the ranks; everything else
# replicates (shared by every sharded index type)
_SHARDED_FIELDS = frozenset({
    "local_cents", "codes_sorted", "vectors_sorted", "sorted_ids",
    "list_offsets", "list_sizes",
})


def _cdiv_host(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _np(v) -> np.ndarray:
    """A field as a host array (a list of per-rank tensors stacked)."""
    if isinstance(v, (list, tuple)):
        return np.stack([_np(t) for t in v])
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    """A host array as a tensor on ``dev`` (torch wants writable,
    contiguous memory: read-only or strided arrays are copied)."""
    return torch.as_tensor(np.require(a, requirements=("C", "W")),
                           device=dev)


def _on(t, dev):
    """A replicated operand on a rank's device (no copy when it is
    there already)."""
    return t if t.device == dev else t.to(dev)


def _local_devices(comms):
    return [comms.rank_device(r) for r in comms.local_ranks]


def _sharded(comms, blocks):
    """Per-local-rank tensors as one sharded operand: stacked when the
    local ranks share a device, else a list."""
    devs = {b.device for b in blocks}
    if len(devs) == 1:
        return torch.stack(blocks)
    return list(blocks)


def _place_sharded(comms, v):
    """A host (P, ...) field (or a placed one) as the local ranks' blocks
    on their devices."""
    devs = _local_devices(comms)
    if (isinstance(v, torch.Tensor) and len(devs) == comms.size
            and v.shape[0] == comms.size and {v.device} == set(devs)):
        return v                      # placed already: no copy
    if isinstance(v, np.ndarray) or not isinstance(v, (torch.Tensor,
                                                       list, tuple)):
        v = np.asarray(v)
    blocks = []
    for r, dev in zip(comms.local_ranks, devs):
        b = v[r]
        blocks.append(_tensor(b, dev) if isinstance(b, np.ndarray)
                      else b.to(dev))
    return _sharded(comms, blocks)


# ------------------------------------------------------ the PQ index
@dataclasses.dataclass
class MnmgIVFPQIndex:
    """List-sharded IVF-PQ index over a communicator's ranks (the
    reference's field names and order, so the archive and the placement
    machinery apply unchanged). Sharded fields carry a leading axis over
    the ranks; the quantizers and the ownership maps replicate.
    ``sorted_ids`` hold GLOBAL row ids, so per-rank results merge without
    translation. Shards serve the grouped (list-major) search only."""

    centroids: typing.Any       # (n_lists_g, d) replicated
    codebooks: typing.Any       # (M, 2^bits, ds) replicated
    owner: typing.Any           # (n_lists_g,) int32 — owning rank per list
    local_id: typing.Any        # (n_lists_g,) int32 — list id on its owner
    local_cents: typing.Any     # (P, nl_pad, d) — per-rank centroid slab
    codes_sorted: typing.Any    # (P, n_pad + 1, M) uint8
    vectors_sorted: typing.Any  # (P, n_pad + 1, d) raw rows | None
    sorted_ids: typing.Any      # (P, n_pad) int32 GLOBAL row ids
    list_offsets: typing.Any    # (P, nl_pad + 1) int32
    list_sizes: typing.Any      # (P, nl_pad) int32
    pq_dim: int
    pq_bits: int
    n_pad: int
    nl_pad: int
    max_list: int
    n_rows: int
    # R-way striped replica layout: each rank's slab holds `replication`
    # segments of nl_pad/replication lists — segment 0 its own primary
    # shard, segment j the shard (rank - j*replica_offset) % P
    replication: int = 1
    replica_offset: int = 1
    # optional two-level coarse quantizer over the GLOBAL probe set
    coarse: typing.Optional[CoarseIndex] = None
    _placed: typing.Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # each local rank's shard as an IVFPQIndex view of its slabs (their
    # kernel-engine code copies are kept with them)
    _shards: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def shard(self, i: int) -> IVFPQIndex:
        """Local rank ``i``'s shard as a single-device
        :class:`~raft_tpu_torch.spatial.ann.ivf_pq.IVFPQIndex` (views of
        the slabs, the codebooks on the shard's device; made on first
        use and kept)."""
        view = self._shards.get(i)
        if view is None:
            sids = self.sorted_ids[i]
            dev = sids.device
            storage = ListStorage(
                sorted_ids=sids,
                list_offsets=self.list_offsets[i],
                # the grouped search reads no list_index; its row count
                # is the list count
                list_index=torch.zeros((self.nl_pad, 1), dtype=torch.int32,
                                       device=dev),
                list_sizes=self.list_sizes[i],
                n=self.n_pad,
                max_list=self.max_list,
            )
            vecs = (None if self.vectors_sorted is None
                    else self.vectors_sorted[i])
            view = IVFPQIndex(self.local_cents[i],
                              _on(self.codebooks, dev), self.codes_sorted[i],
                              storage, vecs, self.pq_dim, self.pq_bits)
            self._shards[i] = view
        return view

    def warmup(self, comms, nq: int, *, k: int = 10, n_probes: int = 8,
               qcap=None, list_block: int = 8, refine_ratio: float = 2.0,
               exact_selection: bool = True,
               approx_recall_target: float = 0.95,
               donate_queries: bool = False, shard_mask=None,
               failover=None, overprobe: float = 2.0,
               merge_ways: typing.Optional[int] = None,
               use_kernel: typing.Optional[bool] = None, mutation=None,
               wire: str = "bf16") -> int:
        """Dispatch one all-zeros (nq, d) batch through
        :func:`mnmg_ivf_pq_search` (building the kernels and each shard's
        code copy on first use) and return the shape-only qcap
        (:func:`~raft_tpu_torch.spatial.ann.common.static_qcap`) to pass
        on every serving dispatch of this batch size.
        ``shard_mask=True`` warms the degraded variant. The JAX package's
        ``audit=`` (its jaxpr program auditor) has no counterpart here."""
        qc = static_qcap(qcap, nq, n_probes, int(self.centroids.shape[0]))
        dev = comms.rank_device(comms.local_ranks[0])
        q0 = torch.zeros((nq, int(self.centroids.shape[1])),
                         dtype=torch.float32, device=dev)
        mnmg_ivf_pq_search(
            comms, self, q0, k, n_probes=n_probes, qcap=qc,
            list_block=list_block, refine_ratio=refine_ratio,
            exact_selection=exact_selection,
            approx_recall_target=approx_recall_target,
            donate_queries=donate_queries, shard_mask=shard_mask,
            failover=failover, overprobe=overprobe, merge_ways=merge_ways,
            use_kernel=use_kernel, mutation=mutation, wire=wire)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return qc


# ------------------------------------------------------- host bookkeeping
def _slab_height(loads) -> int:
    """Bucketed per-rank slab height (n_pad) shared by the builds and
    :func:`reshard_index`: the raw max load is data-dependent, so it is
    rounded up to a coarse bucket (<= ~6% padding) that keeps a
    same-shape rebuild's slab shapes stable."""
    raw_npad = max(int(np.max(loads)), 1)
    bucket = 256 if raw_npad < (1 << 17) else 4096
    return _cdiv_host(raw_npad, bucket) * bucket


def _rank_slab_maps(owner, local_id, sizes, cents, n_ranks: int,
                    nl_pad: int, d: int):
    """Per-rank (offsets, sizes, centroids) slabs from a list -> rank
    assignment (owner -1 = unowned, left out of every slab) — the one
    layout authority of builds and reshards."""
    offs_sh = np.zeros((n_ranks, nl_pad + 1), np.int32)
    szs_sh = np.zeros((n_ranks, nl_pad), np.int32)
    lcents_sh = np.zeros((n_ranks, nl_pad, d), np.float32)
    for r in range(n_ranks):
        mine = np.nonzero(owner == r)[0]
        lid = local_id[mine]
        szs_sh[r, lid] = sizes[mine]
        offs_sh[r] = np.concatenate([[0], np.cumsum(szs_sh[r])])
        lcents_sh[r, lid] = cents[mine]
    return offs_sh, szs_sh, lcents_sh


def _lpt_assign(sizes: np.ndarray, n_ranks: int):
    """Greedy longest-processing-time list -> rank assignment: biggest
    list to the least-loaded rank. Returns (owner (nl,), local_id (nl,),
    rows_per_rank (P,), lists_per_rank (P,))."""
    nl = sizes.shape[0]
    owner = np.empty(nl, np.int32)
    local_id = np.empty(nl, np.int32)
    loads = np.zeros(n_ranks, np.int64)
    counts = np.zeros(n_ranks, np.int32)
    for l in np.argsort(-sizes, kind="stable"):
        r = int(np.argmin(loads))
        owner[l] = r
        local_id[l] = counts[r]
        loads[r] += int(sizes[l])
        counts[r] += 1
    return owner, local_id, loads, counts


# ------------------------------------------------------------ the build
def shard_rows(comms, x):
    """A host (n, d) matrix as contiguous row shards over the ranks:
    returns (the local ranks' (n_loc, d) blocks as one sharded operand,
    ``n_valid`` (P,) int32). Shard row (r, j) is global row ``r * n_loc
    + j``; each block is copied to its device on its own, so the host
    never holds a second full copy."""
    x = np.asarray(x)
    n, d = x.shape
    Pn = comms.size
    nloc = _cdiv_host(n, Pn)
    blocks = []
    for r, dev in zip(comms.local_ranks, _local_devices(comms)):
        blk = x[r * nloc:min(n, (r + 1) * nloc)]
        t = torch.zeros((nloc, d), dtype=torch.as_tensor(x[:1]).dtype,
                        device=dev)
        if blk.shape[0]:
            t[:blk.shape[0]] = torch.as_tensor(
                np.ascontiguousarray(blk), device=dev)
        blocks.append(t)
    n_valid = np.array([max(0, min(nloc, n - r * nloc)) for r in range(Pn)],
                       np.int32)
    return _sharded(comms, blocks), n_valid


def _check_row_shards(comms, x):
    """(n_loc, d) of a sharded row operand over the local ranks."""
    n_local = len(x) if isinstance(x, (list, tuple)) else x.shape[0]
    errors.expects(
        n_local == len(comms.local_ranks)
        and all(x[i].dim() == 2 for i in range(n_local)),
        "x: expected (n_ranks, n_loc, d) stacked row shards over the %d "
        "local ranks", len(comms.local_ranks),
    )
    nloc, d = x[0].shape
    return nloc, d


def _train_coarse_distributed(comms, x, n_valid, n: int, nl: int,
                              train_size, kmeans_n_iters: int,
                              kmeans_init: str, seed: int):
    """Phase 1 of every distributed list-sharded build: a collective
    training subsample and replicated coarse k-means.

    Every non-empty rank contributes ``train_n / n_active`` uniformly
    sampled local rows to one allgather (empty ranks' slots are left
    out). A permutation prefix drawn from a CPU ``torch.Generator``
    seeded from ``seed`` and the rank gives exact sampling without
    replacement on full shards; ragged shards remap out-of-range picks
    modulo the valid count. (The JAX package draws from its own PRNG,
    which cannot be reproduced here: a comparison injects its output.)
    Returns (xt, coarse KMeansOutput)."""
    nloc, d = _check_row_shards(comms, x)
    n_valid = np.asarray(n_valid, np.int32)
    train_n = min(n, train_size if train_size is not None
                  else max(1 << 20, 64 * nl))
    keep = np.nonzero(n_valid > 0)[0]
    t_per = _cdiv_host(train_n, max(keep.size, 1))
    keep_t = torch.as_tensor(keep, dtype=torch.int64)

    def sub_body(ax, xb):
        rank = ax.get_rank()
        nvr = int(n_valid[rank])
        gen = torch.Generator().manual_seed(int(seed) * 1_000_003 + rank)
        sel = torch.randperm(nloc, generator=gen)[:t_per]
        sel = torch.where(sel < nvr, sel, sel % max(nvr, 1))
        g = ax.allgather(xb[sel.to(xb.device)])             # (P, t, d)
        return g[keep_t.to(g.device)].reshape(-1, d)

    xt = comms.run(sub_body, sharded=(x,))
    coarse = kmeans_fit(xt, KMeansParams(
        n_clusters=nl, max_iter=kmeans_n_iters, seed=seed, init=kmeans_init,
        # quantizer training tolerates bf16-rounded centroid updates
        compute_dtype="bfloat16",
    ))
    return xt, coarse


def _split_bookkeeping(C_np, cents_np, cap):
    """Host O(n_lists) half of phase 3: oversized-list split sizes and
    the split lists' centroids. Returns (base (nl,), sizes of the split
    lists, their centroids)."""
    nl = C_np.shape[1]
    sizes = C_np.sum(0)
    if cap:
        extra = np.maximum(0, -(-sizes // cap) - 1)
        cum = np.concatenate([[0], np.cumsum(extra)])
        base_np = (nl + cum[:nl]).astype(np.int32)
        reps = np.repeat(np.arange(nl), extra)
        jidx = np.arange(int(extra.sum())) - cum[reps] + 1
        ssz = np.concatenate([
            np.minimum(sizes, cap),
            np.clip(sizes[reps] - jidx * cap, 0, cap),
        ])
        cents_np = np.concatenate([cents_np, cents_np[reps]])
    else:
        base_np = np.zeros(nl, np.int32)
        ssz = sizes
    return base_np, ssz, cents_np


def _positions(key, n_keys: int):
    """Each element's rank among the elements of its key (stable), for
    integer ``key`` in [0, n_keys] (n_keys = dropped)."""
    n = key.shape[0]
    dev = key.device
    order = torch.sort(key, stable=True)[1]
    ksort = key[order]
    kstart = torch.searchsorted(
        ksort, torch.arange(n_keys, dtype=key.dtype, device=dev))
    wsort = (torch.arange(n, dtype=torch.int64, device=dev)
             - kstart[torch.clamp(ksort, max=n_keys - 1)])
    within = torch.empty(n, dtype=torch.int64, device=dev)
    within[order] = wsort
    return within


def _exchange_and_assemble(comms, x, n_valid, lbl_g, C, cents, cap: int,
                           store_vectors: bool, codes_g=None, M: int = 0):
    """Phases 3-4 of every distributed list-sharded build:

    * host O(n_lists) bookkeeping — oversized-list split sizes,
      greedy-LPT ``owner`` / ``local_id``, per-rank offset / size /
      centroid slabs;
    * device-side routing — each row's GLOBAL within-list rank (a
      per-rank prefix over the gathered count matrix ``C`` and one local
      stable sort) gives its split sublist and its exact slab position
      on its owner;
    * a bounded-round ``alltoall`` exchange (each round's buffers about
      half a shard of rows) with positional scatter into the slabs.

    ``codes_g`` (sharded (n_loc, M) uint8) adds a code payload,
    ``store_vectors`` the raw-row payload. Returns (maps, slabs): host
    metadata arrays and the sharded ``sids`` / ``codes`` / ``vecs``
    slabs."""
    nloc, d = _check_row_shards(comms, x)
    Pn = comms.size
    C_t = C
    C_np = _np(C).astype(np.int64)                          # (P, nl)
    nl = C_np.shape[1]
    n_valid = np.asarray(n_valid, np.int32)

    # ---- phase 3 (host, O(n_lists))
    base_np, ssz, cents_np = _split_bookkeeping(
        C_np, np.asarray(_np(cents), np.float32), cap)
    owner, local_id, loads, lists_per = _lpt_assign(ssz, Pn)
    n_pad = _slab_height(loads)
    nl_pad = int(lists_per.max()) + 1          # +1 empty sentinel list
    max_list = max(int(ssz.max()), 1)
    offs_sh, szs_sh, lcents_sh = _rank_slab_maps(
        owner, local_id, ssz, cents_np, Pn, nl_pad, d)
    n_sub = owner.shape[0]

    # ---- phase 4a: device-side routing
    def route_body(ax, lbl, C_in):
        dev = lbl.device
        rank = ax.get_rank()
        i64 = torch.int64
        lbl = lbl.to(i64)
        C_in = _on(C_in, dev).to(i64)
        valid = torch.arange(nloc, device=dev) < int(n_valid[rank])
        starts = (torch.cumsum(C_in, 0) - C_in)[rank]
        key = torch.where(valid, lbl, nl)
        within = _positions(key, nl)
        lbl_c = torch.clamp(lbl, 0, nl - 1)
        gw = starts[lbl_c] + within      # global rank within parent list
        if cap:
            sub = gw // cap
            base = torch.as_tensor(base_np, device=dev).to(i64)
            nlbl = torch.where(sub == 0, lbl_c, base[lbl_c] + sub - 1)
            wsub = gw % cap              # rank within the split sublist
        else:
            nlbl, wsub = lbl_c, gw
        # padding rows route nowhere; their (clamped) ids are never read
        nlbl = torch.clamp(nlbl, 0, n_sub - 1)
        owner_t = torch.as_tensor(owner, device=dev).to(i64)
        lid_t = torch.as_tensor(local_id, device=dev).to(i64)
        offs_t = torch.as_tensor(offs_sh, device=dev).to(i64)
        lloc = lid_t[nlbl]
        dest = torch.where(valid, owner_t[nlbl], Pn)         # Pn = dropped
        pos = offs_t[torch.clamp(dest, max=Pn - 1), lloc] + wsub
        wslot = _positions(dest, Pn)
        dcnt = torch.bincount(dest, minlength=Pn + 1)[:Pn].to(torch.int32)
        return dest, pos, wslot, ax.allgather(dcnt)

    dest_g, pos_g, wslot_g, C2 = comms.run(
        route_body, sharded=(lbl_g,), replicated=(C_t,),
        out=("stacked", "stacked", "stacked", "replicated"))
    C2_np = _np(C2)                                          # (src, dst)
    max_send = max(1, int(C2_np.max()))

    # ---- phase 4b: bounded-round alltoall + positional slab scatter;
    # rounds bound each payload's padded buffer to (P, ms_r) rows
    ms_r = min(max_send, max(1024, _cdiv_host(max(nloc, 1), 2 * Pn)))
    n_rounds = _cdiv_host(max_send, ms_r)
    gb_np = np.concatenate([[0], np.cumsum(n_valid)[:-1]]).astype(np.int64)
    with_codes = codes_g is not None
    C2_t = torch.as_tensor(C2_np)

    def asm_body(ax, xb, dst, pos, wslot, *rest):
        cds = rest[0] if with_codes else None
        dev = xb.device
        me = ax.get_rank()
        recv_cnt = _on(C2_t, dev)[:, me].to(torch.int64)
        gids = int(gb_np[me]) + torch.arange(nloc, dtype=torch.int64,
                                             device=dev)
        sids_sl = torch.zeros(n_pad + 1, dtype=torch.int32, device=dev)
        vecs_sl = (torch.zeros((n_pad + 2, d), dtype=xb.dtype, device=dev)
                   if store_vectors else None)
        codes_sl = (torch.zeros((n_pad + 2, M), dtype=torch.uint8,
                                device=dev) if with_codes else None)
        for t in range(n_rounds):
            w0 = t * ms_r
            in_r = (wslot >= w0) & (wslot < w0 + ms_r) & (dst < Pn)
            dsel = torch.where(in_r, dst, Pn)          # row Pn drops
            wr = torch.where(in_r, wslot - w0, 0)

            def ex(payload, dtype):
                buf = torch.zeros((Pn + 1, ms_r) + tuple(payload.shape[1:]),
                                  dtype=dtype, device=dev)
                buf[dsel, wr] = payload.to(dtype)
                return ax.alltoall(buf[:Pn])           # [s] = from s

            rb_gid = ex(gids, torch.int32)
            rb_pos = ex(pos, torch.int64)
            valid_r = ((w0 + torch.arange(ms_r, device=dev))[None, :]
                       < recv_cnt[:, None])
            pc = torch.where(valid_r, rb_pos, n_pad + 1).reshape(-1)
            ps = torch.where(valid_r, rb_pos, n_pad).reshape(-1)
            sids_sl[ps] = rb_gid.reshape(-1)
            if with_codes:
                codes_sl[pc] = ex(cds, torch.uint8).reshape(-1, M)
            if store_vectors:
                vecs_sl[pc] = ex(xb, xb.dtype).reshape(-1, d)
        outs = [sids_sl[:n_pad]]
        if with_codes:
            outs.append(codes_sl[:n_pad + 1])
        if store_vectors:
            outs.append(vecs_sl[:n_pad + 1])
        return tuple(outs)

    sharded = (x, dest_g, pos_g, wslot_g) + ((codes_g,) if with_codes
                                             else ())
    res = comms.run(asm_body, sharded=sharded, out="stacked")
    slabs = {"sids": res[0]}
    i = 1
    if with_codes:
        slabs["codes"] = res[i]
        i += 1
    if store_vectors:
        slabs["vecs"] = res[i]
    maps = {
        "cents_np": cents_np,
        "owner": owner,
        "local_id": local_id,
        "lcents_sh": lcents_sh,
        "offs_sh": offs_sh,
        "szs_sh": szs_sh,
        "n_pad": n_pad,
        "nl_pad": nl_pad,
        "max_list": max_list,
    }
    return maps, slabs


def mnmg_ivf_pq_build(comms, x,
                      params: IVFPQParams = IVFPQParams()) -> MnmgIVFPQIndex:
    """One-host convenience wrapper: row-shard ``x`` over the ranks (one
    shard at a time, :func:`shard_rows`) and run the per-rank distributed
    PQ build."""
    x = np.asarray(x)
    errors.expects(
        x.ndim == 2 and x.shape[0] >= 2,
        "x: expected a (n >= 2, d) matrix, got shape %s", tuple(x.shape),
    )
    if x.dtype == np.float64:
        x = x.astype(np.float32)    # as the JAX package stores f64 input
    xg, n_valid = shard_rows(comms, x)
    return mnmg_ivf_pq_build_distributed(comms, xg, params, n_valid=n_valid)


def mnmg_ivf_pq_build_distributed(
    comms, x, params: IVFPQParams = IVFPQParams(), *, n_valid=None,
) -> MnmgIVFPQIndex:
    """Build a list-sharded IVF-PQ index from PER-RANK row shards: ``x``
    the local ranks' (n_loc, d) blocks (a (P_local, n_loc, d) tensor or a
    list), ``n_valid`` (P,) the valid rows of every rank (default all);
    shard row (r, j) gets global id ``sum(n_valid[:r]) + j``.

    1. **Subsample + train (replicated):** the collective training
       subsample (:func:`_train_coarse_distributed`), coarse k-means and
       the PQ codebooks on it, identically on every rank.
    2. **Per-rank blocked encode:** each rank labels and PQ-encodes its
       rows against the replicated quantizers in ``encode_block``-row
       blocks (:func:`_encode_ranks`); the list counts come back from one
       allgather.
    3-4. **List split, LPT routing, row exchange and slab assembly**
       (:func:`_exchange_and_assemble`), the codes as the exchange
       payload beside the raw rows when ``store_raw``.

    ``max_list_cap=None`` means AUTO here (``max(256, 2 * n /
    n_lists)``); pass 0 to disable."""
    nloc, d = _check_row_shards(comms, x)
    Pn = comms.size
    M = params.pq_dim
    errors.expects(d % M == 0, "d=%d not divisible by pq_dim=%d", d, M)
    errors.expects(
        1 <= params.pq_bits <= 8,
        "pq_bits=%d out of range [1, 8] — codes are stored as uint8",
        params.pq_bits,
    )
    ds = d // M
    n_codes = 1 << params.pq_bits
    if n_valid is None:
        n_valid = np.full(Pn, nloc, np.int32)
    n_valid = np.asarray(n_valid, np.int32)
    errors.expects(n_valid.shape == (Pn,),
                   "n_valid: expected (%d,), got %s", Pn,
                   tuple(n_valid.shape))
    n = int(n_valid.sum())
    errors.check_k(params.n_lists, n, "n_lists vs dataset rows")
    errors.expects(
        n >= n_codes,
        "n=%d rows cannot train %d-entry PQ codebooks (pq_bits=%d); lower "
        "pq_bits", n, n_codes, params.pq_bits,
    )
    nl = params.n_lists

    # phase 1: collective subsample -> replicated quantizers
    xt, coarse = _train_coarse_distributed(
        comms, x, n_valid, n, nl, params.train_size, params.kmeans_n_iters,
        params.kmeans_init, params.seed)
    codebooks = _train_pq_codebooks(xt, coarse, params, ds, n_codes)
    cents = coarse.centroids
    # phase 2: per-rank blocked encode + global list sizes
    lbl_g, codes_g, C = _encode_ranks(comms, x, n_valid, cents, codebooks,
                                      nl, M, params.encode_block)
    cap = (params.max_list_cap if params.max_list_cap is not None
           else max(256, 2 * _cdiv_host(n, nl)))
    maps, slabs = _exchange_and_assemble(
        comms, x, n_valid, lbl_g, C, cents, cap,
        store_vectors=params.store_raw, codes_g=codes_g, M=M)
    host = MnmgIVFPQIndex(
        centroids=maps["cents_np"],
        codebooks=np.asarray(_np(codebooks), np.float32),
        owner=maps["owner"],
        local_id=maps["local_id"],
        local_cents=maps["lcents_sh"],
        codes_sorted=slabs["codes"],
        vectors_sorted=slabs.get("vecs"),
        sorted_ids=slabs["sids"],
        list_offsets=maps["offs_sh"],
        list_sizes=maps["szs_sh"],
        pq_dim=M,
        pq_bits=params.pq_bits,
        n_pad=maps["n_pad"],
        nl_pad=maps["nl_pad"],
        max_list=maps["max_list"],
        n_rows=n,
    )
    if len(comms.local_ranks) != comms.size:
        host._placed = tuple(comms.local_ranks)
    return place_index(comms, host)


def _encode_ranks(comms, x, n_valid, cents, codebooks, nl: int, M: int,
                  block: int):
    """Phase 2 of the PQ distributed build: each rank labels and encodes
    its rows in ``block``-row blocks (``ivf_pq._encode_rows``: nearest
    centroid, then each subspace's nearest codebook entry, ties to the
    lowest), and one allgather of the local bincounts. Returns (labels,
    the local ranks' (n_loc,) int32 blocks; codes, their (n_loc, M)
    uint8 blocks; C (P, nl) int32 replicated count matrix)."""
    nloc, d = _check_row_shards(comms, x)
    n_valid = np.asarray(n_valid, np.int32)
    B = max(1, min(nloc, int(block)))
    ds = d // M

    def enc_body(ax, xb, cents_in, cbs_in):
        dev = xb.device
        c = _on(torch.as_tensor(cents_in), dev).float()
        cb = _on(torch.as_tensor(cbs_in), dev).float()
        parts = [_encode_rows(xb[s:s + B].float(), c, cb, M, ds)
                 for s in range(0, nloc, B)]
        lbl = torch.cat([p[0] for p in parts]).to(torch.int32)
        codes = torch.cat([p[1] for p in parts])
        valid = (torch.arange(nloc, device=dev)
                 < int(n_valid[ax.get_rank()]))
        key = torch.where(valid, lbl.to(torch.int64), nl)
        cnt = torch.bincount(key, minlength=nl + 1)[:nl].to(torch.int32)
        return lbl, codes, ax.allgather(cnt)

    return comms.run(enc_body, sharded=(x,), replicated=(cents, codebooks),
                     out=("stacked", "stacked", "replicated"))


# ------------------------------------------------- layouts and placement
def _n_ranks(index) -> int:
    errors.expects(
        getattr(index, "_placed", None) is None,
        "the index is placed on ranks %s of a torch.distributed group and "
        "holds only their slabs; reshard or save the host index it was "
        "placed from", getattr(index, "_placed", None),
    )
    v = index.sorted_ids
    return len(v) if isinstance(v, (list, tuple)) else int(v.shape[0])


def reshard_index(comms, index, *, replication: int = 1,
                  replica_offset: typing.Optional[int] = None):
    """Re-partition a list-sharded index built for a different rank count
    onto ``comms`` — the recovery path after losing (or regaining)
    ranks. Host O(n): every list's rows are copied from their old owner's
    slab segment into a fresh LPT-balanced layout (the build's
    :func:`_lpt_assign`, slab-height bucketing and layout helpers), so
    quantizer, global ids, per-list contents and ``max_list`` are
    unchanged and search results equal the original's. ``owner = -1``
    probe-set extras stay unowned. A replicated input is read through
    its primary copies; ``replication=R`` re-replicates the fresh layout
    (:func:`replicate_index`). Returns a host index."""
    Pn = comms.size
    owner = _np(index.owner)
    local_id = _np(index.local_id)
    szs = _np(index.list_sizes)
    offs = _np(index.list_offsets)
    sids = _np(index.sorted_ids)
    cents = np.asarray(_np(index.centroids), np.float32)
    d = cents.shape[1]
    codes = getattr(index, "codes_sorted", None)
    codes = None if codes is None else _np(codes)
    vecs = (None if index.vectors_sorted is None
            else _np(index.vectors_sorted))
    nl_g = owner.shape[0]
    real = np.nonzero(owner >= 0)[0]
    errors.expects(real.size > 0,
                   "reshard_index: index owns no lists (owner all -1)")
    sizes = np.zeros(nl_g, np.int64)
    sizes[real] = szs[owner[real], local_id[real]]
    new_owner = np.full(nl_g, -1, np.int32)
    new_lid = np.zeros(nl_g, np.int32)
    o_r, l_r, loads, lists_per = _lpt_assign(sizes[real], Pn)
    new_owner[real] = o_r
    new_lid[real] = l_r
    n_pad = _slab_height(loads)
    nl_pad = int(lists_per.max()) + 1          # +1 empty sentinel list
    offs_sh, szs_sh, lcents_sh = _rank_slab_maps(
        new_owner, new_lid, sizes, cents, Pn, nl_pad, d)
    new_sids = np.zeros((Pn, n_pad), np.int32)
    new_codes = (None if codes is None
                 else np.zeros((Pn, n_pad + 1, codes.shape[2]), codes.dtype))
    new_vecs = (None if vecs is None
                else np.zeros((Pn, n_pad + 1, vecs.shape[2]), vecs.dtype))
    for l in real.tolist():
        sz = int(sizes[l])
        if sz == 0:
            continue
        ro, jo = int(owner[l]), int(local_id[l])
        rn, jn = int(new_owner[l]), int(new_lid[l])
        src = slice(int(offs[ro, jo]), int(offs[ro, jo]) + sz)
        dst = slice(int(offs_sh[rn, jn]), int(offs_sh[rn, jn]) + sz)
        new_sids[rn, dst] = sids[ro, src]
        if new_codes is not None:
            new_codes[rn, dst] = codes[ro, src]
        if new_vecs is not None:
            new_vecs[rn, dst] = vecs[ro, src]
    kw = dict(
        owner=new_owner, local_id=new_lid, local_cents=lcents_sh,
        sorted_ids=new_sids, list_offsets=offs_sh, list_sizes=szs_sh,
        n_pad=n_pad, nl_pad=nl_pad, replication=1, replica_offset=1,
        centroids=cents,
    )
    if new_codes is not None:
        kw["codes_sorted"] = new_codes
    if new_vecs is not None:
        kw["vectors_sorted"] = new_vecs
    out = _host_copy(index, **kw)
    if replication > 1:
        out = replicate_index(out, replication, offset=replica_offset)
    return out


def _host_copy(index, **kw):
    """``index`` with ``kw`` replaced and every other array field on the
    host (a reshard's or replication's result)."""
    for f in dataclasses.fields(index):
        if f.name in kw or not f.init:
            continue
        v = getattr(index, f.name)
        if isinstance(v, (torch.Tensor, list, tuple)) and not isinstance(
                v, str) and f.name != "coarse":
            kw[f.name] = _np(v)
    return dataclasses.replace(index, **kw)


def replicate_index(index, replication: int, *,
                    offset: typing.Optional[int] = None):
    """R-way replicate a list-sharded index's slabs for failover with no
    coverage loss. Host O(R·n) over the striped placement
    (:class:`~raft_tpu_torch.resilience.ReplicaPlacement`): rank ``r``'s
    new slab is R segments — segment 0 its own primary shard's layout
    unchanged, segment ``j`` an exact copy of rank ``(r - j*offset) %
    P``'s primary layout. The degraded search's ``failover=`` route
    then picks at run time which copy serves each shard. Memory is
    exactly R x the slab footprint. The input must be unreplicated.
    Returns a host index."""
    from raft_tpu_torch.resilience.replica import ReplicaPlacement

    errors.expects(
        int(getattr(index, "replication", 1) or 1) == 1,
        "replicate_index: index is already %d-way replicated — reshard "
        "first (place_index(..., replication=R) does both)",
        getattr(index, "replication", 1),
    )
    Pn = _n_ranks(index)
    placement = ReplicaPlacement.striped(Pn, replication, offset)
    if replication == 1:
        return dataclasses.replace(index, replication=1, replica_offset=1)
    offs = _np(index.list_offsets)
    szs = _np(index.list_sizes)
    lcents = _np(index.local_cents)
    sids = _np(index.sorted_ids)
    codes = getattr(index, "codes_sorted", None)
    codes = None if codes is None else _np(codes)
    vecs = (None if index.vectors_sorted is None
            else _np(index.vectors_sorted))
    nlp0 = int(index.nl_pad)
    d = lcents.shape[2]
    valid = offs[:, -1]                    # rows in each rank's slab
    segs = [placement.segments(r) for r in range(Pn)]
    n_pad = _slab_height(
        [int(sum(valid[s] for s in segs[r])) for r in range(Pn)])
    nl_pad = replication * nlp0
    new_szs = np.zeros((Pn, nl_pad), np.int32)
    new_offs = np.zeros((Pn, nl_pad + 1), np.int32)
    new_lcents = np.zeros((Pn, nl_pad, d), lcents.dtype)
    new_sids = np.zeros((Pn, n_pad), np.int32)
    new_codes = (None if codes is None
                 else np.zeros((Pn, n_pad + 1, codes.shape[2]), codes.dtype))
    new_vecs = (None if vecs is None
                else np.zeros((Pn, n_pad + 1, vecs.shape[2]), vecs.dtype))
    for r in range(Pn):
        # R primary tables stacked: copy j of list l lands at local id
        # j*nlp0 + local_id[l], its rows right after segments 0..j-1's
        for j, s in enumerate(segs[r]):
            new_szs[r, j * nlp0:(j + 1) * nlp0] = szs[s]
            new_lcents[r, j * nlp0:(j + 1) * nlp0] = lcents[s]
        new_offs[r] = np.concatenate([[0], np.cumsum(new_szs[r])])
        start = 0
        for s in segs[r]:
            n_s = int(valid[s])
            new_sids[r, start:start + n_s] = sids[s, :n_s]
            if new_codes is not None:
                new_codes[r, start:start + n_s] = codes[s, :n_s]
            if new_vecs is not None:
                new_vecs[r, start:start + n_s] = vecs[s, :n_s]
            start += n_s
    kw = dict(
        local_cents=new_lcents, sorted_ids=new_sids,
        list_offsets=new_offs, list_sizes=new_szs,
        n_pad=n_pad, nl_pad=nl_pad,
        replication=replication, replica_offset=placement.offset,
    )
    if new_codes is not None:
        kw["codes_sorted"] = new_codes
    if new_vecs is not None:
        kw["vectors_sorted"] = new_vecs
    return _host_copy(index, **kw)


def _place_coarse(coarse: CoarseIndex, dev) -> CoarseIndex:
    return dataclasses.replace(
        coarse,
        super_cents=torch.as_tensor(coarse.super_cents, device=dev),
        member_ids=torch.as_tensor(coarse.member_ids, device=dev),
        cents_padded=torch.as_tensor(coarse.cents_padded, device=dev),
    )


def place_index(comms, index, *, replication: typing.Optional[int] = None,
                replica_offset: typing.Optional[int] = None):
    """(Re-)place a sharded index onto ``comms``: each local rank's slab
    on its device, the quantizer and ownership maps on the first local
    rank's device (every rank reads them from there, or moves them to
    its own). An index built for a different rank count is
    re-partitioned first (:func:`reshard_index`). ``replication=R``
    builds (or rebuilds) the R-way striped replica layout
    (:func:`replicate_index`); ``None`` keeps the index's.
    ``replica_offset`` overrides the stripe offset (default ``max(1, P //
    R)``; on a two-level communicator with R <= the host count, the
    host-aware stripe, :func:`~.multihost.host_aware_offset`). Through
    ``torch.distributed`` the placed index holds its own rank's slab."""
    n_ranks = (comms.size if getattr(index, "_placed", None) is not None
               else _n_ranks(index))
    if replica_offset is None and replication is not None \
            and int(replication) > 1:
        n_hosts, inner_width = comms_levels(comms)
        if 1 < n_hosts and int(replication) <= n_hosts:
            replica_offset = host_aware_offset(comms.size, inner_width,
                                               int(replication))
    cur_r = int(getattr(index, "replication", 1) or 1)
    cur_off = int(getattr(index, "replica_offset", 1) or 1)
    want_r = cur_r if replication is None else int(replication)
    if (n_ranks != comms.size or want_r != cur_r
            or (replica_offset is not None and want_r > 1
                and int(replica_offset) != cur_off)):
        if n_ranks == comms.size and cur_r == 1:
            index = replicate_index(index, want_r, offset=replica_offset)
        else:
            index = reshard_index(comms, index, replication=want_r,
                                  replica_offset=replica_offset)
    placed = getattr(index, "_placed", None)
    local = tuple(comms.local_ranks)
    dev0 = comms.rank_device(local[0])
    kw = {}
    for f in dataclasses.fields(index):
        if not f.init:
            continue
        v = getattr(index, f.name)
        if v is None or isinstance(v, (int, float, str)):
            continue
        if f.name == "coarse":
            kw[f.name] = _place_coarse(v, dev0)
        elif f.name in _SHARDED_FIELDS:
            if placed is None:
                kw[f.name] = _place_sharded(comms, v)
            else:
                errors.expects(placed == local,
                               "place_index: the index holds ranks %s, "
                               "this process runs %s", placed, local)
                kw[f.name] = v
        elif isinstance(v, np.ndarray):
            kw[f.name] = _tensor(v, dev0)
        else:
            kw[f.name] = torch.as_tensor(v, device=dev0)
    out = dataclasses.replace(index, **kw)
    if len(local) != comms.size:
        out._placed = local
    return out


def recover_rank(comms, index, path, rank: int):
    """Re-place ONE rank's slab content from a saved checkpoint — the
    spare- or healed-rank recovery path: after a
    :class:`~raft_tpu_torch.resilience.FailoverPlan` routed a dead rank's
    shards onto replicas, its slabs are restored from the archive
    (CRC-verified by :func:`~raft_tpu_torch.spatial.ann.load_index`),
    health flips up, and the route flips back to primaries — no k-means,
    no row exchange. The checkpoint must carry the live index's layout
    (rank count, slab heights, replication geometry, ownership), or this
    raises rather than splice rows into the wrong slots. Only ``rank``'s
    rows of the sharded fields are replaced, in a copy of each field.
    Returns the recovered index."""
    from raft_tpu_torch.spatial.ann.interop import load_index

    errors.expects(0 <= rank < comms.size,
                   "recover_rank: rank %d out of range [0, %d)", rank,
                   comms.size)
    host = load_index(path)
    errors.expects(
        type(host) is type(index),
        "recover_rank: checkpoint holds a %s, live index is a %s",
        type(host).__name__, type(index).__name__,
    )
    for name in ("n_pad", "nl_pad", "max_list", "n_rows", "replication",
                 "replica_offset"):
        errors.expects(
            getattr(host, name, None) == getattr(index, name, None),
            "recover_rank: checkpoint %s=%r != live index %s=%r — not a "
            "checkpoint of this build (restore via load_index/place_index)",
            name, getattr(host, name, None), name,
            getattr(index, name, None),
        )
    errors.expects(
        _np(host.sorted_ids).shape[0] == comms.size,
        "recover_rank: rank counts differ (checkpoint %d, mesh %d)",
        _np(host.sorted_ids).shape[0], comms.size,
    )
    errors.expects(
        np.array_equal(_np(host.owner), _np(index.owner)),
        "recover_rank: checkpoint ownership map differs from the live "
        "index — its slab rows would splice into the wrong lists",
    )
    local = tuple(comms.local_ranks)
    if rank not in local:
        return index                  # another process holds that slab
    i = local.index(rank)
    kw = {}
    for f in dataclasses.fields(index):
        if f.name not in _SHARDED_FIELDS:
            continue
        cur = getattr(index, f.name)
        src = getattr(host, f.name)
        if cur is None and src is None:
            continue
        cur_shape = (len(local),) + tuple(cur[0].shape)
        errors.expects(
            cur is not None and src is not None
            and tuple(np.shape(src))[1:] == cur_shape[1:],
            "recover_rank: field %r shape mismatch (checkpoint %s, live "
            "%s)", f.name, None if src is None else tuple(np.shape(src)),
            cur_shape,
        )
        row = _tensor(np.asarray(src[rank]), cur[i].device)
        if isinstance(cur, torch.Tensor):
            updated = cur.clone()
            updated[i] = row
        else:
            updated = list(cur)
            updated[i] = row
        kw[f.name] = updated
    out = dataclasses.replace(index, **kw)
    out._placed = getattr(index, "_placed", None)
    return out


# ------------------------------------------------ the search's shared tail
def _merge_across_shards(ax, hier, vals, gids, k, merge_ways, wire):
    """The cross-shard merge tail of the rank bodies. One level
    (``hier`` None): the flat allgather + ``merge_parts_select_k``
    (``merge_ways`` pads it to a deployment's shard count with
    +inf / -1 absent parts). Two levels: the flat stage within each host,
    then only each host's top-k crosses hosts in the compressed wire
    format (:func:`~.multihost.hierarchical_merge_select_k`)."""
    if hier is None:
        pd = ax.allgather(vals)                          # (P, nq, k)
        pi = ax.allgather(gids)
        md, mi = merge_parts_select_k(pd, pi, k, ways=merge_ways)
    else:
        inner = ax.level(hier[1])
        pd = inner.allgather(vals)                       # (I, nq, k)
        pi = inner.allgather(gids)
        sv, si = merge_parts_select_k(pd, pi, k, ways=merge_ways)
        md, mi = hierarchical_merge_select_k(
            ax.level(hier[0]), sv, si, k, wire=wire or "bf16")
    return md, torch.where(torch.isfinite(md), mi, -1)


def _merge_local_delta(qf, vals, gids, dvl, dil, k, rank, nl_pad,
                       replication, replica_offset, n_ranks, alive, route):
    """The mutation tier's shard-local tail (every engine): exactly score
    this rank's delta segments against the queries and fold their top-k
    into the rank's (nq, k) candidates BEFORE the cross-shard merge.

    ``dvl`` / ``dil`` are the rank's flattened (nl_pad * cap, d) /
    (nl_pad * cap,) delta slabs. The serve rule is the main scan's: a
    delta entry is scanned only by the rank whose slab SEGMENT serves its
    logical shard (no route: segment 0, the primaries), so replicated
    delta copies never appear twice in the merge, and a failover route
    moves delta serving to the replica with the same runtime operand.
    The scan and fold are the single-device tier's
    :func:`~raft_tpu_torch.spatial.ann.mutation.delta_merge_topk`."""
    from raft_tpu_torch.spatial.ann.mutation import delta_merge_topk

    DL = dil.shape[0]
    cap = DL // nl_pad
    nlp_base = nl_pad // replication
    seg = (torch.arange(DL, dtype=torch.int64, device=dil.device)
           // cap) // nlp_base
    if route is not None:
        shard_of = (rank - seg * replica_offset) % n_ranks
        serve = (route.long()[shard_of] == seg) & (alive[rank] > 0)
    else:
        serve = seg == 0
    return delta_merge_topk(qf, vals, gids, dvl, dil, serve & (dil >= 0), k)


def _rank_body(ax, scan, dev, q, cents, owner, local_id, sup_c, mem_i, cpad,
               alive, route, mut, *, k, n_probes, nl_pad, use_coarse,
               overprobe, merge_ways, replication, replica_offset,
               use_kernel, hier, wire):
    """The per-rank search body of every sharded engine: the replicated
    probe (the two-level probe when a coarse quantizer is attached), the
    owned probes kept (the sentinel list ``nl_pad - 1``, which has no
    rows, takes the rest; under ``route`` the rank holding a shard's
    serving copy serves it from that segment), the engine's own scan of
    this rank's shard (``scan(qf, probes, row_mask)``), the mutation
    tail (``mut``: this rank's row mask and delta slabs), and the
    cross-shard merge. With ``alive`` the degraded variant: a down rank
    contributes +inf, bad query rows are neutralized, coverage is
    reported."""
    rank = ax.get_rank()
    n_ranks = ax.get_size()
    degraded = alive is not None
    qf = _on(q, dev).float()
    cents, owner, local_id = (_on(t, dev) for t in (cents, owner, local_id))
    row_valid = None
    if degraded:
        alive, route = _on(alive, dev), _on(route, dev)
        qf, row_valid = sanitize_query_rows(qf)
    # replicated compute: identical global probes on every rank
    if use_coarse:
        probes_g, _ = two_level_probe(
            qf, _on(sup_c, dev), _on(mem_i, dev), _on(cpad, dev),
            owner.shape[0], n_probes,
            n_super_probes(n_probes, sup_c.shape[0], overprobe),
            _PROBE_BLOCK_Q, use_kernel=use_kernel)
    else:
        probes_g, _ = coarse_probe(qf, cents, n_probes)      # (nq, p)
    probe_owner = owner.long()[probes_g]                     # (nq, p)
    lid = local_id.long()[probes_g]
    sentinel = nl_pad - 1
    if degraded:
        # route[s] names the copy serving logical shard s: the rank
        # holding that copy serves the probe from its segment j
        j = route.long()[torch.clamp(probe_owner, 0, n_ranks - 1)]
        serving = torch.where(
            (probe_owner >= 0) & (j >= 0),
            (probe_owner + torch.clamp(j, min=0) * replica_offset)
            % n_ranks, -1)
        own = serving == rank
        nlp_base = nl_pad // replication
        lp = torch.where(own, torch.clamp(j, min=0) * nlp_base + lid,
                         sentinel)
    else:
        serving = probe_owner
        lp = torch.where(probe_owner == rank, lid, sentinel)
    vals, gids = scan(qf, lp, None if mut is None else mut[0])
    if mut is not None:
        vals, gids = _merge_local_delta(
            qf, vals, gids, mut[1], mut[2], k, rank, nl_pad, replication,
            replica_offset, n_ranks, alive, route)
    if degraded:
        # a down rank contributes +inf distances to the merge
        vals = torch.where(alive[rank] > 0, vals, float("inf"))
    md, mi = _merge_across_shards(ax, hier, vals, gids, k, merge_ways,
                                  wire)
    if degraded:
        # a failed-over shard on a live replica counts covered
        cov = probe_coverage(serving, alive, row_valid)
        md, mi = mask_invalid_rows(md, mi, row_valid)
        return md, mi, cov, row_valid
    return md, mi


def _mutation_operands(mutation, index, n_local: int):
    """A search's ``mutation=`` (None, an
    :class:`~.mnmg_mutation.MnmgMutationState`, or the
    :class:`~.mnmg_mutation.MnmgMutableIndex` wrapper) as the rank body's
    three sharded operands — ``(row_mask (P, n_pad + 1), delta_vecs (P,
    nl_pad * cap, d), delta_ids (P, nl_pad * cap))`` over the local
    ranks — or None. Shapes are checked against the index layout, so a
    state made for another geometry cannot splice rows into the wrong
    slots."""
    from raft_tpu_torch.comms.mnmg_mutation import (
        MnmgMutableIndex, MnmgMutationState,
    )

    if mutation is None:
        return None
    state = (mutation.state if isinstance(mutation, MnmgMutableIndex)
             else mutation)
    errors.expects(
        isinstance(state, MnmgMutationState),
        "mutation=: expected an MnmgMutationState or MnmgMutableIndex, "
        "got %s", type(mutation).__name__,
    )
    rm, dv, di = state.row_mask, state.delta_vecs, state.delta_ids
    errors.expects(
        len(rm) == n_local
        and tuple(rm[0].shape) == (index.n_pad + 1,),
        "mutation state row_mask (%d x %s) does not match the index "
        "layout (%d x %s)", len(rm), tuple(rm[0].shape), n_local,
        (index.n_pad + 1,),
    )
    errors.expects(
        len(dv) == n_local and len(di) == n_local and dv[0].dim() == 2
        and dv[0].shape[0] % index.nl_pad == 0
        and tuple(di[0].shape) == (dv[0].shape[0],),
        "mutation state delta slabs (%s / %s) do not match the index "
        "layout (nl_pad=%d)", tuple(dv[0].shape), tuple(di[0].shape),
        index.nl_pad,
    )
    return rm, dv, di


def _coarse_probe_operands(index, d, dev):
    """The three replicated CoarseIndex operands of the search
    (placeholders when the index carries no coarse quantizer)."""
    if index.coarse is not None:
        c = index.coarse
        return c.super_cents, c.member_ids, c.cents_padded
    return (
        torch.zeros((1, d), dtype=torch.float32, device=dev),
        torch.zeros((1, 1), dtype=torch.int32, device=dev),
        torch.zeros((1, 1, d), dtype=torch.float32, device=dev),
    )


def _check_probe_args(index, nl_g, overprobe, merge_ways, merge_floor,
                      wire="bf16"):
    """Shared validation of the probe and merge knobs. ``merge_floor``
    is the width the padded flat merge stage runs at: the rank count on
    one level, the per-host width on two."""
    errors.expects(
        index.coarse is None or index.coarse.n_cents == nl_g,
        "coarse index covers %d centroids but the probe set has %d — "
        "rebuild it (attach_coarse_index; expand_probe_set rebuilds "
        "automatically)",
        None if index.coarse is None else index.coarse.n_cents, nl_g,
    )
    errors.expects(overprobe >= 1.0,
                   "overprobe=%s out of range [1, inf)", overprobe)
    errors.expects(
        merge_ways is None
        or (isinstance(merge_ways, (int, np.integer))
            and merge_ways >= merge_floor),
        "merge_ways=%r must be an int >= the merge stage width (%d) — "
        "it emulates a WIDER deployment's merge, never a narrower one",
        merge_ways, merge_floor,
    )
    errors.expects(
        wire in ("bf16", "f32"),
        "wire=%r not a known cross-host wire format (bf16 | f32)", wire,
    )


def expand_probe_set(index, extra_centroids):
    """Extend a sharded index's global probe set with centroids owned by
    no rank (owner -1): searched on fewer ranks than a deployment holds,
    the index then runs a rank's exact share of the larger deployment —
    its probe at deployment scale, unowned probes on the sentinel list.
    Paired with ``merge_ways=`` the merge runs at deployment width too.
    Slabs are shared, not copied; an attached coarse quantizer is
    rebuilt over the expanded set with the caller's original arguments."""
    cents = torch.as_tensor(index.centroids).float()
    extra = torch.as_tensor(np.asarray(_np(extra_centroids), np.float32),
                            device=cents.device)
    errors.expects(
        extra.dim() == 2 and extra.shape[1] == cents.shape[1],
        "extra_centroids: expected (m, %d), got %s", cents.shape[1],
        tuple(extra.shape),
    )
    n_extra = extra.shape[0]
    owner = torch.as_tensor(index.owner)
    lid = torch.as_tensor(index.local_id)
    out = dataclasses.replace(
        index,
        centroids=torch.cat([cents, extra]),
        owner=torch.cat([owner, torch.full((n_extra,), -1,
                                           dtype=owner.dtype,
                                           device=owner.device)]),
        local_id=torch.cat([lid, torch.zeros(n_extra, dtype=lid.dtype,
                                             device=lid.device)]),
        coarse=None,
    )
    out._placed = getattr(index, "_placed", None)
    if index.coarse is not None:
        n_sup, cap, iters, seed = index.coarse.build_args
        out = attach_coarse_index(out, n_super=n_sup, member_cap=cap,
                                  kmeans_n_iters=iters, seed=seed)
    return out


def attach_coarse_index(index, *, n_super=None, member_cap=None,
                        kmeans_n_iters: int = 10, seed: int = 0):
    """Attach (or rebuild) a two-level coarse quantizer
    (:class:`~raft_tpu_torch.spatial.ann.common.CoarseIndex`) over a
    sharded index's global probe set, built on the centroids' device;
    the search probes through it when present (``overprobe=`` trades
    probe FLOPs for probe recall). The archive carries it (format v3)."""
    cents = torch.as_tensor(index.centroids).float()
    coarse = build_coarse_index(
        cents, n_super=n_super, member_cap=member_cap,
        kmeans_n_iters=kmeans_n_iters, seed=seed)
    out = dataclasses.replace(index, coarse=coarse)
    out._placed = getattr(index, "_placed", None)
    return out


# ------------------------------------------------------ the PQ search
def mnmg_ivf_pq_search(
    comms, index: MnmgIVFPQIndex, queries, k: int, *,
    n_probes: int = 8, qcap: typing.Union[int, str, None] = None,
    list_block: int = 8, refine_ratio: float = 2.0,
    exact_selection: bool = True, approx_recall_target: float = 0.95,
    qcap_max_drop_frac: typing.Optional[float] = None,
    donate_queries: bool = False, shard_mask=None, failover=None,
    overprobe: float = 2.0, merge_ways: typing.Optional[int] = None,
    use_kernel: typing.Optional[bool] = None, mutation=None,
    wire: str = "bf16",
):
    """Distributed grouped ADC search over a list-sharded IVF-PQ index.
    Returns (exact-refined squared L2 distances, GLOBAL row ids), both
    (nq, k) on the first local rank's device. Each probed list is
    searched by exactly one rank with the single-device grouped search,
    and each rank refines its own top candidates against its own raw
    rows, so recall matches the single-device search on the same lists.

    ``qcap`` as in the single-device grouped search (None: sized from
    the global probe map; ``"throughput"``; an int — serving passes the
    value :meth:`MnmgIVFPQIndex.warmup` returned). ``shard_mask``
    selects the degraded variant and a
    :class:`~raft_tpu_torch.resilience.PartialSearchResult`;
    ``failover`` (with ``shard_mask``) serves a down rank's shards from
    live replicas of an R-way replicated index with no coverage loss.
    ``overprobe``, ``merge_ways`` and ``wire`` as in
    :func:`~.mnmg_ivf_flat.mnmg_ivf_flat_search`. ``use_kernel`` picks
    each shard's ADC engine as
    :func:`~raft_tpu_torch.spatial.ann.ivf_pq._resolve_adc_engine` does
    (None: the CUDA ADC kernel on a Hopper card when refinement is
    active). ``mutation`` (an
    :class:`~.mnmg_mutation.MnmgMutationState` or
    :class:`~.mnmg_mutation.MnmgMutableIndex`) folds the per-rank
    tombstones into each shard's scan and merges an exact scan of the
    rank's delta segments before the cross-shard merge.

    ``exact_selection`` and ``approx_recall_target``: the JAX package's
    approximate selection is exact off the TPU, and exact here either
    way (the target is range-checked only). ``donate_queries`` is
    accepted and does nothing: the port does not alias the batch."""
    body, sharded, replicated, degraded = _prepare_pq_search(
        comms, index, queries, k, n_probes=n_probes, qcap=qcap,
        list_block=list_block, refine_ratio=refine_ratio,
        exact_selection=exact_selection,
        approx_recall_target=approx_recall_target,
        qcap_max_drop_frac=qcap_max_drop_frac, shard_mask=shard_mask,
        failover=failover, overprobe=overprobe, merge_ways=merge_ways,
        use_kernel=use_kernel, mutation=mutation, wire=wire)
    if not degraded:
        return comms.run(body, sharded=sharded, replicated=replicated)
    md, mi, cov, rv = comms.run(body, sharded=sharded, replicated=replicated)
    return PartialSearchResult(distances=md, ids=mi, coverage=cov,
                               row_valid=rv)


def _check_placed(comms, index):
    """The local ranks and the first one's device, after checking that
    ``index`` is placed on this communicator's ranks."""
    local = tuple(comms.local_ranks)
    errors.expects(
        isinstance(index.centroids, torch.Tensor)
        and getattr(index, "_placed", None) in (None, local)
        and len(index.sorted_ids) == len(local),
        "the index is not placed on this communicator's ranks "
        "(place_index(comms, index))",
    )
    return local, comms.rank_device(local[0])


def _degraded_operands(comms, index, shard_mask, failover, dev0):
    """(alive, route) runtime operands of the degraded variant (None,
    None without ``shard_mask``)."""
    errors.expects(
        failover is None or shard_mask is not None,
        "failover= requires shard_mask= (the degraded variant carries the "
        "routing operand)",
    )
    if shard_mask is None:
        return None, None
    alive = torch.as_tensor(resolve_shard_mask(shard_mask, comms.size),
                            device=dev0)
    route = torch.as_tensor(
        resolve_route(failover, comms.size, int(index.replication),
                      int(index.replica_offset)), device=dev0)
    return alive, route


def _prepare_pq_search(comms, index, queries, k, *, n_probes, qcap,
                       list_block, refine_ratio, exact_selection,
                       approx_recall_target, qcap_max_drop_frac,
                       shard_mask, failover, overprobe, merge_ways,
                       use_kernel, mutation, wire):
    """The non-dispatching front half of :func:`mnmg_ivf_pq_search`:
    validation, qcap and engine resolution, and the rank body's operands.
    Returns ``(body, sharded, replicated, degraded)``."""
    local, dev0 = _check_placed(comms, index)
    q = torch.as_tensor(queries, device=dev0)
    if q.dtype == torch.float64:
        q = q.float()
    errors.check_matrix(q, "queries")
    errors.check_same_cols(q, index.centroids, "queries", "index")
    errors.expects(
        k <= n_probes * index.max_list,
        "k=%d exceeds the candidate pool (n_probes*max_list=%d)",
        k, n_probes * index.max_list,
    )
    errors.expects(
        0.0 < approx_recall_target <= 1.0,
        "approx_recall_target=%s out of range (0, 1]", approx_recall_target,
    )
    nl_g = int(index.centroids.shape[0])
    n_hosts, inner_width = comms_levels(comms)
    _check_probe_args(index, nl_g, overprobe, merge_ways, inner_width, wire)
    qcap, _ = resolve_qcap_arg(
        qcap, q, index.centroids, nl_g, n_probes,
        max_drop_frac=qcap_max_drop_frac, coarse=index.coarse,
        overprobe=overprobe)
    list_block = max(1, min(list_block, index.nl_pad))
    d = int(index.centroids.shape[1])
    shards = [index.shard(i) for i in range(len(local))]
    refine = index.vectors_sorted is not None and refine_ratio > 1.0
    engines = {s.device: ivf_pq._resolve_adc_engine(
        use_kernel, refine, index.pq_dim, index.pq_bits, qcap, s.device)
        for s in shards}
    alive, route = _degraded_operands(comms, index, shard_mask, failover,
                                      dev0)
    mut = _mutation_operands(mutation, index, len(local))
    sup_c, mem_i, cpad = _coarse_probe_operands(index, d, dev0)
    statics = dict(
        k=k, n_probes=n_probes, nl_pad=int(index.nl_pad),
        use_coarse=index.coarse is not None, overprobe=float(overprobe),
        merge_ways=None if merge_ways is None else int(merge_ways),
        replication=int(index.replication),
        replica_offset=int(index.replica_offset), hier=hier_axes(comms),
        wire=wire if n_hosts > 1 else None,
    )

    def body(ax, shard, *ops):
        m, ops = (ops[:3], ops[3:]) if mut is not None else (None, ops)
        engine = engines[shard.device]

        def scan(qf, lp, row_mask):
            return ivf_pq._pq_grouped_impl(
                shard, qf, k, n_probes, qcap, list_block, refine_ratio,
                probes=lp, exact_selection=exact_selection,
                use_kernel=engine, row_mask=row_mask)

        return _rank_body(ax, scan, shard.device, *ops, m,
                          use_kernel=engine, **statics)

    replicated = (q, index.centroids, index.owner, index.local_id, sup_c,
                  mem_i, cpad, alive, route)
    return body, (shards,) + tuple(mut or ()), replicated, alive is not None
