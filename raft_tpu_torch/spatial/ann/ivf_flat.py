"""IVF-Flat ANN index — the port of ``raft_tpu/spatial/ann/ivf_flat.py``.

Build: k-means coarse quantizer -> vectors permuted into contiguous lists
(:mod:`.common`). Search (per query): score queries x centroids, take the
top-nprobe lists, gather the padded probed lists, score the candidates
in exact f32, keep the k best. Grouped search (the serving path): invert
the probe map and scan each list once per batch for all its probing
queries — with the hand-written CUDA sub-chunk-min scan
(:mod:`.flat_kernel`) and an exact f32 rerank, or with the legacy
materialized-tile scan.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import Tuple

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
from raft_tpu_torch.core.device import full_f32, hopper_device, resolve_device
from raft_tpu_torch.spatial.ann import flat_kernel, scan_core, sq_kernel
from raft_tpu_torch.spatial.ann.common import (
    ListStorage,
    build_list_storage,
    check_candidate_pool,
    coarse_probe,
    invert_probe_map_ranked,
    map_query_blocks,
    regroup_pairs,
    regroup_values,
    resolve_qcap_arg,
    scatter_pairs,
    score_l2_candidates,
    select_candidates,
    split_oversized_lists,
    static_qcap,
    subchunk_pool_rows,
    warn_engine_fallback,
)
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = [
    "IVFFlatParams",
    "IVFFlatIndex",
    "ivf_flat_build",
    "ivf_flat_search",
    "ivf_flat_search_grouped",
]

# grouped searches of a CUDA index that use_kernel=None sent to the legacy
# (plain PyTorch) scan because the kernel cannot serve them
ENGINE_FALLBACKS = 0
_fallback_reasons_warned: set = set()


@dataclasses.dataclass(frozen=True)
class IVFFlatParams:
    """Analog of IVFFlatParam (reference ann_common.h: nlist, nprobe)."""

    n_lists: int = 64
    kmeans_n_iters: int = 20
    seed: int = 0
    kmeans_init: str = "k-means++"  # "random": cheap coarse quantizer
    # longest allowed inverted list (common.split_oversized_lists);
    # None/0 = off
    max_list_cap: typing.Optional[int] = None


@dataclasses.dataclass
class IVFFlatIndex:
    centroids: torch.Tensor      # (n_lists, d)
    data_sorted: torch.Tensor    # (n + 1, d) — last row is the sentinel (zeros)
    storage: ListStorage
    metric: str
    # the kernel engine's slab operands of data_sorted, by padded row count
    _scan_rows: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def scan_rows(self, n_rows: int) -> torch.Tensor:
        """``data_sorted`` as a scan kernel's slab operand — bf16 for
        float rows, the int8 codes as they are for the IVF-SQ view — with
        zero rows appended up to ``n_rows``: made on first use, then kept
        (an index is not mutated in place). int8 codes that need no
        padding are returned without a copy."""
        rows = self._scan_rows.get(n_rows)
        if rows is None:
            rows = self.data_sorted
            if rows.dtype != torch.int8:
                rows = rows.to(torch.bfloat16)
            if n_rows > rows.shape[0]:
                rows = torch.nn.functional.pad(
                    rows, (0, 0, 0, n_rows - rows.shape[0]))
            self._scan_rows[n_rows] = rows
        return rows

    def warmup(self, nq: int, *, k: int = 10, n_probes: int = 8,
               qcap=None, list_block: int = 32, stream_partials=None,
               use_kernel: typing.Optional[bool] = None,
               rerank_ratio: float = 4.0) -> int:
        """Run one all-zeros (nq, d) batch through the grouped serving
        search (building the CUDA kernels, the bf16 scan copy of the rows
        and initialising the device libraries on first use) and return the shape-only qcap
        (:func:`~.common.static_qcap`) to pass on every serving dispatch
        of this batch size."""
        qc = static_qcap(qcap, nq, n_probes, self.centroids.shape[0])
        q0 = torch.zeros((nq, self.centroids.shape[1]), dtype=torch.float32,
                         device=self.device)
        ivf_flat_search_grouped(
            self, q0, k, n_probes=n_probes, qcap=qc,
            list_block=list_block, stream_partials=stream_partials,
            use_kernel=use_kernel, rerank_ratio=rerank_ratio,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return qc


def ivf_flat_build(x, params: IVFFlatParams = IVFFlatParams(), *,
                   metric: str = "l2", device=None) -> IVFFlatIndex:
    """Build: k-means (bf16-operand centroid updates) + list permutation.
    ``device`` defaults to CUDA and raises when no CUDA device is
    present; pass ``device="cpu"`` to build on the CPU."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if x.dtype == torch.float64:
        x = x.float()          # as the JAX package stores f64 input
    errors.check_matrix(x, "x", min_rows=2)
    errors.check_k(params.n_lists, x.shape[0], "n_lists vs dataset rows")
    out = kmeans_fit(
        x,
        KMeansParams(
            n_clusters=params.n_lists,
            max_iter=params.kmeans_n_iters,
            seed=params.seed,
            init=params.kmeans_init,
            compute_dtype="bfloat16",
        ),
    )
    labels_np, cents = out.labels.cpu().numpy(), out.centroids
    if params.max_list_cap:
        labels_np, cents = split_oversized_lists(
            labels_np, cents, params.max_list_cap
        )
    storage = build_list_storage(labels_np, cents.shape[0], dev)
    data_sorted = torch.cat([
        x[storage.sorted_ids.long()],
        torch.zeros((1, x.shape[1]), dtype=x.dtype, device=dev),
    ])
    return IVFFlatIndex(cents, data_sorted, storage, metric)


def _as_queries(index: IVFFlatIndex, queries):
    q = torch.as_tensor(queries, device=index.device)
    errors.check_matrix(q, "queries")
    errors.check_same_cols(q, index.centroids, "queries", "index")
    return q


def ivf_flat_search(index: IVFFlatIndex, queries, k: int, *,
                    n_probes: int = 8, block_q: int = 512,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query search: returns (dists, ids) with original row ids
    (squared distances, sqrt applied for metric='l2'). Queries are
    processed in ``block_q`` blocks to bound the candidate gather."""
    q = _as_queries(index, queries)
    check_candidate_pool(k, n_probes, index.storage)
    storage = index.storage

    def one_block(qb):
        qf = qb.float()
        probes, _ = coarse_probe(qf, index.centroids, n_probes)
        cand_pos = storage.list_index[probes].reshape(qb.shape[0], -1)
        cand_vecs = index.data_sorted[cand_pos.long()].float()
        d2 = score_l2_candidates(qf, cand_vecs, cand_pos < storage.n)
        return select_candidates(storage, cand_pos, d2, k)

    vals, ids = map_query_blocks(one_block, q, block_q)
    if index.metric == "l2":
        vals = _sqrt(vals)
    return vals, ids


def _sqrt(vals):
    # via f64: correctly rounded on every device (torch's f32 CPU sqrt
    # is not, and neither is XLA's)
    return torch.sqrt(torch.clamp_min(vals, 0.0).double()).float()


def _resolve_scan_engine(use_kernel, d: int, qcap: int,
                         device: torch.device) -> bool:
    """Resolve the ``use_kernel`` knob of the grouped search.

    ``None``: the CUDA kernel on a capability-9.0 CUDA device whenever
    :func:`~.flat_kernel.flat_scan_supported` holds, the legacy
    materialized-tile scan elsewhere; a CUDA index sent to the legacy
    scan is counted in ``ENGINE_FALLBACKS`` and warned about once per
    reason. ``True``: the kernel path, raising with the reason when it
    cannot run (on a CPU index the kernel path's scan runs its plain
    version). ``False``: the legacy scan."""
    if use_kernel is None:
        if device.type != "cuda":
            return False
        if not flat_kernel.flat_scan_supported(d, qcap):
            reason = (f"d={d} qcap={qcap} does not fit the kernel's "
                      "shared-memory tiles")
        elif not hopper_device(device):
            reason = f"{device} is not a capability-9.0 (Hopper) card"
        else:
            return True
        _note_fallback(reason)
        return False
    if use_kernel:
        errors.expects(
            flat_kernel.flat_scan_supported(d, qcap),
            "use_kernel=True unsupported at d=%d qcap=%d (the kernel's "
            "shared-memory tiles or the scan window plan do not fit); use "
            "the legacy scan (use_kernel=False)", d, qcap,
        )
        errors.expects(
            device.type == "cpu" or hopper_device(device),
            "use_kernel=True needs a capability-9.0 (Hopper) CUDA device "
            "for the sm_90a kernel; %s is not one", device,
        )
    return bool(use_kernel)


def _note_fallback(reason: str) -> None:
    global ENGINE_FALLBACKS
    ENGINE_FALLBACKS += 1
    warn_engine_fallback(_fallback_reasons_warned, "IVF-Flat", reason)


# rerank-pool gather budget per query block on the kernel path
_RERANK_BLOCK_BYTES = 256 << 20


@full_f32
def _grouped_impl(index, q, k, n_probes, qcap, list_block, probes=None,
                  stream_partials=None, use_kernel=False,
                  rerank_ratio=4.0, dequant=None):
    # ``dequant``: optional (vmin, vscale) (d,) f32 pair — the IVF-SQ mode
    # of this one grouped body. ``index.data_sorted`` then holds int8
    # codes: the legacy scan and the rerank tail decode the rows they
    # touch through ``ivf_sq.sq_decode``, and the kernel engine's
    # ``sq_kernel`` reads the int8 codes in place (no bf16 or f32 copy).
    storage = index.storage
    dev = q.device
    n_lists = storage.list_index.shape[0]
    L = storage.max_list
    nq, d = q.shape
    p = n_probes
    f32 = torch.float32
    qf = q.float()
    inf = float("inf")  # a Python scalar: no host-to-device copy

    def dq_rows(rows_f32):
        if dequant is None:
            return rows_f32
        from raft_tpu_torch.spatial.ann.ivf_sq import sq_decode

        return sq_decode(rows_f32, dequant[0], dequant[1])

    if probes is None:
        probes, _ = coarse_probe(qf, index.centroids, p)     # (nq, p)
    qmat, rmat, l_flat, slot = invert_probe_map_ranked(probes, n_lists,
                                                       qcap)
    qmat_l = qmat.long()

    q_pad = torch.cat([qf, torch.zeros((1, d), dtype=f32, device=dev)])
    qn_pad = torch.cat([torch.sum(qf * qf, dim=1),
                        torch.zeros(1, dtype=f32, device=dev)])
    offsets = storage.list_offsets.long()
    sizes = storage.list_sizes.long()

    def block_fn(lblk):                                      # (LB,) list ids
        qids = qmat_l[lblk]                                  # (LB, qcap)
        qv = q_pad[qids]                                     # (LB, qcap, d)
        qnv = qn_pad[qids]
        offs = offsets[lblk]
        szs = sizes[lblk]
        o_c = torch.clamp(offs, max=storage.n + 1 - L)       # slice clamp
        pos = o_c[:, None] + torch.arange(L, device=dev)[None, :]
        mv = dq_rows(index.data_sorted[pos].float())         # (LB, L, d)
        in_list = (pos >= offs[:, None]) & (pos < (offs + szs)[:, None])
        mn = torch.sum(mv * mv, dim=2)                       # (LB, L)
        dots = torch.bmm(qv, mv.transpose(1, 2))             # full f32
        d2 = qnv[:, :, None] + mn[:, None, :] - 2.0 * dots
        invalid = (qids >= nq)[:, :, None] | (~in_list)[:, None, :]
        d2 = torch.where(invalid, inf, d2)
        vals, sel = top_k_smallest(d2, k)
        memp = torch.gather(pos[:, None, :].expand(d2.shape), 2, sel)
        return vals, memp

    if use_kernel:
        kmod = flat_kernel if dequant is None else sq_kernel
        sub = scan_core.SUBCHUNK
        # the JAX window rule fixes l_pad (and with it the sub-chunk
        # windows and the pool clamp); the kernel takes qcap rows as-is
        l_tile = kmod.plan_l_tile(
            d, scan_core.pad_queries(qcap),
            l_tile=scan_core.round_up(L, scan_core.LANE),
            profile=scan_core.tile_profile(qcap),
        )
        l_pad = scan_core.round_up(L, l_tile)
        nsc = l_pad // sub
        # n + 1 rows (sentinel last), zero-padded to one full window: bf16
        # rows, or int8 codes whose zero pad rows decode to 128·vscale +
        # vmin and lie outside every list's [lo, hi)
        rows_pad = max(index.data_sorted.shape[0], l_pad)
        data_src = index.scan_rows(rows_pad)
        q_bf16 = q_pad.to(torch.bfloat16)
        # every list's window origin (the slice clamp) and its [lo, hi)
        # relative to it: the scans read rows (or codes) in place
        o_all = torch.clamp(offsets[:n_lists], max=rows_pad - l_pad)
        lo_all = offsets[:n_lists] - o_all
        win_origin = o_all.to(torch.int32)
        win_bounds = torch.stack([lo_all, lo_all + sizes], 1).to(torch.int32)

        def block_fn_kernel(lblk):
            # query rows by id, slab rows in place: no gather
            if dequant is None:
                return flat_kernel.flat_scan_lists(
                    q_bf16, qmat[lblk], data_src, win_origin[lblk],
                    win_bounds[lblk], l_pad)                 # (LB, qcap, nsc)
            return sq_kernel.sq_scan_lists(
                q_bf16, qmat[lblk], data_src, win_origin[lblk],
                win_bounds[lblk], l_pad, dequant[0], dequant[1])

        width, scan_fn = nsc, block_fn_kernel
    else:
        width, scan_fn = k, block_fn

    # pad the list axis to a multiple of list_block with clamped ids (the
    # padded slots recompute the last list; nothing reads them)
    nl_pad = -(-n_lists // list_block) * list_block
    lids = torch.clamp(torch.arange(nl_pad, device=dev),
                       max=n_lists - 1).reshape(-1, list_block)

    if stream_partials is None:
        # stream once materialized (n_lists, qcap, width) partials pass
        # ~2 GB; the kernel path pools values only
        per_entry = 4 if use_kernel else 8
        stream_partials = n_lists * qcap * width * per_entry > (1 << 31)
    if stream_partials:
        # scatter each list block's partials straight into the
        # query-major (nq, p, width) pool; sentinel slots drop
        pv = torch.full((nq, p, width), float("inf"), dtype=f32, device=dev)
        pm = None if use_kernel else torch.full(
            (nq, p, k), storage.n, dtype=torch.int64, device=dev)
        for lblk in lids:
            out = scan_fn(lblk)
            if use_kernel:
                scatter_pairs(pv, qmat[lblk], rmat[lblk], out, nq, p)
            else:
                scatter_pairs(pv, qmat[lblk], rmat[lblk], out[0], nq, p)
                scatter_pairs(pm, qmat[lblk], rmat[lblk], out[1], nq, p)
        pv = pv.reshape(nq, p * width)
        if pm is not None:
            pm = pm.reshape(nq, p * k)
    elif use_kernel:
        vals = scan_fn(slice(None))              # one launch for the batch
        pv = regroup_values(vals, l_flat, slot, nq, p, qcap)
        pm = None
    else:
        outs = [scan_fn(lblk) for lblk in lids]
        vals = torch.cat([o[0] for o in outs])[:n_lists]
        mem = torch.cat([o[1] for o in outs])[:n_lists]
        pv, pm = regroup_pairs(vals, mem, l_flat, slot, nq, p, qcap)

    if use_kernel:
        # rescore the rows of the top-c sub-chunks in exact f32; clamp c
        # to the pool width last
        c = min(p * width, max(k, int(math.ceil(rerank_ratio * k))))
        rpos, validf = subchunk_pool_rows(pv, c, probes, storage, rows_pad,
                                          l_pad, width)

        def rerank_blk(args):
            qb, rp, vl = args
            raw = dq_rows(
                index.data_sorted[torch.clamp(rp, 0, storage.n)].float())
            exact = score_l2_candidates(qb, raw, vl & (rp < storage.n))
            return select_candidates(storage, rp, exact, k)

        blk_q = max(8, min(nq, _RERANK_BLOCK_BYTES // (c * sub * d * 4)))
        return map_query_blocks(rerank_blk, (qf, rpos, validf), blk_q)

    fvals, fpos = top_k_smallest(pv, k)
    fmem = torch.gather(pm, 1, fpos)
    ids = storage.sorted_ids[torch.clamp(fmem, 0, storage.n - 1)]
    ids = torch.where(torch.isfinite(fvals), ids, -1).to(torch.int32)
    return fvals, ids


def ivf_flat_search_grouped(
    index: IVFFlatIndex, queries, k: int, *, n_probes: int = 8,
    qcap: typing.Union[int, str, None] = None, list_block: int = 32,
    stream_partials: typing.Optional[bool] = None,
    qcap_max_drop_frac: typing.Optional[float] = None,
    use_kernel: typing.Optional[bool] = None,
    rerank_ratio: float = 4.0, row_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Throughput-mode IVF search, grouped by list instead of by query:
    each list's vectors are read once per batch and scored against all
    its probing queries (at most ``qcap``; overflow pairs drop, lowest
    probe rank kept first).

    ``qcap``: ``None`` auto-sizes from the actual probe map (at most 2%
    of pairs drop, logged); ``"throughput"`` ~0.75x the mean occupancy;
    an int as-is (serving passes the value ``index.warmup`` returned).

    ``use_kernel``: ``None`` runs the CUDA sub-chunk-min scan on a
    Hopper card when it fits (:func:`_resolve_scan_engine`) — only the
    (qcap, l_pad/8) minima per list leave the kernel, and the top
    ``ceil(rerank_ratio*k)`` sub-chunks' rows are rescored in exact f32,
    so returned distances are exact (a CUDA index the kernel cannot serve
    runs the legacy scan, counted in ``ENGINE_FALLBACKS`` and warned
    about); ``False`` pins the legacy
    materialized-tile scan; ``True`` asks for the kernel path and raises
    when it cannot run. The engines return the same candidates by value
    (the rerank pool covers the top-k at the ``rerank_ratio`` margin);
    tied candidates may order differently.

    ``row_mask`` (mutation tombstones) belongs to a module not yet
    ported; passing it raises. (The IVF-SQ mode of this search is
    :func:`~.ivf_sq.ivf_sq_search_grouped`.)

    With ``qcap`` large enough this returns what :func:`ivf_flat_search`
    returns for the same ``n_probes``."""
    errors.expects(row_mask is None,
                   "row_mask=: the mutation tier is not yet ported to "
                   "raft_tpu_torch")
    q = _as_queries(index, queries)
    storage = index.storage
    if k > storage.max_list:
        # a single list cannot fill a per-list top-k row
        errors.expects(
            not use_kernel,
            "use_kernel=True: k=%d > max_list=%d routes to the per-query "
            "search, which has no kernel path; lower k or rebuild with "
            "fewer lists", k, storage.max_list,
        )
        return ivf_flat_search(index, q, k, n_probes=n_probes)
    check_candidate_pool(k, n_probes, storage)
    n_lists = storage.list_index.shape[0]
    qcap, probes = resolve_qcap_arg(
        qcap, q, index.centroids, n_lists, n_probes,
        max_drop_frac=qcap_max_drop_frac,
    )
    list_block = max(1, min(list_block, n_lists))
    use_kernel = _resolve_scan_engine(
        use_kernel, index.centroids.shape[1], qcap, index.device
    )
    vals, ids = _grouped_impl(
        index, q, k, n_probes, qcap, list_block, probes=probes,
        stream_partials=stream_partials, use_kernel=use_kernel,
        rerank_ratio=float(rerank_ratio),
    )
    if index.metric == "l2":
        vals = _sqrt(vals)
    return vals, ids
