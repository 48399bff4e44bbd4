"""IVF-PQ ANN index — the port of ``raft_tpu/spatial/ann/ivf_pq.py``.

Build: coarse k-means -> per-list residuals -> product quantization: the
d dimensions split into M subspaces, each with its own 2^bits-entry
codebook trained by k-means on the residual sub-vectors
(:func:`~raft_tpu_torch.cluster.kmeans.kmeans_fit_batched`); codes are
(n, M) uint8. Datasets past the training size train on a subsample and
encode in blocks; datasets smaller than a codebook train per subspace
with inf-padded codebooks.

Search (ADC): per (query, probed list) a (M, 2^bits) table of squared
sub-distances between the query's residual and every codebook entry,
then each candidate's score is the sum of its M table entries. With
``refine_ratio`` > 1 (and raw vectors stored, or a ``refine_dataset``)
the best ADC candidates are rescored in exact f32 and re-selected.

The grouped (list-major) search has two ADC engines: the hand-written
CUDA sub-chunk-min scan (:mod:`.pq_kernel`, a gather from a LUT held in
shared memory) feeding the exact refine tail, and the legacy one-hot
engine (the LUT contracted with a one-hot expansion of the codes, as the
JAX package's XLA path spells it).

Selection: the JAX package's ``lax.approx_min_k`` stages are exact off
the TPU, and here they are the exact, stable
:func:`~raft_tpu_torch.spatial.selection.top_k_smallest`:
``exact_selection=False`` selects exactly too, and
``approx_recall_target`` is checked and otherwise unused.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.cluster.kmeans import (
    KMeansParams,
    _generator,
    kmeans_fit,
    kmeans_fit_batched,
    kmeans_predict,
)
from raft_tpu_torch.core.device import full_f32, hopper_device, resolve_device
from raft_tpu_torch.spatial.ann import pq_kernel, scan_core
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
    "IVFPQParams", "IVFPQIndex", "ivf_pq_build", "ivf_pq_search",
    "ivf_pq_search_grouped",
]

# grouped PQ searches of a CUDA index that use_kernel=None sent to the
# one-hot engine although the refine tail was active, because the kernel
# cannot serve them (an unrefined search runs the one-hot engine by rule)
ENGINE_FALLBACKS = 0
_fallback_reasons_warned: set = set()


@dataclasses.dataclass(frozen=True)
class IVFPQParams:
    """Analog of IVFPQParam (reference ann_common.h: nlist,
    M=n_subquantizers, n_bits)."""

    n_lists: int = 64
    pq_dim: int = 8           # M subspaces
    pq_bits: int = 8          # 2^bits codebook entries
    kmeans_n_iters: int = 20
    pq_kmeans_n_iters: int = 20
    seed: int = 0
    store_raw: bool = True    # keep raw vectors for exact refinement
    kmeans_init: str = "k-means++"  # "random": cheap coarse/code books
    # training-set cap of the coarse quantizer and the codebooks; None =
    # max(2^20, 64 * n_lists)
    train_size: typing.Optional[int] = None
    encode_block: int = 1 << 20  # rows per streaming-encode block
    # longest allowed inverted list (common.split_oversized_lists); None =
    # max(256, 2 * ceil(n / n_lists)) on the blocked build only, 0 = off
    max_list_cap: typing.Optional[int] = None


@dataclasses.dataclass
class IVFPQIndex:
    centroids: torch.Tensor      # (n_lists, d)
    codebooks: torch.Tensor      # (M, 2^bits, ds), inf rows on tiny builds
    codes_sorted: torch.Tensor   # (n + 1, M) uint8 — sentinel row appended
    storage: ListStorage
    # (n + 1, d) raw vectors in list-sorted order (sentinel row appended),
    # or None when built with store_raw=False
    vectors_sorted: typing.Optional[torch.Tensor]
    pq_dim: int
    pq_bits: int
    # the kernel engine's zero-padded code slabs, by padded row count
    _code_rows: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def code_rows(self, n_rows: int) -> torch.Tensor:
        """``codes_sorted`` with zero rows appended up to ``n_rows`` (no
        copy when none are needed): made on first use, then kept."""
        rows = self._code_rows.get(n_rows)
        if rows is None:
            rows = self.codes_sorted
            if n_rows > rows.shape[0]:
                rows = torch.nn.functional.pad(
                    rows, (0, 0, 0, n_rows - rows.shape[0]))
            self._code_rows[n_rows] = rows
        return rows

    def warmup(self, nq: int, *, k: int = 10, n_probes: int = 8,
               qcap=None, list_block: int = 8, refine_ratio: float = 2.0,
               refine_dataset=None, exact_selection: bool = False,
               approx_recall_target: float = 0.95, stream_partials=None,
               use_kernel: typing.Optional[bool] = None) -> int:
        """Run one all-zeros (nq, d) batch through
        :func:`ivf_pq_search_grouped` (building the CUDA kernels and
        initialising the device libraries on first use) and return the
        shape-only qcap (:func:`~.common.static_qcap`) to pass on every
        serving dispatch of this batch size. The JAX package's
        ``audit=`` option (its jaxpr program auditor) has no counterpart
        in the port and is not offered."""
        qc = static_qcap(qcap, nq, n_probes, self.centroids.shape[0])
        q0 = torch.zeros((nq, self.centroids.shape[1]), dtype=torch.float32,
                         device=self.device)
        ivf_pq_search_grouped(
            self, q0, k, n_probes=n_probes, qcap=qc,
            list_block=list_block, refine_ratio=refine_ratio,
            refine_dataset=refine_dataset, exact_selection=exact_selection,
            approx_recall_target=approx_recall_target,
            stream_partials=stream_partials, use_kernel=use_kernel,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return qc


def _train_pq_codebooks(xt, coarse, params: IVFPQParams, ds: int,
                        n_codes: int):
    """Codebooks from the training subsample's residuals (``coarse`` was
    fit on ``xt``, so its labels are the subsample's assignments)."""
    m = params.pq_dim
    res_t = xt - coarse.centroids[coarse.labels.long()]
    sub_t = res_t.reshape(xt.shape[0], m, ds).transpose(0, 1)   # (M, tn, ds)
    outs = kmeans_fit_batched(
        sub_t.contiguous(),
        KMeansParams(
            n_clusters=n_codes,
            max_iter=params.pq_kmeans_n_iters,
            seed=params.seed + 1,
            init=params.kmeans_init,
            compute_dtype="bfloat16",
        ),
    )
    return outs.centroids                                       # (M, K, ds)


def _encode_subspaces(sub, codebooks):
    """(M, n, ds) residual sub-vectors -> (n, M) uint8 codes: the nearest
    codebook entry per subspace, ties to the lowest entry."""
    return torch.stack([kmeans_predict(sub[m], codebooks[m])
                        for m in range(sub.shape[0])], dim=1).to(torch.uint8)


def _encode_rows(blk, coarse_centroids, codebooks, m: int, ds: int):
    """Label and PQ-encode one row block against the quantizers: returns
    (labels (rows,) int32, codes (rows, M) uint8)."""
    lbl = kmeans_predict(blk, coarse_centroids)
    res = blk - coarse_centroids[lbl.long()]
    s = res.reshape(blk.shape[0], m, ds).transpose(0, 1)
    return lbl, _encode_subspaces(s, codebooks)


def _train_pq_and_encode_blocked(x, xt, coarse, params: IVFPQParams,
                                 ds: int, n_codes: int):
    """Subsample-trained codebooks, then the whole dataset labelled and
    coded in ``encode_block``-row blocks (peak transient memory is one
    block's, not the dataset's)."""
    n = x.shape[0]
    codebooks = _train_pq_codebooks(xt, coarse, params, ds, n_codes)
    lbl_parts, code_parts = [], []
    for s0 in range(0, n, params.encode_block):
        lbl, codes = _encode_rows(x[s0:s0 + params.encode_block],
                                  coarse.centroids, codebooks,
                                  params.pq_dim, ds)
        lbl_parts.append(lbl)
        code_parts.append(codes)
    return torch.cat(lbl_parts), torch.cat(code_parts), codebooks


def _train_coarse(x, params: IVFPQParams):
    """Training subsample and coarse quantizer: at most ``train_size``
    rows (a uniform subsample in row order, drawn from a
    ``torch.Generator`` seeded with ``params.seed`` — the JAX package
    draws from its PRNG, so the two packages pick different rows), then
    k-means with bf16-operand centroid updates. Returns (xt, coarse,
    train_n)."""
    n = x.shape[0]
    train_n = min(n, params.train_size if params.train_size is not None
                  else max(1 << 20, 64 * params.n_lists))
    if train_n < n:
        sel = torch.randperm(n, generator=_generator(params.seed))[:train_n]
        xt = x[torch.sort(sel).values.to(x.device)]
    else:
        xt = x
    coarse = kmeans_fit(
        xt,
        KMeansParams(
            n_clusters=params.n_lists,
            max_iter=params.kmeans_n_iters,
            seed=params.seed,
            init=params.kmeans_init,
            compute_dtype="bfloat16",
        ),
    )
    return xt, coarse, train_n


def _tiny_codebooks(sub, params: IVFPQParams, n_codes: int):
    """n < 2^bits: one k-means per subspace with n clusters, each
    codebook padded with inf rows to 2^bits entries."""
    m, n, ds = sub.shape
    books = []
    for i in range(m):
        out = kmeans_fit(sub[i], KMeansParams(
            n_clusters=min(n_codes, n), max_iter=params.pq_kmeans_n_iters,
            seed=params.seed + i, init=params.kmeans_init,
        ))
        cents = out.centroids
        pad = n_codes - cents.shape[0]
        if pad > 0:
            cents = torch.cat([cents, cents.new_full((pad, ds),
                                                     float("inf"))])
        books.append(cents)
    return torch.stack(books)                                   # (M, K, ds)


def ivf_pq_build(x, params: IVFPQParams = IVFPQParams(), *,
                 device=None) -> IVFPQIndex:
    """Build an IVF-PQ index (see the module docstring). ``device``
    defaults to CUDA and raises when no CUDA device is present."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if x.dtype == torch.float64:
        x = x.float()          # as the JAX package stores f64 input
    errors.check_matrix(x, "x", min_rows=2)
    n, d = x.shape
    m = params.pq_dim
    errors.check_k(params.n_lists, n, "n_lists vs dataset rows")
    errors.expects(d % m == 0, "d=%d not divisible by pq_dim=%d", d, m)
    errors.expects(
        1 <= params.pq_bits <= 8,
        "pq_bits=%d out of range [1, 8] — codes are stored as uint8",
        params.pq_bits,
    )
    ds = d // m
    n_codes = 1 << params.pq_bits

    xt, coarse, train_n = _train_coarse(x, params)
    blocked = train_n < n or n > params.encode_block
    if params.max_list_cap is not None:
        cap = params.max_list_cap
    else:
        # auto cap only where it is the scaling blocker (see IVFPQParams)
        cap = max(256, 2 * -(-n // params.n_lists)) if blocked else 0

    if blocked:
        labels, codes, codebooks = _train_pq_and_encode_blocked(
            x, xt, coarse, params, ds, n_codes)
    else:
        labels = coarse.labels
        residuals = x - coarse.centroids[labels.long()]
        sub = residuals.reshape(n, m, ds).transpose(0, 1).contiguous()
        if n >= n_codes:
            codebooks = kmeans_fit_batched(sub, KMeansParams(
                n_clusters=n_codes, max_iter=params.pq_kmeans_n_iters,
                seed=params.seed + 1, init=params.kmeans_init,
            )).centroids
            codes = _encode_subspaces(sub, codebooks)
        else:
            codebooks = _tiny_codebooks(sub, params, n_codes)
            finite = torch.where(torch.isfinite(codebooks), codebooks,
                                 torch.full_like(codebooks, 1e30))
            codes = _encode_subspaces(sub, finite)

    labels_np, cents_out = labels.cpu().numpy(), coarse.centroids
    if cap:
        labels_np, cents_out = split_oversized_lists(labels_np, cents_out,
                                                     cap)
    storage = build_list_storage(labels_np, cents_out.shape[0], dev)
    sid = storage.sorted_ids.long()
    codes_sorted = torch.cat([
        codes[sid], torch.zeros((1, m), dtype=torch.uint8, device=dev)])
    vectors_sorted = None
    if params.store_raw:
        vectors_sorted = torch.cat([
            x[sid], torch.zeros((1, d), dtype=x.dtype, device=dev)])
    return IVFPQIndex(cents_out, codebooks, codes_sorted, storage,
                      vectors_sorted, m, params.pq_bits)


def _as_queries(index: IVFPQIndex, queries):
    q = torch.as_tensor(queries, device=index.device)
    errors.check_matrix(q, "queries")
    errors.check_same_cols(q, index.centroids, "queries", "index")
    return q


def _refine_active(index: IVFPQIndex, refine_dataset,
                   refine_ratio: float) -> bool:
    return ((index.vectors_sorted is not None or refine_dataset is not None)
            and refine_ratio > 1.0)


def _finite_codebooks(index: IVFPQIndex):
    """Codebooks with inf rows zeroed, and their squared norms (M, K)."""
    cb = index.codebooks.float()
    cb = torch.where(torch.isfinite(cb), cb, torch.zeros_like(cb))
    return cb, torch.sum(cb * cb, dim=2)


def _gather_refine_rows(index: IVFPQIndex, refine_dataset, rpos):
    """Raw f32 rows of candidates at sorted positions ``rpos``: from the
    index's list-sorted copy when stored, else from the caller's
    dataset through the sorted-order -> original-id map."""
    if index.vectors_sorted is not None:
        return index.vectors_sorted[rpos.long()].float()
    oid = index.storage.sorted_ids[
        torch.clamp(rpos, 0, index.storage.n - 1).long()]
    ds = torch.as_tensor(refine_dataset, device=index.device)
    return ds[oid.long()].float()


@full_f32
def ivf_pq_search(
    index: IVFPQIndex, queries, k: int, *, n_probes: int = 8,
    block_q: int = 256, refine_ratio: float = 2.0, refine_dataset=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query ADC search: returns (squared L2 distances, original row
    ids), queries in ``block_q`` blocks. ``refine_ratio`` > 1 with raw
    vectors (stored, or ``refine_dataset``, the caller-held (n, d)
    dataset of a ``store_raw=False`` index) rescores the top
    ``ceil(refine_ratio * k)`` ADC candidates in exact f32; otherwise the
    distances are the f32 ADC sums."""
    q = _as_queries(index, queries)
    d = q.shape[1]
    m = index.pq_dim
    ds = d // m
    storage = index.storage
    check_candidate_pool(k, n_probes, storage)
    refine = _refine_active(index, refine_dataset, refine_ratio)
    c = max(k, min(int(math.ceil(refine_ratio * k)),
                   n_probes * storage.max_list))
    cents = index.centroids.float()
    cb, cb_n = _finite_codebooks(index)

    def one_block(qb):
        nq = qb.shape[0]
        qf = qb.float()
        probes, _ = coarse_probe(qf, cents, n_probes)          # (q, p)
        res = (qf[:, None, :] - cents[probes]).reshape(nq, n_probes, m, ds)
        dots = torch.einsum("qpmd,mkd->qpmk", res, cb)
        res_n = torch.sum(res * res, dim=3)
        lut = res_n[..., None] + cb_n[None, None] - 2.0 * dots  # (q,p,M,K)
        cand_pos = storage.list_index[probes]                  # (q, p, L)
        codes = index.codes_sorted[cand_pos.long()].long()     # (q,p,L,M)
        # dist[q, p, l] = sum_m lut[q, p, m, codes[q, p, l, m]]
        gath = torch.gather(lut.transpose(2, 3), 2, codes)      # (q,p,L,M)
        d2 = torch.sum(gath, dim=3)
        valid = cand_pos < storage.n
        d2 = torch.where(valid, d2, float("inf")).reshape(nq, -1)
        flat_pos = cand_pos.reshape(nq, -1)
        if not refine:
            return select_candidates(storage, flat_pos, d2, k)
        adc, cpos = top_k_smallest(d2, c)
        rpos = torch.gather(flat_pos, 1, cpos)
        raw = _gather_refine_rows(index, refine_dataset, rpos)
        exact = score_l2_candidates(
            qf, raw, torch.isfinite(adc) & (rpos < storage.n))
        return select_candidates(storage, rpos, exact, k)

    return map_query_blocks(one_block, q, block_q)


def _resolve_adc_engine(use_kernel, refine_active: bool, pq_dim: int,
                        pq_bits: int, qcap: int,
                        device: torch.device) -> bool:
    """Resolve the ``use_kernel`` knob of the grouped PQ search.

    ``None``: the CUDA ADC kernel on a capability-9.0 CUDA device when
    the exact refine tail is active and
    :func:`~.pq_kernel.pq_adc_supported` holds. An unrefined search runs
    the one-hot engine — the rule, as in the JAX package, not a
    fallback; a refined CUDA search the kernel cannot serve runs the
    one-hot engine too, counted in ``ENGINE_FALLBACKS`` and warned about
    once per reason. ``True``: the kernel path, raising with the reason
    when it cannot run (on a CPU index the kernel path's scan runs its
    plain version). ``False``: the one-hot engine."""
    if use_kernel is None:
        if device.type != "cuda" or not refine_active:
            return False
        if not pq_kernel.pq_adc_supported(pq_dim, pq_bits, qcap):
            reason = (f"pq_dim={pq_dim} pq_bits={pq_bits} qcap={qcap} does "
                      "not fit the ADC kernel's shared memory or window "
                      "plan")
        elif not hopper_device(device):
            reason = f"{device} is not a capability-9.0 (Hopper) card"
        else:
            return True
        global ENGINE_FALLBACKS
        ENGINE_FALLBACKS += 1
        warn_engine_fallback(_fallback_reasons_warned, "IVF-PQ", reason)
        return False
    if use_kernel:
        errors.expects(
            refine_active,
            "use_kernel=True requires the exact refine tail "
            "(refine_ratio > 1 and stored raw vectors or a "
            "refine_dataset): the kernel emits sub-chunk ADC minima to "
            "build the refine pool, not per-row ADC distances",
        )
        errors.expects(
            pq_kernel.pq_adc_supported(pq_dim, pq_bits, qcap),
            "use_kernel=True unsupported at pq_dim=%d pq_bits=%d qcap=%d "
            "(one query's LUT and a code tile exceed a block's shared "
            "memory, or the window plan does not fit); use the one-hot "
            "engine (use_kernel=False)", pq_dim, pq_bits, qcap,
        )
        errors.expects(
            device.type == "cpu" or hopper_device(device),
            "use_kernel=True needs a capability-9.0 (Hopper) CUDA device "
            "for the sm_90a kernel; %s is not one", device,
        )
    return bool(use_kernel)


# refine-pool gather budget per query block on the kernel path
_REFINE_BLOCK_BYTES = 256 << 20


# f32 LUT bytes of one chunk of live (list, slot) pairs on the kernel path
# (its transients, the einsum's products and the sums, take a few times
# that); one ADC launch covers each chunk
_LUT_BLOCK_BYTES = 256 << 20


def _pair_luts(qf, cents, cb, cb_n, m: int, pair_lists, pair_qids):
    """bf16 ADC tables (P, M*K) of live (list, query) pairs: each query's
    residual against its list's centroid, scored against every codebook
    entry, residual-norm term included — the arithmetic of
    ``_pq_grouped_impl``'s ``block_luts``, row for row, without the dead
    slots."""
    ds = qf.shape[1] // m
    res = (qf[pair_qids] - cents[pair_lists]).reshape(-1, m, ds)
    dots = torch.einsum("pmd,mkd->pmk", res, cb)
    res_n = torch.sum(res * res, dim=2)                        # (P, M)
    lut = res_n[..., None] + cb_n[None] - 2.0 * dots
    return lut.flatten(1).to(torch.bfloat16)


def _max_lut_pairs(mk: int) -> int:
    """The live pairs of one LUT chunk: (M*K)-wide f32 rows under
    :data:`_LUT_BLOCK_BYTES`."""
    return max(1, _LUT_BLOCK_BYTES // (4 * mk))


def _lut_chunks(cum, max_pairs: int, max_lists: int):
    """[a, b) list ranges, in order, covering every list: each holds at
    most ``max_lists`` lists and ``max_pairs`` live pairs (but always at
    least one list). ``cum[i]`` counts the live pairs of lists 0..i."""
    chunks, a, n = [], 0, len(cum)
    while a < n:
        base = int(cum[a - 1]) if a else 0
        b = int(np.searchsorted(cum, base + max_pairs, side="right"))
        b = min(max(b, a + 1), a + max_lists, n)
        chunks.append((a, b))
        a = b
    return chunks


def _pq_kernel_pool(pair_luts, scan, probes, pmap, width: int,
                    max_pairs: int, max_lists: int, stream: bool):
    """The ADC kernel engine's (nq, p * width) pool of sub-chunk minima.

    ``pair_luts(pair_lists, pair_qids)`` builds LUT rows
    (:func:`_pair_luts`); ``scan(luts, lut_map, a, b, out=None)`` is one
    :func:`~.pq_kernel.pq_adc_lists` launch over lists [a, b), code rows
    read in place; ``pmap`` is the (qmat, rmat, slot) of
    :func:`invert_probe_map_ranked`. When the batch's nq * p pairs fit
    ``max_pairs``, one launch covers every list, its LUT rows in
    (query, probe) order, with no host sync. Otherwise (or with
    ``stream``) one host sync reads the live-pair counts that cut the
    lists into chunks of at most ``max_lists`` lists and ``max_pairs``
    live pairs; a chunk without a live pair is skipped, since nothing
    reads its lists. ``stream`` scatters each chunk into the query-major
    pool instead of materializing the (lists, qcap, width) minima."""
    qmat, rmat, slot = pmap
    n_lists, qcap = qmat.shape
    nq, p = probes.shape
    dev = qmat.device
    l_flat = probes.reshape(-1).long()
    live = qmat < nq
    if not stream and nq * p <= max_pairs:
        luts = pair_luts(l_flat, torch.arange(nq * p, device=dev) // p)
        lut_map = torch.where(live, qmat * p + rmat, -1).to(torch.int32)
        return regroup_values(scan(luts, lut_map, 0, n_lists), l_flat,
                              slot, nq, p, qcap)
    pair = torch.nonzero(live.reshape(-1)).squeeze(1)          # list-major
    pair_lists = pair // qcap
    pair_qids = qmat.reshape(-1)[pair].long()
    gmap = torch.full((n_lists * qcap,), -1, dtype=torch.int32, device=dev)
    gmap[pair] = torch.arange(pair.numel(), dtype=torch.int32, device=dev)
    gmap = gmap.reshape(n_lists, qcap)
    cum = torch.cumsum(live.sum(1), 0).cpu().numpy()
    if stream:
        pv = torch.full((nq, p, width), float("inf"), dtype=torch.float32,
                        device=dev)
    else:
        vals = torch.empty((n_lists, qcap, width), dtype=torch.float32,
                           device=dev)
    for a, b in _lut_chunks(cum, max_pairs, max_lists):
        p0, p1 = (int(cum[a - 1]) if a else 0), int(cum[b - 1])
        if p0 == p1:
            continue
        luts = pair_luts(pair_lists[p0:p1], pair_qids[p0:p1])
        gm = gmap[a:b]
        lut_map = torch.where(gm >= 0, gm - p0, gm)
        if stream:
            scatter_pairs(pv, qmat[a:b], rmat[a:b],
                          scan(luts, lut_map, a, b), nq, p)
        else:
            scan(luts, lut_map, a, b, out=vals[a:b])
    if stream:
        return pv.reshape(nq, p * width)
    return regroup_values(vals, l_flat, slot, nq, p, qcap)


@full_f32
def _pq_grouped_impl(index, q, k, n_probes, qcap, list_block, refine_ratio,
                     refine_dataset=None, probes=None,
                     exact_selection=False, stream_partials=None,
                     use_kernel=False):
    # ``exact_selection`` is accepted for parity: both of its settings
    # select exactly here (lax.approx_min_k is exact off the TPU)
    del exact_selection
    storage = index.storage
    dev = q.device
    n_lists = index.centroids.shape[0]
    L = storage.max_list
    nq, d = q.shape
    p = n_probes
    m = index.pq_dim
    ds = d // m
    kc = 1 << index.pq_bits
    f32 = torch.float32
    qf = q.float()
    cents = index.centroids.float()
    cb, cb_n = _finite_codebooks(index)
    inf = float("inf")  # a Python scalar: no host-to-device copy

    if probes is None:
        probes, _ = coarse_probe(qf, cents, p)                 # (nq, p)
    qmat, rmat, l_flat, slot = invert_probe_map_ranked(probes, n_lists,
                                                       qcap)
    qmat_l = qmat.long()
    q_pad = torch.cat([qf, torch.zeros((1, d), dtype=f32, device=dev)])
    # per-(list, query) partial width: must cover the refine pool, not
    # just k (a query's home list can hold most of its top-c candidates)
    refine = _refine_active(index, refine_dataset, refine_ratio)
    kk = min(max(k, int(math.ceil(refine_ratio * k)) if refine else k), L)
    use_kernel = bool(use_kernel) and refine
    offsets = storage.list_offsets.long()
    sizes = storage.list_sizes.long()

    def block_luts(lblk):
        """Per-(list, query-slot) ADC tables of one list block — each
        slot's query residual against THIS list's centroid, scored
        against every codebook entry, residual-norm term included, so
        summed entries are complete squared distances. The one-hot
        engine's LUT (the kernel engine builds the same rows for live
        pairs only, :func:`_pair_luts`). Returns (qids (LB, qcap), lut
        (LB, qcap, M, K))."""
        lb = lblk.shape[0]
        qids = qmat_l[lblk]                                    # (LB, qcap)
        res = (q_pad[qids] - cents[lblk][:, None, :]).reshape(
            lb, qcap, m, ds)
        dots = torch.einsum("bqmd,mkd->bqmk", res, cb)
        res_n = torch.sum(res * res, dim=3)                    # (LB, qcap, M)
        return qids, res_n[..., None] + cb_n[None, None] - 2.0 * dots

    def block_fn(lblk):                                        # (LB,) list ids
        lb = lblk.shape[0]
        qids, lut = block_luts(lblk)
        offs = offsets[lblk]
        szs = sizes[lblk]
        o_c = torch.clamp(offs, max=storage.n + 1 - L)         # slice clamp
        pos = o_c[:, None] + torch.arange(L, device=dev)[None, :]
        codes = index.codes_sorted[pos].long()                 # (LB, L, M)
        in_list = (pos >= offs[:, None]) & (pos < (offs + szs)[:, None])
        # the one-hot engine: dist[b, q, l] = sum_m lut[b, q, m, codes]
        # as a contraction of the bf16 LUT with the one-hot codes, f32
        # accumulation
        onehot = torch.zeros((lb, L, m, kc), dtype=f32, device=dev)
        onehot.scatter_(3, codes[..., None], 1.0)
        lut_b = lut.reshape(lb, qcap, m * kc).to(torch.bfloat16).float()
        d2 = torch.bmm(lut_b, onehot.reshape(lb, L, m * kc).transpose(1, 2))
        invalid = (qids >= nq)[:, :, None] | (~in_list)[:, None, :]
        d2 = torch.where(invalid, inf, d2)
        vals, sel = top_k_smallest(d2, kk)                     # (LB, qcap, kk)
        memp = torch.gather(pos[:, None, :].expand(d2.shape), 2, sel)
        return vals, memp

    if use_kernel:
        # the JAX window rule fixes l_pad (and with it the sub-chunk
        # windows and the pool clamp); the kernel takes qcap rows as-is
        l_tile = pq_kernel.plan_l_tile(
            m * kc, scan_core.pad_queries(qcap),
            l_tile=scan_core.round_up(L, scan_core.LANE),
            profile=scan_core.tile_profile(qcap),
        )
        l_pad = scan_core.round_up(L, l_tile)
        width = l_pad // scan_core.SUBCHUNK
        # n + 1 code rows (sentinel last), zero-padded to one full window
        rows_pad = max(index.codes_sorted.shape[0], l_pad)
        codes_src = index.code_rows(rows_pad)
        # every list's window origin (the slice clamp) and its [lo, hi)
        # relative to it: the kernel reads code rows in place from these
        o_all = torch.clamp(offsets[:n_lists], max=rows_pad - l_pad)
        lo_all = offsets[:n_lists] - o_all
        win_origin = o_all.to(torch.int32)
        win_bounds = torch.stack([lo_all, lo_all + sizes], 1).to(torch.int32)
        if stream_partials is None:
            stream_partials = n_lists * qcap * width * 4 > (1 << 31)

        def pair_luts(pair_lists, pair_qids):
            return _pair_luts(qf, cents, cb, cb_n, m, pair_lists, pair_qids)

        def scan(luts, lut_map, a, b, out=None):
            return pq_kernel.pq_adc_lists(
                luts, lut_map, codes_src, win_origin[a:b], win_bounds[a:b],
                l_pad, out=out)

        pv = _pq_kernel_pool(
            pair_luts, scan, probes, (qmat, rmat, slot), width,
            _max_lut_pairs(m * kc),
            list_block if stream_partials else n_lists, stream_partials)
        pm = None
    else:
        width = kk
        # pad the list axis to a multiple of list_block with clamped ids
        # (the padded slots recompute the last list; nothing reads them)
        nl_pad = -(-n_lists // list_block) * list_block
        lids = torch.clamp(torch.arange(nl_pad, device=dev),
                           max=n_lists - 1).reshape(-1, list_block)
        if stream_partials is None:
            # stream once materialized (n_lists, qcap, width) partials
            # pass ~2 GB
            stream_partials = n_lists * qcap * width * 8 > (1 << 31)
        if stream_partials:
            # scatter each list block's partials straight into the
            # query-major (nq, p, width) pool; sentinel slots drop
            pv = torch.full((nq, p, width), float("inf"), dtype=f32,
                            device=dev)
            pm = torch.full((nq, p, width), storage.n, dtype=torch.int64,
                            device=dev)
            for lblk in lids:
                out = block_fn(lblk)
                scatter_pairs(pv, qmat[lblk], rmat[lblk], out[0], nq, p)
                scatter_pairs(pm, qmat[lblk], rmat[lblk], out[1], nq, p)
            pv = pv.reshape(nq, p * width)
            pm = pm.reshape(nq, p * width)
        else:
            outs = [block_fn(lblk) for lblk in lids]
            vals = torch.cat([o[0] for o in outs])[:n_lists]
            mem = torch.cat([o[1] for o in outs])[:n_lists]
            pv, pm = regroup_pairs(vals, mem, l_flat, slot, nq, p, qcap)

    if not refine:
        return select_candidates(storage, pm, pv, k)

    if use_kernel:
        # refine the rows of the top-c sub-chunks (a superset of the
        # one-hot engine's top-c ADC rows) in exact f32; clamp c to the
        # pool width last
        c = min(p * width, max(k, int(math.ceil(refine_ratio * k))))
        rpos, validf = subchunk_pool_rows(pv, c, probes, storage, rows_pad,
                                          l_pad, width)

        def refine_blk(args):
            qb, rp, vl = args
            raw = _gather_refine_rows(index, refine_dataset,
                                      torch.clamp(rp, 0, storage.n))
            exact = score_l2_candidates(qb, raw, vl & (rp < storage.n))
            return select_candidates(storage, rp, exact, k)

        blk_q = max(8, min(nq, _REFINE_BLOCK_BYTES
                           // (c * scan_core.SUBCHUNK * d * 4)))
        return map_query_blocks(refine_blk, (qf, rpos, validf), blk_q)

    # exact refinement: top-c of the pooled ADC candidates, f32 rescore
    c = max(k, min(int(math.ceil(refine_ratio * k)), p * kk))
    nadc, cpos = top_k_smallest(pv, c)                         # (nq, c)
    rpos = torch.gather(pm, 1, cpos)
    raw = _gather_refine_rows(index, refine_dataset, rpos)
    exact = score_l2_candidates(
        qf, raw, torch.isfinite(nadc) & (rpos < storage.n))
    return select_candidates(storage, rpos, exact, k)


def ivf_pq_search_grouped(
    index: IVFPQIndex, queries, k: int, *, n_probes: int = 8,
    qcap: typing.Union[int, str, None] = None, list_block: int = 8,
    refine_ratio: float = 2.0, refine_dataset=None,
    exact_selection: bool = False, approx_recall_target: float = 0.95,
    stream_partials: typing.Optional[bool] = None,
    qcap_max_drop_frac: typing.Optional[float] = None,
    use_kernel: typing.Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Throughput-mode IVF-PQ search, grouped by list: each list's codes
    are read once per batch for all its probing queries (at most
    ``qcap``; ``qcap`` as in :func:`~.ivf_flat.ivf_flat_search_grouped`).

    ``use_kernel`` (:func:`_resolve_adc_engine`): ``None`` runs the CUDA
    ADC sub-chunk-min kernel on a Hopper card when the exact refine tail
    is active and the kernel fits — only (qcap, l_pad/8) minima per list
    leave it, and the top ``ceil(refine_ratio*k)`` sub-chunks' rows are
    rescored in exact f32; ``False`` pins the one-hot engine; ``True``
    asks for the kernel path and raises when it cannot run. Returned
    candidates are value-exact between engines at the same refine_ratio
    (the kernel's refine pool is a superset by the sub-chunk cover);
    tied candidates may order differently. Without refinement the
    returned distances are the bf16-LUT ADC sums.

    ``exact_selection`` / ``approx_recall_target``: the JAX package's
    approximate selection stages are exact off the TPU, and exact here
    for either setting (the target is range-checked only).
    ``refine_dataset``: the caller-held (n, d) dataset of a
    ``store_raw=False`` index, for exact refinement.
    ``stream_partials``: stream list blocks through the query-major pool
    instead of materializing per-block partials (``None``: past ~2 GB)."""
    q = _as_queries(index, queries)
    check_candidate_pool(k, n_probes, index.storage)
    errors.expects(
        0.0 < approx_recall_target <= 1.0,
        "approx_recall_target=%s out of range (0, 1]", approx_recall_target,
    )
    n_lists = index.centroids.shape[0]
    qcap, probes = resolve_qcap_arg(
        qcap, q, index.centroids, n_lists, n_probes,
        max_drop_frac=qcap_max_drop_frac,
    )
    list_block = max(1, min(list_block, n_lists))
    use_kernel = _resolve_adc_engine(
        use_kernel, _refine_active(index, refine_dataset, refine_ratio),
        index.pq_dim, index.pq_bits, qcap, index.device,
    )
    return _pq_grouped_impl(
        index, q, k, n_probes, qcap, list_block, refine_ratio,
        refine_dataset=refine_dataset, probes=probes,
        exact_selection=exact_selection, stream_partials=stream_partials,
        use_kernel=use_kernel,
    )
