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

The grouped (list-major) search is the one grouped body
(:func:`.grouped.search`) over :class:`PQEngine`, whose two forms are the
hand-written CUDA sub-chunk-min scan (:mod:`.pq_kernel`, a gather from a
LUT held in shared memory) feeding the exact refine tail, and the legacy
one-hot engine (the LUT contracted with a one-hot expansion of the
codes, as the JAX package's XLA path spells it). Both build their bf16
tables with
:func:`~.pq_kernel.pq_lut_rows`: a CUDA kernel on a CUDA device (which
has to be a Hopper card), its plain version on the CPU.

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
from raft_tpu_torch.core.annotate import annotate
from raft_tpu_torch.core.device import full_f32, resolve_device
from raft_tpu_torch.spatial.ann import grouped, pq_kernel, search_obs
from raft_tpu_torch.spatial.ann.common import (
    ListStorage,
    as_queries,
    build_list_storage,
    check_candidate_pool,
    coarse_probe,
    map_query_blocks,
    resolve_qcap_arg,
    score_l2_candidates,
    select_candidates,
    split_oversized_lists,
    static_qcap,
)
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = [
    "IVFPQParams", "IVFPQIndex", "PQEngine", "ivf_pq_build",
    "ivf_pq_search", "ivf_pq_search_grouped",
]


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
        return grouped.slab_rows(self.codes_sorted, n_rows, self._code_rows)

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
        with search_obs.uncounted():
            ivf_pq_search_grouped(
                self, q0, k, n_probes=n_probes, qcap=qc,
                list_block=list_block, refine_ratio=refine_ratio,
                refine_dataset=refine_dataset,
                exact_selection=exact_selection,
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
    q = as_queries(queries, index.centroids)
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


# LUT bytes of one chunk of live (list, slot) pairs on the kernel path,
# counted at 4 bytes an entry though the rows are bf16; one LUT launch and
# one ADC launch cover each chunk
_LUT_BLOCK_BYTES = 256 << 20


def _max_lut_pairs(mk: int) -> int:
    """The live pairs of one LUT chunk: rows of M*K entries at 4 bytes
    each under :data:`_LUT_BLOCK_BYTES`."""
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


class PQEngine(grouped.Engine):
    """The grouped engine of an :class:`IVFPQIndex` (the module's
    docstring); ``ratio`` is the refine ratio. The kernel form needs the
    refine tail (:func:`_refine_active`); without it the one-hot form
    returns its ADC sums."""

    name, label = "ivf_pq", "IVF-PQ"

    def __init__(self, index: IVFPQIndex, kernel: bool = False,
                 ratio: float = 2.0, refine_dataset=None):
        super().__init__(index.centroids.float().contiguous(), index.storage,
                         kernel, ratio)
        self.index, self.refine_dataset = index, refine_dataset
        self.rescore = _refine_active(index, refine_dataset, ratio)
        self.mk = index.pq_dim << index.pq_bits
        self.cb, self.cb_n = _finite_codebooks(index)

    @classmethod
    def of(cls, index: IVFPQIndex, use_kernel, qcap=None,
           ratio: float = 2.0, refine_dataset=None):
        """The engine of ``index``, its form by the rule (``qcap`` does
        not enter it)."""
        kernel = grouped.resolve_kernel(
            use_kernel, cls, index.device, index.pq_dim, index.pq_bits,
            refine=_refine_active(index, refine_dataset, ratio))
        return cls(index, kernel, ratio, refine_dataset)

    @staticmethod
    def fits(pq_dim: int, pq_bits: int):
        return (
            pq_kernel.pq_adc_supported(pq_dim, pq_bits),
            f"pq_dim={pq_dim} pq_bits={pq_bits} does not fit the ADC "
            "kernel's uint8 codes or shared memory",
            f"use_kernel=True unsupported at pq_dim={pq_dim} "
            f"pq_bits={pq_bits} (codes wider than uint8, or one query's LUT "
            "and a code tile exceed a block's shared memory); use the "
            "one-hot engine (use_kernel=False)",
        )

    @property
    def lut_stage(self):
        return self.kernel

    def window(self, b):
        # the window length fixes the sub-chunk windows and the pool
        # clamp; the kernel takes qcap rows as-is
        l_pad = pq_kernel.window_l_pad(self.mk, b.qcap, self.storage.max_list)
        # n + 1 code rows (sentinel last), zero-padded to one full window
        rows_pad = max(self.index.codes_sorted.shape[0], l_pad)
        self._src = self.index.code_rows(rows_pad)
        return l_pad, rows_pad

    def pieces(self, b, stream, list_block):
        """The LUT chunk plan. When the batch's nq * p pairs fit one
        chunk, one piece covers every list, its LUT rows in (query,
        probe) order, with no host sync. Otherwise (or when streaming) one
        host sync reads the live-pair counts that cut the lists into
        chunks of at most ``list_block`` lists (streaming) and
        :func:`_max_lut_pairs` live pairs; a chunk without a live pair is
        skipped, since nothing reads its lists."""
        qmat, qcap = b.qmat, b.qcap
        n_lists = qmat.shape[0]
        dev = qmat.device
        max_pairs = _max_lut_pairs(self.mk)
        self._live = qmat < b.nq
        if not stream and b.nq * b.p <= max_pairs:
            return [(slice(None), None)]
        with search_obs.host_sync("ivf_pq", "live_pairs"):
            pair = torch.nonzero(self._live.reshape(-1)).squeeze(1)
        self._pair_lists = pair // qcap                      # list-major
        self._pair_qids = qmat.reshape(-1)[pair].long()
        gmap = torch.full((n_lists * qcap,), -1, dtype=torch.int32,
                          device=dev)
        gmap[pair] = torch.arange(pair.numel(), dtype=torch.int32, device=dev)
        self._gmap = gmap.reshape(n_lists, qcap)
        cum = torch.cumsum(self._live.sum(1), 0)
        with search_obs.host_sync("ivf_pq", "chunk_plan"):
            cum = cum.cpu().numpy()
        # the chunks' lists and live-pair ranges [p0, p1)
        spans = [(a, c, int(cum[a - 1]) if a else 0, int(cum[c - 1]))
                 for a, c in _lut_chunks(cum, max_pairs,
                                         list_block if stream else n_lists)]
        return [(slice(a, c), (p0, p1)) for a, c, p0, p1 in spans if p1 > p0]

    def tables(self, b, sel, ctx):
        if ctx is None:
            lists = b.l_flat
            qids = torch.arange(b.nq * b.p, device=lists.device) // b.p
        else:
            lists = self._pair_lists[ctx[0]:ctx[1]]
            qids = self._pair_qids[ctx[0]:ctx[1]]
        return pq_kernel.pq_lut_rows(b.qf, self.centroids, self.cb, self.cb_n,
                                     lists, qids)

    def scan(self, b, sel, ctx, luts, out=None):
        if ctx is None:
            lut_map = torch.where(self._live, b.qmat * b.p + b.rmat,
                                  -1).to(torch.int32)
        else:
            gm = self._gmap[sel]
            lut_map = torch.where(gm >= 0, gm - ctx[0], gm)
        return pq_kernel.pq_adc_lists(
            luts, lut_map, self._src, b.win_origin[sel], b.win_bounds[sel],
            b.l_pad, out=out)

    def scores(self, b, lblk, qids, pos):
        # per-(list, query-slot) ADC tables of the block: each slot's
        # query residual against THIS list's centroid, scored against
        # every codebook entry, residual-norm term included, so summed
        # entries are complete squared distances (the kernel form builds
        # the same rows for live pairs only)
        lb, qcap = qids.shape
        with annotate("ivf.lut"):
            lut = pq_kernel.pq_lut_rows(
                b.q_pad, self.centroids, self.cb, self.cb_n,
                lblk.repeat_interleave(qcap), qids.flatten(),
            ).float().reshape(lb, qcap, self.mk)
        # dist[b, q, l] = sum_m lut[b, q, m, codes] as a contraction of the
        # bf16 LUT with the one-hot codes, f32 accumulation
        codes = self.index.codes_sorted[pos].long()          # (LB, L, M)
        L, m = codes.shape[1:]
        onehot = torch.zeros((lb, L, m, self.mk // m), dtype=torch.float32,
                             device=codes.device)
        onehot.scatter_(3, codes[..., None], 1.0)
        return torch.bmm(lut, onehot.reshape(lb, L, self.mk).transpose(1, 2))

    def rows(self, pos):
        return _gather_refine_rows(self.index, self.refine_dataset, pos)

    def rerank_source(self):
        # the stored list-sorted rows; a caller's refine_dataset is by
        # original id, so its rows are gathered
        return self.index.vectors_sorted


@search_obs.entry("ivf_pq")
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

    ``use_kernel`` (:func:`~.grouped.resolve_kernel`): ``None`` runs the CUDA
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
    q = as_queries(queries, index.centroids)
    check_candidate_pool(k, n_probes, index.storage)
    errors.expects(
        0.0 < approx_recall_target <= 1.0,
        "approx_recall_target=%s out of range (0, 1]", approx_recall_target,
    )
    n_lists = index.centroids.shape[0]
    qcap, probes = resolve_qcap_arg(
        qcap, q, index.centroids, n_lists, n_probes,
        max_drop_frac=qcap_max_drop_frac, engine="ivf_pq",
    )
    list_block = max(1, min(list_block, n_lists))
    engine = PQEngine.of(index, use_kernel, qcap, refine_ratio,
                         refine_dataset)
    return grouped.search(engine, q, k, n_probes, qcap, list_block,
                          probes=probes, stream_partials=stream_partials)
