"""IVF-SQ (8-bit scalar quantization) — the port of
``raft_tpu/spatial/ann/ivf_sq.py``.

Rows are mapped to int8 per dimension by a global min/max affine map
(the QT_8bit scheme); lists and search reuse the IVF-Flat machinery with
the dequantization fused into the scan. The grouped search is the one
grouped body (:func:`.grouped.search`) over :class:`SQEngine`: its
kernel form scans the int8 codes in place, one launch per batch, with
the hand-written CUDA dequant + sub-chunk-min scan (:mod:`.sq_kernel`;
codes cross device memory at one byte per element), its legacy form
decodes the sliced rows to f32 first, and both rescore or score the rows
they keep against f32-decoded values.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Tuple

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.spatial.ann import grouped, sq_kernel
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

__all__ = [
    "IVFSQParams", "IVFSQIndex", "SQEngine", "ivf_sq_build",
    "ivf_sq_search", "ivf_sq_search_grouped", "sq_decode", "sq_encode",
]


def _per_dim(v, ndim: int):
    return torch.as_tensor(v, dtype=torch.float32).reshape(
        (1,) * (ndim - 1) + (-1,))


def sq_encode(x, vmin, vscale):
    """THE QT_8bit affine encoder — ``clip(round((x − vmin) / vscale) −
    128, −128, 127)`` as int8, per dimension over the last axis.
    ``torch.round`` rounds half to even, as ``jnp.round`` does, and the
    division stays a division. Inverse: :func:`sq_decode`."""
    x = torch.as_tensor(x)
    vmin = _per_dim(vmin, x.dim()).to(x.device)
    vscale = _per_dim(vscale, x.dim()).to(x.device)
    return torch.clamp(
        torch.round((x.float() - vmin) / vscale) - 128, -128, 127,
    ).to(torch.int8)


def sq_decode(codes_f32, vmin, vscale):
    """THE QT_8bit affine decoder — ``y = (code + 128) · vscale + vmin``
    in f32, per dimension over the last axis (the multiply and the add
    rounded each on its own). ``codes_f32``: codes already widened to
    f32. The kernel's column spelling, with its one bf16 rounding, is
    ``sq_kernel._dequant_tile``."""
    nd = codes_f32.dim()
    return ((codes_f32 + 128.0) * _per_dim(vscale, nd).to(codes_f32.device)
            + _per_dim(vmin, nd).to(codes_f32.device))


@dataclasses.dataclass(frozen=True)
class IVFSQParams:
    n_lists: int = 64
    kmeans_n_iters: int = 20
    seed: int = 0
    # see IVFFlatParams.max_list_cap (common.split_oversized_lists)
    max_list_cap: typing.Optional[int] = None


@dataclasses.dataclass
class IVFSQIndex:
    centroids: torch.Tensor      # (n_lists, d)
    codes_sorted: torch.Tensor   # (n + 1, d) int8 — last row the sentinel
    vmin: torch.Tensor           # (d,) f32
    vscale: torch.Tensor         # (d,) f32
    storage: ListStorage
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
               qcap=None, list_block: int = 32, stream_partials=None,
               use_kernel: typing.Optional[bool] = None,
               rerank_ratio: float = 4.0) -> int:
        """Run one all-zeros (nq, d) batch through
        :func:`ivf_sq_search_grouped` (building the CUDA kernels and
        initialising the device libraries on first use) and return the
        shape-only qcap (:func:`~.common.static_qcap`) to pass on every
        serving dispatch of this batch size. The JAX package's
        ``audit=`` option (its jaxpr program auditor) has no counterpart
        in the port and is not offered."""
        qc = static_qcap(qcap, nq, n_probes, self.centroids.shape[0])
        q0 = torch.zeros((nq, self.centroids.shape[1]), dtype=torch.float32,
                         device=self.device)
        ivf_sq_search_grouped(
            self, q0, k, n_probes=n_probes, qcap=qc,
            list_block=list_block, stream_partials=stream_partials,
            use_kernel=use_kernel, rerank_ratio=rerank_ratio,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return qc


def ivf_sq_build(x, params: IVFSQParams = IVFSQParams(), *,
                 device=None) -> IVFSQIndex:
    """Build: k-means (k-means++ init, bf16-operand centroid updates),
    the per-dimension affine map from the data's min and max, the int8
    encode and the list permutation. ``device`` defaults to CUDA and
    raises when no CUDA device is present."""
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
            # quantizer training tolerates bf16-rounded centroid updates
            compute_dtype="bfloat16",
        ),
    )
    vmin = torch.amin(x, dim=0).float()
    vmax = torch.amax(x, dim=0).float()
    vscale = torch.clamp_min(vmax - vmin, 1e-12) / 255.0
    codes = sq_encode(x, vmin, vscale)
    labels_np, cents = out.labels.cpu().numpy(), out.centroids
    if params.max_list_cap:
        labels_np, cents = split_oversized_lists(
            labels_np, cents, params.max_list_cap
        )
    storage = build_list_storage(labels_np, cents.shape[0], dev)
    codes_sorted = torch.cat([
        codes[storage.sorted_ids.long()],
        torch.zeros((1, x.shape[1]), dtype=torch.int8, device=dev),
    ])
    return IVFSQIndex(cents, codes_sorted, vmin, vscale, storage)


class SQEngine(grouped.FlatEngine):
    """int8 QT_8bit codes (n + 1, d), the sentinel last, with their
    per-dimension pair ``vmin`` / ``vscale``: the kernel form reads the
    codes in place (:func:`~.sq_kernel.sq_scan_lists`), the legacy form
    and the rescore decode the rows they touch to f32
    (:func:`sq_decode`)."""

    name, label = "ivf_sq", "IVF-SQ"
    kmod = sq_kernel

    def __init__(self, centroids, storage, codes, vmin, vscale,
                 kernel: bool = False, ratio: float = 4.0, slab=None):
        super().__init__(centroids, storage, codes, kernel, ratio, slab)
        self.vmin, self.vscale = vmin.float(), vscale.float()

    @classmethod
    def of(cls, index, use_kernel, qcap: int, ratio: float = 4.0):
        """The engine of an :class:`IVFSQIndex`, its form by the rule."""
        kernel = grouped.resolve_kernel(use_kernel, cls, index.device,
                                        index.centroids.shape[1], qcap)
        return cls(index.centroids, index.storage, index.codes_sorted,
                   index.vmin, index.vscale, kernel, ratio, index.code_rows)

    @staticmethod
    def fits(d: int, qcap: int):
        return (
            sq_kernel.sq_scan_supported(d, qcap),
            f"d={d} qcap={qcap} does not fit the SQ kernel's shared-memory "
            "tiles",
            f"use_kernel=True unsupported at d={d} qcap={qcap}: "
            "sq_kernel.sq_scan_supported is False — the kernel's "
            "shared-memory tiles (the query tile, the dequantized slab "
            "tile, vmin and vscale) do not fit a block, or the window rule "
            "(sq_kernel.plan_l_tile) returned None even at the 128-row "
            "floor; use the legacy decode scan (use_kernel=False)",
        )

    def scan(self, b, sel, ctx, luts, out=None):
        # int8 zero pad rows decode to 128·vscale + vmin and lie outside
        # every list's [lo, hi)
        return sq_kernel.sq_scan_lists(
            self._q, b.qmat[sel], self._src, b.win_origin[sel],
            b.win_bounds[sel], b.l_pad, self.vmin, self.vscale)

    def rows(self, pos):
        return sq_decode(self.data[pos].float(), self.vmin, self.vscale)

    def rerank_source(self):
        # int8 codes, decoded a row at a time: the rows are gathered
        return None


def ivf_sq_search_grouped(
    index: IVFSQIndex, queries, k: int, *, n_probes: int = 8,
    qcap: typing.Union[int, str, None] = None, list_block: int = 32,
    stream_partials: typing.Optional[bool] = None,
    qcap_max_drop_frac: typing.Optional[float] = None,
    use_kernel: typing.Optional[bool] = None,
    rerank_ratio: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Throughput-mode (list-major) IVF-SQ search — the one grouped body
    over :class:`SQEngine`. Returns (squared L2 distances
    over the dequantized rows, row ids): the per-query
    :func:`ivf_sq_search` semantics at the grouped engine's throughput.

    ``use_kernel`` (:func:`~.grouped.resolve_kernel`): ``None`` runs the CUDA
    int8 dequant + sub-chunk-min kernel on a Hopper card when it fits —
    int8 slab tiles cross device memory at one byte per element, and the
    top ``ceil(rerank_ratio*k)`` sub-chunks' rows are rescored against
    f32-decoded values, so returned distances are the legacy engine's;
    ``False`` pins the legacy decode scan; ``True`` asks for the kernel
    path and raises naming the unmet requirement. ``qcap``,
    ``stream_partials`` and ``rerank_ratio`` are as in
    :func:`~.ivf_flat.ivf_flat_search_grouped`."""
    q = as_queries(queries, index.centroids)
    storage = index.storage
    if k > storage.max_list:
        # a single list cannot fill a per-list top-k row
        errors.expects(
            not use_kernel,
            "use_kernel=True: k=%d > max_list=%d routes to the per-query "
            "SQ search, which has no kernel path; lower k or rebuild with "
            "fewer lists", k, storage.max_list,
        )
        return ivf_sq_search(index, q, k, n_probes=n_probes)
    check_candidate_pool(k, n_probes, storage)
    n_lists = storage.list_index.shape[0]
    qcap, probes = resolve_qcap_arg(
        qcap, q, index.centroids, n_lists, n_probes,
        max_drop_frac=qcap_max_drop_frac,
    )
    list_block = max(1, min(list_block, n_lists))
    return grouped.search(SQEngine.of(index, use_kernel, qcap, rerank_ratio),
                          q, k, n_probes, qcap, list_block, probes=probes,
                          stream_partials=stream_partials)


def ivf_sq_search(
    index: IVFSQIndex, queries, k: int, *, n_probes: int = 8,
    block_q: int = 512, use_kernel: typing.Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query IVF-SQ search: the probed candidates are gathered,
    decoded and scored in exact f32. The kernel scans whole list slabs,
    which only the grouped search forms, so ``use_kernel=True`` raises
    here, pointing at :func:`ivf_sq_search_grouped`."""
    errors.expects(
        not use_kernel,
        "use_kernel=True: the per-query SQ search has no kernel path — "
        "the int8 dequant + scan kernel (spatial/ann/sq_kernel) scans "
        "whole list slabs, which only the list-major grouped search "
        "forms; use ivf_sq_search_grouped(use_kernel=True)",
    )
    q = as_queries(queries, index.centroids)
    check_candidate_pool(k, n_probes, index.storage)
    storage = index.storage

    def one_block(qb):
        qf = qb.float()
        probes, _ = coarse_probe(qf, index.centroids, n_probes)
        cand_pos = storage.list_index[probes].reshape(qb.shape[0], -1)
        codes = index.codes_sorted[cand_pos.long()].float()
        cand = sq_decode(codes, index.vmin, index.vscale)
        d2 = score_l2_candidates(qf, cand, cand_pos < storage.n)
        return select_candidates(storage, cand_pos, d2, k)

    return map_query_blocks(one_block, q, block_q)
