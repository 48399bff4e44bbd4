"""The two-level coarse probe of a :class:`~.common.CoarseIndex` on
both engines, and its recall audit. The kernel engine's member stage is
the grouped body (:func:`~.grouped.search`) over the member blocks as
lists; the legacy engine, the index and its build live in
:mod:`.common`, whose eager qcap probes run that engine."""

from __future__ import annotations

import logging

import torch

from raft_tpu_torch.core.device import as_tensor
from raft_tpu_torch.spatial.ann import flat_kernel, grouped, scan_core
from raft_tpu_torch.spatial.ann.common import (
    CoarseIndex,
    ListStorage,
    coarse_probe,
    default_qcap,
    map_query_blocks,
    n_super_probes,
    score_l2_candidates,
    two_level_probe_plain,
)
from raft_tpu_torch.spatial.ann.scan_core import BIG, SUBCHUNK
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = [
    "COARSE_ENGINE_FALLBACKS", "coarse_probe_recall", "two_level_probe",
    "two_level_probe_kernel_supported",
]

logger = logging.getLogger("raft_tpu_torch")

# two-level probes with use_kernel=True that the geometry sent to the
# legacy engine (two_level_probe_kernel_supported was False)
COARSE_ENGINE_FALLBACKS = 0
_coarse_fallbacks_warned: set = set()


def two_level_probe(qf, super_cents, member_ids, cents_padded,
                    n_cents: int, n_probes: int, n_sup_probes: int,
                    block_q: int = 256, precision=None,
                    use_kernel: bool = False):
    """Sub-linear coarse probe: score queries against the super
    centroids, take the top ``n_sup_probes`` super clusters' member
    blocks, and rerank only those candidate centroids in exact f32.
    Returns (probes (nq, p) int64, d2 (nq, p) f32 squared distances,
    best first; ties lowest id first) — a drop-in for
    :func:`~.common.coarse_probe` at a fraction of its FLOPs.

    Legacy engine (``use_kernel=False``, the default):
    :func:`~.common.two_level_probe_plain`. ``use_kernel=True``: both
    stages on the flat scan kernel (:func:`_two_level_probe_kernel`);
    equal probes to the legacy engine's whenever its shape-only qcap
    (:func:`_probe_qcap`) drops no (query, super) pair. Where
    :func:`two_level_probe_kernel_supported` rejects the geometry,
    ``use_kernel=True`` serves the legacy engine, counted in
    ``COARSE_ENGINE_FALLBACKS`` and warned about once. A pinned
    ``precision`` (any value but None) also selects the legacy engine,
    as in the JAX package; every product here is full f32 either way."""
    qf = as_tensor(qf, super_cents.device).float()
    ns, mm, d = cents_padded.shape
    S = max(1, min(int(n_sup_probes), ns))
    if use_kernel and precision is None:
        if two_level_probe_kernel_supported(d, qf.shape[0], n_probes, ns,
                                            mm, S, block_q):
            return _two_level_probe_kernel(
                qf, super_cents, member_ids, cents_padded, n_cents,
                n_probes, S, block_q)
        _note_coarse_fallback(
            f"d={d} nq={qf.shape[0]} n_probes={n_probes} n_super={ns} "
            f"max_members={mm} S={S} block_q={block_q}")
    return two_level_probe_plain(qf, super_cents, member_ids, cents_padded,
                                 n_cents, n_probes, S, block_q)


def _note_coarse_fallback(geometry: str) -> None:
    global COARSE_ENGINE_FALLBACKS
    COARSE_ENGINE_FALLBACKS += 1
    if geometry not in _coarse_fallbacks_warned:
        _coarse_fallbacks_warned.add(geometry)
        logger.warning(
            "two_level_probe(use_kernel=True) runs the legacy engine: the "
            "flat scan kernel does not fit the geometry %s", geometry)


def _probe_qcap(nq: int, n_sup_probes: int, n_super: int) -> int:
    """Queries per super of the kernel engine's grouped member stage: 4x
    the mean per-super occupancy (twice the grouped searches' default:
    the probe has no per-call audit), 8-aligned, at most nq. Slots fill
    in probe-rank order, so a super that still overflows drops each
    query's last-ranked supers first; audit a skewed workload with
    :func:`coarse_probe_recall` (``use_kernel=True``)."""
    return min(nq, 2 * default_qcap(nq, n_sup_probes, n_super))


def _stage_fits(d: int, q: int) -> bool:
    """The flat scan serves ``q`` query slots at width ``d`` and the JAX
    window rule has a plan there, as the JAX package's probe asks: stage
    1 pads the supers to that plan's tile, so its granules match."""
    return (flat_kernel.flat_scan_supported(d, q)
            and flat_kernel.plan_l_tile(
                d, scan_core.pad_queries(q),
                profile=scan_core.tile_profile(q)) is not None)


def two_level_probe_kernel_supported(d: int, nq: int, n_probes: int,
                                     n_super: int, max_members: int,
                                     n_sup_probes: int,
                                     block_q: int = 256) -> bool:
    """Whether the kernel engine of :func:`two_level_probe` applies: both
    stages' query counts fit the flat scan and the JAX window rule
    (:func:`_stage_fits`), and the member pool can fill a
    top-``n_probes`` row."""
    if d < 1 or n_super < 1 or max_members < 1:
        return False
    s1_block = min(block_q, max(nq, 1))
    return (
        n_probes <= n_sup_probes * max_members
        and _stage_fits(d, s1_block)
        and _stage_fits(d, _probe_qcap(nq, n_sup_probes, n_super))
    )


def _super_scan_kernel(qf, super_cents, S: int, block_q: int):
    """Stage 1 of the kernel engine: the top ``S`` supers of each query
    (nq, S) int64. One launch of the flat scan kernel
    (``flat_scan_subchunk_min``) over the whole batch gives each query's
    8-row minima over the supers (bf16 operands, f32 sums); the rows of
    its best ``min(width, 2S)`` granules are reranked in exact f32, in
    query blocks of at least ``block_q`` whose gather stays under
    ``RERANK_BLOCK_BYTES`` (a query's result does not depend on its
    block). The window tile follows the JAX rule at the ``block_q``
    block, so the granules match the blocked JAX stage."""
    nq, d = qf.shape
    ns = super_cents.shape[0]
    sub = SUBCHUNK
    sup_f = super_cents.float()
    s1_block = min(block_q, max(nq, 1))
    l_tile1 = flat_kernel.plan_l_tile(
        d, scan_core.pad_queries(s1_block),
        l_tile=scan_core.round_up(ns, scan_core.LANE),
        profile=scan_core.tile_profile(s1_block),
    )
    ns_pad = scan_core.round_up(ns, l_tile1)
    rows_bf16 = torch.nn.functional.pad(
        sup_f, (0, 0, 0, ns_pad - ns)).to(torch.bfloat16)
    bounds = torch.tensor([[0, ns]], dtype=torch.int32, device=qf.device)
    mins = flat_kernel.flat_scan_subchunk_min(
        qf.to(torch.bfloat16)[None], rows_bf16.T[None], bounds)[0]
    c1 = min(ns_pad // sub, 2 * S)

    def super_blk(args):
        qb, mb = args
        bq = qb.shape[0]
        nv, cpos = top_k_smallest(mb, c1)
        rows = (cpos[:, :, None] * sub
                + torch.arange(sub, device=qb.device)).reshape(bq, c1 * sub)
        live = (torch.isfinite(nv) & (nv < BIG))[:, :, None].expand(
            bq, c1, sub).reshape(bq, c1 * sub)
        cand = sup_f[torch.clamp(rows, max=ns - 1)]
        exact = score_l2_candidates(qb, cand, (rows < ns) & live)
        sv, spos = top_k_smallest(exact, S)
        return sv, torch.clamp(torch.gather(rows, 1, spos), max=ns - 1)

    blk = max(s1_block, grouped.RERANK_BLOCK_BYTES // (c1 * sub * d * 4))
    return map_query_blocks(super_blk, (qf, mins), blk)[1]


def _two_level_probe_kernel(qf, super_cents, member_ids, cents_padded,
                            n_cents: int, n_probes: int, S: int,
                            block_q: int):
    """The kernel engine of :func:`two_level_probe` (the caller checked
    :func:`two_level_probe_kernel_supported`). Stage 1:
    :func:`_super_scan_kernel`. Stage 2: the grouped search body over a
    :class:`~.grouped.FlatEngine` whose lists are the supers and whose
    rows are the padded member blocks (members first, so list s's rows
    are ``[s*mm, s*mm + size_s)``), with the supers of stage 1 as its
    probes: one ``flat_scan_lists`` launch, then the exact f32 rerank,
    whose distances are the ones returned."""
    nq = qf.shape[0]
    ns, mm, d = cents_padded.shape
    dev = qf.device
    i32 = torch.int32
    sup = _super_scan_kernel(qf, super_cents, S, block_q)
    storage = ListStorage(
        sorted_ids=member_ids.reshape(ns * mm).to(i32),
        list_offsets=torch.arange(ns + 1, dtype=i32, device=dev) * mm,
        # the grouped body reads only this tensor's leading axis
        list_index=torch.zeros((ns, 1), dtype=i32, device=dev),
        list_sizes=(member_ids < n_cents).sum(1).to(i32),
        n=ns * mm,
        max_list=mm,
    )
    # the member rows and the sentinel row the grouped body expects last
    rows = torch.nn.functional.pad(
        cents_padded.reshape(ns * mm, d).float(), (0, 0, 0, 1))
    engine = grouped.FlatEngine(super_cents.float(), storage, rows,
                                kernel=True, ratio=2.0)
    d2, probes = grouped.search(engine, qf, n_probes, S,
                                _probe_qcap(nq, S, ns), max(1, min(8, ns)),
                                probes=sup)
    # the legacy engine's clamp of a +inf slot's id
    return torch.where(torch.isfinite(d2), probes.long(), 0), d2


def coarse_probe_recall(queries, centroids, coarse: CoarseIndex,
                        n_probes: int, *, overprobe: float = 2.0,
                        block_q: int = 256,
                        use_kernel: bool = False) -> float:
    """The two-level probe's recall audit: the fraction of the flat
    scan's probed lists that the two-level probe (the kernel engine with
    ``use_kernel=True``) also probes on ``queries``. Workloads should
    stay within 0.01 of the flat probe; raise ``overprobe`` when they do
    not."""
    dev = coarse.super_cents.device
    qf = as_tensor(queries, dev).float()
    flat, _ = coarse_probe(qf, as_tensor(centroids, dev).float(), n_probes)
    S = n_super_probes(n_probes, coarse.n_super, overprobe)
    two, _ = two_level_probe(
        qf, coarse.super_cents, coarse.member_ids, coarse.cents_padded,
        coarse.n_cents, n_probes, S, block_q, use_kernel=use_kernel,
    )
    a, b = flat.cpu().numpy(), two.cpu().numpy()
    hits = sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a, b))
    return hits / a.size
