"""The exact rerank of the IVF kernel engines, R: every candidate's f32
row scored in place, over the whole batch, by one launch of
``raft_tpu_torch/csrc/rerank.cu`` (its source note says what bounds it
and what the design does about that).

:func:`rescore_rows_kernel` takes the (nq, d) f32 queries, an engine's
(n + 1, d) f32 rows (the sentinel last,
:meth:`~.grouped.Engine.rerank_source`) and the (nq, C) slab positions
and mask of the pool's rows (:func:`~.common.subchunk_pool_rows`), and
returns the (nq, C) squared distances of its plain version
:func:`rescore_rows_plain`: the rows gathered and scored by
:func:`~.common.score_l2_candidates`, +inf where not valid.
Integer-valued rows give its bits; others lie within the f32 summation
bound of it.

:func:`rerank_kernel_fits` is the route rule: a capability-9.0 CUDA
device, f32 queries and rows, contiguous rows, and ``1 <= d <=
RERANK_MAX_D`` (read from the kernel's source). A grouped search whose
engine gives no source, or whose source the rule refuses (every CPU
search), gathers in query blocks as before (``grouped._rerank``); the
counter ``ivf_rerank_calls_total{engine,route}``
(:func:`.search_obs.rerank`) counts each rerank by the route it took, and
:data:`RERANK_LAUNCHES` the kernel's launches. The JAX package reranks in
``jnp``, so R, like the selection and LUT kernels, has no TPU kernel.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import hopper_device
from raft_tpu_torch.spatial.ann.common import score_l2_candidates

__all__ = ["RERANK_LAUNCHES", "RERANK_MAX_D", "rerank_kernel_fits",
           "rescore_rows_kernel", "rescore_rows_plain"]

RERANK_MAX_D = int(re.search(
    r"constexpr int kMaxD = (\d+);",
    (Path(__file__).resolve().parents[2] / "csrc" / "rerank.cu").read_text(),
).group(1))
# kernel launches since import (or since a caller reset it to 0)
RERANK_LAUNCHES = 0


def rerank_kernel_fits(qf, src) -> bool:
    """Does the rerank of ``qf``'s candidates over the rows ``src`` (an
    engine's source, or None) take the kernel? ``src`` on a
    capability-9.0 CUDA device, both float32, ``src`` a contiguous (rows,
    d) matrix with ``1 <= d <= RERANK_MAX_D``."""
    if src is None or src.device.type != "cuda":
        return False
    if src.dtype != torch.float32 or qf.dtype != torch.float32:
        return False
    if src.dim() != 2 or not src.is_contiguous():
        return False
    return 1 <= src.shape[1] <= RERANK_MAX_D and hopper_device(src.device)


def _check(qf, src, rpos, valid):
    errors.expects(
        qf.dim() == 2 and src.dim() == 2 and qf.shape[1] == src.shape[1],
        "rescore_rows: queries %s and rows %s need one width",
        tuple(qf.shape), tuple(src.shape))
    errors.expects(
        rpos.shape == valid.shape and rpos.dim() == 2
        and rpos.shape[0] == qf.shape[0],
        "rescore_rows: positions %s and mask %s need (nq=%d, C)",
        tuple(rpos.shape), tuple(valid.shape), qf.shape[0])
    errors.expects(src.shape[0] >= 1, "rescore_rows: no sentinel row")


def rescore_rows_plain(qf, src, rpos, valid):
    """Plain version of :func:`rescore_rows_kernel`: the rows gathered
    (the sentinel's where a position lies outside [0, n]) and scored by
    :func:`~.common.score_l2_candidates`."""
    _check(qf, src, rpos, valid)
    n = src.shape[0] - 1
    rp = rpos.long()
    cand = src[torch.clamp(rp, 0, n)].float()
    return score_l2_candidates(qf.float(), cand,
                               valid & (rp >= 0) & (rp < n))


def rescore_rows_kernel(qf, src, rpos, valid):
    """(nq, C) f32 squared distances of the (nq, d) queries ``qf`` to the
    (n + 1, d) rows ``src`` (the sentinel last) at the (nq, C) positions
    ``rpos``, +inf where the bool ``valid`` is False or a position lies
    outside [0, n), by one launch of R; counts it in
    :data:`RERANK_LAUNCHES`. Raises where :func:`rerank_kernel_fits`
    does not hold."""
    _check(qf, src, rpos, valid)
    errors.expects(
        rerank_kernel_fits(qf, src),
        "rescore_rows: the kernel needs f32 queries and contiguous f32 "
        "rows of 1 to %d features on a capability-9.0 CUDA device; got "
        "%s queries, %s rows %s on %s", RERANK_MAX_D, qf.dtype, src.dtype,
        tuple(src.shape), src.device)
    dev = src.device
    nq, c = rpos.shape
    qc = qf.to(dev).contiguous()
    rp = rpos.to(device=dev, dtype=torch.int64).contiguous()
    ok = valid.to(device=dev, dtype=torch.bool).contiguous()
    out = torch.empty((nq, c), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.raft_rerank(
            qc.data_ptr(), src.data_ptr(), rp.data_ptr(), ok.data_ptr(),
            out.data_ptr(), nq, c, src.shape[0] - 1, src.shape[1],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"rescore_rows: kernel launch failed: CUDA error {err} "
            f"({lib.raft_rerank_error_string(err).decode()})")
    global RERANK_LAUNCHES
    RERANK_LAUNCHES += 1
    return out


@functools.cache
def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("rerank")
    fn = lib.raft_rerank
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, ctypes.c_longlong, i, p]
        fn.restype = i
        lib.raft_rerank_error_string.argtypes = [i]
        lib.raft_rerank_error_string.restype = ctypes.c_char_p
    return lib
