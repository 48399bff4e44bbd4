"""Dense linear algebra of the port — the counterpart of ``raft_tpu/linalg``
(analog of raft/linalg, reference L3): elementwise ops, reductions,
GEMM / GEMV, matrix-vector broadcasts, the dense decompositions through
``torch.linalg`` and the thick-restart Lanczos solver. Every product
runs full f32 with TF32 off (``core.device.full_f32``)."""

from raft_tpu_torch.linalg.elementwise import (
    unary_op,
    binary_op,
    ternary_op,
    map_op,
    map_then_reduce,
    add,
    add_scalar,
    subtract,
    subtract_scalar,
    multiply_scalar,
    divide_scalar,
    eltwise_multiply,
    eltwise_divide,
    scalar_multiply,
    power,
    sqrt,
    reciprocal,
    sign_flip,
    axpy,
    dot,
)
from raft_tpu_torch.linalg.reduction import (
    reduce,
    coalesced_reduction,
    strided_reduction,
    norm,
    row_norm,
    col_norm,
    L1Norm,
    L2Norm,
    LinfNorm,
    reduce_rows_by_key,
    reduce_cols_by_key,
    mean_squared_error,
    binary_div_skip_zero,
)
from raft_tpu_torch.linalg.gemm import gemm, gemv, transpose
from raft_tpu_torch.linalg.matrix_vector import (
    matrix_vector_op, matrix_vector_add, matrix_vector_mul,
)
from raft_tpu_torch.linalg.decomp import (
    eig_dc,
    eig_jacobi,
    eig_sel_dc,
    qr_get_q,
    qr_get_qr,
    svd_qr,
    svd_eig,
    svd_jacobi,
    svd_reconstruction,
    rsvd_fixed_rank,
    rsvd_perc,
    lstsq_svd_qr,
    lstsq_svd_jacobi,
    lstsq_eig,
    lstsq_qr,
    cholesky_rank1_update,
)
from raft_tpu_torch.linalg.lanczos import (
    lanczos_smallest_eigenvectors,
    lanczos_largest_eigenvectors,
)

__all__ = [k for k in dir() if not k.startswith("_")]
