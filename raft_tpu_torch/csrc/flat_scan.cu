// Flat sub-chunk-min scan for Hopper (sm_90a).
//
// Replaces the TPU kernel flat_scan_subchunk_min
// (raft_tpu/spatial/ann/flat_kernel.py:115), which runs through the shared
// Pallas scan scan_core.subchunk_scan (raft_tpu/spatial/ann/scan_core.py:211).
//
// Computes, for every list b, query q and 8-row sub-chunk j of the slab,
//   out[b, q, j] = min over r in 8j..8j+7 of (|q|^2 + |y_r|^2) - 2 q.y_r
// with bf16 operands, f32 products and sums, and rows outside the list's
// [lo, hi) range scoring BIG. Only the (LB, Q, Lpad/8) minima are written:
// the distance tile never reaches device memory. The kernel is
// scan_core::l2_scan_kernel (scan_core.cuh) with the bf16 row loader; its
// arithmetic note is there.
//
// What bounds it on the H100: at the main path's shapes (Q = 64 queries per
// list, d = 96) the scan does about 54 FLOP per byte it must move, far
// under the ~295 FLOP/byte ridge of the bf16 tensor cores, so the least
// time is set by device memory. This first version computes on the CUDA
// cores in f32 instead of the tensor cores, which makes the f32 FMA rate
// (67 TFLOP/s) and shared-memory bandwidth its practical limit. What the
// design does about the bytes: each block stages its query rows and a
// 64-row slab tile in shared memory once, computes every norm once per
// row, and keeps the 8 x 2 partial dots of a thread in registers, so each
// input byte crosses device memory once per (row tile, query tile) pair and
// the output is 8x smaller than the distance tile. wgmma and TMA are left
// for a later version.
//
// Layout: the slab is read through its strides (b, d, l), so the caller can
// pass a gathered row-major (LB, Lpad, d) slab as a transposed view without
// a copy. Queries are a contiguous (LB, Q, d) array with any Q.

#include "scan_core.cuh"

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// qrows (lb, nq, d) bf16 contiguous; slabs (lb, d, lpad) bf16 with element
// strides (sb, sd, sl); bounds (lb, 2) int32 contiguous; out (lb, nq,
// lpad/8) f32 contiguous. lpad must be a multiple of 8.
int raft_flat_scan_subchunk_min(const void* qrows, const void* slabs,
                                const void* bounds, void* out, int lb, int nq,
                                int d, int lpad, long long sb, long long sd,
                                long long sl, void* stream) {
  return scan_core::launch_l2_scan<scan_core::Bf16Rows>(
      qrows, slabs, nullptr, bounds, out, lb, nq, d, lpad, sb, sd, sl,
      stream);
}

// Dynamic shared memory one block needs at feature width d.
long long raft_flat_scan_smem_bytes(int d) {
  return (long long)scan_core::l2_smem_bytes(d, scan_core::Bf16Rows::kParams);
}

const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
