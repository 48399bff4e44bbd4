// IVF-SQ int8 dequant + sub-chunk-min scan for Hopper (sm_90a).
//
// Replaces the TPU kernel sq_scan_subchunk_min
// (raft_tpu/spatial/ann/sq_kernel.py:114), which runs through the shared
// Pallas scan scan_core.subchunk_scan (raft_tpu/spatial/ann/scan_core.py:211).
//
// Computes, for every list b, query q and 8-row sub-chunk j of the code slab,
//   out[b, q, j] = min over r in 8j..8j+7 of (|q|^2 + |y_r|^2) - 2 q.y_r
// where y_r is row r dequantized: y = bf16((code + 128) * vscale + vmin), the
// affine map in f32 with each operation rounded on its own, then rounded
// once to bf16 (sq_kernel._dequant_tile of both packages). Operands bf16,
// products, norms and sums f32; rows outside [lo, hi) score BIG.
//
// The kernel is the flat scan's scan_core::l2_scan_kernel (scan_core.cuh)
// with the int8 tile loader: the slab tile crosses device memory at one byte
// per element and is dequantized as it is staged into shared memory, where
// the per-feature vmin and vscale stay resident for the whole block. No bf16
// or f32 copy of the index is ever made.
//
// What bounds it on the H100: at the path's shapes (Q <= 64, d = 96, Lpad =
// 512) the bytes it must move are about half the flat scan's, so its memory
// bound halves; like the flat scan this first version runs the products on
// the CUDA cores in f32 from shared memory, which sets its time well above
// that bound. The dequant is 3 f32 operations and a bf16 rounding per staged
// element, once per (row tile, query tile) pair. wgmma and TMA are left for a
// later version.
//
// Layout: the code slab is read through its strides (b, d, l), so the caller
// passes a gathered row-major (LB, Lpad, d) int8 slab as a transposed view.

#include "scan_core.cuh"

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// qrows (lb, nq, d) bf16 contiguous; codes (lb, d, lpad) int8 with element
// strides (sb, sd, sl); params (2, d) f32 contiguous, vmin then vscale;
// bounds (lb, 2) int32 contiguous; out (lb, nq, lpad/8) f32 contiguous.
// lpad must be a multiple of 8.
int raft_sq_scan_subchunk_min(const void* qrows, const void* codes,
                              const void* params, const void* bounds,
                              void* out, int lb, int nq, int d, int lpad,
                              long long sb, long long sd, long long sl,
                              void* stream) {
  return scan_core::launch_l2_scan<scan_core::Int8DequantRows>(
      qrows, codes, params, bounds, out, lb, nq, d, lpad, sb, sd, sl, stream);
}

// Dynamic shared memory one block needs at feature width d.
long long raft_sq_scan_smem_bytes(int d) {
  return (long long)scan_core::l2_smem_bytes(
      d, scan_core::Int8DequantRows::kParams);
}

const char* raft_sq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
