// Shared core of the port's sub-chunk scan kernels for Hopper (sm_90a).
//
// The counterpart of the shared Pallas scan scan_core.subchunk_scan
// (raft_tpu/spatial/ann/scan_core.py:211, pallas_call at :275). What every
// scan shares lives here once:
//
//   * the grid: one block per (row tile, query tile, list), blockIdx.(x, y, z);
//   * the [lo, hi) mask: rows outside a list's valid range score kBig;
//   * the epilogue: the min of every 8-row sub-chunk is the only output, an
//     (LB, Q, Lpad/8) f32 array; the distance tile never reaches device memory;
//   * the launch-limit checks of that grid.
//
// The L2 scan of IVF-SQ is a templated kernel, l2_scan_kernel<Rows>, with a
// tile-loader policy Rows that says how a slab element becomes the f32 value
// of a bf16 operand: Int8DequantRows reads an int8 code and dequantizes it as
// it is staged into shared memory (sq_scan.cu). The flat scan (flat_scan.cu,
// on the tensor cores) and the ADC scan of IVF-PQ (pq_scan.cu) read list
// rows in place with their own bodies and use the constants and the
// sub-chunk min.
//
// Arithmetic of the L2 scan (scan_core.l2_gram_tile of the port): norms are
// f32 sums of the bf16-rounded squares, the dot is bf16 x bf16 accumulated in
// f32, both summed over the feature axis in ascending order (each product of
// two bf16 values is exact in f32, so a fused multiply-add rounds exactly as
// a multiply then an add would), and the formula order is (qn + yn) - 2 * dot.
// The plain PyTorch version sums in the same order, so the two agree bitwise
// on any input.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_core {

constexpr int kSub = 8;                 // rows per sub-chunk
constexpr float kBig = 1e30f;           // score of a masked row (finite)
constexpr int kMaxGridYZ = 65535;       // launch limit of gridDim.y and .z

// Min over one sub-chunk whose first row is lc; rows outside [lo, hi) kBig.
__device__ __forceinline__ float masked_subchunk_min(const float (&v)[kSub],
                                                     int lc, int lo, int hi) {
  float m = kBig;
  bool first = true;
#pragma unroll
  for (int r = 0; r < kSub; ++r) {
    const int l = lc + r;
    const float s = (l >= lo && l < hi) ? v[r] : kBig;
    m = first ? s : fminf(m, s);
    first = false;
  }
  return m;
}

// The (row tiles, query tiles, lists) grid of a scan over lb lists of lpad
// rows, or cudaErrorInvalidConfiguration past the launch limits.
inline cudaError_t scan_grid(int lb, int nq, int lpad, int row_tile,
                             int q_tile, dim3* grid) {
  const int q_tiles = (nq + q_tile - 1) / q_tile;
  if (lb > kMaxGridYZ || q_tiles > kMaxGridYZ) {
    return cudaErrorInvalidConfiguration;
  }
  *grid = dim3((lpad + row_tile - 1) / row_tile, q_tiles, lb);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The L2 scan: out[b, q, j] = min over r in 8j..8j+7 of (|q|^2 + |y_r|^2)
// - 2 q.y_r, bf16 operands, f32 products and sums.
// ---------------------------------------------------------------------------

constexpr int kRowTile = 64;                  // slab rows per block (8 sub-chunks)
constexpr int kQLanes = 32;                   // query lanes per block
constexpr int kQPerThread = 2;                // queries per thread
constexpr int kQTile = kQLanes * kQPerThread; // query rows per block
constexpr int kL2Threads = kQLanes * (kRowTile / kSub);
constexpr int kRowStride = kRowTile + 4;      // shared slab row stride (16-byte aligned)

// Tile loader of int8 codes (IVF-SQ): y = (code + 128) * vscale + vmin in
// f32, each operation rounded on its own (no contraction into an FMA, as the
// plain version rounds them), then rounded once to bf16. prm holds vmin[d]
// then vscale[d] in shared memory.
struct Int8DequantRows {
  using T = int8_t;
  static constexpr int kParams = 2;
  __device__ static float load(T v, const float* prm, int c, int d) {
    const float y = __fadd_rn(
        __fmul_rn(__fadd_rn(static_cast<float>(v), 128.f), prm[d + c]),
        prm[c]);
    return __bfloat162float(__float2bfloat16_rn(y));
  }
};

__host__ __device__ inline size_t l2_smem_bytes(int d, int n_params) {
  // query tile (kQTile x (d + 1)), transposed slab tile (d x kRowStride),
  // query norms, row norms, per-feature parameters
  return sizeof(float) * ((size_t)kQTile * (d + 1) + (size_t)d * kRowStride +
                          kQTile + kRowTile + (size_t)n_params * d);
}

template <class Rows>
__global__ void __launch_bounds__(kL2Threads)
l2_scan_kernel(const __nv_bfloat16* __restrict__ qrows,
               const typename Rows::T* __restrict__ slabs,
               const float* __restrict__ params,
               const int32_t* __restrict__ bounds, float* __restrict__ out,
               int nq, int d, int lpad, long long sb, long long sd,
               long long sl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qstride = d + 1;                  // odd stride: no bank conflicts
  float* sq = smem;                           // [kQTile][d + 1]
  float* sy = sq + (size_t)kQTile * qstride;  // [d][kRowStride]
  float* sqn = sy + (size_t)d * kRowStride;   // [kQTile]
  float* syn = sqn + kQTile;                  // [kRowTile]
  float* sprm = syn + kRowTile;               // [Rows::kParams * d]

  const int b = blockIdx.z;
  const int q0 = blockIdx.y * kQTile;
  const int l0 = blockIdx.x * kRowTile;
  const int t = threadIdx.x;
  const int lo = bounds[2 * b];
  const int hi = bounds[2 * b + 1];
  const __nv_bfloat16* qb = qrows + (long long)b * nq * d;
  const typename Rows::T* yb = slabs + (long long)b * sb;

  if constexpr (Rows::kParams > 0) {
    for (int i = t; i < Rows::kParams * d; i += kL2Threads) sprm[i] = params[i];
    __syncthreads();
  }
  for (int i = t; i < kQTile * d; i += kL2Threads) {
    const int r = i / d, c = i - r * d;
    const int qq = q0 + r;
    sq[r * qstride + c] =
        qq < nq ? __bfloat162float(qb[(long long)qq * d + c]) : 0.f;
  }
  for (int i = t; i < kRowTile * d; i += kL2Threads) {
    const int r = i / d, c = i - r * d;  // c fastest: coalesced when sd == 1
    const int l = l0 + r;
    sy[c * kRowStride + r] =
        l < lpad ? Rows::load(yb[c * sd + (long long)l * sl], sprm, c, d) : 0.f;
  }
  __syncthreads();

  if (t < kQTile) {
    float s = 0.f;
    for (int c = 0; c < d; ++c) {
      const float v = sq[t * qstride + c];
      s += v * v;
    }
    sqn[t] = s;
  } else if (t < kQTile + kRowTile) {
    const int r = t - kQTile;
    float s = 0.f;
    for (int c = 0; c < d; ++c) {
      const float v = sy[c * kRowStride + r];
      s += v * v;
    }
    syn[r] = s;
  }

  const int j = t % kSub;      // sub-chunk of the tile this thread owns
  const int ql = t / kSub;     // query lane: queries ql and ql + kQLanes
  float acc[kQPerThread][kSub];
#pragma unroll
  for (int a = 0; a < kQPerThread; ++a)
#pragma unroll
    for (int r = 0; r < kSub; ++r) acc[a][r] = 0.f;

  for (int c = 0; c < d; ++c) {
    const float4 ya = *reinterpret_cast<const float4*>(&sy[c * kRowStride + j * kSub]);
    const float4 yc = *reinterpret_cast<const float4*>(&sy[c * kRowStride + j * kSub + 4]);
#pragma unroll
    for (int a = 0; a < kQPerThread; ++a) {
      const float qv = sq[(ql + a * kQLanes) * qstride + c];
      acc[a][0] += qv * ya.x;
      acc[a][1] += qv * ya.y;
      acc[a][2] += qv * ya.z;
      acc[a][3] += qv * ya.w;
      acc[a][4] += qv * yc.x;
      acc[a][5] += qv * yc.y;
      acc[a][6] += qv * yc.z;
      acc[a][7] += qv * yc.w;
    }
  }
  __syncthreads();  // norms written above are read below

  const int lc = l0 + j * kSub;
  if (lc >= lpad) return;
  const int nsc = lpad / kSub;
#pragma unroll
  for (int a = 0; a < kQPerThread; ++a) {
    const int qq = q0 + ql + a * kQLanes;
    if (qq >= nq) continue;
    const float qn = sqn[ql + a * kQLanes];
    float v[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      v[r] = (qn + syn[j * kSub + r]) - 2.f * acc[a][r];
    }
    out[((long long)b * nq + qq) * nsc + lc / kSub] =
        masked_subchunk_min(v, lc, lo, hi);
  }
}

// Launch l2_scan_kernel<Rows> on `stream`; returns cudaGetLastError() after
// the launch (0 = ok). qrows (lb, nq, d) bf16 contiguous; slabs (lb, d, lpad)
// of Rows::T with element strides (sb, sd, sl); params Rows::kParams * d f32
// (may be null when kParams is 0); bounds (lb, 2) int32 contiguous; out
// (lb, nq, lpad/8) f32 contiguous. lpad must be a multiple of 8.
template <class Rows>
int launch_l2_scan(const void* qrows, const void* slabs, const void* params,
                   const void* bounds, void* out, int lb, int nq, int d,
                   int lpad, long long sb, long long sd, long long sl,
                   void* stream) {
  if (lb < 1 || nq < 1 || d < 1 || lpad < kSub || lpad % kSub) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid;
  cudaError_t err = scan_grid(lb, nq, lpad, kRowTile, kQTile, &grid);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = l2_smem_bytes(d, Rows::kParams);
  err = cudaFuncSetAttribute(l2_scan_kernel<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2_scan_kernel<Rows><<<grid, kL2Threads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qrows),
      static_cast<const typename Rows::T*>(slabs),
      static_cast<const float*>(params), static_cast<const int32_t*>(bounds),
      static_cast<float*>(out), nq, d, lpad, sb, sd, sl);
  return (int)cudaGetLastError();
}

}  // namespace scan_core
