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
// the distance tile never reaches device memory.
//
// Arithmetic follows scan_core.l2_gram_tile: the norms are f32 sums of the
// bf16-rounded squares, the dot is bf16 x bf16 accumulated in f32 (each
// product of two bf16 values is exact in f32, so a fused multiply-add
// rounds exactly as a multiply then add would), and the formula order is
// (qn + yn) - 2 * dot. On integer-exact inputs every sum is exact and the
// result is bitwise that of the plain PyTorch version.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 8;                       // rows per sub-chunk
constexpr int kRowTile = 64;                  // slab rows per block (8 sub-chunks)
constexpr int kQLanes = 32;                   // query lanes per block
constexpr int kQPerThread = 2;                // queries per thread
constexpr int kQTile = kQLanes * kQPerThread; // query rows per block
constexpr int kThreads = kQLanes * (kRowTile / kSub);
constexpr int kRowStride = kRowTile + 4;      // shared slab row stride (16-byte aligned)
constexpr float kBig = 1e30f;

__host__ __device__ inline size_t smem_bytes(int d) {
  // query tile (kQTile x (d + 1)), transposed slab tile (d x kRowStride),
  // query norms, row norms
  return sizeof(float) *
         ((size_t)kQTile * (d + 1) + (size_t)d * kRowStride + kQTile + kRowTile);
}

__global__ void __launch_bounds__(kThreads)
flat_scan_kernel(const __nv_bfloat16* __restrict__ qrows,
                 const __nv_bfloat16* __restrict__ slabs,
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

  const int b = blockIdx.z;
  const int q0 = blockIdx.y * kQTile;
  const int l0 = blockIdx.x * kRowTile;
  const int t = threadIdx.x;
  const int lo = bounds[2 * b];
  const int hi = bounds[2 * b + 1];
  const __nv_bfloat16* qb = qrows + (long long)b * nq * d;
  const __nv_bfloat16* yb = slabs + (long long)b * sb;

  for (int i = t; i < kQTile * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int qq = q0 + r;
    sq[r * qstride + c] =
        qq < nq ? __bfloat162float(qb[(long long)qq * d + c]) : 0.f;
  }
  for (int i = t; i < kRowTile * d; i += kThreads) {
    const int r = i / d, c = i - r * d;  // c fastest: coalesced when sd == 1
    const int l = l0 + r;
    sy[c * kRowStride + r] =
        l < lpad ? __bfloat162float(yb[c * sd + (long long)l * sl]) : 0.f;
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
    float m = kBig;
    bool first = true;
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const int l = lc + r;
      float v = (qn + syn[j * kSub + r]) - 2.f * acc[a][r];
      v = (l >= lo && l < hi) ? v : kBig;
      m = first ? v : fminf(m, v);
      first = false;
    }
    out[((long long)b * nq + qq) * nsc + lc / kSub] = m;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// qrows (lb, nq, d) bf16 contiguous; slabs (lb, d, lpad) bf16 with element
// strides (sb, sd, sl); bounds (lb, 2) int32 contiguous; out (lb, nq,
// lpad/8) f32 contiguous. lpad must be a multiple of 8.
int raft_flat_scan_subchunk_min(const void* qrows, const void* slabs,
                                const void* bounds, void* out, int lb, int nq,
                                int d, int lpad, long long sb, long long sd,
                                long long sl, void* stream) {
  if (lb < 1 || nq < 1 || d < 1 || lpad < kSub || lpad % kSub) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flat_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lpad + kRowTile - 1) / kRowTile, (nq + kQTile - 1) / kQTile,
                  lb);
  flat_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qrows),
      static_cast<const __nv_bfloat16*>(slabs),
      static_cast<const int32_t*>(bounds), static_cast<float*>(out), nq, d,
      lpad, sb, sd, sl);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one block needs at feature width d.
long long raft_flat_scan_smem_bytes(int d) { return (long long)smem_bytes(d); }

const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
