// Fused brute-force kNN kernels for Hopper (sm_90a): phase-1 chunk minima,
// phase-2 chunk rescore, and the launch probe.
//
// Replaces the three TPU kernels of raft_tpu/spatial/fused_knn.py:
//   chunk_mins_kernel  <- _chunk_mins / _chunkmin_kernel (:85 / :62)
//   rescore_kernel     <- _rescore_scores / _rescore_dma_kernel (:180 / :116)
//   probe_copy_kernel  <- probe_grid_steps (:443)
//
// Phase 1 computes, for every query i and 128-row index chunk c,
//   out[i, c] = min over r in 128c..128c+127 of (ynorm[r] - 2 * (q_i . y_r))
// with the operands in the compute type (f32, or both rounded to bf16 in
// registers), products accumulated in f32, and rows r >= n scoring BIG.
// The index is read in its storage type (f32 or bf16) and is never padded
// or copied: the kernel masks the ragged last chunk itself, and chunks
// wholly past n (the plan's npad) are written as BIG without any work.
// Only the (m, npad/128) minima reach device memory.
//
// What bounds phase 1 on the H100: at the SIFT shape (10,000 queries,
// 1,000,000 x 128 rows) it does 2.56 TFLOP and must move ~0.8 GB, so it is
// bound by arithmetic: 38 ms at the 67 TFLOP/s f32 rate of the CUDA cores
// (2.6 ms at the bf16 tensor rate, which this version does not use). What
// the design does about it: a 128-query x 128-row block tile in the style of
// a register-blocked SGEMM. Each of 256 threads keeps an 8 x 8 tile of f32
// sums in registers and reads its operands from shared memory as float4, so
// 64 FMAs cost four shared loads; the feature axis streams through shared
// memory in 16-wide slices (any d, up to the 4096 of fused_knn_supported),
// with the next slice's global loads in flight during the current slice's
// FMAs. Consecutive blocks share one index chunk, so the index is read from
// device memory about once and the queries stay in L2. wgmma is left for a
// later version.
//
// Phase 2 computes, for every query i and candidate slot j, the score of
// each of the 128 contiguous rows of chunk cids[i, j]:
//   out[i, 128 j + r] = sum over d of y * (y - 2 q_i)     (y upcast to f32)
// with q in f32 (never rounded). The caller adds |q|^2 and masks rows >= n.
// It is bound by bytes: each candidate chunk is 128 * d elements, read
// straight from the index layout. One block serves one query; its row of q
// sits in shared memory (at most 16 KB at d = 4096); each warp scores 32
// rows at a time, one row per step with every lane on its own 16-byte
// slice of the row (coalesced), a shuffle reduction per row, and one
// coalesced 128-byte store per 32 rows. A block loads its own chunk ids:
// the counterpart of the TPU kernel's scalar prefetch.
//
// The probe copies one (8, 128) f32 tile with every block of a 1-D grid of
// `steps` blocks of 256 threads: the layout of the phase-1 launch. It tells
// whether the card accepts a phase-1 grid of that many blocks.
//
// Every row offset is 64-bit: a 3M x 768 partition holds 2.3e9 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;       // index rows per chunk
constexpr float kBig = 1e30f;     // score of a row past the index

// ---- phase 1 ----
constexpr int kQTile = 128;       // queries per block
constexpr int kKTile = 16;        // feature slice staged in shared memory
constexpr int kThreads1 = 256;    // 16 x 16 threads, 8 x 8 outputs each
constexpr int kStride1 = kQTile + 4;  // shared row stride (16-byte aligned)
constexpr int kLoads1 = kQTile * kKTile / kThreads1;  // 8 per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// T: storage type of the index; kBf16: round both operands to bf16.
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads1, 2)
chunk_mins_kernel(const float* __restrict__ q, const T* __restrict__ y,
                  const float* __restrict__ ynorm, float* __restrict__ out,
                  int m, long long n, int d, long long n_chunks,
                  int q_tiles) {
  __shared__ __align__(16) float sq[kKTile][kStride1];
  __shared__ __align__(16) float sy[kKTile][kStride1];
  __shared__ float red[kThreads1 / 32][kQTile];

  const long long blk = blockIdx.x;
  const long long chunk = blk / q_tiles;
  const int q0 = (int)(blk - chunk * q_tiles) * kQTile;
  const long long r0 = chunk * kChunk;
  const int t = threadIdx.x;

  if (r0 >= n) {  // a chunk wholly past the index: all of its rows are BIG
    if (t < kQTile && q0 + t < m) out[(long long)(q0 + t) * n_chunks + chunk] = kBig;
    return;
  }

  const int tx = t % 16;  // query group: queries 4tx..4tx+3 and 64+4tx..
  const int ty = t / 16;  // row group: rows 4ty..4ty+3 and 64+4ty..
  const int lc = t % kKTile;   // feature within the slice this thread loads
  const int lr = t / kKTile;   // first tile row it loads (then + 16 each)

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float pq[kLoads1], py[kLoads1];
  auto load_slice = [&](int k0) {
    const int kk = k0 + lc;
#pragma unroll
    for (int s = 0; s < kLoads1; ++s) {
      const int r = lr + s * (kThreads1 / kKTile);
      const int qq = q0 + r;
      float v = 0.f;
      if (qq < m && kk < d) v = q[(long long)qq * d + kk];
      pq[s] = kBf16 ? round_bf16(v) : v;
      const long long row = r0 + r;
      float w = 0.f;
      if (row < n && kk < d) w = to_f32(y[row * d + kk]);
      py[s] = kBf16 ? round_bf16(w) : w;
    }
  };

  load_slice(0);
  for (int k0 = 0; k0 < d; k0 += kKTile) {
#pragma unroll
    for (int s = 0; s < kLoads1; ++s) {
      const int r = lr + s * (kThreads1 / kKTile);
      sq[lc][r] = pq[s];
      sy[lc][r] = py[s];
    }
    __syncthreads();
    if (k0 + kKTile < d) load_slice(k0 + kKTile);  // in flight during the FMAs
#pragma unroll
    for (int c = 0; c < kKTile; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sq[c][4 * tx]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sq[c][64 + 4 * tx]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sy[c][4 * ty]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sy[c][64 + 4 * ty]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(b[i], a[j], acc[i][j]);
    }
    __syncthreads();
  }

  // scores ynorm - 2 g; each thread's min over its 8 rows per query
  float mn[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) mn[j] = __int_as_float(0x7f800000);  // +inf
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = r0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    const bool valid = row < n;
    const float yn = valid ? ynorm[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s = valid ? yn - 2.f * acc[i][j] : kBig;
      mn[j] = fminf(mn[j], s);
    }
  }
  // the two row groups of a warp (ty = 2w, 2w + 1), then the 8 warps
#pragma unroll
  for (int j = 0; j < 8; ++j) mn[j] = fminf(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], 16));
  const int warp = t / 32;
  if ((t & 31) < 16) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp][j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4] = mn[j];
  }
  __syncthreads();
  if (t < kQTile && q0 + t < m) {
    float v = red[0][t];
#pragma unroll
    for (int w = 1; w < kThreads1 / 32; ++w) v = fminf(v, red[w][t]);
    out[(long long)(q0 + t) * n_chunks + chunk] = v;
  }
}

// ---- phase 2 ----
constexpr int kThreads2 = 256;
constexpr int kWarps2 = kThreads2 / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One lane's share of sum y * (y - 2q) over one row: 16-byte slices when
// kVec (rows a whole number of 16-byte slices, the index 16-byte aligned),
// single elements otherwise.
template <bool kVec>
__device__ __forceinline__ float row_part(const float* __restrict__ yr,
                                          const float* sq, int d, int lane) {
  float s = 0.f;
  if (kVec) {
    for (int e = 4 * lane; e < d; e += 128) {
      const float4 v = *reinterpret_cast<const float4*>(yr + e);
      const float4 w = *reinterpret_cast<const float4*>(sq + e);
      s = fmaf(v.x, v.x - 2.f * w.x, s);
      s = fmaf(v.y, v.y - 2.f * w.y, s);
      s = fmaf(v.z, v.z - 2.f * w.z, s);
      s = fmaf(v.w, v.w - 2.f * w.w, s);
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      const float v = yr[e];
      s = fmaf(v, v - 2.f * sq[e], s);
    }
  }
  return s;
}

template <bool kVec>
__device__ __forceinline__ float row_part(const __nv_bfloat16* __restrict__ yr,
                                          const float* sq, int d, int lane) {
  float s = 0.f;
  if (kVec) {
    for (int e = 8 * lane; e < d; e += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(yr + e);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 v = __bfloat1622float2(h[p]);
        s = fmaf(v.x, v.x - 2.f * sq[e + 2 * p], s);
        s = fmaf(v.y, v.y - 2.f * sq[e + 2 * p + 1], s);
      }
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      const float v = __bfloat162float(yr[e]);
      s = fmaf(v, v - 2.f * sq[e], s);
    }
  }
  return s;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads2)
rescore_kernel(const float* __restrict__ q, const int32_t* __restrict__ cids,
               const T* __restrict__ y, float* __restrict__ out, long long n,
               int d, int c) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  const long long i = blockIdx.x;  // query
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int e = t; e < d; e += kThreads2) sq[e] = q[i * d + e];
  __syncthreads();

  const int groups = c * (kChunk / 32);  // 32-row groups of this query
  for (int g = warp; g < groups; g += kWarps2) {
    const int j = g / (kChunk / 32);
    const int sub = g % (kChunk / 32);
    const long long row0 = (long long)cids[i * c + j] * kChunk + 32 * sub;
    float res = 0.f;
#pragma unroll 8
    for (int rr = 0; rr < 32; ++rr) {
      const long long row = row0 + rr;
      float s = 0.f;
      if (row >= 0 && row < n) {  // warp-uniform; other rows score 0
        s = row_part<kVec>(y + row * d, sq, d, lane);
      }
      s = warp_sum(s);
      if (lane == rr) res = s;
    }
    out[(i * c + j) * kChunk + 32 * sub + lane] = res;
  }
}

// ---- launch probe ----
__global__ void __launch_bounds__(kThreads1)
probe_copy_kernel(const float* __restrict__ in, float* __restrict__ out) {
  for (int e = threadIdx.x; e < 8 * 128; e += kThreads1) out[e] = in[e];
}

}  // namespace

extern "C" {

// All launchers run on `stream` and return cudaGetLastError() after the
// launch (0 = ok). Tensors are contiguous.

// q (m, d) f32; y (n, d) f32 (y_bf16 = 0) or bf16 (y_bf16 = 1); ynorm (n,)
// f32; out (m, n_chunks) f32, n_chunks * 128 >= n. bf16_compute rounds both
// operands to bf16. One block per (128-query tile, chunk), chunk-major.
int raft_fused_chunk_mins(const void* q, const void* y, const void* ynorm,
                          void* out, int m, long long n, int d,
                          long long n_chunks, int y_bf16, int bf16_compute,
                          void* stream) {
  if (m < 1 || n < 1 || d < 1 || n_chunks * kChunk < n) {
    return (int)cudaErrorInvalidValue;
  }
  const int q_tiles = (m + kQTile - 1) / kQTile;
  const long long blocks = (long long)q_tiles * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const float* yn = static_cast<const float*>(ynorm);
  float* o = static_cast<float*>(out);
  if (y_bf16) {
    const __nv_bfloat16* yb = static_cast<const __nv_bfloat16*>(y);
    if (bf16_compute) {
      chunk_mins_kernel<__nv_bfloat16, true><<<grid, kThreads1, 0, s>>>(
          qf, yb, yn, o, m, n, d, n_chunks, q_tiles);
    } else {
      chunk_mins_kernel<__nv_bfloat16, false><<<grid, kThreads1, 0, s>>>(
          qf, yb, yn, o, m, n, d, n_chunks, q_tiles);
    }
  } else {
    const float* yf = static_cast<const float*>(y);
    if (bf16_compute) {
      chunk_mins_kernel<float, true><<<grid, kThreads1, 0, s>>>(
          qf, yf, yn, o, m, n, d, n_chunks, q_tiles);
    } else {
      chunk_mins_kernel<float, false><<<grid, kThreads1, 0, s>>>(
          qf, yf, yn, o, m, n, d, n_chunks, q_tiles);
    }
  }
  return (int)cudaGetLastError();
}

// q (m, d) f32; cids (m, c) int32 chunk ids < ceil(n / 128) rounded up to
// the caller's plan; y (n, d) f32 or bf16; out (m, c * 128) f32. Rows past
// n score 0 (the caller masks them). One block per query.
int raft_fused_rescore(const void* q, const void* cids, const void* y,
                       void* out, int m, long long n, int d, int c,
                       int y_bf16, void* stream) {
  if (m < 1 || n < 1 || d < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)((d + 3) / 4 * 4);
  const int elems = y_bf16 ? 8 : 4;  // elements per 16-byte slice
  const bool vec = d % elems == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const int32_t* ci = static_cast<const int32_t*>(cids);
  float* o = static_cast<float*>(out);
  cudaError_t err = cudaSuccess;
#define RAFT_RESCORE_LAUNCH(T, V)                                            \
  do {                                                                       \
    err = cudaFuncSetAttribute(rescore_kernel<T, V>,                         \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               (int)smem);                                   \
    if (err != cudaSuccess) return (int)err;                                 \
    rescore_kernel<T, V><<<m, kThreads2, smem, s>>>(                         \
        qf, ci, static_cast<const T*>(y), o, n, d, c);                       \
  } while (0)
  if (y_bf16) {
    if (vec) RAFT_RESCORE_LAUNCH(__nv_bfloat16, true);
    else RAFT_RESCORE_LAUNCH(__nv_bfloat16, false);
  } else {
    if (vec) RAFT_RESCORE_LAUNCH(float, true);
    else RAFT_RESCORE_LAUNCH(float, false);
  }
#undef RAFT_RESCORE_LAUNCH
  return (int)cudaGetLastError();
}

// Copy one (8, 128) f32 tile in each of `steps` blocks (1-D grid of
// 256-thread blocks, the phase-1 layout). Returns the launch's error:
// cudaErrorInvalidConfiguration when the card refuses the grid.
int raft_fused_probe_grid_steps(const void* in, void* out, long long steps,
                                void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  if (steps > 0xffffffffLL) return (int)cudaErrorInvalidConfiguration;
  probe_copy_kernel<<<dim3((unsigned)steps), kThreads1, 0,
                      (cudaStream_t)stream>>>(static_cast<const float*>(in),
                                              static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The error code of a refused launch configuration, and the largest 1-D
// grid the current device accepts.
int raft_fused_invalid_configuration(void) {
  return (int)cudaErrorInvalidConfiguration;
}

long long raft_fused_max_grid_x(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxGridDimX, dev) != cudaSuccess) {
    return -1;
  }
  return (long long)v;
}

const char* raft_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
