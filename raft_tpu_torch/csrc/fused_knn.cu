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
// device memory about once and the queries stay in L2. This kernel serves
// f32 compute only.
//
// Phase 1 with bf16 compute (chunk_mins_tc_kernel) runs on the tensor cores:
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, index rows on M,
// queries on N, the feature axis on K, with the fragment and ldmatrix code
// of flat_scan.cu. Its bound at the SIFT shape is 2.6 ms of bf16 tensor
// work (2.56 TFLOP at 989 TFLOP/s); at 1,024 x 1M x 768 it is 1.6 ms.
//   * Block tile: 128 queries x 128 index rows (one chunk), 8 warps as 2 row
//     halves x 4 query quarters, each warp 64 rows x 32 queries (4 x 4
//     mma tiles, 64 f32 sums a thread). A block walks 8 consecutive chunks
//     with the same query tile, so its 128 x 8 minima leave as one
//     coalesced store (32 bytes a query) and the grid is 8x smaller than
//     the routing count _grid_steps. Chosen over a larger tile because a
//     128 x 128 tile keeps the sums at 64 registers a thread (123-162
//     registers in all, no spills), but at 128 x 128 x 32 the block reads
//     16 KB (bf16) to 32 KB (f32 operands) a slice for 1 MFLOP, so L2
//     bandwidth, not the tensor cores, bounds it.
//   * Up to d = 320 the query tile is rounded to bf16 once and stays in
//     shared memory for the block's 8 chunks, which halves the L2 traffic
//     of an f32 batch; wider tiles stream like the index (kTcResidentMax).
//   * The feature axis streams through two shared-memory stages of 32
//     features (bf16 rows padded to 40 elements, 5 16-byte units, so
//     ldmatrix reads them without bank conflicts). The slice after the
//     current one is in flight during its mma: a bf16 index with d % 8 == 0
//     is copied with 16-byte cp.async; f32 operands (an f32 index, streamed
//     queries) are loaded into registers, rounded with __float2bfloat16_rn
//     and stored into the other stage after the mma.
//   * Epilogue per chunk: ynorm - 2 * dot in the plain version's order, the
//     min of each query column over the warp's 64 rows by a butterfly over
//     the 8 lanes that hold it, then across the two row halves in shared
//     memory. Chunks wholly past n are written BIG without work.
// bf16 products are exact in f32 and integer partial sums are exact, so on
// integer inputs the result equals the plain version's bit for bit; on
// others it differs by the f32 summation order only.
//
// Phase 2 computes, for every query i and candidate slot j, the score of
// each of the 128 contiguous rows of chunk cids[i, j]:
//   out[i, 128 j + r] = sum over d of y * (y - 2 q_i)     (y upcast to f32)
// with q in f32 (never rounded), summed over d in ascending order, one
// fmaf(-2, q, y) and one fmaf per term. The caller adds |q|^2 and masks
// rows >= n. Its bound at (10,000 queries, 24 chunks, d = 128) is about
// 0.19 ms of bytes: the 7,813 distinct chunks it names (0.5 GB) and the
// scores it writes (0.12 GB). Each chunk is named by ~31 queries, and one
// block a query would read each chunk again for every query naming it
// (15.7 GB).
// What the design does about it:
//   * the launch inverts the pair map first, on the card and with no host
//     sync: a counting sort of the (query, slot) pairs by chunk
//     (rescore_count_kernel, rescore_scan_kernel, rescore_scatter_kernel;
//     the CPU tests hold a plain mirror of it), each chunk's
//     bucket cut into groups of at most kGroup = 32 pairs;
//   * one block a group reads the chunk once for all its pairs: the 128
//     rows (in the index's type) and the pairs' queries stream through
//     shared memory in 32-feature slices by 16-byte cp.async, a ring of
//     stages keeping the next slices in flight (4 for f32, so a d = 128
//     chunk is in flight whole, 6 for bf16: groups are small where
//     queries are few, and a block that waited on one slice at a time was
//     latency-bound);
//   * a register-blocked 128 x 32 tile of sums on the CUDA cores (the port
//     keeps TF32 off, and the formula is no bf16 product) writes each
//     pair's 128 scores as four coalesced 128-byte stores;
//   * blocks are launched for an upper bound of the group count, and the
//     ones past the last group return at once.
//
// The probe copies one (8, 128) f32 tile with every block of a 1-D grid of
// `steps` blocks of 256 threads: the layout of the phase-1 launch. It tells
// whether the card accepts a phase-1 grid of that many blocks.
//
// Every row offset is 64-bit: a 3M x 768 partition holds 2.3e9 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// T: storage type of the index; kBf16: round both operands to bf16 (only
// false is launched: bf16 compute runs chunk_mins_tc_kernel).
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

// ---- phase 1, bf16 compute, on the tensor cores ----
constexpr int kTcQ = 128;          // queries per block
constexpr int kTcK = 32;           // feature slice per stage
constexpr int kTcChunks = 8;       // chunks per block (one coalesced store)
constexpr int kTcThreads = 256;    // 8 warps: 2 row halves x 4 query quarters
constexpr int kTcStride = kTcK + 8;  // bf16 per shared row: 5 16-byte units
constexpr int kTcUnits = kChunk * kTcK / 8 / kTcThreads;  // 8-element units a thread loads per operand
// The most shared memory a block may take to keep its query tile resident:
// two blocks an SM (228 KB, 1 KB reserved a block), so d <= 320. Past it
// the query slices stream (H100, 700 W: at d = 768 one resident block an SM
// ran 9.9 ms against 8.1 ms streamed; at d = 128 resident 14.5 ms against
// 21.2 ms streamed; tools/time_chunk_mins.py).
constexpr size_t kTcResidentMax = 115712;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, rows x k) * b (16 x 8, k x queries), f32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Eight consecutive elements from p as f32, the first `rem` of them read
// (16-byte loads when vec and all eight are there), the rest zero.
__device__ __forceinline__ void load8(const float* p, int rem, bool vec,
                                      float (&v)[8]) {
  if (vec && rem >= 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < rem ? p[e] : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int rem,
                                      bool vec, float (&v)[8]) {
  if (vec && rem >= 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < rem ? __bfloat162float(p[e]) : 0.f;
  }
}

// Round eight f32 values to bf16 (nearest even) and store them as 16 bytes.
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float (&v)[8]) {
  uint4 w;
  uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    u[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = w;
}

// Shared memory of chunk_mins_tc_kernel: two index stages, the row-half
// minima and the block's chunk minima, then the query tile: resident
// (kTcQ rows of tc_q_stride(d) bf16) or two stages like the index's.
constexpr size_t kTcBase = 2 * kChunk * kTcStride * 2 + 4 * 2 * kTcQ +
                           4 * kTcQ * kTcChunks;

__host__ __device__ inline int tc_q_stride(int d) {
  return (d + kTcK - 1) / kTcK * kTcK + 8;  // an odd number of 16-byte units
}

inline size_t tc_smem_bytes(int d, bool resident) {
  return kTcBase + 2 * (size_t)kTcQ *
                       (resident ? tc_q_stride(d) : 2 * kTcStride);
}

// T: storage type of the index. kAsync: the index is bf16 with d % 8 == 0
// and 16-byte aligned rows, copied into the stage with cp.async. kQRes:
// the block's query tile is rounded to bf16 once and stays in shared
// memory for all its chunks (only the index streams); otherwise the query
// slices stream through two stages beside the index's.
template <typename T, bool kAsync, bool kQRes>
__global__ void __launch_bounds__(kTcThreads)
chunk_mins_tc_kernel(const float* __restrict__ q, const T* __restrict__ y,
                     const float* __restrict__ ynorm, float* __restrict__ out,
                     int m, long long n, int d, long long n_chunks,
                     int q_tiles, bool vec_q, bool vec_y) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  auto sy = reinterpret_cast<__nv_bfloat16(*)[kChunk * kTcStride]>(tc_smem);
  auto red = reinterpret_cast<float(*)[kTcQ]>(tc_smem +
                                              2 * kChunk * kTcStride * 2);
  float* cmin = &red[2][0];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(tc_smem + kTcBase);
  const int qst = kQRes ? tc_q_stride(d) : kTcStride;  // query row stride

  const long long grp = blockIdx.x / q_tiles;
  const int q0 = (int)(blockIdx.x - grp * q_tiles) * kTcQ;
  const long long c0 = grp * kTcChunks;
  const int t = threadIdx.x;
  // chunks this block writes, and those that hold a row < n
  const int n_out = (int)min((long long)kTcChunks, n_chunks - c0);
  const long long left = n - c0 * kChunk;
  const int n_live =
      left > 0 ? (int)min((long long)n_out, (left + kChunk - 1) / kChunk) : 0;

  for (int i = t; i < kTcQ * kTcChunks; i += kTcThreads) cmin[i] = kBig;

  if (n_live > 0) {
    const int nks = (d + kTcK - 1) / kTcK;
    const int steps = n_live * nks;
    const int warp = t >> 5, lane = t & 31;
    const int wr = warp & 1, wq = warp >> 1;
    const int g = lane >> 2, tq = lane & 3;
    // ldmatrix row addresses: A (16 rows x 16 k) from the index stage, B
    // (16 queries x 16 k, two n-tiles) from the query stage
    const int a_off = (wr * 64 + (lane & 15)) * kTcStride + (lane >> 4) * 8;
    const int b_off = (wq * 32 + (lane & 7) + ((lane >> 4) << 3)) * qst +
                      ((lane >> 3) & 1) * 8;

    if constexpr (kQRes) {  // the query tile, once (visible after the loop's first barrier)
      const int groups = (qst - 8) / 8;
      for (int u = t; u < kTcQ * groups; u += kTcThreads) {
        const int r = u / groups;
        const int k = 8 * (u - r * groups);
        const int qq = q0 + r;
        float v[8];
        load8(qq < m ? q + (long long)qq * d + k : q, qq < m ? d - k : 0,
              vec_q, v);
        store8_bf16(&sq[r * qst + k], v);
      }
    }

    float pq[kTcUnits][8], py[kTcUnits][8];
    // global loads of step s into registers (the index too unless kAsync)
    auto fetch = [&](int s) {
      const int cc = s / nks;
      const int k0 = (s - cc * nks) * kTcK;
      const long long r0 = (c0 + cc) * kChunk;
#pragma unroll
      for (int h = 0; h < kTcUnits; ++h) {
        const int u = t + h * kTcThreads;
        const int r = u >> 2;
        const int k = k0 + 8 * (u & 3);
        if constexpr (!kQRes) {
          const int qq = q0 + r;
          load8(qq < m ? q + (long long)qq * d + k : q, qq < m ? d - k : 0,
                vec_q, pq[h]);
        }
        if constexpr (!kAsync) {
          const long long row = r0 + r;
          load8(row < n ? y + row * d + k : y, row < n ? d - k : 0, vec_y,
                py[h]);
        }
      }
    };
    // the index slice of step s copied into stage buf with cp.async
    auto copy_y = [&](int s, int buf) {
      const int cc = s / nks;
      const int k0 = (s - cc * nks) * kTcK;
      const long long r0 = (c0 + cc) * kChunk;
#pragma unroll
      for (int h = 0; h < kTcUnits; ++h) {
        const int u = t + h * kTcThreads;
        const int r = u >> 2;
        const int k = k0 + 8 * (u & 3);
        __nv_bfloat16* dst = &sy[buf][r * kTcStride + 8 * (u & 3)];
        if (r0 + r < n && k < d) {
          cp_async16(dst, y + (r0 + r) * d + k);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int h = 0; h < kTcUnits; ++h) {
        const int u = t + h * kTcThreads;
        const int off = (u >> 2) * kTcStride + 8 * (u & 3);
        if constexpr (!kQRes) store8_bf16(&sq[buf * kTcQ * kTcStride + off], pq[h]);
        if constexpr (!kAsync) store8_bf16(&sy[buf][off], py[h]);
      }
    };

    fetch(0);
    if constexpr (kAsync) copy_y(0, 0);
    store(0);

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int s = 0; s < steps; ++s) {
      const int buf = s & 1;
      const bool more = s + 1 < steps;
      if (more) fetch(s + 1);  // in flight during this step's mma
      if constexpr (kAsync) asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();  // stage s landed; the other stage is free
      if constexpr (kAsync) {
        if (more) copy_y(s + 1, buf ^ 1);
      }
      const int cc = s / nks;
      const int k0 = (s - cc * nks) * kTcK;
      const int ksteps = min(kTcK / 16, (d - k0 + 15) / 16);
      const __nv_bfloat16* ys = sy[buf];
      const __nv_bfloat16* qs = kQRes ? sq + k0 : sq + buf * kTcQ * kTcStride;
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldmatrix_x4(a[i], ys + a_off + i * 16 * kTcStride + kk * 16);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          ldmatrix_x4(b[jj], qs + b_off + jj * 16 * qst + kk * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_16816(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3],
                      b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
      }
      if (more) store(buf ^ 1);

      if (k0 + kTcK >= d) {  // the chunk's last slice: its minima
        const long long r0 = (c0 + cc) * kChunk + wr * 64 + g;
        float mn[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) mn[j][0] = mn[j][1] = __int_as_float(0x7f800000);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // accumulator rows g and g + 8
            const long long row = r0 + i * 16 + h * 8;
            const bool valid = row < n;
            const float yn = valid ? ynorm[row] : 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int p = 0; p < 2; ++p) {
                const float sc = valid ? yn - 2.f * acc[i][j][2 * h + p] : kBig;
                mn[j][p] = fminf(mn[j][p], sc);
                acc[i][j][2 * h + p] = 0.f;
              }
          }
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int p = 0; p < 2; ++p)
              mn[j][p] = fminf(mn[j][p], __shfl_xor_sync(0xffffffffu, mn[j][p], o));
        if (g == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int p = 0; p < 2; ++p)
              red[wr][wq * 32 + j * 8 + 2 * tq + p] = mn[j][p];
        }
        __syncthreads();
        if (t < kTcQ) cmin[t * kTcChunks + cc] = fminf(red[0][t], red[1][t]);
      }
    }
  }
  __syncthreads();
  for (int i = t; i < kTcQ * n_out; i += kTcThreads) {
    const int s = i / n_out, j = i - s * n_out;
    if (q0 + s < m) {
      out[(long long)(q0 + s) * n_chunks + c0 + j] = cmin[s * kTcChunks + j];
    }
  }
}

// ---- phase 2: the rescore, one block per (chunk, group of pairs) ----
constexpr int kGroup = 32;            // (query, slot) pairs of one chunk
constexpr int kThreads2 = 256;        // 8 warps x 4 pairs; a lane 4 rows
constexpr int kSlice2 = 32;           // features per stage
constexpr int kQStride2 = kSlice2 + 4;  // f32 query row: 9 16-byte units
constexpr int kScanThreads = 1024;    // the plan's one-block scan

// A stage: one 32-feature slice of the chunk's 128 rows in the index's
// type (rows padded to an odd number of 16-byte units: 9 for f32, 5 for
// bf16, so the 8 lanes of a quarter-warp reading 16 bytes of 8 rows hit
// distinct banks) and of the group's queries in f32. Stages in the ring:
// 4 for f32 (a d = 128 chunk in flight whole), 6 for bf16.
template <typename T>
struct RescoreStage {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kYStride = kBf16 ? kSlice2 + 8 : kSlice2 + 4;
  static constexpr int kStages = kBf16 ? 6 : 4;
  static constexpr size_t kYBytes = sizeof(T) * kChunk * kYStride;
  static constexpr size_t kBytes =
      kYBytes + sizeof(float) * kGroup * kQStride2;
  static constexpr size_t kSmem = kStages * kBytes;
};

// Blocks of a rescore launch: an upper bound of the group count, sum over
// buckets of ceil(pairs / kGroup) <= pairs / kGroup + buckets, and at most
// one a pair. The blocks past the last group return at once.
inline long long rescore_blocks(long long n_pairs, int buckets) {
  const long long ub = n_pairs / kGroup + buckets;
  return ub < n_pairs ? ub : n_pairs;
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// The plan: the (query i, slot j) pairs p = i * c + j bucketed by chunk id
// (a counting sort), each bucket cut into groups of at most kGroup pairs.
// Bucket k < n_chunks is chunk k; bucket n_chunks takes every id outside
// [0, n_chunks) (rows past the index, scoring 0).
__device__ __forceinline__ int bucket_of(int id, int n_chunks) {
  return id >= 0 && id < n_chunks ? id : n_chunks;
}

__global__ void rescore_count_kernel(const int32_t* __restrict__ cids,
                                     int* __restrict__ count, int n_pairs,
                                     int n_chunks) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    atomicAdd(&count[bucket_of(cids[p], n_chunks)], 1);
  }
}

// Inclusive sum over the block of v (kScanThreads threads); `tmp` holds
// one value a warp.
__device__ __forceinline__ int block_scan(int v, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) tmp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = tmp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    tmp[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? tmp[warp - 1] : 0);
  __syncthreads();
  return out;
}

// One block: each bucket's first sorted position (start, and the scatter
// cursor), its first group (gstart; gstart[buckets] = the group count) and
// each group's bucket (gkey).
__global__ void __launch_bounds__(kScanThreads)
rescore_scan_kernel(const int* __restrict__ count, int* __restrict__ start,
                    int* __restrict__ cursor, int* __restrict__ gstart,
                    int* __restrict__ gkey, int buckets) {
  __shared__ int tmp[32];
  __shared__ int tot[2];
  int carry_p = 0, carry_g = 0;
  for (int base = 0; base < buckets; base += kScanThreads) {
    const int k = base + threadIdx.x;
    const int cnt = k < buckets ? count[k] : 0;
    const int grp = (cnt + kGroup - 1) / kGroup;
    const int ip = block_scan(cnt, tmp);
    const int ig = block_scan(grp, tmp);
    if (k < buckets) {
      start[k] = cursor[k] = carry_p + ip - cnt;
      const int g0 = gstart[k] = carry_g + ig - grp;
      for (int j = 0; j < grp; ++j) gkey[g0 + j] = k;
    }
    if (threadIdx.x == kScanThreads - 1) {  // this slice's totals
      tot[0] = ip;
      tot[1] = ig;
    }
    __syncthreads();
    carry_p += tot[0];
    carry_g += tot[1];
    __syncthreads();
  }
  if (threadIdx.x == 0) gstart[buckets] = carry_g;
}

__global__ void rescore_scatter_kernel(const int32_t* __restrict__ cids,
                                       int* __restrict__ cursor,
                                       int32_t* __restrict__ spair,
                                       int n_pairs, int n_chunks) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    spair[atomicAdd(&cursor[bucket_of(cids[p], n_chunks)], 1)] = p;
  }
}

// Block g scores the pairs of group g: the j-th group of bucket k =
// gkey[g] (j = g - gstart[k]), at most kGroup pairs that all name chunk k:
// the chunk's 128 rows and the pairs' queries stream through a ring of
// shared-memory stages in 32-feature slices (RescoreStage); warp w holds
// pairs 4w..4w+3 and lane l rows l, l + 32, l + 64, l + 96, 16 sums in
// registers. Blocks past the last group return at once. kVec: 16-byte cp.async of rows and queries (d a
// whole number of 16-byte units, both 16-byte aligned); else
// single-element loads.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads2, 2)
rescore_kernel(const float* __restrict__ q, const int* __restrict__ start,
               const int* __restrict__ count, const int* __restrict__ gstart,
               const int* __restrict__ gkey,
               const int32_t* __restrict__ spair, const T* __restrict__ y,
               float* __restrict__ out, long long n, int d, int c,
               int buckets) {
  using Stage = RescoreStage<T>;
  constexpr int kYS = Stage::kYStride;
  constexpr int kStages = Stage::kStages;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ long long sout[kGroup];   // each pair's first output element
  __shared__ long long sqrow[kGroup];  // each pair's query row offset

  const int g = blockIdx.x;
  if (g >= gstart[buckets]) return;
  const int k = gkey[g];
  const int s0 = start[k] + (g - gstart[k]) * kGroup;
  const int ng = min(kGroup, start[k] + count[k] - s0);
  const long long row0 = (long long)k * kChunk;
  const int nrows = (int)max(0LL, min((long long)kChunk, n - row0));
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < ng) {
    const int p = spair[s0 + t];
    sout[t] = (long long)p * kChunk;
    sqrow[t] = (long long)(p / c) * d;
  }
  __syncthreads();
  if (nrows == 0) {  // a chunk past the index: every row scores 0
    for (int i = t; i < ng * kChunk; i += kThreads2) {
      out[sout[i / kChunk] + i % kChunk] = 0.f;
    }
    return;
  }

  constexpr int kElems = 16 / sizeof(T);       // elements per 16-byte unit
  constexpr int kUnits = kSlice2 / kElems;     // units per row slice
  auto stage_y = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * Stage::kBytes);
  };
  auto stage_q = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * Stage::kBytes +
                                    Stage::kYBytes);
  };
  // slice s into stage buf, as one cp.async group (empty past the last
  // slice, so every thread commits one group a step)
  const int n_slices = (d + kSlice2 - 1) / kSlice2;
  auto load = [&](int s, int buf) {
    if (s < n_slices) {
      const int f0 = s * kSlice2;
      T* ydst = stage_y(buf);
      float* qdst = stage_q(buf);
      if constexpr (kVec) {
        for (int u = t; u < kChunk * kUnits; u += kThreads2) {
          const int r = u / kUnits, f = kElems * (u % kUnits);
          const bool ok = r < nrows && f0 + f < d;
          cp_async16_zfill(ydst + r * kYS + f,
                           ok ? y + (row0 + r) * d + f0 + f : y, ok);
        }
        const int j = t / 8, f = 4 * (t % 8);  // one query unit a thread
        const bool ok = j < ng && f0 + f < d;
        cp_async16_zfill(qdst + j * kQStride2 + f,
                         ok ? q + sqrow[j] + f0 + f : q, ok);
      } else {
        for (int u = t; u < kChunk * kSlice2; u += kThreads2) {
          const int r = u / kSlice2, f = u % kSlice2;
          ydst[r * kYS + f] = (r < nrows && f0 + f < d)
                                  ? y[(row0 + r) * d + f0 + f]
                                  : T(0.f);
        }
        for (int u = t; u < kGroup * kSlice2; u += kThreads2) {
          const int j = u / kSlice2, f = u % kSlice2;
          qdst[j * kQStride2 + f] =
              (j < ng && f0 + f < d) ? q[sqrow[j] + f0 + f] : 0.f;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // 8 features of row r of a stage, widened to f32
  auto row8 = [&](const T* yb, int r, int f, float (&v)[8]) {
    if constexpr (Stage::kBf16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(yb + r * kYS + f);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 w = __bfloat1622float2(h[e]);
        v[2 * e] = w.x;
        v[2 * e + 1] = w.y;
      }
    } else {
      const float4 a = *reinterpret_cast<const float4*>(yb + r * kYS + f);
      const float4 b = *reinterpret_cast<const float4*>(yb + r * kYS + f + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // the ring: kStages - 1 slices in flight ahead of the one being summed
  for (int s = 0; s < kStages - 1; ++s) load(s, s);
  for (int s = 0; s < n_slices; ++s) {
    load(s + kStages - 1, (s + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncthreads();
    if (4 * warp < ng) {  // warp-uniform: warps without pairs skip the sums
      const T* yb = stage_y(s % kStages);
      const float* qb = stage_q(s % kStages) + 4 * warp * kQStride2;
      for (int f = 0; f < kSlice2; f += 8) {
        float yv[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) row8(yb, lane + 32 * i, f, yv[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qa =
              *reinterpret_cast<const float4*>(qb + j * kQStride2 + f);
          const float4 qc =
              *reinterpret_cast<const float4*>(qb + j * kQStride2 + f + 4);
          const float qv[8] = {qa.x, qa.y, qa.z, qa.w,
                               qc.x, qc.y, qc.z, qc.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = acc[i][j];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              a = fmaf(yv[i][e], fmaf(-2.f, qv[e], yv[i][e]), a);
            }
            acc[i][j] = a;
          }
        }
      }
    }
    __syncthreads();
  }

  // each pair's 128 scores: 4 coalesced 128-byte stores by one warp
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int jj = 4 * warp + j;
    if (jj < ng) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lane + 32 * i;
        out[sout[jj] + r] = r < nrows ? acc[i][j] : 0.f;
      }
    }
  }
}

// ---- launch probe ----
__global__ void __launch_bounds__(kThreads1)
probe_copy_kernel(const float* __restrict__ in, float* __restrict__ out) {
  for (int e = threadIdx.x; e < 8 * 128; e += kThreads1) out[e] = in[e];
}

// The same grid doing no work: its time is the card's floor for issuing
// and retiring that many 256-thread blocks, the other half of the probe's
// bound (a measuring aid, not a port of a TPU kernel).
__global__ void __launch_bounds__(kThreads1) probe_empty_kernel() {}

}  // namespace

extern "C" {

// All launchers run on `stream` and return cudaGetLastError() after the
// launch (0 = ok). Tensors are contiguous.

// q (m, d) f32; y (n, d) f32 (y_bf16 = 0) or bf16 (y_bf16 = 1); ynorm (n,)
// f32; out (m, n_chunks) f32, n_chunks * 128 >= n. bf16_compute rounds both
// operands to bf16 and runs chunk_mins_tc_kernel on the tensor cores: one
// block per (128-query tile, 8 chunks), chunk-major. f32 compute runs
// chunk_mins_kernel: one block per (128-query tile, chunk), chunk-major.
int raft_fused_chunk_mins(const void* q, const void* y, const void* ynorm,
                          void* out, int m, long long n, int d,
                          long long n_chunks, int y_bf16, int bf16_compute,
                          void* stream) {
  if (m < 1 || n < 1 || d < 1 || n_chunks * kChunk < n) {
    return (int)cudaErrorInvalidValue;
  }
  const int q_tiles = (m + kQTile - 1) / kQTile;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const float* yn = static_cast<const float*>(ynorm);
  float* o = static_cast<float*>(out);
  if (bf16_compute) {
    const long long groups = (n_chunks + kTcChunks - 1) / kTcChunks;
    const long long blocks = (long long)q_tiles * groups;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const bool vec_q = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    const bool aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0;
    const bool resident = tc_smem_bytes(d, true) <= kTcResidentMax;
    const size_t smem = tc_smem_bytes(d, resident);
    cudaError_t err = cudaSuccess;
#define RAFT_TC_LAUNCH(T, A, R, VY)                                           \
  do {                                                                        \
    err = cudaFuncSetAttribute(chunk_mins_tc_kernel<T, A, R>,                 \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                               (int)smem);                                    \
    if (err != cudaSuccess) return (int)err;                                  \
    chunk_mins_tc_kernel<T, A, R><<<(unsigned)blocks, kTcThreads, smem, s>>>( \
        qf, static_cast<const T*>(y), yn, o, m, n, d, n_chunks, q_tiles,      \
        vec_q, VY);                                                           \
  } while (0)
#define RAFT_TC_RES(T, A, VY)                \
  do {                                       \
    if (resident) RAFT_TC_LAUNCH(T, A, true, VY);  \
    else RAFT_TC_LAUNCH(T, A, false, VY);    \
  } while (0)
    if (y_bf16) {
      if (d % 8 == 0 && aligned) RAFT_TC_RES(__nv_bfloat16, true, true);
      else RAFT_TC_RES(__nv_bfloat16, false, false);
    } else {
      RAFT_TC_RES(float, false, d % 4 == 0 && aligned);
    }
#undef RAFT_TC_RES
#undef RAFT_TC_LAUNCH
    return (int)cudaGetLastError();
  }
  const long long blocks = (long long)q_tiles * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  if (y_bf16) {
    chunk_mins_kernel<__nv_bfloat16, false><<<grid, kThreads1, 0, s>>>(
        qf, static_cast<const __nv_bfloat16*>(y), yn, o, m, n, d, n_chunks,
        q_tiles);
  } else {
    chunk_mins_kernel<float, false><<<grid, kThreads1, 0, s>>>(
        qf, static_cast<const float*>(y), yn, o, m, n, d, n_chunks, q_tiles);
  }
  return (int)cudaGetLastError();
}

// q (m, d) f32; cids (m, c) int32 chunk ids; y (n, d) f32 or bf16; out
// (m, c * 128) f32. Rows past n, and ids outside [0, ceil(n / 128)), score
// 0. `plan` is int32 scratch of plan_ints(m, c, n) elements: the launch
// first builds the plan there (count, scan, scatter), then runs one block
// per group of pairs.
int raft_fused_rescore(const void* q, const void* cids, const void* y,
                       void* out, void* plan, int m, long long n, int d,
                       int c, int y_bf16, void* stream) {
  if (m < 1 || n < 1 || d < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const long long n_pairs = (long long)m * c;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  if (n_pairs > 0x7fffffffLL || n_chunks >= 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int buckets = (int)n_chunks + 1;
  const long long blocks = rescore_blocks(n_pairs, buckets);
  cudaStream_t s = (cudaStream_t)stream;
  int* count = static_cast<int*>(plan);
  int* start = count + buckets;
  int* cursor = start + buckets;
  int* gstart = cursor + buckets;                 // buckets + 1
  int* gkey = gstart + buckets + 1;               // blocks
  int32_t* spair = gkey + blocks;                 // n_pairs
  const int32_t* ci = static_cast<const int32_t*>(cids);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * buckets, s);
  if (err != cudaSuccess) return (int)err;
  const int pair_blocks = (int)((n_pairs + 255) / 256 < 1024
                                    ? (n_pairs + 255) / 256 : 1024);
  rescore_count_kernel<<<pair_blocks, 256, 0, s>>>(ci, count, (int)n_pairs,
                                                   (int)n_chunks);
  rescore_scan_kernel<<<1, kScanThreads, 0, s>>>(count, start, cursor,
                                                 gstart, gkey, buckets);
  rescore_scatter_kernel<<<pair_blocks, 256, 0, s>>>(
      ci, cursor, spair, (int)n_pairs, (int)n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = y_bf16 ? RescoreStage<__nv_bfloat16>::kSmem
                             : RescoreStage<float>::kSmem;
  const int elems = y_bf16 ? 8 : 4;  // elements per 16-byte unit
  const bool vec = d % elems == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
#define RAFT_RESCORE_LAUNCH(T, V)                                            \
  do {                                                                       \
    err = cudaFuncSetAttribute(rescore_kernel<T, V>,                         \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               (int)smem);                                   \
    if (err != cudaSuccess) return (int)err;                                 \
    rescore_kernel<T, V><<<(unsigned)blocks, kThreads2, smem, s>>>(          \
        qf, start, count, gstart, gkey, spair, static_cast<const T*>(y), o,  \
        n, d, c, buckets);                                                   \
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

// int32 scratch elements the rescore's plan needs: four arrays over the
// buckets (count, start, cursor, gstart + 1), the group bucket of every
// launched block, the sorted pairs.
long long raft_fused_rescore_plan_ints(int m, long long n, int c) {
  const long long n_pairs = (long long)m * c;
  const int buckets = (int)((n + kChunk - 1) / kChunk) + 1;
  return 4LL * buckets + 1 + rescore_blocks(n_pairs, buckets) + n_pairs;
}

// Pairs per rescore block at most (the plan's group cap).
int raft_fused_rescore_group(void) { return kGroup; }

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

// Launch `steps` empty 256-thread blocks (probe_grid_steps' grid) on
// `stream`; returns the launch's error.
int raft_fused_probe_empty(long long steps, void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  if (steps > 0xffffffffLL) return (int)cudaErrorInvalidConfiguration;
  probe_empty_kernel<<<dim3((unsigned)steps), kThreads1, 0,
                       (cudaStream_t)stream>>>();
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
