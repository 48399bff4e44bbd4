// Beam-search candidate scan for Hopper (sm_90a).
//
// Replaces the TPU kernel beam_scan_subchunk_min
// (raft_tpu/spatial/ann/graph_kernel.py:88), which runs through the shared
// Pallas scan scan_core.subchunk_scan (raft_tpu/spatial/ann/scan_core.py:211)
// with one live query row padded to 16 sublanes and the candidate rows
// gathered and transposed into an (NQ, d, Cpad) operand beforehand.
//
// Reads each named row once and computes two outputs from it. For every
// query b and candidate r of its Cpad ids, y_r = table[ids[b, r]]:
//
//   * the minima (always): for each 8-row sub-chunk j,
//       mins[b, j] = min over r in 8j..8j+7 of (|q_b|^2 + |y_r|^2) - 2 q_b.y_r
//     with bf16-rounded operands (round to nearest even, as
//     .to(torch.bfloat16) rounds), f32 products and sums, and candidates
//     outside the query's [lo, hi) range scoring BIG;
//   * the exact distances (when `exact` is not null): the same formula on
//     the unrounded f32 query and row, +inf where ids[b, r] >= n_valid
//     (the sentinel and ids past it), as common.score_l2_candidates scores
//     the gathered rows. The graph walk's pool merge takes these, so it
//     reads no candidate row a second time.
//
// Arithmetic: one thread walks one row, so no reduction tree reorders a
// sum. Every sum runs over the feature axis in ascending order with one
// fmaf per term (the query norms too, once per block). For the minima a
// product of two bf16 values is exact in f32, so the fmaf rounds as a
// multiply then an add and the minima are bitwise equal to the plain
// version on any input. The exact sums round once per term (fmaf), where
// the plain version's torch.sum and bmm round the product too and add in
// their own order: bitwise equal on integer-exact inputs, within the f32
// summation bound elsewhere. The formula order is (qn + yn) - 2 * dot in
// both. The sentinel row of the index (1e15 in every feature) scores ~1e32
// in the minima.
//
// What bounds it on the H100: per-query GEMVs, one query against its own
// Cpad gathered rows, about 1 FLOP per byte moved (the rows are f32 in
// device memory), so device memory: the ids, each distinct row they name,
// the queries, the minima and the exact distances (rows that several
// queries name in one launch are read from device memory once at best and
// come from L2 after that). The tensor cores have nothing to do here: with
// one query per candidate set there is no reuse across queries (a 64-query
// tile would waste 63/64 of its work, as the TPU's 16-sublane padding
// wasted 15/16). What the design does about it:
//   * the kernel reads the ids and gathers the rows itself, so no
//     (NQ, Cpad, d) gathered copy is written and read back, and it writes
//     the exact distances beside the 8x smaller minima, so the caller reads
//     no row again;
//   * rows are staged in shared memory, unrounded, by 16-byte cp.async
//     (4-byte where d or the table's alignment forbid), consecutive threads
//     on consecutive units of a row; a row's stride is an odd number of
//     16-byte units, so the 8 threads of a quarter-warp that read one unit
//     of 8 consecutive rows hit distinct banks;
//   * the copies cache in L1 (cp.async.ca): the walk pads and dedups with
//     the sentinel id, so up to a quarter of a launch's rows are the one
//     sentinel row, and L2-only copies (.cg) sent them all to its few L2
//     lines (several times slower on an H100 at (4096, 1024) with a
//     quarter sentinels);
//   * one tile of rows per block and four blocks an SM at d = 96: while
//     one block sums its tile the others' rows are in flight. A block that
//     walks several tiles with two stages, the next in flight during the
//     current one's sums, measured slower at every shape tried (two blocks
//     an SM);
//   * launches with few queries take smaller tiles (down to 32 rows), so
//     even nq = 1 spreads over many SMs.
//
// Layout: q (NQ, d) f32, table (rows, d) f32, ids (NQ, Cpad) int32 and
// bounds (NQ, 2) int32, all contiguous; mins (NQ, Cpad/8) f32 and exact
// (NQ, Cpad) f32. Ids must lie in [0, rows); a row outside is not read and
// scores as a zero row (+inf in the exact output when past n_valid).

#include "scan_core.cuh"

namespace {

using scan_core::kSub;

constexpr int kMaxRows = 128;       // candidate rows (threads) of a tile
constexpr int kMinRows = 16;        // the narrowest tile rows_per_block picks
constexpr int kMinLaunchRows = 32;  // the narrowest tile a small launch takes
constexpr size_t kSmemLimit = 232448;

// floats of a staged row: d rounded up to 16-byte units, then to an odd
// number of units (bank spread of the float4 reads)
__host__ __device__ inline int beam_stride(int d) {
  const int s = (d + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

__host__ __device__ inline size_t beam_smem_bytes(int d, int rows) {
  // the query row unrounded and bf16-rounded, the staged rows, one value
  // per row
  const size_t s = beam_stride(d);
  return sizeof(float) * (2 * s + (size_t)rows * s + rows);
}

// Rows per tile: the largest of 128, 64, 32, 16 whose shared memory fits a
// block beside the static id array; 0 when none does.
int rows_per_block(int d) {
  for (int rows = kMaxRows; rows >= kMinRows; rows /= 2) {
    if (beam_smem_bytes(d, rows) + sizeof(int) * kMaxRows <= kSmemLimit) {
      return rows;
    }
  }
  return 0;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of kBytes (16 or 4), cached in L1 and L2, with zero fill:
// src_bytes = 0 copies nothing and writes zeros
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool ok) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Stage the nr rows of sid[0..nr) into dst ([rows][stride], unrounded f32):
// kVec copies 16-byte units (d % 4 == 0, table 16-byte aligned), else
// single elements. Columns in [d, round_up(d, 4)) are zero-filled.
template <bool kVec>
__device__ __forceinline__ void stage_rows(float* dst, const float* table,
                                           const int* sid, int nr, int d,
                                           int stride, int n_rows) {
  const int rows = blockDim.x;
  if constexpr (kVec) {
    const int d4 = d / 4;
    for (int i = threadIdx.x; i < nr * d4; i += rows) {
      const int r = i / d4, c = 4 * (i - r * d4);
      const int id = sid[r];
      const bool ok = id >= 0 && id < n_rows;
      cp_async_zfill<16>(dst + r * stride + c,
                         ok ? table + (long long)id * d + c : table, ok);
    }
  } else {
    const int dp = (d + 3) / 4 * 4;
    for (int i = threadIdx.x; i < nr * dp; i += rows) {
      const int r = i / dp, c = i - r * dp;
      const int id = sid[r];
      const bool ok = id >= 0 && id < n_rows && c < d;
      cp_async_zfill<4>(dst + r * stride + c,
                        ok ? table + (long long)id * d + c : table, ok);
    }
  }
}

__device__ __forceinline__ void accumulate(float y, float qv, float qr,
                                           float& dot, float& yn, float& dotr,
                                           float& ynr) {
  const float yr = bf16_round(y);
  dotr = fmaf(qr, yr, dotr);
  ynr = fmaf(yr, yr, ynr);
  dot = fmaf(qv, y, dot);
  yn = fmaf(y, y, yn);
}

// grid (NQ, Cpad / rows), one thread per row of the block's tile
template <bool kVec>
__global__ void __launch_bounds__(kMaxRows)
beam_scan_kernel(const float* __restrict__ q, const float* __restrict__ table,
                 const int32_t* __restrict__ ids,
                 const int32_t* __restrict__ bounds, float* __restrict__ mins,
                 float* __restrict__ exact, int n_rows, int n_valid, int d,
                 int cpad) {
  extern __shared__ float4 smem4[];
  __shared__ int sid[kMaxRows];
  __shared__ float sqn[2];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = blockDim.x;
  const int stride = beam_stride(d);
  float* sq = smem;                               // [stride] unrounded
  float* sqr = sq + stride;                       // [stride] bf16-rounded
  float* sy = sqr + stride;                       // [rows][stride]
  float* sv = sy + (size_t)rows * stride;         // [rows]

  const long long b = blockIdx.x;                 // query
  const int c0 = blockIdx.y * rows;               // first candidate
  const int nr = min(rows, cpad - c0);            // a multiple of kSub
  const int t = threadIdx.x;
  const int lo = bounds[2 * b];
  const int hi = bounds[2 * b + 1];

  if (t < nr) sid[t] = ids[b * cpad + c0 + t];
  for (int c = t; c < stride; c += rows) {
    const float v = c < d ? q[b * d + c] : 0.f;
    sq[c] = v;
    sqr[c] = bf16_round(v);
  }
  __syncthreads();
  stage_rows<kVec>(sy, table, sid, nr, d, stride, n_rows);
  if (t == 0) {  // the query's norms, ascending, while the rows land
    float qnr = 0.f, qn = 0.f;
    for (int c = 0; c < d; ++c) {
      qnr = fmaf(sqr[c], sqr[c], qnr);
      qn = fmaf(sq[c], sq[c], qn);
    }
    sqn[0] = qnr;
    sqn[1] = qn;
  }
  cp_async_wait_all();
  __syncthreads();

  if (t < nr) {
    const float* y = sy + t * stride;
    float dot = 0.f, yn = 0.f, dotr = 0.f, ynr = 0.f;
    for (int c = 0; c < d; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(y + c);
      const float4 a = *reinterpret_cast<const float4*>(sq + c);
      const float4 ar = *reinterpret_cast<const float4*>(sqr + c);
      accumulate(v.x, a.x, ar.x, dot, yn, dotr, ynr);
      accumulate(v.y, a.y, ar.y, dot, yn, dotr, ynr);
      accumulate(v.z, a.z, ar.z, dot, yn, dotr, ynr);
      accumulate(v.w, a.w, ar.w, dot, yn, dotr, ynr);
    }
    sv[t] = (sqn[0] + ynr) - 2.f * dotr;
    if (exact != nullptr) {
      exact[b * cpad + c0 + t] = sid[t] < n_valid
                                     ? (sqn[1] + yn) - 2.f * dot
                                     : __int_as_float(0x7f800000);
    }
  }
  __syncthreads();

  if (t < nr / kSub) {
    float v[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) v[r] = sv[t * kSub + r];
    mins[b * (cpad / kSub) + c0 / kSub + t] =
        scan_core::masked_subchunk_min(v, c0 + t * kSub, lo, hi);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// q (nq, d) f32, table (n_rows, d) f32, ids (nq, cpad) int32, bounds (nq, 2)
// int32, mins (nq, cpad/8) f32, exact (nq, cpad) f32 or null (minima only),
// all contiguous; cpad a positive multiple of 8, n_valid <= n_rows.
int raft_beam_scan(const void* q, const void* table, const void* ids,
                   const void* bounds, void* mins, void* exact, int nq,
                   int n_rows, int n_valid, int d, int cpad, void* stream) {
  int rows = rows_per_block(d);
  if (nq < 1 || n_rows < 1 || n_valid < 0 || n_valid > n_rows || d < 1 ||
      cpad < kSub || cpad % kSub || rows == 0) {
    return (int)cudaErrorInvalidValue;
  }
  // few queries: narrower tiles, so the launch spreads over the SMs (below
  // two blocks an SM)
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  while (rows > kMinLaunchRows &&
         (long long)nq * ((cpad + rows - 1) / rows) < 2LL * sms) {
    rows /= 2;
  }
  const dim3 grid(nq, (cpad + rows - 1) / rows);
  if (grid.y > scan_core::kMaxGridYZ) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = beam_smem_bytes(d, rows);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  auto kernel = vec ? beam_scan_kernel<true> : beam_scan_kernel<false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, rows, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(table),
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(bounds),
      static_cast<float*>(mins), static_cast<float*>(exact), n_rows, n_valid,
      d, cpad);
  return (int)cudaGetLastError();
}

// Candidate rows (threads) of the widest tile at feature width d;
// 0 = unsupported.
int raft_beam_scan_rows_per_block(int d) { return rows_per_block(d); }

// Dynamic shared memory of a block of that tile at feature width d.
long long raft_beam_scan_smem_bytes(int d) {
  return (long long)beam_smem_bytes(d, rows_per_block(d));
}

const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
