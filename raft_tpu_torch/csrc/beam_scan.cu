// Beam-search candidate scan for Hopper (sm_90a).
//
// Replaces the TPU kernel beam_scan_subchunk_min
// (raft_tpu/spatial/ann/graph_kernel.py:88), which runs through the shared
// Pallas scan scan_core.subchunk_scan (raft_tpu/spatial/ann/scan_core.py:211)
// with one live query row padded to 16 sublanes and the candidate rows
// gathered and transposed into an (NQ, d, Cpad) operand beforehand.
//
// Computes, for every query b and 8-row sub-chunk j of its Cpad candidates,
//   out[b, j] = min over r in 8j..8j+7 of (|q_b|^2 + |y_r|^2) - 2 q_b.y_r,
//   y_r = table[ids[b, r]],
// with bf16-rounded operands (round to nearest even at load, as
// .to(torch.bfloat16) rounds), f32 products and sums, and candidates outside
// the query's [lo, hi) range scoring BIG. Only the (NQ, Cpad/8) minima are
// written.
//
// Arithmetic (the port's scan_core.l2_gram_tile): each row's dot and norm,
// and the query's norm, are summed over the feature axis in ascending order,
// one rounded f32 add per term (a product of two bf16 values is exact in
// f32, so a fused multiply-add rounds as a multiply then an add), and the
// formula order is (qn + yn) - 2 * dot. One thread walks one row, so no
// reduction tree reorders the sum, and the kernel is bitwise equal to its
// plain version on any input. The sentinel row of the index (1e15 in every
// feature) scores ~1e32 in both.
//
// What bounds it on the H100: the work is a batch of GEMVs, one query
// against its own Cpad gathered rows, about 0.5 FLOP per byte it must move
// (the rows are f32 in device memory), so device memory bounds it: the ids,
// each distinct row they name, the queries and the minima (rows that several
// queries name in one launch are read from device memory once at best, and
// come from L2 after that). What the design does about it: the kernel reads
// the candidate ids and gathers the rows itself, so no (NQ, Cpad, d) gathered
// copy is written and read back; each block stages its rows in shared memory
// with loads coalesced along each row (16 bytes a thread where d allows),
// and writes only the 8x smaller minima. It does not use the tensor cores:
// with one query per candidate set there is no reuse for them (a 64-query
// tile would waste 63/64 of its work, as the TPU's 16-sublane padding
// wasted 15/16).
//
// Layout: q (NQ, d) f32, table (rows, d) f32, ids (NQ, Cpad) int32 and
// bounds (NQ, 2) int32, all contiguous. Ids must lie in [0, rows); a row
// outside is not read and scores as a zero row.

#include "scan_core.cuh"

namespace {

using scan_core::kSub;

constexpr int kMaxRows = 128;         // candidate rows (threads) per block

__host__ __device__ inline size_t beam_smem_bytes(int d, int rows) {
  // the query row, the candidate rows at an odd stride (no bank conflicts
  // when each thread walks its own row), one value per row
  return sizeof(float) *
         ((size_t)d + (size_t)rows * (d + 1) + (size_t)rows);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kMaxRows)
beam_scan_kernel(const float* __restrict__ q, const float* __restrict__ table,
                 const int32_t* __restrict__ ids,
                 const int32_t* __restrict__ bounds, float* __restrict__ out,
                 int n_rows, int d, int cpad, bool vec4) {
  extern __shared__ float4 smem4[];
  __shared__ int sid[kMaxRows];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = blockDim.x;
  const int stride = d + 1;
  float* sq = smem;                               // [d]
  float* sy = sq + d;                             // [rows][d + 1]
  float* sv = sy + (size_t)rows * stride;         // [rows]

  const long long b = blockIdx.x;                 // query
  const int c0 = blockIdx.y * rows;               // first candidate
  const int t = threadIdx.x;
  const int nr = min(rows, cpad - c0);            // a multiple of kSub
  const int lo = bounds[2 * b];
  const int hi = bounds[2 * b + 1];

  for (int c = t; c < d; c += rows) sq[c] = bf16_round(q[b * d + c]);
  sid[t] = t < nr ? ids[b * cpad + c0 + t] : -1;
  __syncthreads();

  // consecutive threads load consecutive features of a row (coalesced), 16
  // bytes each where d and the table's alignment allow: at d = 96 this
  // measured ~2.8x faster than 4-byte loads on random rows
  if (vec4) {
    const int d4 = d / 4;
    for (int i = t; i < nr * d4; i += rows) {
      const int r = i / d4, c = 4 * (i - r * d4);
      const int id = sid[r];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (id >= 0 && id < n_rows) {
        v = *reinterpret_cast<const float4*>(table + (long long)id * d + c);
      }
      float* dst = sy + r * stride + c;
      dst[0] = bf16_round(v.x);
      dst[1] = bf16_round(v.y);
      dst[2] = bf16_round(v.z);
      dst[3] = bf16_round(v.w);
    }
  } else {
    for (int i = t; i < nr * d; i += rows) {
      const int r = i / d, c = i - r * d;
      const int id = sid[r];
      sy[r * stride + c] = (id >= 0 && id < n_rows)
                               ? bf16_round(table[(long long)id * d + c])
                               : 0.f;
    }
  }
  __syncthreads();

  if (t < nr) {
    const float* y = sy + t * stride;
    float dot = 0.f, yn = 0.f, qn = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qv = sq[c];
      const float yv = y[c];
      dot += qv * yv;
      yn += yv * yv;
      qn += qv * qv;
    }
    sv[t] = (qn + yn) - 2.f * dot;
  }
  __syncthreads();

  if (t < nr / kSub) {
    float v[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) v[r] = sv[t * kSub + r];
    out[b * (cpad / kSub) + c0 / kSub + t] =
        scan_core::masked_subchunk_min(v, c0 + t * kSub, lo, hi);
  }
}

// Rows per block: the largest of 128, 64, 32 whose shared memory fits a
// block beside the static id array; 0 when none does.
int rows_per_block(int d) {
  for (int rows = kMaxRows; rows >= 32; rows /= 2) {
    if (beam_smem_bytes(d, rows) + sizeof(int) * kMaxRows <= 232448) {
      return rows;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// q (nq, d) f32, table (n_rows, d) f32, ids (nq, cpad) int32, bounds (nq, 2)
// int32, out (nq, cpad/8) f32, all contiguous; cpad a positive multiple of 8.
int raft_beam_scan_subchunk_min(const void* q, const void* table,
                                const void* ids, const void* bounds, void* out,
                                int nq, int n_rows, int d, int cpad,
                                void* stream) {
  const int rows = rows_per_block(d);
  if (nq < 1 || n_rows < 1 || d < 1 || cpad < kSub || cpad % kSub ||
      rows == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(nq, (cpad + rows - 1) / rows);
  if (grid.y > scan_core::kMaxGridYZ) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = beam_smem_bytes(d, rows);
  cudaError_t err = cudaFuncSetAttribute(
      beam_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_scan_kernel<<<grid, rows, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(table),
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(bounds),
      static_cast<float*>(out), n_rows, d, cpad,
      d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0);
  return (int)cudaGetLastError();
}

// Candidate rows (threads) per block at feature width d; 0 = unsupported.
int raft_beam_scan_rows_per_block(int d) { return rows_per_block(d); }

// Dynamic shared memory one block needs at feature width d.
long long raft_beam_scan_smem_bytes(int d) {
  return (long long)beam_smem_bytes(d, rows_per_block(d));
}

const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
