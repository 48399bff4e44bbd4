// IVF-PQ ADC sub-chunk-min scan for Hopper (sm_90a).
//
// Replaces the TPU kernel pq_adc_subchunk_min
// (raft_tpu/spatial/ann/pq_kernel.py:107), which runs through the shared
// Pallas scan scan_core.subchunk_scan (raft_tpu/spatial/ann/scan_core.py:211).
//
// Computes, for every list b, query slot q and 8-row sub-chunk j of the code
// slab,
//   out[b, q, j] = min over r in 8j..8j+7 of sum_m lut[b, q, m*K + code[b, m, r]]
// over a bf16 LUT (LB, Q, M*K) and uint8 codes (LB, M, Lpad): each entry
// widened to f32 and summed over m = 0..M-1 in ascending order, one rounded
// f32 add per term, starting from 0. Rows outside [lo, hi) score BIG. The
// plain PyTorch version adds in the same order, so the two agree bitwise on
// any input.
//
// Design: the TPU kernel spells the byte-indexed lookup as a one-hot MXU
// contraction because Mosaic had no dynamic gather. Here it is a gather
// from the LUT held in shared memory. A block stages the LUT rows of its
// query tile (16-byte copies where the width allows) and the codes of a
// 256-row tile, then each lane of a warp owns one 8-row sub-chunk of one
// query: per subspace it reads its 8 codes as one 8-byte word and adds the 8
// LUT entries they select. One query's LUT is M*K*2 bytes (12 KB at M = 24,
// K = 256), so the whole Q-slot LUT of a list may not fit the 227 KB a block
// can use: the wrapper tiles the query axis into the largest balanced tiles
// that fit (grid.y), re-staging the code tile once per query tile.
//
// What bounds it on the H100: the bytes are the LUT (LB*Q*M*K*2) plus the
// codes and the minima, about a microsecond at the path's shapes, and the
// work is M table lookups per (query, row); at those shapes one launch is
// dominated by its fixed launch and staging costs, not by either bound. The
// random LUT reads of a warp's 32 lanes fall on shared-memory banks at
// random and conflict; that is left for a later version (a bank-spread LUT
// layout, or lanes that share codes).

#include "scan_core.cuh"

namespace {

using scan_core::kSub;
constexpr int kPqRowTile = 256;             // rows per block: a sub-chunk per lane
constexpr int kPqWarps = 8;                 // warp w runs query slots w, w + 8, ...
constexpr int kPqThreads = 32 * kPqWarps;
constexpr size_t kSmemLimit = 232448;       // shared memory one block may use

__host__ __device__ inline size_t lut_bytes(int qtile, int mk) {
  return ((size_t)qtile * mk * 2 + 15) / 16 * 16;  // code tile 16-byte aligned
}

__host__ __device__ inline size_t pq_smem_bytes(int qtile, int m_dim,
                                                int k_dim) {
  return lut_bytes(qtile, m_dim * k_dim) + (size_t)m_dim * kPqRowTile;
}

__global__ void __launch_bounds__(kPqThreads)
pq_adc_kernel(const __nv_bfloat16* __restrict__ luts,
              const uint8_t* __restrict__ codes,
              const int32_t* __restrict__ bounds, float* __restrict__ out,
              int nq, int m_dim, int k_dim, int lpad, int qtile, int vec,
              long long sb, long long sm, long long sl) {
  extern __shared__ float4 smem4[];
  const int mk = m_dim * k_dim;
  __nv_bfloat16* slut = reinterpret_cast<__nv_bfloat16*>(smem4);  // [qtile][mk]
  uint8_t* scode = reinterpret_cast<uint8_t*>(smem4) + lut_bytes(qtile, mk);
  // scode: [m_dim][kPqRowTile]

  const int b = blockIdx.z;
  const int q0 = blockIdx.y * qtile;
  const int l0 = blockIdx.x * kPqRowTile;
  const int t = threadIdx.x;
  const int nqt = min(qtile, nq - q0);

  // the tile's LUT rows are contiguous in the (LB, Q, M*K) array
  const __nv_bfloat16* lsrc = luts + ((long long)b * nq + q0) * mk;
  const long long n_lut = (long long)nqt * mk;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(lsrc);
    uint4* d4 = reinterpret_cast<uint4*>(slut);
    for (long long i = t; i < n_lut / 8; i += kPqThreads) d4[i] = s4[i];
  } else {
    for (long long i = t; i < n_lut; i += kPqThreads) slut[i] = lsrc[i];
  }
  const uint8_t* cb = codes + (long long)b * sb;
  for (int i = t; i < kPqRowTile * m_dim; i += kPqThreads) {
    const int r = i / m_dim, m = i - r * m_dim;  // m fastest: coalesced when sm == 1
    const int l = l0 + r;
    scode[m * kPqRowTile + r] = l < lpad ? cb[m * sm + (long long)l * sl] : 0;
  }
  __syncthreads();

  const int lane = t & 31;
  const int lc = l0 + lane * kSub;        // first row of this lane's sub-chunk
  if (lc >= lpad) return;
  const int lo = bounds[2 * b];
  const int hi = bounds[2 * b + 1];
  const int nsc = lpad / kSub;
  for (int qi = t >> 5; qi < nqt; qi += kPqWarps) {
    const __nv_bfloat16* lq = slut + (size_t)qi * mk;
    float acc[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) acc[r] = 0.f;
    for (int m = 0; m < m_dim; ++m) {
      const uint2 c8 =
          *reinterpret_cast<const uint2*>(scode + m * kPqRowTile + lane * kSub);
      const __nv_bfloat16* lm = lq + m * k_dim;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r] = __fadd_rn(acc[r], __bfloat162float(lm[(c8.x >> (8 * r)) & 0xff]));
        acc[r + 4] =
            __fadd_rn(acc[r + 4], __bfloat162float(lm[(c8.y >> (8 * r)) & 0xff]));
      }
    }
    out[((long long)b * nq + q0 + qi) * nsc + lc / kSub] =
        scan_core::masked_subchunk_min(acc, lc, lo, hi);
  }
}

}  // namespace

extern "C" {

// Largest query tile whose LUT rows and code tile fit one block's shared
// memory at (m_dim, k_dim); 0 when not even one query's LUT fits.
int raft_pq_adc_max_qtile(int m_dim, int k_dim) {
  if (m_dim < 1 || k_dim < 1) return 0;
  const size_t codes = (size_t)m_dim * kPqRowTile;
  if (codes >= kSmemLimit) return 0;
  int q = (int)((kSmemLimit - codes) / ((size_t)m_dim * k_dim * 2));
  while (q > 0 && pq_smem_bytes(q, m_dim, k_dim) > kSmemLimit) --q;
  return q;
}

// Dynamic shared memory one block needs at a query tile of qtile slots.
long long raft_pq_adc_smem_bytes(int qtile, int m_dim, int k_dim) {
  return (long long)pq_smem_bytes(qtile, m_dim, k_dim);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// luts (lb, nq, m_dim * k_dim) bf16 contiguous; codes (lb, m_dim, lpad)
// uint8 with element strides (sb, sm, sl); bounds (lb, 2) int32 contiguous;
// out (lb, nq, lpad/8) f32 contiguous. k_dim <= 256 and lpad a multiple of
// 8. The query axis is tiled into the largest balanced tiles that fit.
int raft_pq_adc_subchunk_min(const void* luts, const void* codes,
                             const void* bounds, void* out, int lb, int nq,
                             int m_dim, int k_dim, int lpad, long long sb,
                             long long sm, long long sl, void* stream) {
  if (lb < 1 || nq < 1 || m_dim < 1 || k_dim < 1 || k_dim > 256 ||
      lpad < kSub || lpad % kSub) {
    return (int)cudaErrorInvalidValue;
  }
  const int qmax = raft_pq_adc_max_qtile(m_dim, k_dim);
  if (qmax < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (nq + qmax - 1) / qmax;
  const int qtile = (nq + n_tiles - 1) / n_tiles;
  dim3 grid;
  cudaError_t err =
      scan_core::scan_grid(lb, nq, lpad, kPqRowTile, qtile, &grid);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = pq_smem_bytes(qtile, m_dim, k_dim);
  err = cudaFuncSetAttribute(pq_adc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int mk = m_dim * k_dim;
  const int vec = mk % 8 == 0 && reinterpret_cast<uintptr_t>(luts) % 16 == 0;
  pq_adc_kernel<<<grid, kPqThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(luts),
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(bounds),
      static_cast<float*>(out), nq, m_dim, k_dim, lpad, qtile, vec, sb, sm,
      sl);
  return (int)cudaGetLastError();
}

const char* raft_pq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
