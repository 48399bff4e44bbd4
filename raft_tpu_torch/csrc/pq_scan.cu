// IVF-PQ ADC sub-chunk-min scan for Hopper (sm_90a).
//
// Replaces the TPU kernel pq_adc_subchunk_min
// (raft_tpu/spatial/ann/pq_kernel.py:107), which runs through the shared
// Pallas scan scan_core.subchunk_scan (raft_tpu/spatial/ann/scan_core.py:211).
//
// One launch scans every list of a chunk of a grouped-search batch. For list
// b, query slot s and 8-row sub-chunk j of the list's code window,
//   out[b, s, j] = min over r in 8j..8j+7 of
//                  sum_m luts[lut_map[b, s], m*K + codes[origin[b] + r, m]]
// over bf16 LUT rows (n_luts, M*K) and the index's uint8 codes (rows, M),
// read in place by window origin: each entry widened to f32 and added over
// m = 0..M-1 in ascending order, one rounded f32 add per term, from 0. Rows
// outside the list's [lo, hi) (relative to its origin) score BIG; a slot
// whose map entry is outside [0, n_luts) (-1: a dead slot) scores BIG. The
// plain PyTorch version adds in the same order, so the two agree bitwise on
// any input.
//
// Design: the TPU kernel spells the byte-indexed lookup as a one-hot MXU
// contraction because Mosaic had no dynamic gather; here it is a gather from
// LUT rows held in shared memory. The grid is (query tiles, lists); a block
// stages the LUT rows of its S live slots once (16-byte cp.async copies),
// then walks the 256-row code tiles of the window that meet [lo, hi),
// staging each tile's codes transposed to [m][row] so that a lane reads the
// 8 codes of its sub-chunk as one 8-byte word. A block with no live slot, or
// whose window misses [lo, hi), writes BIG and reads nothing.
//
// Lanes and banks: a warp's 32 lanes are S slots x 32/S sub-chunks, slot
// fastest, so the S lanes of one sub-chunk look up the SAME code in S
// different LUT rows. Each LUT row is padded to a word stride of 32/S modulo
// 32, which puts those S lookups on S distinct banks; only the 32/S
// sub-chunks of a warp draw their codes at random. With S = 8 a lookup
// instruction meets 4 random codes instead of 32 (the natural layout with a
// lane per sub-chunk, whose random bank hits cost ~3.5 wavefronts). S is the
// largest power of two up to 8 whose LUT rows fit beside a code tile, capped
// by the slot count; at S = 1 the layout is the natural one.
//
// What bounds it on the H100: the bytes are the live pairs' LUT rows
// (M*K*2 each), the codes of the live lists' [lo, hi) rows and the minima;
// the work is M lookups and adds per (live slot, row), shared-memory bound
// well under the byte time at the path's shapes. A chunk of lists is one
// launch, so a batch costs a few launches instead of one per 8-list block.
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): 32 registers, no spills; 104,576
// bytes of dynamic shared memory at S = 8, M = 24, K = 256 (two blocks an
// SM).

#include "scan_core.cuh"

namespace {

using scan_core::kBig;
using scan_core::kSub;
constexpr int kPqRowTile = 256;             // rows per code tile: 32 sub-chunks
constexpr int kPqMaxSlots = 8;              // slots per block (S)
constexpr size_t kSmemLimit = 232448;       // shared memory one block may use

// 32-bit words per staged LUT row: 16-byte rows at a stride of 32/S mod 32
__host__ __device__ inline int lut_stride_words(int mk, int slots) {
  int w = ((mk + 1) / 2 + 3) / 4 * 4;
  w += (32 / slots - w % 32 + 64) % 32;
  return w;
}

__host__ __device__ inline size_t pq_smem_bytes(int slots, int m_dim,
                                                int k_dim) {
  return (size_t)slots * lut_stride_words(m_dim * k_dim, slots) * 4 +
         (size_t)m_dim * kPqRowTile;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kPqMaxSlots)
pq_lists_kernel(const __nv_bfloat16* __restrict__ luts,
                const int32_t* __restrict__ lut_map,
                const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ origins,
                const int32_t* __restrict__ bounds, float* __restrict__ out,
                int q_slots, int n_luts, int m_dim, int k_dim, int l_pad,
                int slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sid[kPqMaxSlots];
  const int mk = m_dim * k_dim;
  const int sw = lut_stride_words(mk, slots);
  __nv_bfloat16* slut = reinterpret_cast<__nv_bfloat16*>(smem);  // [S][2 sw]
  uint8_t* scode = smem + (size_t)slots * sw * 4;  // [m_dim][kPqRowTile]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * slots;
  const int t = threadIdx.x;
  const int nthr = 32 * slots;
  const int lo = bounds[2 * b];
  const int hi = bounds[2 * b + 1];
  const int r_beg = max(lo, 0);
  const int r_end = min(hi, l_pad);
  const int nsc = l_pad / kSub;

  int live = 0;
  if (t < slots) {
    int id = -1;
    if (q0 + t < q_slots) {
      const int v = lut_map[(long long)b * q_slots + q0 + t];
      if (v >= 0 && v < n_luts) id = v;
    }
    sid[t] = id;
    live = id >= 0;
  }
  const bool any = __syncthreads_or(live) && r_beg < r_end;

  const int s = t % slots;          // this thread's slot ...
  const int jl = t / slots;         // ... and sub-chunk of each code tile
  const bool slot_ok = q0 + s < q_slots;
  float* orow = out + ((long long)b * q_slots + q0 + s) * nsc;
  const int id = any ? sid[s] : -1;
  const int tb = any ? r_beg / kPqRowTile : 0;
  const int te = any ? (r_end - 1) / kPqRowTile + 1 : 0;
  if (slot_ok) {
    for (int j = jl; j < nsc; j += 32) {
      const int tile = j / (kPqRowTile / kSub);
      if (id < 0 || tile < tb || tile >= te) orow[j] = kBig;
    }
  }
  if (!any) return;

  // the LUT rows of the live slots, copied once
  if constexpr (kVec) {
    const int cpr = mk / 8;
    for (int i = t; i < slots * cpr; i += nthr) {
      const int ss = i / cpr, c = i - ss * cpr;
      const int sl = sid[ss];
      if (sl >= 0) {
        cp_async16(slut + (size_t)ss * sw * 2 + c * 8,
                   luts + (long long)sl * mk + c * 8);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = t; i < slots * mk; i += nthr) {
      const int ss = i / mk, c = i - ss * mk;
      const int sl = sid[ss];
      if (sl >= 0) slut[(size_t)ss * sw * 2 + c] = luts[(long long)sl * mk + c];
    }
  }

  const long long org = origins[b];
  const __nv_bfloat16* lq = slut + (size_t)s * sw * 2;
  for (int tile = tb; tile < te; ++tile) {
    const int l0 = tile * kPqRowTile;
    __syncthreads();  // the previous tile's codes are read
    for (int r = t; r < kPqRowTile; r += nthr) {
      const int l = l0 + r;
      if (l < l_pad) {
        const uint8_t* src = codes + (org + l) * m_dim;
        for (int m = 0; m < m_dim; ++m) scode[m * kPqRowTile + r] = src[m];
      }
    }
    if constexpr (kVec) asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    const int lc = l0 + jl * kSub;    // first row of this thread's sub-chunk
    if (id < 0 || lc >= l_pad) continue;
    float acc[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) acc[r] = 0.f;
    for (int m = 0; m < m_dim; ++m) {
      const uint2 c8 =
          *reinterpret_cast<const uint2*>(scode + m * kPqRowTile + jl * kSub);
      const __nv_bfloat16* lm = lq + m * k_dim;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r] = __fadd_rn(acc[r], __bfloat162float(lm[(c8.x >> (8 * r)) & 0xff]));
        acc[r + 4] =
            __fadd_rn(acc[r + 4], __bfloat162float(lm[(c8.y >> (8 * r)) & 0xff]));
      }
    }
    orow[lc / kSub] = scan_core::masked_subchunk_min(acc, lc, lo, hi);
  }
}

}  // namespace

extern "C" {

// Slots per block (S) for Q slots at (m_dim, k_dim): the largest power of
// two up to 8, and up to Q rounded up to a power of two, whose LUT rows fit
// beside a code tile; 0 when not even one query's LUT fits.
int raft_pq_lists_slots(int q_slots, int m_dim, int k_dim) {
  if (q_slots < 1 || m_dim < 1 || k_dim < 1) return 0;
  int s = 1;
  while (s < kPqMaxSlots && s < q_slots) s *= 2;
  while (s > 0 && pq_smem_bytes(s, m_dim, k_dim) > kSmemLimit) s /= 2;
  return s;
}

// Dynamic shared memory one block needs at S slots.
long long raft_pq_lists_smem_bytes(int slots, int m_dim, int k_dim) {
  return (long long)pq_smem_bytes(slots, m_dim, k_dim);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// luts (n_luts, m_dim * k_dim) bf16 contiguous (may be empty); lut_map
// (n_lists, q_slots) int32, an entry outside [0, n_luts) marking a dead
// slot; codes (*, m_dim) uint8 contiguous, list b's window being code rows
// origins[b] .. origins[b] + l_pad - 1 (all in range); origins (n_lists,)
// int32; bounds (n_lists, 2) int32, [lo, hi) relative to the origin; out
// (n_lists, q_slots, l_pad/8) f32 contiguous. k_dim <= 256, l_pad a multiple
// of 8.
int raft_pq_adc_lists(const void* luts, const void* lut_map,
                      const void* codes, const void* origins,
                      const void* bounds, void* out, int n_lists, int q_slots,
                      int n_luts, int m_dim, int k_dim, int l_pad,
                      void* stream) {
  if (n_lists < 1 || q_slots < 1 || n_luts < 0 || m_dim < 1 || k_dim < 1 ||
      k_dim > 256 || l_pad < kSub || l_pad % kSub) {
    return (int)cudaErrorInvalidValue;
  }
  const int slots = raft_pq_lists_slots(q_slots, m_dim, k_dim);
  if (slots < 1) return (int)cudaErrorInvalidValue;
  if (n_lists > scan_core::kMaxGridYZ) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((q_slots + slots - 1) / slots, n_lists);
  const size_t smem = pq_smem_bytes(slots, m_dim, k_dim);
  const int mk = m_dim * k_dim;
  const bool vec =
      mk % 8 == 0 && reinterpret_cast<uintptr_t>(luts) % 16 == 0;
  auto kernel = vec ? pq_lists_kernel<true> : pq_lists_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * slots, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(luts),
      static_cast<const int32_t*>(lut_map),
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(origins),
      static_cast<const int32_t*>(bounds), static_cast<float*>(out), q_slots,
      n_luts, m_dim, k_dim, l_pad, slots);
  return (int)cudaGetLastError();
}

const char* raft_pq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
