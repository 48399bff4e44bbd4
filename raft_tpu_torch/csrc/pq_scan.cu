// IVF-PQ on Hopper (sm_90a): the ADC sub-chunk-min scan (#4) and, below it,
// the live-pair ADC table build that feeds it. One library, loaded once.
//
// ---- The ADC scan ----
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

#include <algorithm>

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

// ---- The live-pair ADC table build ----
//
// Replaces no TPU kernel: the JAX package builds its LUTs in jnp and XLA
// fuses them. Here the plain PyTorch chain (an einsum, then f32 passes for
// the norms, the sum, the difference and the bf16 cast) wrote ~67 GB a
// 10,000-query DEEP-10M batch at M*K = 24 x 256 to keep the 3.93 GB of bf16
// rows the scan reads; this kernel writes each bf16 row once and nothing
// else.
//
// For pair i (list l = pair_lists[i], query q = pair_qids[i]), subspace m
// (columns m*ds .. m*ds+ds-1) and codebook entry k:
//   r_j = Q[q, m*ds+j] - C[l, m*ds+j]
//   n   = r_0*r_0, then n = n + r_j*r_j    (j = 1 .. ds-1, ascending)
//   g   = r_0*B[m,k,0], then g = g + r_j*B[m,k,j]   (ascending)
//   out[i, m*K+k] = bf16_rn((n + B_n[m,k]) - 2*g)
// every product and sum one rounded f32 operation (__fmul_rn / __fadd_rn /
// __fsub_rn, no FMA contraction). The plain PyTorch version
// (pq_kernel.pq_lut_rows_plain) computes in the same order with separate
// tensor ops, so the two agree bitwise on any input.
//
// What bounds it on the H100: the 2*M*K bytes written per pair (134 MB for
// a chunk of 10,922 pairs at M*K = 6,144: 0.040 ms at 3.35 TB/s). The
// inputs (queries, centroids, codebooks) are a few MB and stay in L2; the
// arithmetic is ~2*ds+3 f32 operations an entry, under the write time.
//
// Design: a block owns a run of whole subspaces (grid y) and walks tiles of
// up to kLutMaxPairs pairs (grid x is one wave of resident blocks, so no
// partial last wave idles the card: with the streaming stores, 0.0821 ->
// 0.0612 ms at the chunk shape on the H100, 50% -> 68% of the bound). Each thread owns 8 consecutive k of
// one subspace and holds those codebook entries and norms in registers
// for every tile. For each tile the block stages the pairs' residuals and
// per-subspace norms in shared memory (one thread per (pair, subspace), so
// each norm is summed once), then each thread emits one 16-byte streaming
// store of 8 bf16 entries per pair, neighbouring threads on neighbouring
// addresses: a warp writes 512 contiguous bytes of a row per pair. That
// path takes K % 8 == 0 and ds <= 8 (the DEEP cells run K = 256, ds = 4);
// any other shape runs a plain kernel of one thread per entry, same order,
// same result.
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): lut_rows_kernel<4> 76 registers, no
// spills, 1,280 bytes of dynamic shared memory at M = 24, K = 256 (three
// blocks an SM); <1>..<8> 48..122 registers; lut_rows_any_kernel 32.

constexpr int kLutThreads = 256;        // threads per block at most
constexpr int kLutMaxPairs = 8;         // pairs per tile at most
constexpr int kLutMaxDs = 8;            // widest subspace held in registers
constexpr int kLutStageBytes = 24576;   // staged residuals and norms a block

template <int DS>
__global__ void __launch_bounds__(kLutThreads)
lut_rows_kernel(const float* __restrict__ queries,
                const float* __restrict__ cents, const float* __restrict__ cb,
                const float* __restrict__ cb_n,
                const int64_t* __restrict__ pair_lists,
                const int64_t* __restrict__ pair_qids,
                __nv_bfloat16* __restrict__ out, int n_pairs, int d,
                int m_dim, int k_dim, int m_per_block, int pairs_per_tile) {
  extern __shared__ __align__(16) float lsm[];
  float* sres = lsm;                                      // [TP][MB][DS]
  float* snorm = lsm + pairs_per_tile * m_per_block * DS;  // [TP][MB]
  const int g8 = k_dim / 8;            // threads per subspace
  const int m0 = blockIdx.y * m_per_block;
  const int mb = min(m_per_block, m_dim - m0);
  const int n_tiles = (n_pairs + pairs_per_tile - 1) / pairs_per_tile;
  const int t = threadIdx.x;

  // this thread's 8 codebook entries and norms, held for every tile
  const int ml = t / g8;
  const int m = m0 + ml;
  const int k0 = (t - ml * g8) * 8;
  const bool active = ml < mb;
  float b[8][DS], bn[8];
  if (active) {
    const float* bsrc = cb + ((long long)m * k_dim + k0) * DS;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int j = 0; j < DS; ++j) b[e][j] = bsrc[e * DS + j];
      bn[e] = cb_n[(long long)m * k_dim + k0 + e];
    }
  }

  const long long pitch = (long long)m_dim * k_dim;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * pairs_per_tile;
    const int tp = (int)min((long long)pairs_per_tile, n_pairs - p0);
    __syncthreads();  // the previous tile's residuals are read
    for (int i = t; i < tp * mb; i += blockDim.x) {
      const int p = i / mb, ms = i - p * mb;
      const float* qv = queries + pair_qids[p0 + p] * d + (m0 + ms) * DS;
      const float* cv = cents + pair_lists[p0 + p] * d + (m0 + ms) * DS;
      float* rv = sres + (p * m_per_block + ms) * DS;
      float n = 0.f;
#pragma unroll
      for (int j = 0; j < DS; ++j) {
        const float r = __fsub_rn(qv[j], cv[j]);
        rv[j] = r;
        n = j == 0 ? __fmul_rn(r, r) : __fadd_rn(n, __fmul_rn(r, r));
      }
      snorm[p * m_per_block + ms] = n;
    }
    __syncthreads();
    if (!active) continue;

    __nv_bfloat16* orow = out + p0 * pitch + (long long)m * k_dim + k0;
    for (int p = 0; p < tp; ++p) {
      const float* rv = sres + (p * m_per_block + ml) * DS;
      float r[DS];
#pragma unroll
      for (int j = 0; j < DS; ++j) r[j] = rv[j];
      const float n = snorm[p * m_per_block + ml];
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float g = __fmul_rn(r[0], b[e + h][0]);
#pragma unroll
          for (int j = 1; j < DS; ++j) {
            g = __fadd_rn(g, __fmul_rn(r[j], b[e + h][j]));
          }
          v[h] = __fsub_rn(__fadd_rn(n, bn[e + h]), __fmul_rn(2.f, g));
        }
        const __nv_bfloat162 pr = __floats2bfloat162_rn(v[0], v[1]);
        w[e / 2] = *reinterpret_cast<const uint32_t*>(&pr);
      }
      // a streaming store: the rows are written once and read once, by
      // the scan, from device memory (a chunk's rows outgrow L2)
      __stcs(reinterpret_cast<uint4*>(orow + p * pitch),
             make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

// Any K and ds: one thread per entry, the same order.
__global__ void __launch_bounds__(kLutThreads)
lut_rows_any_kernel(const float* __restrict__ queries,
                    const float* __restrict__ cents,
                    const float* __restrict__ cb,
                    const float* __restrict__ cb_n,
                    const int64_t* __restrict__ pair_lists,
                    const int64_t* __restrict__ pair_qids,
                    __nv_bfloat16* __restrict__ out, long long n_entries,
                    int d, int m_dim, int k_dim, int ds) {
  const long long mk = (long long)m_dim * k_dim;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_entries; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / mk;
    const int c = (int)(e - i * mk);
    const int m = c / k_dim;
    const float* qv = queries + pair_qids[i] * d + m * ds;
    const float* cv = cents + pair_lists[i] * d + m * ds;
    const float* bv = cb + (long long)c * ds;
    float n = 0.f, g = 0.f;
    for (int j = 0; j < ds; ++j) {
      const float r = __fsub_rn(qv[j], cv[j]);
      const float rr = __fmul_rn(r, r), rb = __fmul_rn(r, bv[j]);
      n = j == 0 ? rr : __fadd_rn(n, rr);
      g = j == 0 ? rb : __fadd_rn(g, rb);
    }
    out[e] = __float2bfloat16_rn(__fsub_rn(__fadd_rn(n, cb_n[c]),
                                           __fmul_rn(2.f, g)));
  }
}

template <int DS>
cudaError_t launch_lut_rows(const float* queries, const float* cents,
                            const float* cb, const float* cb_n,
                            const int64_t* pair_lists,
                            const int64_t* pair_qids, __nv_bfloat16* out,
                            int n_pairs, int d, int m_dim, int k_dim,
                            cudaStream_t stream) {
  const int g8 = k_dim / 8;
  const int mb = std::min(m_dim, kLutThreads / g8);
  const int tp = std::max(1, std::min(kLutMaxPairs,
                                      kLutStageBytes / (mb * (DS + 1) * 4)));
  const int threads = mb * g8;
  const size_t smem = (size_t)tp * mb * (DS + 1) * sizeof(float);
  const int col_tiles = (m_dim + mb - 1) / mb;
  if (col_tiles > scan_core::kMaxGridYZ) return cudaErrorInvalidConfiguration;
  // one wave of resident blocks walks the pair tiles: a block loads its
  // codebook entries once, and no partial last wave idles the card
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lut_rows_kernel<DS>, threads, smem);
  }
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_pairs + tp - 1) / tp;
  const int wave = std::max(1, sms * per_sm / col_tiles);
  const dim3 grid(std::min(n_tiles, wave), col_tiles);
  lut_rows_kernel<DS><<<grid, threads, smem, stream>>>(
      queries, cents, cb, cb_n, pair_lists, pair_qids, out, n_pairs, d,
      m_dim, k_dim, mb, tp);
  return cudaGetLastError();
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

// Launch the ADC table build on `stream`; returns cudaGetLastError() after
// the launch (0 = ok). queries (*, d), cents (*, d), cb (m_dim, k_dim, ds)
// and cb_n (m_dim, k_dim) f32 contiguous; pair_lists and pair_qids
// (n_pairs,) int64, every id a row of cents / queries; out (n_pairs,
// m_dim * k_dim) bf16 contiguous. d == m_dim * ds, k_dim <= 256.
int raft_pq_lut_rows(const void* queries, const void* cents, const void* cb,
                     const void* cb_n, const void* pair_lists,
                     const void* pair_qids, void* out, int n_pairs, int d,
                     int m_dim, int k_dim, int ds, void* stream) {
  if (n_pairs < 1 || m_dim < 1 || k_dim < 1 || k_dim > 256 || ds < 1 ||
      d != m_dim * ds) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* q = static_cast<const float*>(queries);
  const auto* c = static_cast<const float*>(cents);
  const auto* b = static_cast<const float*>(cb);
  const auto* bn = static_cast<const float*>(cb_n);
  const auto* pl = static_cast<const int64_t*>(pair_lists);
  const auto* pq = static_cast<const int64_t*>(pair_qids);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const auto st = (cudaStream_t)stream;
  if (k_dim % 8 == 0 && ds <= kLutMaxDs &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    switch (ds) {
#define RAFT_LUT_CASE(n)                                                  \
  case n:                                                                 \
    return (int)launch_lut_rows<n>(q, c, b, bn, pl, pq, o, n_pairs, d,    \
                                   m_dim, k_dim, st);
      RAFT_LUT_CASE(1) RAFT_LUT_CASE(2) RAFT_LUT_CASE(3) RAFT_LUT_CASE(4)
      RAFT_LUT_CASE(5) RAFT_LUT_CASE(6) RAFT_LUT_CASE(7) RAFT_LUT_CASE(8)
#undef RAFT_LUT_CASE
    }
  }
  const long long n_entries = (long long)n_pairs * m_dim * k_dim;
  const long long blocks =
      std::min<long long>((n_entries + kLutThreads - 1) / kLutThreads, 1 << 20);
  lut_rows_any_kernel<<<(unsigned)blocks, kLutThreads, 0, st>>>(
      q, c, b, bn, pl, pq, o, n_entries, d, m_dim, k_dim, ds);
  return (int)cudaGetLastError();
}

const char* raft_pq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
