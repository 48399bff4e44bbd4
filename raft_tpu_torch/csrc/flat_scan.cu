// Flat and IVF-SQ sub-chunk-min scans for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces the TPU kernels flat_scan_subchunk_min
// (raft_tpu/spatial/ann/flat_kernel.py:115) and sq_scan_subchunk_min
// (raft_tpu/spatial/ann/sq_kernel.py:114), which run through the shared
// Pallas scan scan_core.subchunk_scan (raft_tpu/spatial/ann/scan_core.py:211).
//
// One launch scans every list of a grouped-search batch. For list b, query
// slot s and 8-row sub-chunk j of the list's window,
//   out[b, s, j] = min over r in 8j..8j+7 of (|q|^2 + |y_r|^2) - 2 q.y_r
// where q = queries[qmat[b, s]] and y_r = rows[origin[b] + r]: query rows are
// read by id and slab rows in place from the index's row-major bf16 rows, so
// no (lists, Lpad, d) slab and no (lists, Q, d) query copy is ever made.
// Rows outside the list's [lo, hi) (relative to its origin) score BIG; a slot
// whose id is outside [0, n_ids) (the sentinel) scores BIG.
//
// Arithmetic: bf16 operands; the dot runs on the tensor cores
// (mma.sync.m16n8k16, bf16 x bf16 -> f32: slab rows on M, query slots on N,
// the feature axis on K, zero-padded to a multiple of 16); the norms are f32
// sums of the squares in ascending feature order on the CUDA cores; the
// formula order is (qn + yn) - 2 * dot. Only the dot's summation order
// differs from the plain version's (scan_core.l2_gram_tile of the port), so
// the two agree bitwise wherever every partial sum is exact in f32 (small
// integer inputs: each bf16 product is exact) and within 1e-5 x (qn + yn)
// elsewhere.
//
// Work skipped: a block whose query tile holds no live slot, or whose 512
// rows lie wholly outside [lo, hi), writes BIG without reading a row; inside
// a live block only the 64-row tiles that meet [lo, hi) are loaded and
// multiplied. At qcap 8 a batch has at most 8 * n_probes live lists, and an
// average list fills a seventh of its window, so most of the grid exits at
// once.
//
// Design against the bound. The bytes these inputs need are the rows in
// [lo, hi) of the live lists, the live query rows and the (lists, Q, Lpad/8)
// minima, at the 3.35 TB/s of device memory; the tensor cores lift the work
// far under that (a 64 x 64 x 96 tile is 786 kflop). So:
//   * grid (512-row groups, query tiles, lists); 4 warps, each owning 16 rows
//     of a 64-row tile and every query slot of the tile;
//   * the query tile is round_up(Q, 8) slots up to 64 (NT = 1..8 n-tiles of
//     8), balanced over grid y past 64, so qcap 8 pays for 8 slots, not 64;
//   * row tiles stream through two shared-memory stages with 16-byte
//     cp.async copies (double-buffered: the next tile lands while this one is
//     multiplied); shared rows are padded to an odd number of 16-byte units
//     so ldmatrix reads them without bank conflicts;
//   * the 8-row min is a butterfly over the 8 lanes that hold a column of the
//     accumulator fragment; a block's minima collect in shared memory and
//     leave as one coalesced write per query slot.
// Widths off the 16-byte grain (d % 8 != 0) load rows with plain loads.
//
// Wide rows (flat_lists_wide_kernel). Two whole-row stages beside the query
// tile stop fitting 227 KB as rows widen: at d = 960 not even a query tile
// of 8 fits, at d = 768 none past 16 slots. Where the resident form does
// not fit (flat_wide: one rule of width and slots, no knob) the wide form
// runs: the query tile stays resident at full width, as many slots as fit
// up to 64 (64 at d <= 960, 48 at 1,536, 32 at 2,048); each 64-row tile
// streams in slices of 256 features through two cp.async stages, and the
// slices' products accumulate in the MMA fragments. The row norms come from
// the tensor cores too: the diagonal of each warp's 16 x 16 Gram tile, two
// MMAs a 16-wide step on the A fragment already loaded. Everything else is
// the resident form's. Integer-exact inputs stay bitwise the plain version;
// elsewhere the norms and the dot are summed in another order, within the
// f32 summation bound. At the GIST-1M cell's launch (1024 lists, Q 632, d
// 960, Lpad 2048) it runs at ~5% of its bound, the tensor cores' work (the
// cell's scan is compute-heavy); a wgmma form is the next step (PERF.md).
//
// IVF-SQ (raft_sq_scan_lists) is the same kernel with an int8 row loader:
// rows are the index's int8 codes, read in place at one byte per element
// (the bytes the scan must move fall by half) and dequantized into the bf16
// stage as y = bf16((code + 128) * vscale + vmin), the multiply and the add
// each rounded on its own (__fmul_rn, __fadd_rn), as sq_kernel._dequant_tile
// of the port rounds them; vmin and vscale stay in shared memory for the
// block. With d % 16 == 0 a tile's codes land in a raw int8 stage by 16-byte
// cp.async, and each thread dequantizes the units it copied itself (so no
// barrier sits between the copy and the dequant); other widths load codes
// with plain loads and dequantize them as they are stored. Everything after
// the stage is the flat scan's.
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): 48 registers at NT 1-3, 56 at NT 4,
// 71-72 at NT 5-8, no spills but 8-16 bytes at NT 7-8 with 16-byte copies;
// one barrier; 57 KB of dynamic shared memory at d = 96 and 64 slots, so
// four blocks share an SM. The SQ loader: 40-72 registers, 4-12 bytes of
// spills at NT 3, 7 and 8 with 16-byte copies (tools/inspect_build.py), one
// more barrier (the stats), 70 KB at d = 96 and 64 slots (three blocks).
// The wide form: 56-96 registers at NT 1-8, no spills, one barrier, 204 KB
// at d = 960 and 64 slots (one block an SM).

#include <type_traits>

#include "scan_core.cuh"

namespace {

using scan_core::kBig;
using scan_core::kSub;

constexpr int kTileRows = 64;                  // rows per pipeline stage
constexpr int kThreads = 128;                  // 4 warps x 16 rows
constexpr int kGroupTiles = 8;                 // tiles per block
constexpr int kGroupRows = kTileRows * kGroupTiles;
constexpr int kGroupSubs = kGroupRows / kSub;  // sub-chunks per block
constexpr int kMaxNT = 8;                      // n-tiles: 64 query slots
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline int k_pad(int d) { return (d + 15) / 16 * 16; }

// bf16 elements per shared row: an odd number of 16-byte units
__host__ __device__ inline int row_stride(int d) { return k_pad(d) + 8; }

__host__ __device__ inline size_t smem_bytes(int d, int q_tile) {
  // query tile and two row stages (bf16), then the block's minima, the
  // query and row norms (f32) and the slot ids
  return 2 * (size_t)row_stride(d) * (q_tile + 2 * kTileRows) +
         4 * ((size_t)q_tile * kGroupSubs + q_tile + kTileRows + q_tile);
}

// Query slots per block for Q slots: round_up(ceil(Q / tiles), 8) over the
// fewest tiles of at most 64 slots.
inline int q_tile_of(int q_slots) {
  if (q_slots < 1) return 0;
  const int tiles = (q_slots + 8 * kMaxNT - 1) / (8 * kMaxNT);
  return ((q_slots + tiles - 1) / tiles + 7) / 8 * 8;
}

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) / 16 * 16; }

// The SQ loader's extra shared memory after the flat layout: vmin and
// vscale (f32), then two raw int8 row stages.
__host__ __device__ inline size_t sq_smem_bytes(int d, int q_tile) {
  return smem_bytes(d, q_tile) + round16(8 * (size_t)d) +
         2 * kTileRows * round16((size_t)d);
}

// The wide form (flat_lists_wide_kernel): rows stream in slices of
// kSliceK features through kStages stages of 64 rows (double-buffered;
// rows of an odd number of 16-byte units), beside the full-width query
// tile.
constexpr int kSliceK = 256;
constexpr int kSliceStride = kSliceK + 8;
constexpr int kStages = 2;

__host__ __device__ inline size_t wide_smem_bytes(int d, int q_tile) {
  // query tile and the ring (bf16), then the block's minima, the query
  // norms (f32) and the slot ids
  return 2 * (size_t)row_stride(d) * q_tile +
         2 * (size_t)kStages * kTileRows * kSliceStride +
         4 * ((size_t)q_tile * kGroupSubs + 2 * q_tile);
}

// The wide form's query tile cap at width d: the most slots, a multiple of
// 8 up to 64, whose block fits (0 when not even 8 do).
inline int wide_q_cap(int d) {
  int cap = 8 * kMaxNT;
  while (cap > 0 && wide_smem_bytes(d, cap) > kSmemLimit) cap -= 8;
  return cap;
}

// Query slots per block for Q slots at most `cap` a block (a multiple of
// 8): round_up(ceil(Q / tiles), 8) over the fewest tiles.
inline int q_tile_capped(int q_slots, int cap) {
  if (q_slots < 1 || cap < 8) return 0;
  const int tiles = (q_slots + cap - 1) / cap;
  return ((q_slots + tiles - 1) / tiles + 7) / 8 * 8;
}

// The form a flat scan at width d over Q slots launches: the resident
// kernel wherever its whole-row stages fit beside the query tile, the
// wide one otherwise. Sets the query tile and the shared memory.
inline bool flat_wide(int d, int q_slots, int* q_tile, size_t* smem) {
  *q_tile = q_tile_of(q_slots);
  *smem = smem_bytes(d, *q_tile);
  if (*smem <= kSmemLimit) return false;
  *q_tile = q_tile_capped(q_slots, wide_q_cap(d));
  *smem = wide_smem_bytes(d, *q_tile);
  return true;
}

__device__ __forceinline__ __nv_bfloat16 dequant(int code, float vmin,
                                                 float vscale) {
  return __float2bfloat16_rn(__fadd_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(code), 128.f), vscale), vmin));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, rows x k) * b (16 x 8, k x query slots), f32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kVec: 16-byte copies of rows (bf16 rows with d % 8 == 0, int8 codes with
// d % 16 == 0, 16-byte aligned). kInt8: rows are int8 codes dequantized by
// params (vmin[d] then vscale[d]); otherwise bf16 rows and params unused.
template <int NT, bool kVec, bool kInt8>
__global__ void __launch_bounds__(kThreads)
flat_lists_kernel(const __nv_bfloat16* __restrict__ queries,
                  const int32_t* __restrict__ qmat,
                  const std::conditional_t<kInt8, int8_t, __nv_bfloat16>*
                      __restrict__ rows,
                  const int32_t* __restrict__ origins,
                  const int32_t* __restrict__ bounds,
                  const float* __restrict__ params, float* __restrict__ out,
                  int q_slots, int n_ids, int d, int l_pad) {
  constexpr int QT = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int st = row_stride(d);
  const int kp = k_pad(d);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);  // [QT][st]
  __nv_bfloat16* sy = sq + QT * st;               // [2][kTileRows][st]
  float* smin = reinterpret_cast<float*>(sy + 2 * kTileRows * st);
  float* sqn = smin + QT * kGroupSubs;            // [QT]
  float* syn = sqn + QT;                          // [kTileRows]
  int* sid = reinterpret_cast<int*>(syn + kTileRows);  // [QT]
  // SQ only: vmin then vscale, then the raw code stages [2][kTileRows][d]
  float* sprm = reinterpret_cast<float*>(smem + smem_bytes(d, QT));
  int8_t* raw = reinterpret_cast<int8_t*>(smem + smem_bytes(d, QT) +
                                          round16(8 * (size_t)d));

  const int b = blockIdx.z;
  const int q0 = blockIdx.y * QT;
  const int g0 = blockIdx.x * kGroupRows;
  const int t = threadIdx.x;
  const int nsc = l_pad / kSub;
  const int sc0 = g0 / kSub;
  const int n_sub = min(kGroupSubs, nsc - sc0);
  const int lo = bounds[2 * b];
  const int hi = bounds[2 * b + 1];
  const int r_beg = max(lo, g0);
  const int r_end = min(min(hi, l_pad), g0 + kGroupRows);

  int live = 0;
  if (t < QT) {
    int id = -1;
    if (q0 + t < q_slots) {
      const int v = qmat[(long long)b * q_slots + q0 + t];
      if (v >= 0 && v < n_ids) id = v;
    }
    sid[t] = id;
    live = id >= 0;
  }
  if (!__syncthreads_or(live) || r_beg >= r_end) {
    for (int i = t; i < QT * n_sub; i += kThreads) {
      const int s = i / n_sub, j = i - s * n_sub;
      if (q0 + s < q_slots) {
        out[((long long)b * q_slots + q0 + s) * nsc + sc0 + j] = kBig;
      }
    }
    return;
  }

  const long long org = origins[b];
  const int tb = (r_beg - g0) / kTileRows;
  const int te = (r_end - 1 - g0) / kTileRows + 1;
  if constexpr (kInt8) {
    for (int i = t; i < 2 * d; i += kThreads) sprm[i] = params[i];
    __syncthreads();
  }

  auto load_tile = [&](int tt, int buf) {
    const int l0 = g0 + tt * kTileRows;
    __nv_bfloat16* dst = sy + buf * kTileRows * st;
    const auto* src = rows + (org + l0) * d;
    if constexpr (kVec && kInt8) {
      const int cpr = d / 16;
      int8_t* rdst = raw + buf * kTileRows * d;
      for (int i = t; i < kTileRows * cpr; i += kThreads) {
        const int r = i / cpr;
        if (l0 + r < l_pad) cp_async16(rdst + i * 16, src + (long long)i * 16);
      }
      cp_async_commit();
    } else if constexpr (kVec) {
      const int cpr = d / 8;
      for (int i = t; i < kTileRows * cpr; i += kThreads) {
        const int r = i / cpr, c = i - r * cpr;
        if (l0 + r < l_pad) {
          cp_async16(dst + r * st + c * 8, src + (long long)r * d + c * 8);
        }
      }
      cp_async_commit();
    } else {
      for (int i = t; i < kTileRows * d; i += kThreads) {
        const int r = i / d, c = i - r * d;
        if (l0 + r < l_pad) {
          if constexpr (kInt8) {
            dst[r * st + c] = dequant(src[(long long)r * d + c], sprm[c],
                                      sprm[d + c]);
          } else {
            dst[r * st + c] = src[(long long)r * d + c];
          }
        }
      }
    }
  };
  // SQ with 16-byte copies: dequantize the raw units this thread copied
  // (its own cp.async groups have landed) into the bf16 stage
  auto land_tile = [&](int tt, int buf) {
    if constexpr (kVec && kInt8) {
      const int l0 = g0 + tt * kTileRows;
      const int cpr = d / 16;
      const int8_t* rsrc = raw + buf * kTileRows * d;
      __nv_bfloat16* dst = sy + buf * kTileRows * st;
      for (int i = t; i < kTileRows * cpr; i += kThreads) {
        const int r = i / cpr, c = i - r * cpr;
        if (l0 + r >= l_pad) continue;
        const int4 w = *reinterpret_cast<const int4*>(rsrc + i * 16);
        const int8_t* cb = reinterpret_cast<const int8_t*>(&w);
        uint32_t packed[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int f = c * 16 + 2 * e;
          const __nv_bfloat16 lo = dequant(cb[2 * e], sprm[f], sprm[d + f]);
          const __nv_bfloat16 hi =
              dequant(cb[2 * e + 1], sprm[f + 1], sprm[d + f + 1]);
          packed[e] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
                      (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
        }
        uint4* out4 = reinterpret_cast<uint4*>(dst + r * st + c * 16);
        out4[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        out4[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
    }
  };
  load_tile(tb, 0);

  // query rows by id (dead slots zero), the K padding of both stages zero,
  // every minimum BIG until a live tile writes it
  for (int i = t; i < QT * kp; i += kThreads) {
    const int s = i / kp, c = i - s * kp;
    const int id = sid[s];
    sq[s * st + c] = (id >= 0 && c < d) ? queries[(long long)id * d + c]
                                        : __float2bfloat16_rn(0.f);
  }
  if (kp > d) {
    const int w = kp - d;
    for (int i = t; i < 2 * kTileRows * w; i += kThreads) {
      const int r = i / w;
      sy[r * st + d + (i - r * w)] = __float2bfloat16_rn(0.f);
    }
  }
  for (int i = t; i < QT * kGroupSubs; i += kThreads) smin[i] = kBig;
  __syncthreads();
  if (t < QT) {
    float s = 0.f;
    for (int c = 0; c < d; ++c) {
      const float v = __bfloat162float(sq[t * st + c]);
      s = fmaf(v, v, s);
    }
    sqn[t] = s;
  }

  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix row addresses: A (16 rows x 16 k) from the row stage, B (8
  // slots x 16 k) from the query tile
  const int a_off = (warp * 16 + (lane & 15)) * st + (lane >> 4) * 8;
  const int b_off = (lane & 7) * st + ((lane >> 3) & 1) * 8;

  for (int tt = tb; tt < te; ++tt) {
    const int buf = (tt - tb) & 1;
    if (tt + 1 < te) {
      load_tile(tt + 1, buf ^ 1);
      if constexpr (kVec) cp_async_wait<1>();
    } else if constexpr (kVec) {
      cp_async_wait<0>();
    }
    land_tile(tt, buf);
    __syncthreads();  // tile tt landed; the query norms are visible
    const __nv_bfloat16* ys = sy + buf * kTileRows * st;
    if (t < kTileRows) {
      float s = 0.f;
      for (int c = 0; c < d; ++c) {
        const float v = __bfloat162float(ys[t * st + c]);
        s = fmaf(v, v, s);
      }
      syn[t] = s;
    }
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, ys + a_off + k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bq[2];
        ldmatrix_x2(bq, sq + j * 8 * st + b_off + k0);
        mma_16816(acc[j], a, bq);
      }
    }
    __syncthreads();  // row norms visible; the stage may be refilled

    // accumulator rows g and g + 8 of this warp's 16; columns 2tq, 2tq + 1
    const int ra = g0 + tt * kTileRows + warp * 16 + g;
    const int rb = ra + 8;
    const float yna = syn[warp * 16 + g];
    const float ynb = syn[warp * 16 + g + 8];
    const bool va = ra >= lo && ra < hi;
    const bool vb = rb >= lo && rb < hi;
    const int jl = (tt * kTileRows + warp * 16) / kSub;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = j * 8 + tq * 2 + e;
        const float qn = sqn[s];
        float da = va ? (qn + yna) - 2.f * acc[j][e] : kBig;
        float db = vb ? (qn + ynb) - 2.f * acc[j][2 + e] : kBig;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          da = fminf(da, __shfl_xor_sync(0xffffffffu, da, o));
          db = fminf(db, __shfl_xor_sync(0xffffffffu, db, o));
        }
        if (g == 0 && sid[s] >= 0) {
          smin[s * kGroupSubs + jl] = da;
          smin[s * kGroupSubs + jl + 1] = db;
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < QT * n_sub; i += kThreads) {
    const int s = i / n_sub, j = i - s * n_sub;
    if (q0 + s < q_slots) {
      out[((long long)b * q_slots + q0 + s) * nsc + sc0 + j] =
          smin[s * kGroupSubs + j];
    }
  }
}

// The wide form of the flat scan: rows too wide for two whole-row stages
// beside the query tile (at d = 960 not even a query tile of 8 fits). The
// query tile stays resident at full width, as many slots as fit
// (wide_q_cap); each 64-row tile streams through a ring of kStages stages
// in slices of kSliceK features, one barrier a slice, and the slices'
// partial products accumulate in the MMA fragments. A row's norm is the
// diagonal of its warp's 16 x 16 Gram tile, two more MMAs a 16-wide step
// from the A fragment already loaded, so no thread sums a row alone; a
// query's norm is two threads' f32 sums over its halves, once a block.
// The epilogue (the [lo, hi) mask, the 8-row minima), the grid, the early
// exits and the output are the resident form's.
template <int NT, bool kVec>
__global__ void __launch_bounds__(kThreads)
flat_lists_wide_kernel(const __nv_bfloat16* __restrict__ queries,
                       const int32_t* __restrict__ qmat,
                       const __nv_bfloat16* __restrict__ rows,
                       const int32_t* __restrict__ origins,
                       const int32_t* __restrict__ bounds,
                       float* __restrict__ out, int q_slots, int n_ids, int d,
                       int l_pad) {
  constexpr int QT = NT * 8;
  constexpr int kStage = kTileRows * kSliceStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const int st = row_stride(d);
  const int kp = k_pad(d);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);  // [QT][st]
  __nv_bfloat16* ring = sq + QT * st;             // [kStages][kTileRows][.]
  float* smin = reinterpret_cast<float*>(ring + kStages * kStage);
  float* sqn = smin + QT * kGroupSubs;            // [QT]
  int* sid = reinterpret_cast<int*>(sqn + QT);    // [QT]

  const int b = blockIdx.z;
  const int q0 = blockIdx.y * QT;
  const int g0 = blockIdx.x * kGroupRows;
  const int t = threadIdx.x;
  const int nsc = l_pad / kSub;
  const int sc0 = g0 / kSub;
  const int n_sub = min(kGroupSubs, nsc - sc0);
  const int lo = bounds[2 * b];
  const int hi = bounds[2 * b + 1];
  const int r_beg = max(lo, g0);
  const int r_end = min(min(hi, l_pad), g0 + kGroupRows);

  int live = 0;
  if (t < QT) {
    int id = -1;
    if (q0 + t < q_slots) {
      const int v = qmat[(long long)b * q_slots + q0 + t];
      if (v >= 0 && v < n_ids) id = v;
    }
    sid[t] = id;
    live = id >= 0;
  }
  if (!__syncthreads_or(live) || r_beg >= r_end) {
    for (int i = t; i < QT * n_sub; i += kThreads) {
      const int s = i / n_sub, j = i - s * n_sub;
      if (q0 + s < q_slots) {
        out[((long long)b * q_slots + q0 + s) * nsc + sc0 + j] = kBig;
      }
    }
    return;
  }

  const long long org = origins[b];
  const int tb = (r_beg - g0) / kTileRows;
  const int te = (r_end - 1 - g0) / kTileRows + 1;
  const int ns = (kp + kSliceK - 1) / kSliceK;    // slices a tile
  const int n_steps = (te - tb) * ns;

  // step i: slice i % ns of tile tb + i / ns into stage i % kStages; the
  // K padding of a slice's last 16-wide step written zero
  auto load_step = [&](int i) {
    const int tt = tb + i / ns;
    const int c0 = (i % ns) * kSliceK;
    const int w = min(kSliceK, d - c0);
    const int l0 = g0 + tt * kTileRows;
    __nv_bfloat16* dst = ring + (i % kStages) * kStage;
    const __nv_bfloat16* src = rows + (org + l0) * d + c0;
    if constexpr (kVec) {
      const int cpr = w / 8;
      for (int j = t; j < kTileRows * cpr; j += kThreads) {
        const int r = j / cpr, c = j - r * cpr;
        if (l0 + r < l_pad) {
          cp_async16(dst + r * kSliceStride + c * 8,
                     src + (long long)r * d + c * 8);
        }
      }
    } else {
      for (int j = t; j < kTileRows * w; j += kThreads) {
        const int r = j / w, c = j - r * w;
        if (l0 + r < l_pad) dst[r * kSliceStride + c] = src[(long long)r * d + c];
      }
    }
    const int z = min(kSliceK, kp - c0) - w;
    for (int j = t; j < kTileRows * z; j += kThreads) {
      const int r = j / z;
      dst[r * kSliceStride + w + (j - r * z)] = __float2bfloat16_rn(0.f);
    }
  };

  // query rows by id (dead slots zero, the K padding zero; 16-byte loads
  // where rows allow), every minimum BIG until a live tile writes it, the
  // ring's first stages in flight
  if (d % 8 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0) {
    const int upr = kp / 8;
    for (int i = t; i < QT * upr; i += kThreads) {
      const int s = i / upr, c = (i - s * upr) * 8;
      const int id = sid[s];
      uint4 v = make_uint4(0, 0, 0, 0);
      if (id >= 0 && c < d) {
        v = *reinterpret_cast<const uint4*>(queries + (long long)id * d + c);
      }
      *reinterpret_cast<uint4*>(sq + s * st + c) = v;
    }
  } else {
    for (int i = t; i < QT * kp; i += kThreads) {
      const int s = i / kp, c = i - s * kp;
      const int id = sid[s];
      sq[s * st + c] = (id >= 0 && c < d) ? queries[(long long)id * d + c]
                                          : __float2bfloat16_rn(0.f);
    }
  }
  for (int i = t; i < QT * kGroupSubs; i += kThreads) smin[i] = kBig;
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) load_step(i);
    cp_async_commit();
  }
  __syncthreads();
  {
    // slot t / 2, features [h * half, (h + 1) * half) with h = t % 2
    const int s = t >> 1, h = t & 1, half = (d + 1) / 2;
    float v = 0.f;
    if (s < QT) {
      for (int c = h * half; c < min(d, (h + 1) * half); ++c) {
        const float x = __bfloat162float(sq[s * st + c]);
        v = fmaf(x, x, v);
      }
    }
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (s < QT && h == 0) sqn[s] = v;
  }

  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int a_off = (warp * 16 + (lane & 15)) * kSliceStride + (lane >> 4) * 8;
  const int b_off = (lane & 7) * st + ((lane >> 3) & 1) * 8;
  // this warp's 16 rows as the B operand, two n-tiles of 8 (rows 0-7 and
  // 8-15): the diagonal of their Gram tile is the row norms
  const int n_off = (warp * 16 + (lane & 7)) * kSliceStride +
                    ((lane >> 3) & 1) * 8;

  float acc[NT][4];
  float gram0[4], gram1[4];
  for (int i = 0; i < n_steps; ++i) {
    const int tt = tb + i / ns;
    const int ks = i % ns;
    const int c0 = ks * kSliceK;
    if constexpr (kVec) cp_async_wait<kStages - 2>();
    __syncthreads();  // step i landed; step i - 1's stage is free
    if (i + kStages - 1 < n_steps) load_step(i + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* ys = ring + (i % kStages) * kStage;
    if (ks == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) gram0[e] = gram1[e] = 0.f;
    }
    // each 16-wide step's fragments first, then its MMAs
    const int ksteps = (min(kSliceK, kp - c0) + 15) / 16;
#pragma unroll
    for (int kk = 0; kk < kSliceK / 16; ++kk) {
      if (kk < ksteps) {
        uint32_t a[4], y0[2], y1[2], bq[NT][2];
        ldmatrix_x4(a, ys + a_off + kk * 16);
        ldmatrix_x2(y0, ys + n_off + kk * 16);
        ldmatrix_x2(y1, ys + n_off + 8 * kSliceStride + kk * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          ldmatrix_x2(bq[j], sq + j * 8 * st + b_off + c0 + kk * 16);
        }
        mma_16816(gram0, a, y0);
        mma_16816(gram1, a, y1);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_16816(acc[j], a, bq[j]);
      }
    }
    if (ks < ns - 1) continue;

    // row g's norm is column g of n-tile 0 (element g % 2 of lane
    // 4g + g / 2), row g + 8's column g of n-tile 1 (element 2 + g % 2);
    // selected, not indexed, so the fragments stay in registers
    const int src = 4 * g + (g >> 1);
    const float yna =
        __shfl_sync(0xffffffffu, (g & 1) ? gram0[1] : gram0[0], src);
    const float ynb =
        __shfl_sync(0xffffffffu, (g & 1) ? gram1[3] : gram1[2], src);
    const int ra = g0 + tt * kTileRows + warp * 16 + g;
    const int rb = ra + 8;
    const bool va = ra >= lo && ra < hi;
    const bool vb = rb >= lo && rb < hi;
    const int jl = (tt * kTileRows + warp * 16) / kSub;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = j * 8 + tq * 2 + e;
        const float qn = sqn[s];
        float da = va ? (qn + yna) - 2.f * acc[j][e] : kBig;
        float db = vb ? (qn + ynb) - 2.f * acc[j][2 + e] : kBig;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          da = fminf(da, __shfl_xor_sync(0xffffffffu, da, o));
          db = fminf(db, __shfl_xor_sync(0xffffffffu, db, o));
        }
        if (g == 0 && sid[s] >= 0) {
          smin[s * kGroupSubs + jl] = da;
          smin[s * kGroupSubs + jl + 1] = db;
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < QT * n_sub; i += kThreads) {
    const int s = i / n_sub, j = i - s * n_sub;
    if (q0 + s < q_slots) {
      out[((long long)b * q_slots + q0 + s) * nsc + sc0 + j] =
          smin[s * kGroupSubs + j];
    }
  }
}

template <int NT, bool kVec, bool kInt8>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const void* queries, const void* qmat, const void* rows,
                   const void* origins, const void* bounds, const void* params,
                   void* out, int q_slots, int n_ids, int d, int l_pad) {
  auto kernel = flat_lists_kernel<NT, kVec, kInt8>;
  using Row = std::conditional_t<kInt8, int8_t, __nv_bfloat16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(queries),
      static_cast<const int32_t*>(qmat), static_cast<const Row*>(rows),
      static_cast<const int32_t*>(origins), static_cast<const int32_t*>(bounds),
      static_cast<const float*>(params), static_cast<float*>(out), q_slots,
      n_ids, d, l_pad);
  return cudaGetLastError();
}

template <bool kVec, bool kInt8>
cudaError_t launch_nt(int nt, dim3 grid, size_t smem, cudaStream_t stream,
                      const void* queries, const void* qmat, const void* rows,
                      const void* origins, const void* bounds,
                      const void* params, void* out, int q_slots, int n_ids,
                      int d, int l_pad) {
#define RAFT_FLAT_NT(N)                                                    \
  case N:                                                                  \
    return launch<N, kVec, kInt8>(grid, smem, stream, queries, qmat, rows, \
                                  origins, bounds, params, out, q_slots,   \
                                  n_ids, d, l_pad);
  switch (nt) {
    RAFT_FLAT_NT(1)
    RAFT_FLAT_NT(2)
    RAFT_FLAT_NT(3)
    RAFT_FLAT_NT(4)
    RAFT_FLAT_NT(5)
    RAFT_FLAT_NT(6)
    RAFT_FLAT_NT(7)
    RAFT_FLAT_NT(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RAFT_FLAT_NT
}

template <int NT, bool kVec>
cudaError_t launch_wide(dim3 grid, size_t smem, cudaStream_t stream,
                        const void* queries, const void* qmat, const void* rows,
                        const void* origins, const void* bounds, void* out,
                        int q_slots, int n_ids, int d, int l_pad) {
  auto kernel = flat_lists_wide_kernel<NT, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(queries),
      static_cast<const int32_t*>(qmat),
      static_cast<const __nv_bfloat16*>(rows),
      static_cast<const int32_t*>(origins), static_cast<const int32_t*>(bounds),
      static_cast<float*>(out), q_slots, n_ids, d, l_pad);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_wide_nt(int nt, dim3 grid, size_t smem,
                           cudaStream_t stream, const void* queries,
                           const void* qmat, const void* rows,
                           const void* origins, const void* bounds, void* out,
                           int q_slots, int n_ids, int d, int l_pad) {
#define RAFT_FLAT_WIDE_NT(N)                                                 \
  case N:                                                                   \
    return launch_wide<N, kVec>(grid, smem, stream, queries, qmat, rows,    \
                                origins, bounds, out, q_slots, n_ids, d,    \
                                l_pad);
  switch (nt) {
    RAFT_FLAT_WIDE_NT(1)
    RAFT_FLAT_WIDE_NT(2)
    RAFT_FLAT_WIDE_NT(3)
    RAFT_FLAT_WIDE_NT(4)
    RAFT_FLAT_WIDE_NT(5)
    RAFT_FLAT_WIDE_NT(6)
    RAFT_FLAT_WIDE_NT(7)
    RAFT_FLAT_WIDE_NT(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RAFT_FLAT_WIDE_NT
}

// The launch both entries share: checks, grid, the form (the flat scan's
// wide form where its resident one does not fit, flat_wide; the SQ scan
// has the resident form only) and the 16-byte-copy choice (bf16 rows:
// d % 8 == 0; int8 codes: d % 16 == 0; aligned rows).
template <bool kInt8>
int launch_lists(const void* queries, const void* qmat, const void* rows,
                 const void* origins, const void* bounds, const void* params,
                 void* out, int n_lists, int q_slots, int n_ids, int d,
                 int l_pad, void* stream) {
  if (n_lists < 1 || q_slots < 1 || d < 1 || l_pad < kSub || l_pad % kSub) {
    return (int)cudaErrorInvalidValue;
  }
  int q_tile = q_tile_of(q_slots);
  size_t smem = sq_smem_bytes(d, q_tile);
  const bool wide = !kInt8 && flat_wide(d, q_slots, &q_tile, &smem);
  if (q_tile < 1 || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int q_tiles = (q_slots + q_tile - 1) / q_tile;
  if (n_lists > scan_core::kMaxGridYZ || q_tiles > scan_core::kMaxGridYZ) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((l_pad + kGroupRows - 1) / kGroupRows, q_tiles, n_lists);
  const bool vec = d % (kInt8 ? 16 : 8) == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = q_tile / 8;
  if (wide) {
    return (int)(vec ? launch_wide_nt<true>(nt, grid, smem, s, queries, qmat,
                                            rows, origins, bounds, out,
                                            q_slots, n_ids, d, l_pad)
                     : launch_wide_nt<false>(nt, grid, smem, s, queries, qmat,
                                             rows, origins, bounds, out,
                                             q_slots, n_ids, d, l_pad));
  }
  return (int)(vec ? launch_nt<true, kInt8>(nt, grid, smem, s, queries, qmat,
                                            rows, origins, bounds, params, out,
                                            q_slots, n_ids, d, l_pad)
                   : launch_nt<false, kInt8>(nt, grid, smem, s, queries, qmat,
                                             rows, origins, bounds, params,
                                             out, q_slots, n_ids, d, l_pad));
}

}  // namespace

extern "C" {

// Query slots per block for Q slots (q_tile_of).
int raft_flat_scan_q_tile(int q_slots) { return q_tile_of(q_slots); }

// Dynamic shared memory one block needs at feature width d and a query tile
// of q_tile slots.
long long raft_flat_scan_smem_bytes(int d, int q_tile) {
  return (long long)smem_bytes(d, q_tile);
}

// Whether the flat scan at width d over q_slots slots takes the wide form,
// and its query slots per block and dynamic shared memory (flat_wide).
int raft_flat_scan_form(int d, int q_slots, int* q_tile, long long* smem) {
  size_t bytes = 0;
  const int wide = flat_wide(d, q_slots, q_tile, &bytes);
  *smem = (long long)bytes;
  return wide;
}

// Dynamic shared memory one SQ block needs at width d and q_tile slots.
long long raft_sq_scan_smem_bytes(int d, int q_tile) {
  return (long long)sq_smem_bytes(d, q_tile);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// queries (n, d) bf16 contiguous; qmat (n_lists, q_slots) int32, an id
// outside [0, n_ids) marking a dead slot; rows (*, d) bf16 contiguous, list
// b's window being rows origins[b] .. origins[b] + l_pad - 1 (all in range);
// origins (n_lists,) int32; bounds (n_lists, 2) int32, [lo, hi) relative to
// the origin; out (n_lists, q_slots, l_pad/8) f32 contiguous. l_pad must be
// a multiple of 8.
int raft_flat_scan_lists(const void* queries, const void* qmat,
                         const void* rows, const void* origins,
                         const void* bounds, void* out, int n_lists,
                         int q_slots, int n_ids, int d, int l_pad,
                         void* stream) {
  return launch_lists<false>(queries, qmat, rows, origins, bounds, nullptr,
                             out, n_lists, q_slots, n_ids, d, l_pad, stream);
}

// The IVF-SQ scan: as raft_flat_scan_lists, with rows (*, d) the int8
// codes and params (2, d) f32 contiguous, vmin then vscale.
int raft_sq_scan_lists(const void* queries, const void* qmat,
                       const void* codes, const void* origins,
                       const void* bounds, const void* params, void* out,
                       int n_lists, int q_slots, int n_ids, int d, int l_pad,
                       void* stream) {
  return launch_lists<true>(queries, qmat, codes, origins, bounds, params, out,
                            n_lists, q_slots, n_ids, d, l_pad, stream);
}

const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
