// Exact f32 rescore of the IVF kernel engines' candidates for Hopper
// (sm_90a): R, the tail of the grouped search (grouped.search, range
// ivf.rerank), reading every candidate's row in place.
//
// Replaces no Pallas kernel: the JAX package reranks in jnp
// (score_l2_candidates over the gathered rows), which XLA fuses. The
// port's plain version (rerank.rescore_rows_plain) is that gather and
// score_l2_candidates: every candidate's f32 row copied into a (queries,
// C, d) buffer, then read back for the product, its square and the sum.
// At GIST-1M's shape (10,000 queries, 320 candidates, d = 960) that chain
// writes 12.3 GB and reads ~49 GB in 46 query blocks of ~20 launches each:
// 27.9 ms of a ~50 ms call on the H100.
//
// The contract, that of score_l2_candidates(q, src[clamp(rpos, 0, n)],
// valid & (rpos < n)):
//   out[i, j] = (|q_i|^2 + |y|^2) - 2 (q_i . y),   y = src[rpos[i, j]],
// each of the three an f32 sum of fmaf products in the kernel's own order,
// and +inf where valid[i, j] is 0 or rpos[i, j] lies outside [0, n). On
// integer-valued rows every sum is exact, so the result is the plain
// version's bit for bit; otherwise it lies within the f32 summation bound
// of it. A candidate's value depends on its query and its row alone, not
// on the batch, the tile or the other candidates.
//
// What bounds it on the H100: bytes. Each valid candidate's row has to be
// read once: 12.3 GB at the GIST shape, 3.67 ms at 3.35 TB/s; 1.23 GB at
// DEEP-10M's (d = 96), 0.37 ms. Queries, positions, masks and the output
// are noise beside them. What the design does about it:
//   * the rows are read where the index keeps them (the list-sorted f32
//     rows, sentinel last): no gather buffer, one launch for the batch;
//   * one block of kThreads threads a (query, tile of kTile candidates);
//     the query row in shared memory, its norm taken once by one warp;
//   * a team of T lanes (4 to 32, the least that leaves each lane at most
//     four loads of a row) a candidate, so a warp works on 32 / T rows at
//     once; each lane streams 16-byte read-only loads from consecutive
//     addresses (4-byte loads where d is not a multiple of 4 or the rows
//     are not 16-byte aligned), four in flight before their FMAs, and the
//     team's two sums (q . y and |y|^2) meet by shuffles;
//   * an invalid candidate, or one past the rows, reads nothing.
// Rows of up to kMaxD features take the kernel; the wrapper routes by that
// (rerank.rerank_kernel_fits, which reads kMaxD from this file). The
// block's shared memory is all dynamic (the query row, then its norm), and
// a launch past the 48 KB a block may have by default opts in to more
// (d > 12,284: 48 KB and a 16-byte norm slot at d = 12,288).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kTile = 128;      // candidates a block
constexpr int kMaxD = 12288;    // features at most (48 KB of query row)
constexpr size_t kDefaultSmem = 48 * 1024;  // a block's, without opting in
constexpr int kUnroll = 4;      // loads in flight a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void fma_terms(float x, float y, float& dot,
                                          float& nrm) {
  dot = fmaf(x, y, dot);
  nrm = fmaf(y, y, nrm);
}

__device__ __forceinline__ void fma_terms(float4 x, float4 y, float& dot,
                                          float& nrm) {
  fma_terms(x.x, y.x, dot, nrm);
  fma_terms(x.y, y.y, dot, nrm);
  fma_terms(x.z, y.z, dot, nrm);
  fma_terms(x.w, y.w, dot, nrm);
}

// V: float4 (16-byte loads, d % 4 == 0) or float; T: lanes a candidate.
template <typename V, int T>
__global__ void __launch_bounds__(kThreads)
rerank_kernel(const float* __restrict__ q, const float* __restrict__ src,
              const int64_t* __restrict__ rpos,
              const uint8_t* __restrict__ valid, float* __restrict__ out,
              long long n, int d, int c, int tiles) {
  // the query row, padded to 16 bytes, then its norm
  extern __shared__ __align__(16) float qs[];
  float& s_qn = qs[(d + 3) / 4 * 4];

  constexpr int kW = sizeof(V) / sizeof(float);
  constexpr int kTeams = kThreads / T;
  const int tid = threadIdx.x, lane = tid & 31;
  const int team = tid / T, t = tid % T;
  const long long qi = blockIdx.x / tiles;
  const int c0 = (int)(blockIdx.x % tiles) * kTile;
  const int c1 = min(c, c0 + kTile);
  const int nv = d / kW;

  const float* qrow = q + qi * d;
  for (int i = tid; i < d; i += kThreads) qs[i] = qrow[i];
  __syncthreads();
  if (tid < 32) {
    float s = 0.0f;
    for (int i = lane; i < d; i += 32) s = fmaf(qs[i], qs[i], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) s_qn = s;
  }
  __syncthreads();
  const float qn = s_qn;
  const V* qv = reinterpret_cast<const V*>(qs);

  // every lane of the block runs the same trips, so each team's shuffles
  // find their whole warp
  for (int j0 = c0; j0 < c1; j0 += kTeams) {
    const int j = j0 + team;
    const bool in = j < c1;
    const long long e = qi * c + j;
    long long pos = -1;
    bool ok = false;
    if (in) {
      pos = rpos[e];
      ok = valid[e] != 0 && pos >= 0 && pos < n;
    }
    float dot = 0.0f, nrm = 0.0f;
    if (ok) {
      const V* row = reinterpret_cast<const V*>(src + pos * d);
      for (int i = t; i < nv; i += kUnroll * T) {
        V y[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u * T < nv) y[u] = __ldg(row + i + u * T);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u * T < nv) fma_terms(qv[i + u * T], y[u], dot, nrm);
        }
      }
    }
#pragma unroll
    for (int o = T / 2; o > 0; o >>= 1) {
      dot += __shfl_xor_sync(kFull, dot, o);
      nrm += __shfl_xor_sync(kFull, nrm, o);
    }
    if (in && t == 0) out[e] = ok ? (qn + nrm) - 2.0f * dot : INFINITY;
  }
}

// The least team of lanes, 4 to 32, that leaves each lane at most kUnroll
// loads of a row of nv elements.
int team_lanes(int nv) {
  int t = 4;
  while (t < 32 && kUnroll * t < nv) t <<= 1;
  return t;
}

template <typename V>
cudaError_t launch(int team, unsigned blocks, size_t smem, cudaStream_t s,
                   const float* q, const float* src, const int64_t* rpos,
                   const uint8_t* valid, float* out, long long n, int d,
                   int c, int tiles) {
  void (*kernel)(const float*, const float*, const int64_t*, const uint8_t*,
                 float*, long long, int, int, int);
  switch (team) {
    case 4: kernel = rerank_kernel<V, 4>; break;
    case 8: kernel = rerank_kernel<V, 8>; break;
    case 16: kernel = rerank_kernel<V, 16>; break;
    default: kernel = rerank_kernel<V, 32>; break;
  }
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, s>>>(q, src, rpos, valid, out, n, d, c,
                                        tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// q (nq, d) f32, src (rows, d) f32, rpos (nq, c) int64, valid (nq, c)
// uint8 and out (nq, c) f32, all contiguous; rows with index < n are
// scored. 1 <= d <= kMaxD, nq * ceil(c / kTile) < 2^31.
int raft_rerank(const void* q, const void* src, const void* rpos,
                const void* valid, void* out, int nq, int c, long long n,
                int d, void* stream) {
  if (nq < 0 || c < 0 || n < 0 || d < 1 || d > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  if (nq == 0 || c == 0) return 0;
  const int tiles = (c + kTile - 1) / kTile;
  const long long blocks = (long long)nq * tiles;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)d * sizeof(float) + 15) / 16 * 16 + 16;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const float* rows = static_cast<const float*>(src);
  const int64_t* pos = static_cast<const int64_t*>(rpos);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (vec) {
    return (int)launch<float4>(team_lanes(d / 4), (unsigned)blocks, smem, s,
                               qf, rows, pos, ok, o, n, d, c, tiles);
  }
  return (int)launch<float>(team_lanes(d), (unsigned)blocks, smem, s, qf,
                            rows, pos, ok, o, n, d, c, tiles);
}

const char* raft_rerank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
