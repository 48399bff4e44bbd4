// Top-k selection for Hopper (sm_90a): the k smallest f32 entries of each
// row and their int64 column indices, exactly what a stable sort of the
// rows' total-order keys puts first.
//
// Replaces no Pallas kernel: the JAX package selects with lax.top_k, which
// XLA lowers itself. The port's plain version (selection.top_k_smallest_plain)
// is that stable sort: torch.sort over the 32-bit total-order key of every
// entry, its first k indices, then a gather. It makes several full passes
// over the row and writes an int64 index for every entry, to keep a few
// dozen; at (10,000, 14,000) with k = 40 it took ~10 ms of the IVF pool's
// 12.7 ms on the H100.
//
// The contract, bit for bit that of the stable sort:
//   * the values (the original float bits) and the indices of the k
//     smallest total-order keys, ascending, equal keys lowest index first;
//   * the key orders -NaN < -inf < ... < -0.0 < 0.0 < ... < inf < +NaN, so
//     -0.0 comes before 0.0, a NaN is placed by its sign, and every value,
//     inf and the searches' BIG sentinels included, is an ordinary key;
//   * deterministic: the histogram's atomics only count, and the final
//     order is the survivors' (key, index) order.
//
// What bounds it on the H100: bytes. Each entry has to be read once, so the
// least time of a (10,000, 14,000) f32 pool is ~0.17 ms at 3.35 TB/s (the
// k-wide outputs are noise). What the design does about it: one block of
// 256 threads a row reads the row from device memory once (16-byte
// streaming loads where the row is aligned) into shared memory as unsigned
// order keys, and everything after works on that copy:
//   1. a radix select over 8-bit digits, most significant first: a 256-bin
//      histogram of the keys that still share the prefix found so far
//      (warp-aggregated shared atomics: __match_any_sync, one atomic per
//      distinct digit a warp), a block scan of the bins finds the digit of
//      the k-th key and how many keys below it are already taken. At most
//      4 passes; it stops early once the k-th key's bin holds exactly the
//      keys still needed;
//   2. one compaction: every key whose prefix is below the k-th's goes to
//      the survivor buffer (warp-aggregated slot counter, any order), and
//      so does the k-th's whole bin when it fits; otherwise (ties at the
//      k-th key) each warp walks a contiguous stretch of the row in index
//      order and the lowest-indexed ties fill the remaining slots by ballot
//      ranks;
//   3. a bitonic sort of the k survivors (padded to a power of two) as
//      64-bit (key, index) pairs in shared memory, then the keys turned
//      back into their float bits and written with the int64 indices.
// The row has to fit in shared memory: rows of up to kMaxRow keys (192 KB)
// and k up to kMaxK. Longer rows and larger k stay on the stable sort; the
// wrapper routes them by their shape (selection.select_k_kernel_fits, which
// reads kMaxK and kMaxRow from this file).
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): select_k_kernel<true> 30 registers,
// <false> 32, no spills, 3,120 bytes of static shared memory beside the
// row's n * 4 bytes of dynamic.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;           // threads a block: one bin each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;              // survivors at most (the sort buffer)
constexpr int kMaxRow = 49152;          // keys a row at most (192 KB)
constexpr unsigned kFull = 0xffffffffu;

// The devices (a bit each, the first 32) on which each template already
// allows a row of kMaxRow keys of dynamic shared memory.
std::atomic<uint32_t> g_smem_ready[2];

// The unsigned order key of an f32's bits: unsigned order is IEEE total
// order (the signed key of selection._total_order_key with its sign bit
// flipped).
__device__ __forceinline__ uint32_t order_key(uint32_t bits) {
  return bits ^ ((uint32_t)((int32_t)bits >> 31) | 0x80000000u);
}

// The float bits of an order key (order_key's inverse).
__device__ __forceinline__ uint32_t key_bits(uint32_t key) {
  return key ^ ((key >> 31) ? 0x80000000u : kFull);
}

__device__ __forceinline__ uint4 order_keys(uint4 v) {
  return make_uint4(order_key(v.x), order_key(v.y), order_key(v.z),
                    order_key(v.w));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
select_k_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                int64_t* __restrict__ out_i, int n, int k, int kp) {
  extern __shared__ __align__(16) uint32_t keys[];
  __shared__ uint32_t hist[256];
  __shared__ unsigned long long cand[kMaxK];
  __shared__ int warp_sum[kWarps];
  __shared__ int s_bin, s_below, s_count, s_slot;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const float* xr = x + row * n;

  // the row, read once, as order keys in shared memory
  if (kVec) {
    const uint4* src = reinterpret_cast<const uint4*>(xr);
    uint4* dst = reinterpret_cast<uint4*>(keys);
    const int n4 = n >> 2;
    int i = tid;
    for (; i + 3 * kThreads < n4; i += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldcs(src + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[i + u * kThreads] = order_keys(v[u]);
    }
    for (; i < n4; i += kThreads) dst[i] = order_keys(__ldcs(src + i));
  } else {
    for (int i = tid; i < n; i += kThreads) {
      keys[i] = order_key(__float_as_uint(__ldcs(xr + i)));
    }
  }

  // 1. radix select: after each pass `prefix` holds the known high bits of
  // the k-th key (`known` masks them), `need` how many of the keys sharing
  // them are still to take, `group` how many keys share them
  uint32_t prefix = 0, known = 0;
  int need = k, group = n;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      const uint32_t key = i < n ? keys[i] : 0u;
      const bool in = i < n && (key & known) == prefix;
      const unsigned act = __ballot_sync(kFull, in);
      if (in) {
        const uint32_t d = (key >> shift) & 0xffu;
        const unsigned peers = __match_any_sync(act, d);
        if (lane == __ffs(peers) - 1) {
          atomicAdd(&hist[d], (uint32_t)__popc(peers));
        }
      }
    }
    __syncthreads();
    // the bin holding the need-th key of the group: a scan over the bins
    const int c = (int)hist[tid];
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += warp_sum[w];
    const int excl = incl - c;
    if (excl < need && need <= incl) {
      s_bin = tid;
      s_below = excl;
      s_count = c;
    }
    __syncthreads();
    need -= s_below;
    group = s_count;
    prefix |= (uint32_t)s_bin << shift;
    known |= 0xffu << shift;
    if (group == need) break;
  }

  // 2. compaction into cand[0, k): below the prefix always, and the whole
  // group when it is exactly what is needed, in any order
  const bool whole_group = group == need;
  if (tid == 0) s_slot = 0;
  for (int j = k + tid; j < kp; j += kThreads) cand[j] = ~0ull;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    const uint32_t key = i < n ? keys[i] : 0u;
    const uint32_t m = key & known;
    const bool take = i < n && (m < prefix || (whole_group && m == prefix));
    const unsigned ball = __ballot_sync(kFull, take);
    if (ball) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_slot, __popc(ball));
      base = __shfl_sync(kFull, base, 0);
      if (take) {
        const int slot = base + __popc(ball & ((1u << lane) - 1));
        cand[slot] = ((unsigned long long)key << 32) | (uint32_t)i;
      }
    }
  }
  if (!whole_group) {
    // ties at the k-th key (every bit known): its `need` lowest-indexed
    // copies fill cand[k - need, k). Warp w walks keys [lo, hi) in index
    // order; the warps before it hold the lower indices.
    const int seg = (n + kThreads - 1) / kThreads * 32;
    const int lo = min(n, warp * seg), hi = min(n, lo + seg);
    int cnt = 0;
    for (int i = lo + lane; i - lane < hi; i += 32) {
      cnt += __popc(__ballot_sync(kFull, i < hi && keys[i] == prefix));
    }
    if (lane == 0) warp_sum[warp] = cnt;
    __syncthreads();
    int run = 0;
    for (int w = 0; w < warp; ++w) run += warp_sum[w];
    const int below = k - need;
    for (int i = lo + lane; i - lane < hi && run < need; i += 32) {
      const bool eq = i < hi && keys[i] == prefix;
      const unsigned ball = __ballot_sync(kFull, eq);
      const int r = run + __popc(ball & ((1u << lane) - 1));
      if (eq && r < need) {
        cand[below + r] = ((unsigned long long)prefix << 32) | (uint32_t)i;
      }
      run += __popc(ball);
    }
  }
  __syncthreads();

  // 3. the survivors in (key, index) order: a bitonic sort of kp <= 256
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int j = tid ^ stride;
      if (tid < kp && j > tid) {
        const unsigned long long a = cand[tid], b = cand[j];
        if ((a > b) == ((tid & size) == 0)) {
          cand[tid] = b;
          cand[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < k; j += kThreads) {
    const unsigned long long c = cand[j];
    out_v[row * k + j] = __uint_as_float(key_bits((uint32_t)(c >> 32)));
    out_i[row * k + j] = (int64_t)(uint32_t)c;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// x (rows, n) f32 contiguous; out_v (rows, k) f32 and out_i (rows, k) int64
// contiguous. 1 <= k <= min(n, kMaxK), n <= kMaxRow.
int raft_select_k(const void* x, void* out_v, void* out_i, int rows, int n,
                  int k, void* stream) {
  if (rows < 1 || k < 1 || k > kMaxK || n < k || n > kMaxRow) {
    return (int)cudaErrorInvalidValue;
  }
  int kp = 1;
  while (kp < k) kp <<= 1;
  const size_t smem = ((size_t)n * sizeof(uint32_t) + 15) / 16 * 16;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = vec ? select_k_kernel<true> : select_k_kernel<false>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (!bit || !(g_smem_ready[vec].load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxRow * (int)sizeof(uint32_t));
    if (err != cudaSuccess) return (int)err;
    g_smem_ready[vec].fetch_or(bit, std::memory_order_relaxed);
  }
  kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out_v),
      static_cast<int64_t*>(out_i), n, k, kp);
  return (int)cudaGetLastError();
}

const char* raft_select_k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
