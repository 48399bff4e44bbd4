// Shared core of the port's sub-chunk scan kernels for Hopper (sm_90a).
//
// The counterpart of the shared Pallas scan scan_core.subchunk_scan
// (raft_tpu/spatial/ann/scan_core.py:211, pallas_call at :275). What every
// scan shares lives here once:
//
//   * the [lo, hi) mask: rows outside a list's valid range score kBig;
//   * the epilogue: the min of every 8-row sub-chunk is the only output, an
//     (lists, Q, Lpad/8) f32 array; the distance tile never reaches device
//     memory;
//   * the launch limit of grid y and z.
//
// The scans themselves read list rows in place with their own bodies:
// flat_scan.cu (the flat scan and, with its int8 row loader, the IVF-SQ
// scan, on the tensor cores), pq_scan.cu (the ADC scan of IVF-PQ) and
// beam_scan.cu (the graph walk's candidate scan).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_core {

constexpr int kSub = 8;                 // rows per sub-chunk
constexpr float kBig = 1e30f;           // score of a masked row (finite)
constexpr int kMaxGridYZ = 65535;       // launch limit of gridDim.y and .z

// Min over one sub-chunk whose first row is lc; rows outside [lo, hi) kBig.
__device__ __forceinline__ float masked_subchunk_min(const float (&v)[kSub],
                                                     int lc, int lo, int hi) {
  float m = kBig;
  bool first = true;
#pragma unroll
  for (int r = 0; r < kSub; ++r) {
    const int l = lc + r;
    const float s = (l >= lo && l < hi) ? v[r] : kBig;
    m = first ? s : fminf(m, s);
    first = false;
  }
  return m;
}

}  // namespace scan_core
