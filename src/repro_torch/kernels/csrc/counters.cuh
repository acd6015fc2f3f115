// The Table-1 counters and the direction policies in device code,
// shared by the host loops' measure kernel (measure.cu) and the
// whole-traversal kernels' layer loop (traversal_loop.cuh, K6 and K10).
//
// `sum4` is one lane's degree sum of 4 vertices whose degrees came in
// one 16-byte load; `count4` sums one warp's (count, degree sum) of 128
// vertices, each lane 4 bits, with a reduction per call (K6 and K10,
// whose update pass holds one root at a time); `flush_counters`
// reduces one root's counters over the CTA and adds them to a device
// accumulator; `decide` is core/engine.py's four registered policies on
// the float32 of the exact int64 batch sums, the numbers the engine's
// torch policies compare.
#pragma once

#include <cuda_runtime.h>

#include "bfs_common.cuh"

namespace bfs {

constexpr int kModeScalar = 0, kModeSimd = 1, kModeBottomUp = 2;
constexpr int kTopDown = 0, kThresholdSimd = 1, kPaperLayers = 2,
              kBeamer = 3;
constexpr int kStatCols = 8;

struct Policy {
  int kind;
  float alpha;           // BeamerHybrid: unexplored-edges divisor
  float v_over_beta;     // BeamerHybrid: V * B / beta, as float32
  float threshold;       // ThresholdSimd: simd_threshold, as float32
  const int* simd_layer; // PaperLiteralLayers: (max_layers,) 0/1
};

// The policies of core/engine.py on float32 batch sums.
__device__ inline int decide(const Policy& pol, int layer, float f_count,
                             float f_edges, float u_count, float u_edges,
                             bool* bottom_up) {
  switch (pol.kind) {
    case kThresholdSimd:
      *bottom_up = false;
      return f_edges >= pol.threshold ? kModeSimd : kModeScalar;
    case kPaperLayers:
      *bottom_up = false;
      return __ldg(pol.simd_layer + layer) ? kModeSimd : kModeScalar;
    case kBeamer: {
      const bool bu = *bottom_up;
      const bool down = !bu && (f_edges > __fdiv_rn(u_edges, pol.alpha));
      const bool up = bu && (f_count < pol.v_over_beta);
      *bottom_up = down || (!up && bu);
      return (*bottom_up && u_count > 0.f) ? kModeBottomUp : kModeSimd;
    }
    case kTopDown:
    default:
      *bottom_up = false;
      return kModeScalar;
  }
}

// The degree sum of the (up to 4) vertices whose bits are in `bits`
// (bit k: the vertex whose degree is component k of d).
__device__ __forceinline__ int sum4(unsigned bits, const int4& d) {
  return ((bits & 1u) ? d.x : 0) + ((bits & 2u) ? d.y : 0) +
         ((bits & 4u) ? d.z : 0) + ((bits & 8u) ? d.w : 0);
}

// The warp's (count, degree sum) of the vertices whose bits each lane
// holds in `bits` (`sum4`).  Every lane of the warp must call it; every
// lane gets the sums.
__device__ __forceinline__ void count4(unsigned bits, const int4& d,
                                       int* n, int* e) {
  *n = __reduce_add_sync(0xffffffffu, __popc(bits));
  *e = __reduce_add_sync(0xffffffffu, sum4(bits, d));
}

// One root's counters, reduced over the CTA, added to acc (4 values).
__device__ __forceinline__ void flush_counters(long long (&c)[4],
                                               unsigned long long* acc) {
  block_sum(c);
  if (threadIdx.x == 0)
    for (int k = 0; k < 4; ++k)
      if (c[k]) atomicAdd(acc + k, static_cast<unsigned long long>(c[k]));
}

}  // namespace bfs
