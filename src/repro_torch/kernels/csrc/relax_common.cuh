// Device code shared by the semiring relax kernels (K11, gather_relax.cu;
// K12, sell_relax.cu): the synthetic edge weight, the candidate formula
// and the two phases of one edge's relaxation (`relax_at`, on pointers
// to the edge's entries in the root-interleaved layouts of both).
//
// Values travel as 32-bit patterns: int32 values as they are, float32
// values as their bits.  Every value the portfolio produces is >= 0
// (hop counts, component ids, distances: sums of weights in [1, 2)
// from 0) or +inf, and none is NaN; on such floats the order of the
// bit patterns read as int32 is the order of the floats.  So one
// int32 atomicMin folds both types, and one int32 compare tests
// "improved" for both.  The plain versions' tests assert the invariant.
//
// The candidate must be bit-identical to the reference's in phase 0,
// in phase 1 and in the plain version, so every float operation is
// pinned to one rounding: __fmul_rn / __fadd_rn cannot be contracted
// into an FMA, and __uint2float_rn converts the 24-bit hash exactly.
#pragma once

#include <cuda_runtime.h>

#include "bfs_common.cuh"

namespace relax {

// parent-resolve sentinel: larger than any vertex id
constexpr int kUnset = 0x7fffffff;

// The reference's `_weight_impl`: a symmetric splitmix hash of the
// endpoints -> float32 in [1, 2).
__device__ __forceinline__ float edge_weight(int u, int v) {
  const unsigned a = static_cast<unsigned>(min(u, v));
  const unsigned b = static_cast<unsigned>(max(u, v));
  unsigned x = a * 0x9E3779B1u + b;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return __fadd_rn(1.0f, __fmul_rn(__uint2float_rn(x >> 8),
                                   1.0f / 16777216.0f));
}

// cand = vals[u] + unit (+ w(u, v)) as a 32-bit pattern.
template <bool kFloat>
__device__ __forceinline__ int candidate(int val_u, int u, int v, int unit,
                                         bool weighted) {
  if constexpr (kFloat) {
    float c = __int_as_float(val_u);
    if (weighted) c = __fadd_rn(c, edge_weight(u, v));
    else if (unit) c = __fadd_rn(c, static_cast<float>(unit));
    return __float_as_int(c);
  } else {
    return val_u + unit;
  }
}

// Relax edge (u, v) of one root, both ends real vertices, on pointers to
// v's entries: phase 0 folds the candidate into out[v]; phase 1 (after
// every phase-0 atomic has landed: the next launch) offers u as v's
// parent when the candidate equals v's final value and improved on the
// layer-start value.
__device__ __forceinline__ void relax_at(int phase, int u, int cand,
                                         const int* val_v, int* out_v,
                                         int* pl_v) {
  if (phase == 0) {
    if (cand < __ldg(val_v)) atomicMin(out_v, cand);
  } else {
    const int cur = __ldg(out_v);
    if (cand == cur && cur < __ldg(val_v)) atomicMin(pl_v, u);
  }
}

}  // namespace relax
