// K13 redesigned: the host loops' measure kernel, one launch per layer,
// for Hopper.
//
// Replaces: src/repro/kernels/bitmap_kernels.py, `popcount` (Pallas body
// `_popcount_kernel`: per-tile population counts accumulated into one
// scalar across the sequential grid), and the plain-torch Table-1
// counters around it in the port's host loops (core/engine.py
// `_traverse_impl`, algorithms/traversal.py `traverse_semiring`), which
// the reference computes in jnp in the same `bfs.measure_decide` scope
// as its termination test: per root the frontier's popcount and degree
// sum and, for BeamerHybrid, the unvisited set's (`~visited`: padding is
// premarked), their batch sums and the policy's decision.
//
// What it computes, from (B, n_words) frontier words, optional (B,
// n_words) visited words and the (32 n_words,) padded degree array (the
// format's `degree_matrix`):
//   per_root (B, 4) int32: frontier count, frontier degree sum,
//       unvisited count, unvisited degree sum (the last two 0 without
//       visited; the degree sums 0 without deg: the count-only arm);
//   sums (4,) float32: each counter's exact int64 batch sum, rounded;
//   total (1,) int32: the batch's frontier count, K13's result and the
//       host loop's termination test.
// With a layer record (stats, depths, ctrl) the last CTA also writes
// what the host loop used to write with a dozen small torch launches:
// the previous row's "discovered" column (this layer's count: it is the
// previous layer's output) where asked; if any frontier is non-empty,
// the row's columns 0, 1 and 4, depths += (count > 0) and, for a
// registered policy (kind >= 0), its mode in column 3 and ctrl = [active,
// mode, bottom_up], bottom_up read from ctrl and written back.  The host
// reads ctrl with its one sync per layer.
//
// What bounds it on this card: bytes.  At SCALE 22 with 8 roots the
// frontier (4.19 MB), visited (4.19 MB) and degrees (16.8 MB) are read
// once: ~25 MB, ~7.5 us at 3.35 TB/s; at 33 roots ~51 MB, ~15 us.  The
// degrees are the largest input, so each CTA takes a contiguous range
// of words for ALL roots and loads each degree once: a warp takes 32
// words (1024 vertices) at a time, lane l word l, whose 32 degrees it
// holds in registers after one pass through shared memory; they serve
// every root (up to 512 roots: a larger batch reads the degrees once per
// 512).  The roots' words come 8 roots at a time, each load a
// coalesced 128 bytes per warp; per root and step each lane adds its
// word's bits (popcount, and a test and a predicated add per bit for a
// degree sum, `sum32`),
// one warp reduction per counter and one shared atomic per counter
// follow, and the CTA adds its shared sums to a (B, 4) int64
// accumulator with one atomic per root and counter.  Two earlier
// designs lost here: a warp reduction per root and 4 words (`count4`,
// as K6 does for its one root at a time) was instruction-bound, 45 us
// at SCALE 22; 4 vertices per lane with each lane's sums of 8 roots in
// registers, reduced once per CTA, held too few loads in flight (33 us)
// and read the degrees once per 8 roots.  The count-only arm reads one
// word per lane and keeps 8 roots' counts per lane in registers.  The
// CTA that takes the last ticket after a fence reads the accumulator,
// writes the outputs and the record, and zeroes the accumulator and
// the ticket again, so the next launch finds them zero without a
// memset.  No (B, W, 32) temporary is ever made.
#include <cuda_runtime.h>

#include "counters.cuh"

namespace {

using bfs::kStatCols;
using bfs::kThreads;
using bfs::kWarps;

struct Measure {
  const unsigned* frontier;   // (B, n_words)
  const unsigned* visited;    // (B, n_words); null: no unvisited pair
  const int* deg;             // (32 n_words,); null: count-only arm
  int* per_root;              // (B, 4)
  float* sums;                // (4,)
  int* total;                 // (1,)
  unsigned long long* acc;    // (B, 4) then the ticket; zero on entry
  int* ctrl;                  // (3,) active, mode, bottom_up; or null
  int* stats;                 // (max_layers, 8) or null
  int* depths;                // (B,) or null
  long long n_words;
  int n_batch, layer, max_layers, prev_row;
  bfs::Policy pol;            // kind < 0: no decision
};

// This CTA's contiguous range [begin, end) of n steps.
__device__ __forceinline__ void cta_range(long long n, long long* begin,
                                          long long* end) {
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  *begin = min(n, per * blockIdx.x);
  *end = min(n, *begin + per);
}

// The degree sum of the vertices whose bits are set in `bits` (bit j:
// the vertex whose degree is d[j]): per bit a predicate from a masked
// test and a predicated add.  Written in PTX because nvcc compiles the
// same sum written as a select (`bits & (1u << j) ? d[j] : 0`) to more
// instructions per bit, and the kernel is then instruction-bound.
__device__ __forceinline__ int sum32(unsigned bits, const int (&d)[32]) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
        "and.b32 t, %1, %2;\n\tsetp.ne.b32 p, t, 0;\n\t"
        "@p add.s32 %0, %0, %3;\n\t}"
        : "+r"(s)
        : "r"(bits), "r"(1u << j), "r"(d[j]));
  return s;
}

constexpr int kRootChunk = 512;  // roots whose CTA sums shared memory holds
constexpr int kLoadRoots = 8;    // roots whose words one batch of loads takes

// The degree arm: per root the frontier's (and, kUnvisited, ~visited's)
// count and degree sum.  A warp step is 32 words, lane l's word l: the
// step's 1024 degrees come in 8 coalesced 16-byte loads per lane,
// through shared memory (16-byte chunks XOR-swizzled by row, so the
// stores and each lane's reads of its own row are free of bank
// conflicts), into 32 registers per lane that then serve every root of
// the chunk; the roots' words come in coalesced batches of kLoadRoots
// per word; per root one warp reduction per counter and one shared
// atomic per counter and step.  A batch of more than kRootChunk roots
// reads the degrees once per chunk.
template <bool kUnvisited>
__device__ void count_degrees(const Measure& m) {
  __shared__ int4 s_deg[kWarps][32 * 8];
  __shared__ int s_sum[4 * kRootChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kCounters = kUnvisited ? 4 : 2;
  long long begin, end;
  cta_range((m.n_words + 31) / 32, &begin, &end);
  for (int c0 = 0; c0 < m.n_batch; c0 += kRootChunk) {
    const int nc = min(kRootChunk, m.n_batch - c0);
    for (int i = threadIdx.x; i < 4 * nc; i += kThreads) s_sum[i] = 0;
    __syncthreads();
    for (long long s = begin + warp; s < end; s += kWarps) {
      const long long w0 = 32 * s, w = w0 + lane;
      const bool live = w < m.n_words;
      const int4* src = reinterpret_cast<const int4*>(m.deg + 32 * w0);
      const int n_chunks = 8 * static_cast<int>(min(32LL, m.n_words - w0));
      int4 chunk[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int g = lane + 32 * q;
        chunk[q] = g < n_chunks ? __ldg(src + g) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int g = lane + 32 * q, row = g >> 3;
        s_deg[warp][8 * row + ((g & 7) ^ (row & 7))] = chunk[q];
      }
      __syncwarp();
      int d[32];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int4 v = s_deg[warp][8 * lane + (c ^ (lane & 7))];
        d[4 * c] = v.x;
        d[4 * c + 1] = v.y;
        d[4 * c + 2] = v.z;
        d[4 * c + 3] = v.w;
      }
      __syncwarp();                 // the next step overwrites s_deg
      for (int b0 = 0; b0 < nc; b0 += kLoadRoots) {
        unsigned fw[kLoadRoots], uw[kLoadRoots];
#pragma unroll
        for (int i = 0; i < kLoadRoots; ++i) {
          const bool ok = live && b0 + i < nc;
          const long long r = (c0 + b0 + i) * m.n_words + w;
          fw[i] = ok ? __ldg(m.frontier + r) : 0u;
          if constexpr (kUnvisited) uw[i] = ok ? ~__ldg(m.visited + r) : 0u;
        }
#pragma unroll
        for (int i = 0; i < kLoadRoots; ++i) {
          if (b0 + i >= nc) break;                  // the same in the warp
          int v[4] = {__popc(fw[i]), sum32(fw[i], d), 0, 0};
          if constexpr (kUnvisited) {
            v[2] = __popc(uw[i]);
            v[3] = sum32(uw[i], d);
          }
          int mine = 0;
#pragma unroll
          for (int k = 0; k < kCounters; ++k) {
            const int t = __reduce_add_sync(0xffffffffu, v[k]);
            if (lane == k) mine = t;
          }
          if (lane < kCounters && mine)
            atomicAdd(s_sum + 4 * (b0 + i) + lane, mine);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * nc; i += kThreads)
      if (s_sum[i])
        atomicAdd(m.acc + 4LL * c0 + i,
                  static_cast<unsigned long long>(s_sum[i]));
    __syncthreads();
  }
}

constexpr int kPass = 8;  // roots the count-only arm keeps per lane

// The count-only arm: per root the frontier's count, one word per lane;
// each lane keeps a pass of kPass roots' counts in registers, reduced
// over the CTA once per pass (one warp reduction per root, one pass
// through shared memory) and added to the accumulator with one atomic
// per root.
__device__ void count_words(const Measure& m) {
  __shared__ int s_part[kWarps][kPass];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long begin, end;
  cta_range((m.n_words + 31) / 32, &begin, &end);
  for (int b0 = 0; b0 < m.n_batch; b0 += kPass) {
    const int nb = min(kPass, m.n_batch - b0);
    int part[kPass] = {};
    for (long long s = begin + warp; s < end; s += kWarps) {
      const long long w = 32 * s + lane;
      const bool live = w < m.n_words;
#pragma unroll
      for (int i = 0; i < kPass; ++i)
        part[i] += __popc(live && i < nb
                              ? __ldg(m.frontier + (b0 + i) * m.n_words + w)
                              : 0u);
    }
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      const int v = __reduce_add_sync(0xffffffffu, part[i]);
      if (lane == 0) s_part[warp][i] = v;
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      long long t = 0;
      for (int w = 0; w < kWarps; ++w) t += s_part[w][threadIdx.x];
      if (t)
        atomicAdd(m.acc + 4LL * (b0 + threadIdx.x),
                  static_cast<unsigned long long>(t));
    }
    __syncthreads();
  }
}

// The last CTA: outputs, the layer record, the accumulator zeroed.
__device__ void finish(const Measure& m) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(m.acc + 4LL * m.n_batch, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  long long tot[4] = {0, 0, 0, 0};
  for (int b = threadIdx.x; b < m.n_batch; b += kThreads)
    for (int k = 0; k < 4; ++k) {
      const long long c = static_cast<long long>(__ldcg(m.acc + 4 * b + k));
      m.acc[4 * b + k] = 0ull;
      m.per_root[4 * b + k] = static_cast<int>(c);
      tot[k] += c;
    }
  bfs::block_sum(tot);
  const bool active = tot[0] > 0;
  const bool row = m.stats != nullptr && active && m.layer < m.max_layers;
  if (row && m.depths != nullptr)
    for (int b = threadIdx.x; b < m.n_batch; b += kThreads)
      if (m.per_root[4 * b] > 0) m.depths[b] += 1;
  if (threadIdx.x != 0) return;
  *m.total = static_cast<int>(tot[0]);
  for (int k = 0; k < 4; ++k) m.sums[k] = __ll2float_rn(tot[k]);
  if (m.stats != nullptr && m.prev_row >= 0)
    m.stats[kStatCols * m.prev_row + 2] = static_cast<int>(tot[0]);
  if (row) {
    int* r = m.stats + kStatCols * m.layer;
    r[0] = static_cast<int>(tot[0]);
    r[1] = static_cast<int>(tot[1]);
    r[4] = 1;
  }
  if (m.ctrl != nullptr) {
    m.ctrl[0] = active;
    if (row && m.pol.kind >= 0) {
      bool bottom_up = m.ctrl[2] != 0;
      const int mode = bfs::decide(m.pol, m.layer, __ll2float_rn(tot[0]),
                                   __ll2float_rn(tot[1]),
                                   __ll2float_rn(tot[2]),
                                   __ll2float_rn(tot[3]), &bottom_up);
      m.stats[kStatCols * m.layer + 3] = mode;
      m.ctrl[1] = mode;
      m.ctrl[2] = bottom_up;
    }
  }
  m.acc[4LL * m.n_batch] = 0ull;      // the ticket, for the next launch
}

// kArm: 0 count-only, 1 degrees, 2 degrees and the unvisited pair
template <int kArm>
__global__ void __launch_bounds__(kThreads) measure_kernel(Measure m) {
  if constexpr (kArm == 0)
    count_words(m);
  else
    count_degrees<kArm == 2>(m);
  finish(m);
}

}  // namespace

// frontier, visited: (B, n_words) 32-bit words (visited may be null);
// deg: (32 n_words,) int32, 16-byte aligned, or null (count-only arm);
// per_root (B, 4) int32, sums (4,) float32, total (1,) int32 outputs;
// acc: (4 B + 1,) int64, zero on entry and left zero; ctrl (3,), stats
// (max_layers, 8), depths (B,): the layer record, or null; simd_layer:
// (max_layers,) 0/1 (PaperLiteralLayers) or null.  prev_row < 0 writes
// no discovered column; kind < 0 decides nothing.
extern "C" int repro_measure(
    const void* frontier, const void* visited, const void* deg,
    void* per_root, void* sums, void* total, void* acc, void* ctrl,
    void* stats, void* depths, const void* simd_layer, long long n_words,
    int n_batch, int layer, int max_layers, int prev_row, int kind,
    float alpha, float v_over_beta, float threshold, int grid,
    void* stream) {
  if (n_batch <= 0 || grid <= 0) return 0;
  Measure m{static_cast<const unsigned*>(frontier),
            static_cast<const unsigned*>(visited),
            static_cast<const int*>(deg),
            static_cast<int*>(per_root),
            static_cast<float*>(sums),
            static_cast<int*>(total),
            static_cast<unsigned long long*>(acc),
            static_cast<int*>(ctrl),
            static_cast<int*>(stats),
            static_cast<int*>(depths),
            n_words, n_batch, layer, max_layers, prev_row,
            bfs::Policy{kind, alpha, v_over_beta, threshold,
                        static_cast<const int*>(simd_layer)}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (deg == nullptr)
    measure_kernel<0><<<grid, kThreads, 0, s>>>(m);
  else if (visited == nullptr)
    measure_kernel<1><<<grid, kThreads, 0, s>>>(m);
  else
    measure_kernel<2><<<grid, kThreads, 0, s>>>(m);
  return static_cast<int>(cudaGetLastError());
}
