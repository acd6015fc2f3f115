// K2: SIMD frontier compaction (paper §4 queue generation) for Hopper,
// one single-pass launch.
//
// Replaces: src/repro/kernels/compact.py, `frontier_compact_batched`
// (Pallas body `_compact_batched_kernel`, tile offsets from `_plan`)
// and, at B = 1, `frontier_compact` (`_compact_kernel`,
// `_rank_scatter`).  Its stream arm also replaces the first half of
// the plain apportionment (core/engine.py `apportion`: the entries'
// degrees and their int32 `cumsum`).
//
// What it computes: a (B, W) packed bitmap becomes a (B, size) queue of
// the set-bit vertex ids in ascending order, padded with `fill`, plus
// the per-root set-bit counts (not capped at size).  Ids whose rank is
// >= size are dropped.  The stream arm (deg given) also writes, for
// each queue entry of rank r < min(count, size), `cum[r]`: the
// inclusive prefix of the entries' degrees (deg[v], 0 for v >=
// n_vertices); per root `total` (the last entry's cum, 0 for an empty
// queue) and `truncated` = max(total - n_slots, 0).  cum past the
// count is not written.
//
// The TPU version plans the tile offsets in one call and scatters in
// another; the port's first version was three launches with a torch
// cumsum between them.  Here one CTA takes one tile of 256 words (8192
// vertices) of one root and finds its offset in the root's queue by
// decoupled look-back: it publishes its tile's (count, degree sum) at
// once, sums its predecessors' published values 32 tiles at a time
// (lane i tile t - 1 - i) until it meets one that published its
// inclusive prefix, then publishes its own inclusive prefix.  A CTA only
// waits on tiles of lower block index, which the hardware starts first.
// Status words are 64 bits (2 flag bits, a 31-bit count, a 31-bit
// degree sum: both are int32 quantities), cleared by a memset before
// the launch.  Inside the tile a block scan of the word popcounts ranks
// each word; each warp then walks its 32 words one at a time, lane k
// holding bit k, so the degrees of a word come in one coalesced
// 128-byte load and their prefix in one warp scan; ids (and cum) go to
// shared memory and leave in one coalesced pass over the tile's range
// of the queue.  Fill: the tile's zero bits take the positions from the
// top of the queue down, size - 1 - (zeros before the tile) and below,
// which the tile knows from its own prefix, so [count, size) is
// written by the tiles themselves with no second pass.
//
// What bounds it on this card: bytes.  The words are read once (4 B W),
// every queue slot is written once (4 B size), cum once per entry, and
// the stream arm reads the degree of each set bit (lane k of a word
// with a set bit loads deg[32 w + k] where bit k is set): at least a
// 32-byte sector for each byte of the words with a set bit.  At size =
// V_pad the queue write dominates.
#include <cuda_runtime.h>

namespace {

constexpr int kTileWords = 256;              // words per tile == threads
constexpr int kTileBits = kTileWords * 32;
constexpr int kWarps = kTileWords / 32;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValues = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long pack(long long count,
                                                   long long degs) {
  return (static_cast<unsigned long long>(count) << 31) |
         static_cast<unsigned long long>(degs);
}

__device__ __forceinline__ void publish(unsigned long long* at,
                                        unsigned long long v) {
  __threadfence();
  atomicExch(at, v);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* at) {
  return *static_cast<const volatile unsigned long long*>(at);
}

// Warp 0, lane 0's result: the root's (count, degree sum) before tile t,
// packed; tiles before t are read from `status` (t > 0).
__device__ unsigned long long look_back(const unsigned long long* status,
                                        int t) {
  const int lane = threadIdx.x & 31;
  unsigned long long excl = 0;
  for (int top = t - 1; top >= 0; top -= 32) {
    const int at = top - lane;
    unsigned long long s = kInclusive;         // before tile 0: nothing
    if (at >= 0)
      do {
        s = peek(status + at);
      } while ((s >> 62) == 0);
    const unsigned incl = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    // lanes up to the nearest inclusive prefix (lane 0 is tile top)
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long v = lane <= stop && at >= 0 ? (s & kValues) : 0ull;
    // the two 31-bit fields add without carrying into each other: every
    // partial sum is a prefix of int32 quantities
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    excl += __shfl_sync(0xffffffffu, v, 0);
    if (incl) break;
  }
  __threadfence();
  return excl;
}

struct Compact {
  const unsigned* words;          // (B, n_words)
  const int* deg;                 // (32 n_words,) or null
  int* queue;                     // (B, size)
  int* count;                     // (B,)
  int* cum;                       // (B, size), stream arm
  int* total;                     // (B,), stream arm
  int* truncated;                 // (B,), stream arm
  unsigned long long* status;     // (B, n_tiles), zero on entry
  int n_words, n_tiles, size, fill, n_vertices, n_slots;
};

template <bool kStream>
__global__ void __launch_bounds__(kTileWords)
    compact_kernel(Compact c) {
  extern __shared__ int stage[];  // ids; the stream arm's cum after them
  __shared__ int s_warp_incl[kWarps];
  __shared__ int s_warp_start[kWarps];
  __shared__ long long s_warp_deg[kWarps + 1];
  __shared__ unsigned long long s_excl;
  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(t) * kTileWords + threadIdx.x;
  const unsigned word =
      w < c.n_words ? __ldg(c.words + b * static_cast<long long>(c.n_words) +
                            w)
                    : 0u;
  const int n = __popc(word);

  // block-wide exclusive scan of the word popcounts
  int x = n;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp_incl[warp] = x;
  __syncthreads();
  int before_warp = 0, tile_count = 0;
  for (int i = 0; i < kWarps; ++i) {
    before_warp += i < warp ? s_warp_incl[i] : 0;
    tile_count += s_warp_incl[i];
  }
  const int rank = before_warp + x - n;
  if (lane == 0) s_warp_start[warp] = before_warp;

  // ids (and the in-warp degree prefix) into shared memory, word by word
  int* stage_cum = stage + kTileBits;
  long long warp_deg = 0;
  const long long w0 = static_cast<long long>(t) * kTileWords + 32 * warp;
  for (int j = 0; j < 32; ++j) {
    const unsigned wj = __shfl_sync(0xffffffffu, word, j);
    if (wj == 0u) continue;                      // the same in the warp
    const int rj = __shfl_sync(0xffffffffu, rank, j);
    const bool set = (wj >> lane) & 1u;
    const int pos = rj + __popc(wj & ((1u << lane) - 1u));
    const long long v = 32 * (w0 + j) + lane;
    if constexpr (kStream) {
      int d = set && v < c.n_vertices ? __ldg(c.deg + v) : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, d, o);
        if (lane >= o) d += y;
      }
      if (set) stage_cum[pos] = static_cast<int>(warp_deg) + d;
      warp_deg += __shfl_sync(0xffffffffu, d, 31);
    }
    if (set) stage[pos] = static_cast<int>(v);
  }
  if constexpr (kStream) {
    if (lane == 0) s_warp_deg[warp] = warp_deg;
  }
  __syncthreads();
  long long tile_deg = 0;
  if constexpr (kStream) {
    if (threadIdx.x == 0) {
      long long run = 0;
      for (int i = 0; i < kWarps; ++i) {     // exclusive, then the total
        const long long d = s_warp_deg[i];
        s_warp_deg[i] = run;
        run += d;
      }
      s_warp_deg[kWarps] = run;
    }
    __syncthreads();
    tile_deg = s_warp_deg[kWarps];
  }

  // the tile's offset in the root's queue: decoupled look-back
  unsigned long long* status = c.status + static_cast<long long>(b) *
                                              c.n_tiles;
  if (warp == 0) {
    const unsigned long long mine = pack(tile_count, tile_deg);
    unsigned long long excl = 0;
    if (t == 0) {
      if (lane == 0) publish(status, kInclusive | mine);
    } else {
      if (lane == 0) publish(status + t, kAggregate | mine);
      excl = look_back(status, t);
      if (lane == 0) publish(status + t, kInclusive | (excl + mine));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const long long excl_count = static_cast<long long>(s_excl >> 31);
  const long long excl_deg = static_cast<long long>(s_excl & 0x7fffffffull);
  const long long root_count = excl_count + tile_count;

  // the tile's ids (and cum) into the queue, coalesced; ranks past size
  // drop out
  const long long row = static_cast<long long>(b) * c.size;
  for (int i = threadIdx.x; i < tile_count; i += kTileWords) {
    const long long r = excl_count + i;
    if (r >= c.size) break;
    c.queue[row + r] = stage[i];
    if constexpr (kStream) {
      int wi = 0;                                // the entry's warp
      while (wi + 1 < kWarps && s_warp_start[wi + 1] <= i) ++wi;
      const int cum = static_cast<int>(excl_deg + s_warp_deg[wi]) +
                      stage_cum[i];
      c.cum[row + r] = cum;
      if (r == c.size - 1) {                     // the queue's last entry
        c.total[b] = cum;
        c.truncated[b] = max(cum - c.n_slots, 0);
      }
    }
  }

  // fill: the tile's zero bits, from the top of the queue down
  const long long bits_before = static_cast<long long>(t) * kTileBits;
  const long long live_bits =
      32 * (min(static_cast<long long>(c.n_words), (t + 1LL) * kTileWords) -
            static_cast<long long>(t) * kTileWords);
  const long long zeros_before = bits_before - excl_count;
  const long long v_pad = 32LL * c.n_words;
  const long long hi = v_pad - zeros_before;              // exclusive
  const long long lo = hi - (live_bits - tile_count);
  for (long long p = lo + threadIdx.x;
       p < min(hi, static_cast<long long>(c.size)); p += kTileWords)
    c.queue[row + p] = c.fill;
  // a queue longer than the bitmap: the slots past v_pad
  for (long long p = v_pad + t * static_cast<long long>(kTileWords) +
                     threadIdx.x;
       p < c.size; p += static_cast<long long>(c.n_tiles) * kTileWords)
    c.queue[row + p] = c.fill;

  if (t == c.n_tiles - 1 && threadIdx.x == 0) {   // the root's last tile
    c.count[b] = static_cast<int>(root_count);
    if constexpr (kStream) {
      if (c.size == 0) {
        c.total[b] = 0;
        c.truncated[b] = 0;
      } else if (root_count < c.size) {
        const int tot = static_cast<int>(excl_deg + tile_deg);
        c.total[b] = tot;
        c.truncated[b] = max(tot - c.n_slots, 0);
      }
    }
  }
}

}  // namespace

// words: (B, n_words) 32-bit words; queue: (B, size) int32; count: (B,)
// int32; status: (B, ceil(n_words / 256)) int64 scratch, cleared here.
// The stream arm (deg non-null: (32 n_words,) int32 degrees, 0 past
// n_vertices) also writes cum (B, size), total and truncated (B,).
extern "C" int repro_compact(const void* words, const void* deg,
                             void* queue, void* count, void* cum,
                             void* total, void* truncated, void* status,
                             int n_batch, int n_words, int size, int fill,
                             int n_vertices, int n_slots, void* stream) {
  if (n_batch == 0) return 0;
  const int n_tiles = (n_words + kTileWords - 1) / kTileWords;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles == 0) return 0;
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * n_batch * n_tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Compact c{static_cast<const unsigned*>(words),
            static_cast<const int*>(deg),
            static_cast<int*>(queue),
            static_cast<int*>(count),
            static_cast<int*>(cum),
            static_cast<int*>(total),
            static_cast<int*>(truncated),
            static_cast<unsigned long long*>(status),
            n_words, n_tiles, size, fill, n_vertices, n_slots};
  const dim3 grid(n_tiles, n_batch);
  if (deg == nullptr) {
    compact_kernel<false><<<grid, kTileWords, kTileBits * sizeof(int), s>>>(
        c);
  } else {
    static bool opted = false;
    if (!opted) {
      err = cudaFuncSetAttribute(compact_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 2 * kTileBits * sizeof(int));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted = true;
    }
    compact_kernel<true><<<grid, kTileWords, 2 * kTileBits * sizeof(int),
                           s>>>(c);
  }
  return static_cast<int>(cudaGetLastError());
}
