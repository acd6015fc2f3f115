// K2: SIMD frontier compaction (paper §4 queue generation) for Hopper.
//
// Replaces: src/repro/kernels/compact.py, `frontier_compact_batched`
// (Pallas body `_compact_batched_kernel`, tile offsets from `_plan`)
// and, at B = 1, `frontier_compact` (`_compact_kernel`,
// `_rank_scatter`).
//
// What it computes: a (B, W) packed bitmap becomes a (B, size) queue of
// the set-bit vertex ids in ascending order, padded with `fill`, plus
// the per-root set-bit counts.  Ids whose rank is >= size are dropped.
//
// Three launches, the middle step in torch:
//   1. tile_popcounts_kernel: one CTA per (256-word tile, root) sums
//      __popc over its words;
//   2. an exclusive scan of the per-tile counts gives each tile's base
//      offset in its root's queue (torch.cumsum in the wrapper; the
//      reference also scans outside its kernel, in `_plan`);
//   3. rank_scatter_kernel: one CTA per (tile, root).  Each thread owns
//      one word; a block-wide exclusive scan of the word popcounts
//      ranks it, and its set bits are written in ascending order with
//      __ffs.  The ids go to shared memory first and leave it in one
//      coalesced pass over the tile's contiguous queue range.
//      fill_tail_kernel then writes `fill` into slots [count, size).
//
// What bounds it on this card: bytes.  The words are read twice
// (4 * B * W each pass, a few MB) and every queue slot is written once
// (4 * B * size).  At size = V_pad the queue write dominates.
#include <cuda_runtime.h>

namespace {

constexpr int kTileWords = 256;        // words per tile == threads per CTA
constexpr int kWarps = kTileWords / 32;

__global__ void tile_popcounts_kernel(const unsigned* __restrict__ words,
                                      int* __restrict__ per_tile,
                                      int n_words, int n_tiles) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int w = t * kTileWords + threadIdx.x;
  int c = w < n_words ? __popc(words[(long long)b * n_words + w]) : 0;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  __shared__ int warp_sum[kWarps];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int i = 0; i < kWarps; ++i) s += warp_sum[i];
    per_tile[(long long)b * n_tiles + t] = s;
  }
}

__global__ void rank_scatter_kernel(const unsigned* __restrict__ words,
                                    const int* __restrict__ offs,
                                    int* __restrict__ queue, int n_words,
                                    int n_tiles, int size) {
  __shared__ int stage[kTileWords * 32];     // 32 KB: a full tile's ids
  __shared__ int warp_incl[kWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = t * kTileWords + threadIdx.x;
  unsigned word = w < n_words ? words[(long long)b * n_words + w] : 0u;
  const int c = __popc(word);

  // block-wide exclusive scan of the per-word popcounts
  int x = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_incl[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_incl[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_incl[lane] = s;
  }
  __syncthreads();
  int rank = x - c + (warp > 0 ? warp_incl[warp - 1] : 0);
  const int tile_count = warp_incl[kWarps - 1];

  // set bits in ascending order: the lowest set bit first
  const int base_vid = w * 32;
  while (word) {
    stage[rank++] = base_vid + __ffs(word) - 1;
    word &= word - 1;
  }
  __syncthreads();

  const long long base = offs[(long long)b * n_tiles + t];
  int* q = queue + (long long)b * size;
  for (int i = threadIdx.x; i < tile_count; i += kTileWords) {
    const long long pos = base + i;
    if (pos < size) q[pos] = stage[i];      // ranks past size drop out
  }
}

__global__ void fill_tail_kernel(int* __restrict__ queue,
                                 const int* __restrict__ total, int size,
                                 int fill) {
  const int b = blockIdx.y;
  const int start = min(total[b], size);
  int* q = queue + (long long)b * size;
  for (int i = start + blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += gridDim.x * blockDim.x)
    q[i] = fill;
}

}  // namespace

// words: (B, n_words) 32-bit words; per_tile: (B, n_tiles) int32 with
// n_tiles = ceil(n_words / 256).
extern "C" int repro_tile_popcounts(const void* words, void* per_tile,
                                    int n_batch, int n_words, int n_tiles,
                                    void* stream) {
  if (n_batch == 0 || n_tiles == 0) return 0;
  dim3 grid(n_tiles, n_batch);
  tile_popcounts_kernel<<<grid, kTileWords, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (int*)per_tile, n_words, n_tiles);
  return (int)cudaGetLastError();
}

// offs: (B, n_tiles) exclusive tile offsets; total: (B,) set-bit
// counts; queue: (B, size) int32 output.
extern "C" int repro_rank_scatter(const void* words, const void* offs,
                                  const void* total, void* queue,
                                  int n_batch, int n_words, int n_tiles,
                                  int size, int fill, void* stream) {
  if (n_batch == 0 || size == 0) return 0;
  if (n_tiles > 0) {
    dim3 grid(n_tiles, n_batch);
    rank_scatter_kernel<<<grid, kTileWords, 0, (cudaStream_t)stream>>>(
        (const unsigned*)words, (const int*)offs, (int*)queue, n_words,
        n_tiles, size);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (size + kTileWords - 1) / kTileWords;
  if (blocks > 1024) blocks = 1024;
  dim3 grid(blocks, n_batch);
  fill_tail_kernel<<<grid, kTileWords, 0, (cudaStream_t)stream>>>(
      (int*)queue, (const int*)total, size, fill);
  return (int)cudaGetLastError();
}
