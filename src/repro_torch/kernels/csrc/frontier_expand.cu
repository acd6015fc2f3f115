// K7: the materialized pipeline's expansion over an apportioned edge
// stream (the paper's Listing 1), for Hopper.
//
// Replaces: src/repro/kernels/frontier_expand.py,
// `frontier_expand_batched` (Pallas body `_expand_batched_kernel` over
// `_expand_tile`) and, at B = 1, `frontier_expand` (`_expand_kernel`).
//
// What it computes, per root b and stream slot i with valid[b][i] set:
// cand = cand[b][i] is discovered from nbr = nbr[b][i] when its bit is
// in neither visited nor out and, bottom-up (check_frontier), nbr is in
// the frontier; then P[cand] = nbr - |V| and cand's bit is ORed into
// out with the paper's non-atomic read-OR-write (§3.3.2).  `out` and P
// are updated in place; restoration (K1) makes the result exact.
//
// The reference's grid walks the tiles of a root in order, so tile
// t + 1 sees tile t's writes.  CTAs have no order, so K7 is held to
// K3's contract instead: after restoration `out`, `visited` and the
// marked set equal the plain version's, and every mark names a valid
// lane's nbr (in the frontier, bottom-up); which duplicate discovery
// survives in P differs.
//
// What bounds it on this card: bytes.  The stream is e_pad slots per
// root whatever the frontier: 4 + 4 + 1 bytes per slot (nbr, cand and
// the valid flag as one byte), read once, coalesced; then per valid
// slot a visited and an out word (the bitmaps are 0.5 MB per root at
// SCALE 22, L2-resident), a frontier word bottom-up, and 4 bytes of P
// per discovery.  One thread per (root, slot): a grid-stride loop over
// the slots with the root on grid.y; invalid slots cost their flag's
// byte only.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) frontier_expand_kernel(
    const int* __restrict__ nbr, const int* __restrict__ cand,
    const unsigned char* __restrict__ valid,
    const unsigned* __restrict__ frontier,
    const unsigned* __restrict__ visited, unsigned* out, int* p,
    long long n_slots, int n_words, int v_pad, int n_vertices,
    int check_frontier) {
  const int b = blockIdx.y;
  const long long so = static_cast<long long>(b) * n_slots;
  const unsigned* fr = frontier + static_cast<long long>(b) * n_words;
  const unsigned* vis = visited + static_cast<long long>(b) * n_words;
  unsigned* ob = out + static_cast<long long>(b) * n_words;
  int* pb = p + static_cast<long long>(b) * v_pad;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_slots; i += stride) {
    if (!valid[so + i]) continue;
    const int c = __ldg(cand + so + i);
    const int g = __ldg(nbr + so + i);
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(n_vertices) ||
        static_cast<unsigned>(g) >= static_cast<unsigned>(n_vertices))
      continue;
    const int w = c >> 5;
    const unsigned bit = 1u << (c & 31);
    const unsigned ow = ob[w];                        // racy read
    if ((vis[w] | ow) & bit) continue;
    if (check_frontier && !((fr[g >> 5] >> (g & 31)) & 1u)) continue;
    pb[c] = g - n_vertices;                           // negative mark
    ob[w] = ow | bit;                                 // racy write
  }
}

}  // namespace

// nbr, cand: (B, n_slots) int32; valid: (B, n_slots) bytes (0/1);
// frontier, visited, out: (B, n_words) 32-bit words; p: (B, v_pad)
// int32.  out and p are updated in place.
extern "C" int repro_frontier_expand(
    const void* nbr, const void* cand, const void* valid,
    const void* frontier, const void* visited, void* out, void* p,
    int n_batch, long long n_slots, int n_words, int v_pad, int n_vertices,
    int check_frontier, int grid_x, void* stream) {
  if (n_batch == 0 || n_slots == 0 || grid_x <= 0) return 0;
  dim3 grid(grid_x, n_batch);
  frontier_expand_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), static_cast<const int*>(cand),
      static_cast<const unsigned char*>(valid),
      static_cast<const unsigned*>(frontier),
      static_cast<const unsigned*>(visited), static_cast<unsigned*>(out),
      static_cast<int*>(p), n_slots, n_words, v_pad, n_vertices,
      check_frontier);
  return static_cast<int>(cudaGetLastError());
}
