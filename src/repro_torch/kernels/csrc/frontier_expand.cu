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
// root whatever the frontier: a valid flag (one byte) for every slot,
// nbr and cand (4 + 4 bytes) for the valid ones, read once; then per
// valid slot a visited and an out word (the bitmaps are 0.5 MB per
// root at SCALE 22, L2-resident), a frontier word bottom-up, and 4
// bytes of P per discovery.
//
// The design.  The first port ran one thread per slot: a 1-byte flag
// load, then two 4-byte loads, then the bitmap words, one dependent
// chain per slot, and an invalid slot still cost a warp iteration.
// Here a thread takes a chunk of kChunk = 16 consecutive slots of the
// flattened (B * n_slots) stream: one 16-byte load of the 16 flags, and
// the nbr / cand quads (16 bytes each) only where one of their 4 flags
// is set, so an invalid run costs its flags alone.  The stream lays
// each adjacency out contiguously, so runs of consecutive slots share
// an owner (nbr top-down, cand bottom-up).  Bottom-up (check_frontier)
// the slots are taken in order: a run's cand word and out word are
// loaded once, and the run stops at its cand's first frontier
// neighbour (K9's per-root break), so the random frontier words (the
// first port loaded one per valid slot: 685 million on the largest
// SCALE-22 layer) are looked up only until then; the marked set does
// not change, since a marked cand fails `(visited | out) & bit`.  Top-down the cands are random: the chunk's
// words are loaded together, then tested and written in slot order.
// visited and frontier, which K7 never writes, are read by the
// non-coherent path.  Nothing assumes that the valid slots are a prefix
// of a row: a chunk may cross roots (its slots find their root by the
// row boundary), and the last total % 16 slots, or every slot when a
// stream's base is not 16-byte aligned, take the scalar path (one slot
// per thread) through the same per-slot code.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;        // slots per thread: one 16-byte flag load

struct Stream {
  const int* nbr;
  const int* cand;
  const unsigned char* valid;
  const unsigned* frontier;                  // read by the non-coherent
  const unsigned* visited;                   // path: K7 never writes them
  unsigned* out;
  int* p;
  long long n_slots;               // per root
  int n_words;                     // per root; P rows are 32 * n_words
  int n_vertices;
};

// The root of flat slot i0 + k, the roots' boundaries crossed in order
// (a chunk may span several roots when n_slots < 16).
struct RootCursor {
  long long b, next;                // root, the next root's first slot

  __device__ RootCursor(long long i0, long long n_slots)
      : b(i0 / n_slots), next((i0 / n_slots + 1) * n_slots) {}
  // advances to slot i's root; true when it changed
  __device__ bool seek(long long i, long long n_slots) {
    bool moved = false;
    while (i >= next) {
      ++b;
      next += n_slots;
      moved = true;
    }
    return moved;
  }
};

// The expansion of N consecutive slots from flat index i0 (cand c[k],
// nbr g[k]); bit k of `ok` marks a valid slot whose ids are both real.
// Without the frontier test (top-down): each valid slot's words are
// loaded together (wk[k] is cand's word in the flattened (B * n_words)
// bitmaps, whose root b also places P: b * 32 * n_words + c ==
// 32 * wk[k] + (c & 31)), then tested and written in slot order, `run_o`
// the out word as this thread last left it.
template <int N>
__device__ __forceinline__ void expand_topdown(const Stream& s, long long i0,
                                               const int (&c)[N],
                                               const int (&g)[N],
                                               unsigned ok) {
  int wk[N];
  unsigned vw[N], ow[N];
  RootCursor root(i0, s.n_slots);
  int last_w = -1;
  unsigned lv = 0, lo = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    wk[k] = -1;
    if (!((ok >> k) & 1u)) continue;
    root.seek(i0 + k, s.n_slots);
    wk[k] = static_cast<int>(root.b) * s.n_words + (c[k] >> 5);
    if (wk[k] != last_w) {                     // a new word
      last_w = wk[k];
      lv = __ldg(s.visited + last_w);
      lo = s.out[last_w];                      // racy read
    }
    vw[k] = lv;
    ow[k] = lo;
  }
  int run_w = -1;
  unsigned run_o = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (wk[k] < 0) continue;
    const unsigned bit = 1u << (c[k] & 31);
    unsigned o = wk[k] == run_w ? run_o : ow[k];
    if (!((vw[k] | o) & bit)) {
      s.p[32LL * wk[k] + (c[k] & 31)] = g[k] - s.n_vertices;  // mark
      o |= bit;
      s.out[wk[k]] = o;                                       // racy write
    }
    run_w = wk[k];
    run_o = o;
  }
}

// With the frontier test (bottom-up: runs of one cand, each slot a
// neighbour nbr): slot order.  A run's cand word and out word are
// loaded once at its first slot, and the run is done as soon as its
// cand is visited, in out, or marked here: the later slots of the run
// load no frontier word (the per-run break).
template <int N>
__device__ __forceinline__ void expand_bottomup(const Stream& s,
                                                long long i0,
                                                const int (&c)[N],
                                                const int (&g)[N],
                                                unsigned ok) {
  RootCursor root(i0, s.n_slots);
  int run_c = -1, w = -1, row = 0;
  unsigned vis = 0, o = 0;
  bool done = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (!((ok >> k) & 1u)) continue;
    if (root.seek(i0 + k, s.n_slots)) run_c = -1;
    const unsigned bit = 1u << (c[k] & 31);
    if (c[k] != run_c) {                       // a new run
      run_c = c[k];
      row = static_cast<int>(root.b) * s.n_words;
      const int wc = row + (c[k] >> 5);
      if (wc != w) {
        w = wc;
        vis = __ldg(s.visited + w);
        o = s.out[w];                          // racy read
      }
      done = ((vis | o) & bit) != 0;
    }
    if (done) continue;
    const unsigned fw = __ldg(s.frontier + row + (g[k] >> 5));
    if (!((fw >> (g[k] & 31)) & 1u)) continue;
    s.p[32LL * w + (c[k] & 31)] = g[k] - s.n_vertices;         // mark
    o |= bit;
    s.out[w] = o;                                              // racy write
    done = true;
  }
}

template <bool kCheck, int N>
__device__ __forceinline__ void expand_slots(const Stream& s, long long i0,
                                             const int (&c)[N],
                                             const int (&g)[N],
                                             unsigned ok) {
  if constexpr (kCheck)
    expand_bottomup<N>(s, i0, c, g, ok);
  else
    expand_topdown<N>(s, i0, c, g, ok);
}

__device__ __forceinline__ bool real(const Stream& s, int c, int g) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(s.n_vertices) &&
         static_cast<unsigned>(g) < static_cast<unsigned>(s.n_vertices);
}

// kVec: chunks of 16 slots by 16-byte loads (every base 16-byte
// aligned), then the scalar tail; else every slot by the scalar path.
// kCheck: the frontier test (check_frontier).
template <bool kVec, bool kCheck>
__global__ void __launch_bounds__(kThreads) frontier_expand_kernel(
    Stream s, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if constexpr (kVec) {
    const long long n_chunks = total / kChunk;
    const uint4* flags = reinterpret_cast<const uint4*>(s.valid);
    const int4* cand4 = reinterpret_cast<const int4*>(s.cand);
    const int4* nbr4 = reinterpret_cast<const int4*>(s.nbr);
    for (long long j = tid; j < n_chunks; j += stride) {
      const uint4 f = __ldg(flags + j);
      if (!(f.x | f.y | f.z | f.w)) continue;  // an invalid run
      const unsigned fq[4] = {f.x, f.y, f.z, f.w};
      int c[kChunk], g[kChunk];
      unsigned ok = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int4 cv = make_int4(0, 0, 0, 0), gv = cv;
        if (fq[q]) {                           // a quad with a valid slot
          cv = __ldg(cand4 + 4 * j + q);
          gv = __ldg(nbr4 + 4 * j + q);
        }
        const int cq[4] = {cv.x, cv.y, cv.z, cv.w};
        const int gq[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = 4 * q + r;
          c[k] = cq[r];
          g[k] = gq[r];
          if (((fq[q] >> (8 * r)) & 0xffu) && real(s, c[k], g[k]))
            ok |= 1u << k;
        }
      }
      expand_slots<kCheck, kChunk>(s, j * kChunk, c, g, ok);
    }
    tail = n_chunks * kChunk;
  }
  for (long long i = tail + tid; i < total; i += stride) {
    if (!__ldg(s.valid + i)) continue;
    const int c[1] = {__ldg(s.cand + i)};
    const int g[1] = {__ldg(s.nbr + i)};
    expand_slots<kCheck, 1>(s, i, c, g, real(s, c[0], g[0]) ? 1u : 0u);
  }
}

}  // namespace

// nbr, cand: (B, n_slots) int32; valid: (B, n_slots) bytes (0/1);
// frontier, visited, out: (B, n_words) 32-bit words; p: (B, 32 *
// n_words) int32.  out and p are updated in place.  vec: every stream
// base is 16-byte aligned (the chunked path); grid: CTAs of kThreads
// striding over the chunks.
extern "C" int repro_frontier_expand(
    const void* nbr, const void* cand, const void* valid,
    const void* frontier, const void* visited, void* out, void* p,
    int n_batch, long long n_slots, int n_words, int n_vertices,
    int check_frontier, int vec, int grid, void* stream) {
  if (n_batch == 0 || n_slots == 0 || grid <= 0) return 0;
  const Stream s{static_cast<const int*>(nbr), static_cast<const int*>(cand),
                 static_cast<const unsigned char*>(valid),
                 static_cast<const unsigned*>(frontier),
                 static_cast<const unsigned*>(visited),
                 static_cast<unsigned*>(out), static_cast<int*>(p), n_slots,
                 n_words, n_vertices};
  const long long total = n_slots * n_batch;
  auto kernel = vec ? (check_frontier ? frontier_expand_kernel<true, true>
                                      : frontier_expand_kernel<true, false>)
                    : (check_frontier ? frontier_expand_kernel<false, true>
                                      : frontier_expand_kernel<false, false>);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(s, total);
  return static_cast<int>(cudaGetLastError());
}
