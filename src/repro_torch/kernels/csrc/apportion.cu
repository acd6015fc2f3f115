// The materialized stream's apportionment for Hopper (not a TPU kernel:
// the reference writes it in jnp, src/repro/core/engine.py `apportion`).
//
// Replaces: the port's plain-torch `apportion` on the card (core/engine.py
// `_batched_edge_stream`, the materialized SIMD and bottom-up steps and
// the scalar step): a marker scatter, two int32 prefix sums and three
// gathers over five (B, n_slots) int32 temporaries, ~4.3 GB each at
// SCALE 22 with 8 roots.
//
// What it computes: from K2's stream arm (csrc/compact.cu) — each root's
// ascending queue of L vertex ids, the inclusive prefix `cum` of their
// degrees over the first min(count, L) entries and the root's `total` —
// the edge stream of n_slots slots per root: slot s is valid iff s <
// min(total, n_slots); its owner is the entry whose degree range holds s
// (the first entry with cum > s, so zero-degree entries own no slot),
// u = that entry's id and v = rows[colstarts[u] + s - (the entry's cum
// before it)].  A hub that overruns the slots keeps its list prefix.
// u and v are written only where valid holds (the consumer, K7, reads
// them nowhere else); valid is written for every slot.  No temporary.
//
// Owners: a warp takes 2048 consecutive slots of one root.  One
// warp-wide 32-way search of `cum` finds the first slot's owner (about
// five rounds of 32 loads for a 4M-entry queue); the warp then keeps a
// window of 32 entries in registers (lane j: entry o + j's cum, id and
// colstarts[id]) and walks its slots 32 at a time, each lane finding its
// slot's owner in the window by a 5-step shuffle search; a slot past the
// window moves the window 32 entries on.  So every slot costs a few
// shuffles, the stores of u, v and valid are coalesced, and the rows of
// one entry are read in order.  Chosen over a warp per list entry: that
// balances badly between hubs (hundreds of thousands of slots) and the
// many zero- and low-degree entries of a bottom-up queue, and this one
// gives every warp the same number of slots.
//
// What bounds it on this card: bytes.  Each slot's valid flag (1 byte)
// and each valid slot's u, v (8 bytes) and rows entry (4 bytes) once;
// the queue and cum (8 bytes per entry) and one colstarts entry per
// entry once.  At SCALE 22's materialized bottom-up layer (684,992,610
// valid of 1,073,741,824 slots) that is ~9.9 GB, ~3 ms at 3.35 TB/s.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitSlots = 2048;     // slots per warp unit

struct Stream {
  const int* queue;       // (B, L)
  const int* cum;         // (B, L): valid on [0, min(count, L))
  const int* count;       // (B,)
  const int* total;       // (B,)
  const int* colstarts;   // (V + 1,)
  const int* rows;        // (E,)
  int* u;                 // (B, n_slots)
  int* v;                 // (B, n_slots)
  unsigned char* valid;   // (B, n_slots)
  int n_batch, list_size, n_slots;
};

// The first index in cum[0, n) with cum > s (n if none); warp-wide,
// every lane gets it.
__device__ __forceinline__ int owner_of(const int* cum, int n, int s) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;                 // the answer is in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool le = p < hi && __ldg(cum + p) <= s;
    const int k = __popc(__ballot_sync(0xffffffffu, le));
    const int new_lo = k == 0 ? lo : lo + (k - 1) * step + 1;
    hi = min(hi, lo + k * step);
    lo = new_lo;
  }
  const int p = lo + lane;
  const bool le = p < hi && __ldg(cum + p) <= s;
  return lo + __popc(__ballot_sync(0xffffffffu, le));
}

__global__ void __launch_bounds__(kThreads) apportion_kernel(Stream st) {
  const int lane = threadIdx.x & 31;
  const long long units_per_root =
      (st.n_slots + kUnitSlots - 1) / kUnitSlots;
  const long long n_units = units_per_root * st.n_batch;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long unit = (static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x) / 32;
       unit < n_units; unit += warps) {
    const int b = static_cast<int>(unit / units_per_root);
    const int s0 = static_cast<int>((unit % units_per_root) * kUnitSlots);
    const int s1 = min(st.n_slots, s0 + kUnitSlots);
    const long long row = static_cast<long long>(b) * st.n_slots;
    const int valid_end = max(0, min(__ldg(st.total + b), st.n_slots));
    if (s0 >= valid_end) {                        // an invalid unit
      for (int s = s0 + lane; s < s1; s += 32) st.valid[row + s] = 0;
      continue;
    }
    const int n = min(__ldg(st.count + b), st.list_size);
    const int* cum = st.cum + static_cast<long long>(b) * st.list_size;
    const int* queue = st.queue + static_cast<long long>(b) * st.list_size;
    int o = owner_of(cum, n, s0);
    // the window: entries o .. o + 31
    int c = INT_MAX, id = 0, cs = 0;
    int before = 0;                               // cum before entry o
    auto load = [&]() {
      const int e = o + lane;
      c = INT_MAX;
      id = cs = 0;
      if (e < n) {
        c = __ldg(cum + e);
        id = __ldg(queue + e);
        cs = __ldg(st.colstarts + id);
      }
      before = o > 0 && o <= n ? __ldg(cum + o - 1) : 0;
    };
    load();
    for (int base = s0; base < s1; base += 32) {
      const int s = base + lane;
      bool todo = s < valid_end;
      if (s < s1 && !todo) st.valid[row + s] = 0;
      while (__any_sync(0xffffffffu, todo)) {
        // entries of the window with cum <= s: the slot's owner index
        // (32: past the window)
        int k = 0;
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(0xffffffffu, c, k + step - 1) <= s) k += step;
        if (__shfl_sync(0xffffffffu, c, 31) <= s) k = 32;
        const int k_id = __shfl_sync(0xffffffffu, id, k & 31);
        const int k_cs = __shfl_sync(0xffffffffu, cs, k & 31);
        const int k_prev = __shfl_sync(0xffffffffu, c, (k + 31) & 31);
        if (todo && k < 32) {
          const int prev = k == 0 ? before : k_prev;
          st.u[row + s] = k_id;
          st.v[row + s] = __ldg(st.rows + k_cs + (s - prev));
          st.valid[row + s] = 1;
          todo = false;
        }
        if (__any_sync(0xffffffffu, todo)) {      // past the window
          o += 32;
          load();
        }
      }
    }
  }
}

}  // namespace

// queue, cum: (B, list_size) int32 from K2's stream arm; count, total:
// (B,) int32; colstarts (V + 1,), rows (E,) int32; u, v: (B, n_slots)
// int32 and valid (B, n_slots) bytes, written.
extern "C" int repro_apportion(const void* queue, const void* cum,
                               const void* count, const void* total,
                               const void* colstarts, const void* rows,
                               void* u, void* v, void* valid, int n_batch,
                               int list_size, int n_slots, int grid,
                               void* stream) {
  if (n_batch == 0 || n_slots == 0 || grid <= 0) return 0;
  Stream st{static_cast<const int*>(queue), static_cast<const int*>(cum),
            static_cast<const int*>(count), static_cast<const int*>(total),
            static_cast<const int*>(colstarts),
            static_cast<const int*>(rows), static_cast<int*>(u),
            static_cast<int*>(v), static_cast<unsigned char*>(valid),
            n_batch, list_size, n_slots};
  apportion_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      st);
  return static_cast<int>(cudaGetLastError());
}
