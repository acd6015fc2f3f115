// K1: the restoration process (paper Alg. 3 lines 15-29) for Hopper.
//
// Replaces: src/repro/kernels/restoration.py, `restoration`
// (Pallas body `_restoration_kernel`), reached through `ops.restore`
// with the (B, V_pad) parent array flattened.
//
// What it computes: every vertex v with P[v] < 0 was discovered this
// layer (the expansion wrote P[v] = u - |V|).  The output P gets
// P[v] + |V| there and P[v] elsewhere; the delta bitmap has bit v set
// exactly for those vertices.  The caller ORs delta into out and
// visited, which repairs every bit the racy expansion dropped.
//
// What bounds it on this card: bytes.  It reads P once and writes P
// and the delta once: (4 + 4) * B * V_pad + B * V_pad / 8 bytes, with
// no reuse, at 3.35 TB/s.
//
// Design: one warp covers 32 consecutive vertices, so each lane's
// load and store is coalesced (a warp moves 128 contiguous bytes) and
// the 32 marked flags of a warp are exactly one delta word:
// __ballot_sync packs them (lane k -> bit k, the bitmap's bit order)
// and lane 0 stores the word.  V_pad is a multiple of 128, so the
// flattened length is a multiple of 32 and every warp is either wholly
// in range or wholly out of it, which keeps the ballot's lanes
// converged.  A grid-stride loop covers any length with one launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void restoration_kernel(const int* __restrict__ p,
                                   int* __restrict__ p_out,
                                   unsigned* __restrict__ delta,
                                   long long n_total, int n_vertices) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_total; i += stride) {
    const int v = p[i];
    const bool marked = v < 0;
    p_out[i] = marked ? v + n_vertices : v;
    const unsigned word = __ballot_sync(0xffffffffu, marked);
    if ((threadIdx.x & 31) == 0) delta[i >> 5] = word;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p, p_out: (n_total,) int32; delta: (n_total / 32,) 32-bit words.
extern "C" int repro_restoration(const void* p, void* p_out, void* delta,
                                 long long n_total, int n_vertices,
                                 void* stream) {
  if (n_total % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n_total == 0) return 0;
  long long blocks = (n_total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  restoration_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int*)p, (int*)p_out, (unsigned*)delta, n_total, n_vertices);
  return (int)cudaGetLastError();
}
