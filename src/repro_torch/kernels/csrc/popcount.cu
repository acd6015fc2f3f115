// K13: total set bits of a word bitmap, for Hopper.
//
// Replaces: src/repro/kernels/bitmap_kernels.py, `popcount` (Pallas body
// `_popcount_kernel`: per-tile population counts accumulated into one
// scalar across the sequential grid).
//
// What it computes: the sum of __popc over n 32-bit words, as one int.
// The engine's host loop reads its termination test (is any frontier
// non-empty) from it.
//
// What bounds it on this card: bytes, 4 * n read once.  The TPU grid
// accumulates in order; CTAs cannot, so each thread sums a grid-stride
// share of the words (16-byte loads where the length allows), each
// warp reduces with shuffles, each CTA's warps through shared memory,
// and one atomicAdd per CTA adds the CTA's sum into the output, which
// the wrapper zeroes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    popcount_kernel(const unsigned* __restrict__ words, long long n,
                    int* __restrict__ total) {
  __shared__ int s_warp[kThreads / 32];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int c = 0;
  const long long n4 =
      (reinterpret_cast<uintptr_t>(words) & 15) == 0 ? n / 4 : 0;
  const uint4* w4 = reinterpret_cast<const uint4*>(words);
  for (long long i = tid; i < n4; i += stride) {
    const uint4 v = __ldg(w4 + i);
    c += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride)
    c += __popc(__ldg(words + i));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += s_warp[w];
    if (t) atomicAdd(total, t);
  }
}

}  // namespace

// words: (n,) 32-bit words; total: one int32, zeroed by the caller,
// receives the set-bit count.
extern "C" int repro_popcount(const void* words, void* total, long long n,
                              int grid, void* stream) {
  if (n == 0 || grid <= 0) return 0;
  popcount_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), n, static_cast<int*>(total));
  return static_cast<int>(cudaGetLastError());
}
