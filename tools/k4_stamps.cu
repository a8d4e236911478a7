// K4's first CUDA body with timestamps, for tools/k4_stamps.py; not part of
// the port and never launched by it.
//
// The body is the float32 copy of whole-row tiles that K4 ran before its
// bulk route: one block of 256 threads per tile, 16-byte vectors, four
// loads in flight per thread before its stores.  When `stamps` is given,
// each block writes its start and end (%globaltimer, ns) and its SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    first_body(const uint4* __restrict__ x, uint4* __restrict__ out,
               int64_t tile_units, long long* stamps) {
  long long t0 = 0;
  if (stamps && threadIdx.x == 0)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile_units;
  for (int64_t v0 = threadIdx.x; v0 < tile_units; v0 += kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t v = v0 + k * kThreads;
      if (v < tile_units) r[k] = x[base + v];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t v = v0 + k * kThreads;
      if (v < tile_units) out[base + v] = r[k];
    }
  }
  if (stamps) {
    __syncthreads();
    if (threadIdx.x == 0) {
      long long t1;
      uint32_t sm;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      stamps[3 * blockIdx.x] = t0;
      stamps[3 * blockIdx.x + 1] = t1;
      stamps[3 * blockIdx.x + 2] = sm;
    }
  }
}

}  // namespace

// x, out: tiles x tile_units 16-byte units; stamps: 3 x tiles or null
extern "C" int k4_first_body(const void* x, void* out, long long tiles,
                             long long tile_units, long long* stamps,
                             void* stream) {
  first_body<<<static_cast<unsigned>(tiles), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), tile_units,
      stamps);
  return static_cast<int>(cudaGetLastError());
}
