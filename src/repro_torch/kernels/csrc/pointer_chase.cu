// Pointer-chase latency engine for Hopper (sm_90a): addr = table[addr],
// from 0, for `steps` hops, over C independent chains.
//
// Replaces the Pallas TPU kernel `pointer_chase` in
// src/repro/kernels/pointer_chase.py:32 (body `_chase_kernel` :22).  Same
// function, for each chain c:
//
//   tables (C, n) int32   chain c's table; a single cycle (Sattolo, or a
//                         permutation chained in order)
//   trace  (C, steps) int32
//   addr = 0; for i < steps: addr = tables[c][addr]; trace[c][i] = addr
//
// C = 1 is the Pallas kernel's case; C > 1 is the outstanding sweep's
// `_multi_chase` (src/repro/bench/sweeps/outstanding.py:18), one chain per
// independent request in flight.  A table entry outside [0, n) ends its
// chain: that hop and every later one are written as -1, and nothing
// outside the table is read.
//
// Bound: latency, by construction.  Each load's address is the previous
// load's value, so one chain has exactly one load in flight and a hop
// costs one full trip to wherever the table lives; the bytes moved
// (steps * (one 32-byte sector + 4 bytes of trace)) say nothing about its
// time.  Design: one thread per chain, so a warp issues up to 32
// independent loads at once and C chains are C requests in flight.  The
// load is `ld.global.ca` written out in PTX: it caches in L1 as well as
// L2, so a table's size alone decides whether the chain lives in L1 (up to
// some 200 KiB), in L2 (up to 50 MiB) or in HBM.  A plain C++ load of a
// `const __restrict__` pointer could be compiled to the read-only
// (`ld.global.nc`) path, and `ld.cg` would skip L1, hiding the L1 level;
// the asm is also `volatile`, so no load is merged or elided.  The trace
// store depends on the loaded value and does not stall the next hop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int32_t load_ca(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    pointer_chase_kernel(const int32_t* tables, int32_t* trace, int64_t n,
                         int steps, int chains) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chains) return;
  const int32_t* t = tables + static_cast<int64_t>(c) * n;
  int32_t* o = trace + static_cast<int64_t>(c) * steps;
  int32_t addr = 0;
  int i = 0;
  for (; i < steps; ++i) {
    addr = load_ca(t + addr);
    if (static_cast<uint32_t>(addr) >= static_cast<uint64_t>(n)) break;
    o[i] = addr;
  }
  for (; i < steps; ++i) o[i] = -1;
}

}  // namespace

// tables: (chains, n) int32 contiguous; trace: (chains, steps) int32.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int pointer_chase_launch(const void* tables, void* trace,
                                    long long n, int steps, int chains,
                                    void* stream) {
  if (n <= 0 || n > 0x7FFFFFFFLL || steps <= 0 || chains <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = chains < kThreads ? chains : kThreads;
  const int blocks = (chains + threads - 1) / threads;
  pointer_chase_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables), static_cast<int32_t*>(trace), n,
      steps, chains);
  return static_cast<int>(cudaGetLastError());
}
