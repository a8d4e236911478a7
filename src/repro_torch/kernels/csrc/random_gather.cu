// Random-access engine for Hopper (sm_90a): a row gather through an index
// vector.
//
// Replaces the Pallas TPU kernel `random_gather` in
// src/repro/kernels/random_gather.py:46 (body `_gather_kernel` :40; the
// index vector is scalar-prefetched there and picks the block of each grid
// step).  Same function:
//
//   x    (rows, cols)            float32, bfloat16 or int8, contiguous
//   idx  (n,)                    int32
//   out  (n * block_rows, cols)  x's dtype
//   block_rows rows form one unit; out's i-th unit = x's idx[i]-th unit
//
// Indices must lie in [0, rows / block_rows).  The kernel never reads
// outside x: a unit whose index lies outside is written as zeros.
//
// Bound: bytes, counted as the memory moves them.  Every gathered unit is
// an independent transaction: the card reads whole 32-byte sectors, so a
// unit under 32 bytes costs a full sector on the read side (the paper's
// unit-size finding; the engines' measured column stays useful bytes).
// Design: a group of L lanes per index, L the largest power of two up to
// 32 that does not exceed the unit's vectors, so narrow units put many
// indices in one warp (4-byte units: 32 independent loads a warp) and wide
// ones spread one unit over the warp.  A lane loads its index itself (the
// counterpart of the scalar prefetch) and moves 16-byte vectors when the
// unit's bytes and both pointers are 16-byte aligned, 4-byte words when
// they are 4-byte aligned, single elements otherwise, with kUnroll
// independent loads before its first store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename U>
__global__ void __launch_bounds__(kThreads)
    random_gather_kernel(const U* __restrict__ x,
                         const int32_t* __restrict__ idx, U* __restrict__ out,
                         int64_t n, int64_t nunits, uint32_t unit_words,
                         int log2_lanes) {
  const int lanes = 1 << log2_lanes;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kThreads >> log2_lanes) +
                    (threadIdx.x >> log2_lanes);
  const uint32_t lane = threadIdx.x & (lanes - 1);
  if (i >= n) return;
  const int32_t src = idx[i];
  U* os = out + i * unit_words;
  if (src < 0 || src >= nunits) {
    for (uint32_t v = lane; v < unit_words; v += lanes) os[v] = U{};
    return;
  }
  const U* xs = x + static_cast<int64_t>(src) * unit_words;
  for (uint32_t v0 = lane; v0 < unit_words; v0 += lanes * kUnroll) {
    U r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t v = v0 + k * lanes;
      if (v < unit_words) r[k] = xs[v];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t v = v0 + k * lanes;
      if (v < unit_words) os[v] = r[k];
    }
  }
}

template <typename U>
cudaError_t launch(const void* x, const int32_t* idx, void* out, long long n,
                   long long nunits, long long unit_bytes,
                   cudaStream_t stream) {
  const uint32_t words = static_cast<uint32_t>(unit_bytes / sizeof(U));
  int log2_lanes = 0;
  while (log2_lanes < 5 && (2u << log2_lanes) <= words) ++log2_lanes;
  const long long per_block = kThreads >> log2_lanes;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  random_gather_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const U*>(x), idx, static_cast<U*>(out), n, nunits, words,
      log2_lanes);
  return cudaGetLastError();
}

}  // namespace

// x: nunits contiguous units of unit_bytes; idx: n int32; out: n units.
// word_bytes is 16 (vectors; the caller checked alignment), 4, 2 or 1 and
// divides unit_bytes.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int random_gather_launch(const void* x, const void* idx, void* out,
                                    long long n, long long nunits,
                                    long long unit_bytes, int word_bytes,
                                    void* stream) {
  if (word_bytes != 16 && word_bytes != 4 && word_bytes != 2 &&
      word_bytes != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || nunits <= 0 || unit_bytes <= 0 || unit_bytes % word_bytes ||
      unit_bytes / word_bytes > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16:
      return static_cast<int>(
          launch<uint4>(x, ix, out, n, nunits, unit_bytes, s));
    case 4:
      return static_cast<int>(
          launch<uint32_t>(x, ix, out, n, nunits, unit_bytes, s));
    case 2:
      return static_cast<int>(
          launch<uint16_t>(x, ix, out, n, nunits, unit_bytes, s));
    default:
      return static_cast<int>(
          launch<uint8_t>(x, ix, out, n, nunits, unit_bytes, s));
  }
}
