// Strided-traversal engine for Hopper (sm_90a): block-row i of the output
// is block-row (i * stride) mod nblocks of the input.
//
// Replaces the Pallas TPU kernel `strided_copy` in
// src/repro/kernels/strided_copy.py:22 (body `_kernel` :17, index map
// `in_map` :30).  Same function:
//
//   x    (rows, cols)  float32, bfloat16 or int8, contiguous
//   out  (rows, cols)  x's dtype
//   block_rows rows form one block; nblocks = rows / block_rows;
//   out[i-th block] = x[((i * stride) mod nblocks)-th block]
//
// When stride is not coprime with nblocks some input blocks are read more
// than once and others never: the function is not a permutation, and the
// kernel keeps it so.  The source block is computed in 64-bit arithmetic
// (i * stride overflows 32 bits at the card's sizes); the caller passes
// stride already reduced modulo nblocks, so it is in [0, nblocks).
//
// Bound: bytes (each output block read once from its source and written
// once).  One block of threads moves one block-row, which is contiguous in
// both arrays: 16-byte vectors when the block-row's bytes and both
// pointers are 16-byte aligned, single elements otherwise, kUnroll
// independent loads per thread before its first store.  The stride is the
// paper's (ADDR + S) mod G walk: consecutive blocks of threads read block
// rows `stride` apart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename U>
__global__ void __launch_bounds__(kThreads)
    strided_copy_kernel(const U* __restrict__ x, U* __restrict__ out,
                        int64_t nblocks, int64_t stride, uint32_t block_units) {
  const int64_t i = blockIdx.x;
  const int64_t src = (i * stride) % nblocks;
  const U* xs = x + src * block_units;
  U* os = out + i * block_units;
  for (uint32_t v0 = threadIdx.x; v0 < block_units;
       v0 += kThreads * kUnroll) {
    U r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t v = v0 + k * kThreads;
      if (v < block_units) r[k] = xs[v];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t v = v0 + k * kThreads;
      if (v < block_units) os[v] = r[k];
    }
  }
}

template <typename U>
cudaError_t launch(const void* x, void* out, long long nblocks,
                   long long stride, long long block_bytes,
                   cudaStream_t stream) {
  strided_copy_kernel<U><<<static_cast<unsigned>(nblocks), kThreads, 0,
                           stream>>>(
      static_cast<const U*>(x), static_cast<U*>(out), nblocks, stride,
      static_cast<uint32_t>(block_bytes / sizeof(U)));
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous, nblocks blocks of block_bytes each; unit_bytes is 16
// (vectors; the caller checked alignment), 4, 2 or 1, and divides
// block_bytes.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int strided_copy_launch(const void* x, void* out, long long nblocks,
                                   long long stride, long long block_bytes,
                                   int unit_bytes, void* stream) {
  if (unit_bytes != 16 && unit_bytes != 4 && unit_bytes != 2 &&
      unit_bytes != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks <= 0 || nblocks > 0x7FFFFFFFLL || stride < 0 ||
      stride >= nblocks || block_bytes <= 0 ||
      block_bytes / unit_bytes > 0x7FFFFFFFLL || block_bytes % unit_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 16:
      return static_cast<int>(
          launch<uint4>(x, out, nblocks, stride, block_bytes, s));
    case 4:
      return static_cast<int>(
          launch<uint32_t>(x, out, nblocks, stride, block_bytes, s));
    case 2:
      return static_cast<int>(
          launch<uint16_t>(x, out, nblocks, stride, block_bytes, s));
    case 1:
      return static_cast<int>(
          launch<uint8_t>(x, out, nblocks, stride, block_bytes, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
