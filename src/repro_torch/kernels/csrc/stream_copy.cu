// Sequential-stream engine for Hopper (sm_90a): a 2-D copy, or a x2
// read-modify-write, in (block_rows, block_cols) tiles.
//
// Replaces the Pallas TPU kernel `stream_copy` in
// src/repro/kernels/stream_copy.py:29 (bodies `_copy_kernel` :18 and
// `_rw_kernel` :22).  Same function:
//
//   x    (rows, cols)  float32, bfloat16 or int8, contiguous
//   out  (rows, cols)  x's dtype
//   out = x            (mode 0, copy)
//   out = x * 2        (mode 1, rw; int8 wraps modulo 256 as torch does)
//
// with rows % block_rows == 0 and cols % block_cols == 0.
//
// Bound: bytes.  Every input byte is read once and every output byte
// written once; there is no arithmetic to speak of.  The paper's knobs are
// explicit here: one block moves one tile (the tile's bytes are the
// burst); each thread moves 16-byte vectors (the unit) when the tile's rows
// and the base are 16-byte aligned, single elements otherwise; and each
// thread issues kUnroll independent loads before its first store (the
// outstanding count: kThreads * kUnroll loads of a block in flight).  A
// tile of whole rows is contiguous and walked with linear offsets; a tile
// narrower than the row computes (row, column) of each unit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

enum DType { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

__device__ __forceinline__ uint32_t bf16x2_times2(uint32_t w) {
  const float lo = __uint_as_float(w << 16) * 2.0f;
  const float hi = __uint_as_float(w & 0xFFFF0000u) * 2.0f;
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// x2 of one 32-bit word holding 1, 2 or 4 elements of DT.  For int8 a left
// shift of each byte is x2 modulo 256; the mask drops the carry into the
// next byte.
template <int DT>
__device__ __forceinline__ uint32_t word_times2(uint32_t w) {
  if (DT == kFloat32) return __float_as_uint(__uint_as_float(w) * 2.0f);
  if (DT == kBFloat16) return bf16x2_times2(w);
  return (w << 1) & 0xFEFEFEFEu;
}

template <int DT>
__device__ __forceinline__ uint4 times2(uint4 v) {
  return make_uint4(word_times2<DT>(v.x), word_times2<DT>(v.y),
                    word_times2<DT>(v.z), word_times2<DT>(v.w));
}

template <int DT>
__device__ __forceinline__ float times2(float v) {
  return v * 2.0f;
}

template <int DT>
__device__ __forceinline__ uint16_t times2(uint16_t v) {
  const float f = __uint_as_float(static_cast<uint32_t>(v) << 16) * 2.0f;
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <int DT>
__device__ __forceinline__ int8_t times2(int8_t v) {
  return static_cast<int8_t>(static_cast<uint8_t>(v) << 1);
}

// One block per tile.  U is the unit a thread moves (uint4, or one element
// of DT); sizes are in units.  A tile holds block_rows rows of tile_cols
// units; rows of the array are row_units apart.
template <typename U, int DT, bool kScale>
__global__ void __launch_bounds__(kThreads)
    stream_copy_kernel(const U* __restrict__ x, U* __restrict__ out,
                       int64_t row_units, uint32_t tile_cols,
                       uint32_t block_rows, uint32_t tiles_per_row) {
  const uint32_t ti = blockIdx.x / tiles_per_row;
  const uint32_t tj = blockIdx.x % tiles_per_row;
  const int64_t base = static_cast<int64_t>(ti) * block_rows * row_units +
                       static_cast<int64_t>(tj) * tile_cols;
  const uint32_t n = block_rows * tile_cols;
  const bool contiguous = tile_cols == row_units;
  for (uint32_t v0 = threadIdx.x; v0 < n; v0 += kThreads * kUnroll) {
    U r[kUnroll];
    int64_t off[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t v = v0 + k * kThreads;
      off[k] = contiguous ? static_cast<int64_t>(v)
                          : static_cast<int64_t>(v / tile_cols) * row_units +
                                v % tile_cols;
      if (v < n) r[k] = x[base + off[k]];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (v0 + k * kThreads < n)
        out[base + off[k]] = kScale ? times2<DT>(r[k]) : r[k];
    }
  }
}

template <typename U, int DT>
cudaError_t launch(const void* x, void* out, int64_t row_units,
                   uint32_t tile_cols, uint32_t block_rows,
                   uint32_t tiles_per_row, uint32_t tiles, int scale,
                   cudaStream_t stream) {
  const U* xs = static_cast<const U*>(x);
  U* os = static_cast<U*>(out);
  if (scale)
    stream_copy_kernel<U, DT, true><<<tiles, kThreads, 0, stream>>>(
        xs, os, row_units, tile_cols, block_rows, tiles_per_row);
  else
    stream_copy_kernel<U, DT, false><<<tiles, kThreads, 0, stream>>>(
        xs, os, row_units, tile_cols, block_rows, tiles_per_row);
  return cudaGetLastError();
}

template <int DT, typename E>
cudaError_t dispatch_unit(bool vec, const void* x, void* out, int64_t cols,
                          int64_t block_cols, int64_t block_rows,
                          int64_t tiles_per_row, int64_t tiles, int scale,
                          cudaStream_t stream) {
  if (vec) {
    const int64_t per = 16 / sizeof(E);
    return launch<uint4, DT>(x, out, cols / per, block_cols / per,
                             block_rows, tiles_per_row, tiles, scale, stream);
  }
  return launch<E, DT>(x, out, cols, block_cols, block_rows, tiles_per_row,
                       tiles, scale, stream);
}

}  // namespace

// x, out: (rows, cols) contiguous; the tile is (block_rows, block_cols)
// and divides the array; vec = 1 moves 16-byte vectors (the caller checked
// that the tile's rows and both pointers are 16-byte aligned).  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int stream_copy_launch(const void* x, void* out, long long rows,
                                  long long cols, long long block_rows,
                                  long long block_cols, int dtype, int scale,
                                  int vec, void* stream) {
  if (rows <= 0 || cols <= 0 || block_rows <= 0 || block_cols <= 0 ||
      rows % block_rows || cols % block_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_per_row = cols / block_cols;
  const long long tiles = (rows / block_rows) * tiles_per_row;
  if (tiles > 0x7FFFFFFFLL || block_rows * block_cols > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kFloat32:
      err = dispatch_unit<kFloat32, float>(vec, x, out, cols, block_cols,
                                           block_rows, tiles_per_row, tiles,
                                           scale, s);
      break;
    case kBFloat16:
      err = dispatch_unit<kBFloat16, uint16_t>(vec, x, out, cols, block_cols,
                                               block_rows, tiles_per_row,
                                               tiles, scale, s);
      break;
    case kInt8:
      err = dispatch_unit<kInt8, int8_t>(vec, x, out, cols, block_cols,
                                         block_rows, tiles_per_row, tiles,
                                         scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
