// Tiled matrix product for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas TPU kernel `matmul` in src/repro/kernels/matmul.py
// (function `matmul`, body `_mm_kernel`, grid in `_matmul_call`).  Same
// function: out = x @ y with a float32 accumulator, output in x's dtype.
//
//   x    (M, K)     float32 or bfloat16, contiguous
//   y    (K, N)     x's dtype, contiguous
//   out  (M, N)     x's dtype
//
// Tiles: the tuned plan's (bm, bn, bk) are the kernel's, taken at run time.
// One block per (bm, bn) output tile (grid (ceil(N/bn), ceil(M/bm))); it
// walks K in steps of bk, each step staged in shared memory as float32 (A
// transposed, [kc][bm+1], the pad keeping the transposing stores off one
// bank; B [kc][bn]).  A step is staged whole (kc = bk) when its A and B
// tiles fit the shared memory of a block, else in sub-steps of kc rows, the
// wrapper halving kc until they fit; at the plan's 128 x 128 x 128 a stage
// is 128.5 KiB, so no sub-step.  Single-buffered: load, synchronise,
// accumulate, synchronise.  Threads form a TR x TC grid (TR = min(16, bm),
// TC = min(16, bn)); thread (ty, tx) keeps the outputs (ty + TR*r, tx +
// TC*c), r, c < 8, in registers, so bm and bn are at most 128.  Ragged
// edges are masked: loads outside x or y read 0, stores outside out are
// skipped.
//
// Bound: operations at large sizes (2*M*N*K flops against (MK + KN + MN)
// elements), bytes at decode-like shapes (M of a few rows streams y).  This
// first kernel runs float32 FMAs on the CUDA cores (67 TFLOP/s peak, not the
// tensor cores' 989 in bf16): `mma`/`wgmma` and a multi-stage copy ring are
// for the kernel's redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerThread = 8;   // outputs per thread along each axis
constexpr int kMaxThreadAxis = 16;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <typename T>
__global__ void matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              T* __restrict__ out, int m, int n, int k,
                              int bm, int bn, int bk, int kc) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                       // [kc][bm + 1]
  float* b_s = smem + kc * (bm + 1);       // [kc][bn]

  const int tr = min(kMaxThreadAxis, bm);
  const int tc = min(kMaxThreadAxis, bn);
  const int tid = threadIdx.x;
  const int ty = tid / tc;
  const int tx = tid - ty * tc;
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;
  const int threads = blockDim.x;

  float acc[kMaxPerThread][kMaxPerThread];
#pragma unroll
  for (int r = 0; r < kMaxPerThread; ++r)
#pragma unroll
    for (int c = 0; c < kMaxPerThread; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k; k0 += bk) {
    const int step = min(bk, k - k0);
    for (int s0 = 0; s0 < step; s0 += kc) {
      const int ks = min(kc, step - s0);
      const int kb = k0 + s0;
      // A tile: consecutive threads on consecutive k (coalesced reads)
      for (int e = tid; e < bm * ks; e += threads) {
        const int i = e / ks;
        const int kk = e - i * ks;
        const int row = m0 + i;
        a_s[kk * (bm + 1) + i] =
            row < m ? to_float(x[static_cast<long>(row) * k + kb + kk]) : 0.f;
      }
      // B tile: consecutive threads on consecutive n
      for (int e = tid; e < ks * bn; e += threads) {
        const int kk = e / bn;
        const int j = e - kk * bn;
        const int col = n0 + j;
        b_s[kk * bn + j] =
            col < n ? to_float(y[static_cast<long>(kb + kk) * n + col]) : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < ks; ++kk) {
        float a[kMaxPerThread];
        float b[kMaxPerThread];
#pragma unroll
        for (int r = 0; r < kMaxPerThread; ++r) {
          const int i = ty + tr * r;
          a[r] = i < bm ? a_s[kk * (bm + 1) + i] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kMaxPerThread; ++c) {
          const int j = tx + tc * c;
          b[c] = j < bn ? b_s[kk * bn + j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kMaxPerThread; ++r)
#pragma unroll
          for (int c = 0; c < kMaxPerThread; ++c) acc[r][c] += a[r] * b[c];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxPerThread; ++r) {
    const int i = ty + tr * r;
    const int row = m0 + i;
    if (i >= bm || row >= m) continue;
#pragma unroll
    for (int c = 0; c < kMaxPerThread; ++c) {
      const int j = tx + tc * c;
      const int col = n0 + j;
      if (j < bn && col < n)
        store(out + static_cast<long>(row) * n + col, acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* y, void* out, int m, int n,
                   int k, int bm, int bn, int bk, int kc,
                   cudaStream_t stream) {
  const int tr = bm < kMaxThreadAxis ? bm : kMaxThreadAxis;
  const int tc = bn < kMaxThreadAxis ? bn : kMaxThreadAxis;
  const size_t smem =
      (static_cast<size_t>(kc) * (bm + 1) + static_cast<size_t>(kc) * bn) *
      sizeof(float);
  auto kernel = matmul_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  kernel<<<grid, tr * tc, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      m, n, k, bm, bn, bk, kc);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// dtype codes: 0 float32, 1 bfloat16.  1 <= bm, bn <= 128; 1 <= kc <= bk.
extern "C" int matmul_launch(const void* x, const void* y, void* out, int m,
                             int n, int k, int bm, int bn, int bk, int kc,
                             int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      kc <= 0 || kc > bk || bm > kMaxThreadAxis * kMaxPerThread ||
      bn > kMaxThreadAxis * kMaxPerThread || (m + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch<float>(x, y, out, m, n, k, bm, bn, bk, kc, s);
  else if (dtype == kBFloat16)
    err = launch<__nv_bfloat16>(x, y, out, m, n, k, bm, bn, bk, kc, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
