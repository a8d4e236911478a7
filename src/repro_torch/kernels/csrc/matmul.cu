// Tiled matrix product for Hopper (sm_90a): bfloat16 on the tensor cores
// (wgmma fed by a TMA ring), float32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `matmul` in src/repro/kernels/matmul.py
// (function `matmul`, body `_mm_kernel`, grid in `_matmul_call`).  Same
// function: out = x @ y with a float32 accumulator, output in x's dtype.
//
//   x    (M, K)     float32 or bfloat16, contiguous
//   y    (K, N)     x's dtype, contiguous
//   out  (M, N)     x's dtype
//
// Bound: operations at large sizes (2*M*N*K flops against (MK + KN + MN)
// elements; 4096^3 in bf16 is 0.139 ms at the tensor cores' 989 TFLOP/s),
// bytes at decode-like shapes (M of a few rows streams y: at (8, 8192, 3072)
// y is 50 MB, 0.015 ms at 3.35 TB/s).  The wrapper routes by dtype; each
// route has its own entry point below, so a bfloat16 call never reaches the
// CUDA-core body and a float32 call never reaches the tensor cores (a
// float32 tensor-core product is TF32).
//
// bfloat16 route (`matmul_bf16_launch`).  A block owns a tile_m x tile_n
// output tile (grid (ceil(N/tile_n), ceil(M/tile_m))) and walks K in stages
// of 64.  Warpgroup 0 is the producer (with two consumers it hands
// registers to them: setmaxnreg 56 down, 224 up); warpgroups 1..C are
// consumers, each owning 64 rows of the tile and issuing
// `wgmma.mma_async.m64nNk16.f32.bf16.bf16` with both operands in shared
// memory and the float32 sum in registers.  Three configurations are
// compiled, listed once in MATMUL_BF16_CONFIGS below (the wrapper reads that
// line, and its `kernel_config` picks one):
//
//   tile 128 x 256, 4 stages (2 consumers)   large M, N >= 256
//   tile 128 x 128, 6 stages (2 consumers)   large M, narrower N
//   tile  64 x  64, 8 stages (1 consumer)    M <= 64: decode-like shapes,
//        bound by y's bytes; narrow N tiles give N/64 blocks (128 at N 8192)
//        each streaming its K-walk of y through a deep ring, so enough bytes
//        are in flight without splitting K
//
// A stage is x's [tile_m][64] tile, K-major, and y's [64][tile_n] tile, N-
// major, cut in 64-column chunks.  Every row of a tile or chunk is 128 bytes
// under the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)), the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B.  The x descriptor is
// K-major (stride between 8-row groups 1024 B; a k16 step advances the start
// by 32 B); the y descriptor is MN-major with the transpose bit set (leading
// offset 64 rows x 128 B = 8192 B between 64-column chunks, stride 1024 B
// between 8-row groups of K; a k16 step advances the start by 2048 B).
//
// Staging: with K and N multiples of 8 and 16-byte aligned bases (TMA's
// stride and address rules), one producer thread issues
// `cp.async.bulk.tensor.2d` copies completing on the stage's `mbarrier`;
// elements outside x or y read as zero, which masks ragged M, N and K.
// Otherwise (the reference's K = 100, say) the producer warpgroup's 128
// threads copy element by element into the same swizzled layout, zeroing
// what lies outside, then `fence.proxy.async` and arrive on the barrier;
// the consumers' wgmma body is the same.  Consumers keep one wgmma group in
// flight: after committing stage s they wait for stage s-1's group and
// release its buffer to the producer.  The epilogue rounds to bfloat16 and
// masks its stores.
//
// float32 route (`matmul_f32_launch`): the plan's (bm, bn, bk) are the
// kernel's, taken at run time.  One block per (bm, bn) output tile; it walks
// K in steps of bk, each step staged in shared memory (A transposed,
// [kc][bm+1], the pad keeping the transposing stores off one bank; B
// [kc][bn]), whole when it fits the shared memory of a block, else in sub-
// steps of kc rows, the wrapper halving kc until they fit.  Single-buffered:
// load, synchronise, accumulate, synchronise.  Threads form a TR x TC grid
// (TR = min(16, bm), TC = min(16, bn)); thread (ty, tx) keeps the outputs
// (ty + TR*r, tx + TC*c), r, c < 8, in registers, so bm and bn are at most
// 128.  Ragged edges are masked.  It runs float32 FMAs (67 TFLOP/s peak).
#include <cuda.h>   // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                    // looked up at run time (encoder() below), no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// The bfloat16 route's compiled configurations, X(tile_m, tile_n, stages),
// tile_m 64 per consumer warpgroup.  kernels/matmul.py reads this line.
#define MATMUL_BF16_CONFIGS(X) X(128, 256, 4) X(128, 128, 6) X(64, 64, 8)

namespace {

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kMaxPerThread = 8;   // outputs per thread along each axis
constexpr int kMaxThreadAxis = 16;

__global__ void matmul_f32_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  float* __restrict__ out, int m, int n,
                                  int k, int bm, int bn, int bk, int kc) {
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
            row < m ? x[static_cast<long>(row) * k + kb + kk] : 0.f;
      }
      // B tile: consecutive threads on consecutive n
      for (int e = tid; e < ks * bn; e += threads) {
        const int kk = e / bn;
        const int j = e - kk * bn;
        const int col = n0 + j;
        b_s[kk * bn + j] =
            col < n ? y[static_cast<long>(kb + kk) * n + col] : 0.f;
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
      if (j < bn && col < n) out[static_cast<long>(row) * n + col] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 route: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTileK = 64;          // K per stage: one 128-byte swizzled row
constexpr int kRowBytes = 128;      // kTileK bf16
constexpr int kChunkN = 64;         // y is staged in 64-column chunks
constexpr int kChunkBytes = kTileK * kRowBytes;   // 8192
constexpr long kSpinLimit = 1L << 26;  // a lost barrier traps, never hangs

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_F32(i) \
  REPRO_F8(i), REPRO_F8(i + 8), REPRO_F8(i + 16), REPRO_F8(i + 24)

// D (64 x N, float32) += A (64 x 16, K-major) * B (16 x N, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : REPRO_F32(0)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : REPRO_F32(0), REPRO_F32(32)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : REPRO_F32(0), REPRO_F32(32), REPRO_F32(64), REPRO_F32(96)
      : "l"(a), "l"(b), "r"(1));
}

#undef REPRO_F32
#undef REPRO_F8

// byte offset of a 16-byte chunk's element under the 128-byte swizzle
// (relative to a 1024-byte aligned base, rows of 128 bytes)
__device__ __forceinline__ uint32_t sw128(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

// One stage staged element by element (unaligned K or N, or bases off 16
// bytes): 128 producer threads, zeros outside x and y.
template <int kBM, int kBN>
__device__ __forceinline__ void stage_elementwise(
    uint8_t* a_dst, uint8_t* b_dst, const unsigned short* __restrict__ x,
    const unsigned short* __restrict__ y, int m, int n, int k, int m0, int n0,
    int k0, int t) {
  for (int e = t; e < kBM * kTileK; e += 128) {
    const int r = e / kTileK;
    const int c = e - r * kTileK;
    const int gr = m0 + r, gc = k0 + c;
    const unsigned short v =
        gr < m && gc < k ? __ldg(x + static_cast<long>(gr) * k + gc) : 0;
    *reinterpret_cast<unsigned short*>(a_dst + sw128(r * kRowBytes + c * 2)) =
        v;
  }
  for (int e = t; e < kTileK * kBN; e += 128) {
    const int r = e / kBN;              // K row
    const int c = e - r * kBN;          // N column
    const int gr = k0 + r, gc = n0 + c;
    const unsigned short v =
        gr < k && gc < n ? __ldg(y + static_cast<long>(gr) * n + gc) : 0;
    const int chunk = c / kChunkN;
    *reinterpret_cast<unsigned short*>(
        b_dst + chunk * kChunkBytes +
        sw128(r * kRowBytes + (c - chunk * kChunkN) * 2)) = v;
  }
}

template <int kConsumers, int kBN, int kStages>
struct WgmmaShape {
  static constexpr int kBM = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = (kBN / kChunkN) * kChunkBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // 1024 bytes of slack to align the ring, then the full and empty barriers
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kStages) * kStageBytes + 16 * kStages;
};

template <int kConsumers, int kBN, int kStages, bool kTma>
__global__ void __launch_bounds__(128 * (kConsumers + 1), 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_y,
                        const unsigned short* __restrict__ x,
                        const unsigned short* __restrict__ y,
                        __nv_bfloat16* __restrict__ out, int m, int n,
                        int k) {
  using S = WgmmaShape<kConsumers, kBN, kStages>;
  constexpr int kBM = S::kBM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* ring = smem_raw + pad;                 // 1024-byte aligned
  uint8_t* a_ring = ring;                         // [stages][kABytes]
  uint8_t* b_ring = ring + kStages * S::kABytes;  // [stages][kBBytes]
  const uint32_t full = smem_u32(b_ring + kStages * S::kBBytes);
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int ktiles = (k + kTileK - 1) / kTileK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kTma ? 1 : 128);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup ----
    if constexpr (kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (kTma && tid != 0) return;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      if (kt >= kStages) mbar_wait(empty + 8 * s, (kt / kStages - 1) & 1);
      uint8_t* a_dst = a_ring + s * S::kABytes;
      uint8_t* b_dst = b_ring + s * S::kBBytes;
      if constexpr (kTma) {
        mbar_expect_tx(full + 8 * s, S::kStageBytes);
        tma_load_2d(smem_u32(a_dst), &map_x, full + 8 * s, kt * kTileK, m0);
#pragma unroll
        for (int c = 0; c < kBN / kChunkN; ++c)
          tma_load_2d(smem_u32(b_dst + c * kChunkBytes), &map_y, full + 8 * s,
                      n0 + c * kChunkN, kt * kTileK);
      } else {
        stage_elementwise<kBM, kBN>(a_dst, b_dst, x, y, m, n, k, m0, n0,
                                    kt * kTileK, tid);
        // generic-proxy stores, read next by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ----
  if constexpr (kConsumers == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int cw = wg - 1;
  float d[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) d[i] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t a_s =
        smem_u32(a_ring + s * S::kABytes) + cw * 64 * kRowBytes;
    const uint32_t b_s = smem_u32(b_ring + s * S::kBBytes);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      wgmma_bf16<kBN>(d, sw128_desc(a_s + kk * 32, 16, 1024),
                      sw128_desc(b_s + kk * 16 * kRowBytes, kChunkBytes,
                                 1024));
    wgmma_commit();
    fence_regs(d);
    wgmma_wait<1>();          // the previous stage's products are done
    fence_regs(d);
    if (kt > 0 && tid % 128 == 0)
      mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(d);

  // accumulator fragment: warp w of the warpgroup holds rows 16w + lane/4
  // (+8); register 4j + {0, 1} is columns 8j + 2*(lane%4) + {0, 1}, 4j +
  // {2, 3} the same columns 8 rows down
  const int lane = tid % 32;
  const int row = m0 + cw * 64 + 16 * ((tid % 128) / 32) + lane / 4;
  const bool pairs = (n % 2) == 0;   // 4-byte aligned column pairs
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= m || col >= n) continue;
      __nv_bfloat16* o = out + static_cast<long>(r) * n + col;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && col + 1 < n) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (col + 1 < n) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix, boxes of (box_rows, 64) under the
// 128-byte swizzle; zeros outside.
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kTileK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kConsumers, int kBN, int kStages, bool kTma>
cudaError_t launch_wgmma(const void* x, const void* y, void* out, int m,
                         int n, int k, cudaStream_t stream) {
  using S = WgmmaShape<kConsumers, kBN, kStages>;
  CUtensorMap map_x, map_y;
  if (kTma) {
    if (!encode(&map_x, x, m, k, S::kBM) ||
        !encode(&map_y, y, k, n, kTileK))
      return cudaErrorInvalidValue;
  } else {   // unused by the kernel
    memset(&map_x, 0, sizeof(map_x));
    memset(&map_y, 0, sizeof(map_y));
  }
  auto kernel = matmul_wgmma_kernel<kConsumers, kBN, kStages, kTma>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + S::kBM - 1) / S::kBM);
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
      map_x, map_y, static_cast<const unsigned short*>(x),
      static_cast<const unsigned short*>(y), static_cast<__nv_bfloat16*>(out),
      m, n, k);
  return cudaGetLastError();
}

template <bool kTma>
cudaError_t launch_config(int tile_m, int tile_n, int stages, const void* x,
                          const void* y, void* out, int m, int n, int k,
                          cudaStream_t s) {
#define MATMUL_BF16_LAUNCH(TM, TN, ST)             \
  if (tile_m == TM && tile_n == TN && stages == ST) \
    return launch_wgmma<TM / 64, TN, ST, kTma>(x, y, out, m, n, k, s);
  MATMUL_BF16_CONFIGS(MATMUL_BF16_LAUNCH)
#undef MATMUL_BF16_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// float32 on the CUDA cores.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  1 <= bm, bn <= 128; 1 <= kc <= bk.
extern "C" int matmul_f32_launch(const void* x, const void* y, void* out,
                                 int m, int n, int k, int bm, int bn, int bk,
                                 int kc, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      kc <= 0 || kc > bk || bm > kMaxThreadAxis * kMaxPerThread ||
      bn > kMaxThreadAxis * kMaxPerThread || (m + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tr = bm < kMaxThreadAxis ? bm : kMaxThreadAxis;
  const int tc = bn < kMaxThreadAxis ? bn : kMaxThreadAxis;
  const size_t smem =
      (static_cast<size_t>(kc) * (bm + 1) + static_cast<size_t>(kc) * bn) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  matmul_f32_kernel<<<grid, tr * tc, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), m, n, k, bm, bn, bk, kc);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 on the tensor cores.  (tile_m, tile_n, stages) is one of
// MATMUL_BF16_CONFIGS.
// tma = 1 stages through TMA (K and N multiples of 8, 16-byte aligned
// bases), 0 element by element.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int matmul_bf16_launch(const void* x, const void* y, void* out,
                                  int m, int n, int k, int tile_m, int tile_n,
                                  int stages, int tma, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || tile_m <= 0 ||
      (m + tile_m - 1) / tile_m > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tma && (k % 8 != 0 || n % 8 != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      tma ? launch_config<true>(tile_m, tile_n, stages, x, y, out, m, n, k, s)
          : launch_config<false>(tile_m, tile_n, stages, x, y, out, m, n, k,
                                 s);
  return static_cast<int>(err);
}
