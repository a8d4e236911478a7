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
// written once; there is no arithmetic to speak of.
//
// Two routes; the wrapper picks one from the shapes before the launch
// (`kernel_config` in stream_copy.py), and each has its own entry point.
//
// Bulk route (`stream_copy_bulk_launch`): both bases 16-byte aligned and a
// tile row's bytes a multiple of 16.  The Pallas kernel's block is one
// contiguous DMA, the paper's burst; here it is a run of TMA bulk copies
// (`cp.async.bulk`).  A tile is cut into requests: a tile of whole rows is
// one contiguous range, a narrower tile one range per tile row, and a
// range larger than a ring stage is cut into stage-sized pieces.  Requests
// are numbered tile by tile in address order.  One thread per block copies
// request q global -> shared into stage s of a ring (completing on the
// stage's mbarrier with complete_tx), then shared -> global (a bulk group;
// `wait_group.read` frees the stage for the next load).  In rw mode the
// block's threads double the stage in shared memory first, then
// `fence.proxy.async.shared::cta` orders their writes before the bulk store
// reads them.  The ring is the paper's BRAM cost.
//
// The grid is sized from the SM count and the blocks resident per SM, not
// from the tile count, and a block takes its next request from a counter
// (one atomicAdd a request, fetched one request ahead; block b starts at
// request b).  Why a counter: tools/k4_stamps.py stamps each block of the
// first body (one block per tile) with %globaltimer.  At 1 MiB tiles its
// 1024 blocks all start together but some end in half the time of others:
// HBM serves some blocks faster, and with the work bound to blocks the
// launch ends in a tail.  A static split of the work across blocks keeps
// such a tail (a static grid-stride walk of this route was slower on an
// H100); a counter hands the last requests to whichever blocks are free.
// The last block to finish resets the counter, so it is zero between
// launches (the wrapper keeps one per stream).  No L2 policy hint:
// evict-first loads and stores did not make the copy faster on an H100.
//
// A tile of whole rows is one contiguous range, so from 16 KiB up every
// such tile of an array is the same run of 16 KiB requests: the burst
// reaches the kernel only below one stage.
//
// Element route (`stream_copy_element_launch`): rows whose bytes are not a
// multiple of 16 (the (96, 7) float32 tile, int8 rows of 7 bytes) or a base
// off 16 bytes.  One block per tile; each thread moves single elements and
// issues kUnroll independent loads before its first store.  A tile of whole
// rows is contiguous and walked with linear offsets; a narrower tile
// computes (row, column) of each element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // element route
constexpr int kUnroll = 4;
constexpr int kBulkThreads = 128;     // bulk route
constexpr int kMaxStages = 32;
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block can use
constexpr long kSpinLimit = 1L << 26; // a lost barrier traps, never hangs

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

// ---------------------------------------------------------------------------
// Bulk route
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// How the array is cut into requests, in bytes.  A tile holds `segs`
// contiguous segments (1 for a tile of whole rows, else block_rows) of
// `seg_bytes`, each cut into `pieces` requests of at most `chunk` bytes.
struct Layout {
  int64_t row_bytes;       // cols * itemsize
  int64_t tile_rows;       // block_rows
  int64_t tile_col_bytes;  // block_cols * itemsize
  int64_t tiles_per_row;
  int64_t segs;
  int64_t seg_bytes;
  int64_t pieces;
  int64_t chunk;
  int64_t requests;
};

// Byte offset and length of request q (kernel_config's `request` in
// stream_copy.py is the same arithmetic).
__device__ __forceinline__ void request(const Layout& L, int64_t q,
                                        int64_t* off, uint32_t* len) {
  const int64_t per_tile = L.segs * L.pieces;
  const int64_t t = q / per_tile;
  const int64_t w = q - t * per_tile;
  const int64_t seg = w / L.pieces;
  const int64_t p = w - seg * L.pieces;
  const int64_t ti = t / L.tiles_per_row;
  const int64_t tj = t - ti * L.tiles_per_row;
  *off = (ti * L.tile_rows + seg) * L.row_bytes + tj * L.tile_col_bytes +
         p * L.chunk;
  const int64_t rest = L.seg_bytes - p * L.chunk;
  *len = static_cast<uint32_t>(rest < L.chunk ? rest : L.chunk);
}

// counters[0]: tickets taken; counters[1]: blocks done.  Both are 0 at
// launch and reset by the last block.  In copy mode only thread 0 works;
// in rw mode every thread doubles the stage it waits for, and thread 0
// publishes each stage's request in `qs` before its load.
template <int DT, bool kScale>
__global__ void __launch_bounds__(kBulkThreads)
    stream_copy_bulk_kernel(const char* __restrict__ x, char* __restrict__ out,
                            Layout L, int stages, int* counters) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ int64_t qs[kMaxStages];
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t chunk = static_cast<uint32_t>(L.chunk);
  const uint32_t bars = ring_addr + stages * chunk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!kScale && tid != 0) return;

  // thread 0: the next request, fetched one ahead.  Block b starts at
  // request b; ticket t from the counter is request gridDim.x + t.
  int64_t next = blockIdx.x;
  int64_t local[kMaxStages];
  // thread 0: the block's next request, -1 once the array is done
  auto take = [&]() -> int64_t {
    const int64_t q = next;
    if (q >= L.requests) return -1;
    next = gridDim.x + static_cast<int64_t>(atomicAdd(counters, 1));
    return q;
  };
  // thread 0: request q into stage s; a stage without a request completes
  // its barrier's phase with a plain arrive
  auto issue = [&](int s, int64_t q) {
    local[s] = q;
    if (kScale) qs[s] = q;
    const uint32_t bar = bars + 8 * s;
    if (q < 0) {
      mbar_arrive(bar);
      return;
    }
    int64_t off;
    uint32_t len;
    request(L, q, &off, &len);
    mbar_expect_tx(bar, len);
    bulk_load(ring_addr + s * chunk, x + off, len, bar);
  };
  if (tid == 0)
    for (int s = 0; s < stages; ++s) issue(s, take());
  // a block's requests come in increasing order, so the first stage
  // without one ends the walk
  for (int64_t k = 0;; ++k) {
    const int s = static_cast<int>(k % stages);
    mbar_wait(bars + 8 * s, static_cast<uint32_t>((k / stages) & 1));
    const int64_t q = kScale ? qs[s] : local[s];
    if (q < 0) break;
    int64_t off;
    uint32_t len;
    request(L, q, &off, &len);
    if (kScale) {
      uint4* v = reinterpret_cast<uint4*>(ring + s * chunk);
      for (uint32_t i = tid; i < len / 16; i += kBulkThreads)
        v[i] = times2<DT>(v[i]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (tid == 0) {
      bulk_store(out + off, ring_addr + s * chunk, len);
      if (k >= 1) {  // stage k-1 is free once its store has read it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        issue(static_cast<int>((k - 1) % stages), take());
      }
    }
  }
  if (tid == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    __threadfence();
    if (atomicAdd(counters + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

template <int DT, bool kScale>
cudaError_t launch_bulk(const void* x, void* out, const Layout& L, int grid,
                        int stages, int* counters, cudaStream_t stream) {
  const int smem = stages * static_cast<int>(L.chunk) + 8 * stages;
  auto kernel = stream_copy_bulk_kernel<DT, kScale>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBulkThreads, smem, stream>>>(
      static_cast<const char*>(x), static_cast<char*>(out), L, stages,
      counters);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Element route
// ---------------------------------------------------------------------------

// One block per tile; sizes are in elements.  A tile holds block_rows rows
// of tile_cols elements; rows of the array are row_elems apart.
template <typename E, int DT, bool kScale>
__global__ void __launch_bounds__(kThreads)
    stream_copy_element_kernel(const E* __restrict__ x, E* __restrict__ out,
                               int64_t row_elems, uint32_t tile_cols,
                               uint32_t block_rows, uint32_t tiles_per_row) {
  const uint32_t ti = blockIdx.x / tiles_per_row;
  const uint32_t tj = blockIdx.x % tiles_per_row;
  const int64_t base = static_cast<int64_t>(ti) * block_rows * row_elems +
                       static_cast<int64_t>(tj) * tile_cols;
  const uint32_t n = block_rows * tile_cols;
  const bool contiguous = tile_cols == row_elems;
  for (uint32_t v0 = threadIdx.x; v0 < n; v0 += kThreads * kUnroll) {
    E r[kUnroll];
    int64_t off[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t v = v0 + k * kThreads;
      off[k] = contiguous ? static_cast<int64_t>(v)
                          : static_cast<int64_t>(v / tile_cols) * row_elems +
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

template <typename E, int DT>
cudaError_t launch_element(const void* x, void* out, int64_t cols,
                           uint32_t block_cols, uint32_t block_rows,
                           uint32_t tiles_per_row, uint32_t tiles, int scale,
                           cudaStream_t stream) {
  const E* xs = static_cast<const E*>(x);
  E* os = static_cast<E*>(out);
  if (scale)
    stream_copy_element_kernel<E, DT, true><<<tiles, kThreads, 0, stream>>>(
        xs, os, cols, block_cols, block_rows, tiles_per_row);
  else
    stream_copy_element_kernel<E, DT, false><<<tiles, kThreads, 0, stream>>>(
        xs, os, cols, block_cols, block_rows, tiles_per_row);
  return cudaGetLastError();
}

bool valid_tiling(long long rows, long long cols, long long block_rows,
                  long long block_cols) {
  return rows > 0 && cols > 0 && block_rows > 0 && block_cols > 0 &&
         rows % block_rows == 0 && cols % block_cols == 0;
}

}  // namespace

// x, out: (rows, cols) contiguous; the tile is (block_rows, block_cols) and
// divides the array.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int stream_copy_element_launch(const void* x, void* out,
                                          long long rows, long long cols,
                                          long long block_rows,
                                          long long block_cols, int dtype,
                                          int scale, void* stream) {
  if (!valid_tiling(rows, cols, block_rows, block_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_per_row = cols / block_cols;
  const long long tiles = (rows / block_rows) * tiles_per_row;
  if (tiles > 0x7FFFFFFFLL || block_rows * block_cols > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return static_cast<int>(launch_element<float, kFloat32>(
          x, out, cols, block_cols, block_rows, tiles_per_row, tiles, scale,
          s));
    case kBFloat16:
      return static_cast<int>(launch_element<uint16_t, kBFloat16>(
          x, out, cols, block_cols, block_rows, tiles_per_row, tiles, scale,
          s));
    case kInt8:
      return static_cast<int>(launch_element<int8_t, kInt8>(
          x, out, cols, block_cols, block_rows, tiles_per_row, tiles, scale,
          s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bulk route.  The caller checked that both bases are 16-byte aligned
// and chose `grid` blocks, requests of at most `chunk` bytes (a multiple of
// 16) and a ring of `stages` stages; `counters` are 2 int32 that are 0.
extern "C" int stream_copy_bulk_launch(const void* x, void* out,
                                       long long rows, long long cols,
                                       long long block_rows,
                                       long long block_cols, int dtype,
                                       int scale, long long grid,
                                       long long chunk, int stages,
                                       int* counters, void* stream) {
  const int itemsize = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 2 : 1;
  if (!valid_tiling(rows, cols, block_rows, block_cols) || dtype < 0 ||
      dtype > kInt8 || (block_cols * itemsize) % 16 || chunk <= 0 ||
      chunk % 16 || stages < 2 || stages > kMaxStages ||
      stages * chunk + 16 * stages > kMaxSmem || grid < 1 ||
      grid > 0x7FFFFFFFLL ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  const bool whole = block_cols == cols;
  L.row_bytes = cols * itemsize;
  L.tile_rows = block_rows;
  L.tile_col_bytes = block_cols * itemsize;
  L.tiles_per_row = cols / block_cols;
  L.segs = whole ? 1 : block_rows;
  L.seg_bytes = whole ? block_rows * L.row_bytes : L.tile_col_bytes;
  L.chunk = L.seg_bytes < chunk ? L.seg_bytes : chunk;
  L.pieces = (L.seg_bytes + L.chunk - 1) / L.chunk;
  L.requests = (rows / block_rows) * L.tiles_per_row * L.segs * L.pieces;
  // every ticket a launch hands out fits an int32 counter
  if (L.requests + grid > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(grid);
  if (!scale)  // a copy moves bytes whatever their type
    return static_cast<int>(
        launch_bulk<kFloat32, false>(x, out, L, g, stages, counters, s));
  switch (dtype) {
    case kFloat32:
      return static_cast<int>(
          launch_bulk<kFloat32, true>(x, out, L, g, stages, counters, s));
    case kBFloat16:
      return static_cast<int>(
          launch_bulk<kBFloat16, true>(x, out, L, g, stages, counters, s));
    default:
      return static_cast<int>(
          launch_bulk<kInt8, true>(x, out, L, g, stages, counters, s));
  }
}
