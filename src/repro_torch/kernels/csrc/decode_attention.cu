// Flash-decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (function `decode_attention`, body
// `_kernel`, grid in `_decode_call`).  Same function: one query token per
// sequence attends over its cache.
//
//   q          (B, Hq, D)            float32 or bfloat16
//   k, v       (B, T, Hkv, D)        q's dtype, contiguous
//   valid_len  (B,)                  int32, clamped to [0, T]
//   out        (B, Hq, D)            q's dtype
//
// Math: query head h reads kv head h / (Hq/Hkv); float32 online softmax over
// `q * scale`; optional softcap c*tanh(s/c) on the raw scores; tokens at or
// past valid_len are never loaded and contribute exactly 0; out = acc /
// max(l, 1e-30), so a row with valid_len 0 is exactly 0 (the reference's
// oracle gives the mean of V there and its Pallas kernel the mean of its
// zero padding: such rows are checked on their own).
//
// Bound: bytes.  A decode step reads every live K/V row once and does ~4
// flops per element read, far below the card's ridge point.  The tuned plan
// reaches the kernel as the paper's two knobs: `rows` (the plan's bkv) is
// the burst, the K/V rows one tile stages in shared memory with 16-byte
// `cp.async` copies; `stages` (the plan's pipeline_depth, capped by the
// shared memory of a block) is the outstanding count, the tiles in flight
// in a ring.  The token walk of each (sequence, kv head) is split across
// `splits` blocks (grid.y), each taking an equal share of the row's own
// live tiles, so a small batch still fills the card; the g = Hq/Hkv query
// rows of the head share every K/V row a block loads.  Per tile: (1) each
// warp scores its tokens against all g rows (lanes split D, a warp
// reduction per row), (2) one warp per row updates the running max and
// sum, (3) each thread owns one of the D output columns and accumulates
// p*v for all g rows in registers.  With one split the block writes the
// output; otherwise it writes (m, l, acc) and `combine_kernel` merges the
// splits, as in paged_attention.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 16;     // query heads per kv head
constexpr int kMaxStages = 32;    // tiles in flight (cp.async.wait_group immediates)
constexpr float kNegInf = -1e30f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// 16 bytes global -> shared without passing through registers
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `pending` of this thread's newest copy groups are
// still in flight (the instruction takes an immediate).
__device__ __forceinline__ void copy_async_wait(int pending) {
  switch (pending) {
#define REPRO_WAIT(n)                                      \
  case n:                                                  \
    asm volatile("cp.async.wait_group " #n ";\n" ::);      \
    break;
    REPRO_WAIT(0) REPRO_WAIT(1) REPRO_WAIT(2) REPRO_WAIT(3) REPRO_WAIT(4)
    REPRO_WAIT(5) REPRO_WAIT(6) REPRO_WAIT(7) REPRO_WAIT(8) REPRO_WAIT(9)
    REPRO_WAIT(10) REPRO_WAIT(11) REPRO_WAIT(12) REPRO_WAIT(13)
    REPRO_WAIT(14) REPRO_WAIT(15) REPRO_WAIT(16) REPRO_WAIT(17)
    REPRO_WAIT(18) REPRO_WAIT(19) REPRO_WAIT(20) REPRO_WAIT(21)
    REPRO_WAIT(22) REPRO_WAIT(23) REPRO_WAIT(24) REPRO_WAIT(25)
    REPRO_WAIT(26) REPRO_WAIT(27) REPRO_WAIT(28) REPRO_WAIT(29)
    REPRO_WAIT(30) REPRO_WAIT(31)
#undef REPRO_WAIT
    default:
      asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

template <typename T>
__global__ void decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ valid_len, T* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int hq,
    int hkv, int t_len, int d, int rows, int stages, float scale,
    float softcap) {
  // dynamic: q_s [g][d] f32 scaled query rows | s_s [g][rows] f32 scores,
  // then probabilities (padded to 16 bytes) | ring of `stages` tiles, each
  // [rows][d] of K then [rows][d] of V
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float alpha_s[kMaxGroup];

  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int kvh = bh % hkv;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int g = hq / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int valid = min(max(valid_len[b], 0), t_len);
  const int n_tiles = (valid + rows - 1) / rows;
  const int per_split = (n_tiles + splits - 1) / splits;
  const int tile_begin = split * per_split;
  const int nt = min(n_tiles, tile_begin + per_split) - tile_begin;
  const long part = static_cast<long>(bh) * splits + split;

  if (nt <= 0) {  // nothing of this row in this split
    if (splits > 1) {
      if (tid < g) {
        part_ml[(part * g + tid) * 2] = kNegInf;
        part_ml[(part * g + tid) * 2 + 1] = 0.f;  // l = 0: acc never read
      }
    } else {
      T* ob = out + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;
      for (int i = tid; i < g * d; i += blockDim.x) store(ob + i, 0.f);
    }
    return;
  }

  float* q_s = reinterpret_cast<float*>(smem);
  float* s_s = q_s + g * d;
  T* ring = reinterpret_cast<T*>(smem + static_cast<size_t>(g) * d * 4 +
                                 ((static_cast<size_t>(g) * rows * 4 + 15) / 16) * 16);
  const long tile_elems = static_cast<long>(rows) * d;

  const T* qb = q + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;
  for (int i = tid; i < g * d; i += blockDim.x) q_s[i] = to_float(qb[i]) * scale;
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) acc[h] = 0.f;

  const int per_copy = 16 / static_cast<int>(sizeof(T));   // elements
  const int chunks = d / per_copy;                           // per row
  const long row_stride = static_cast<long>(hkv) * d;        // token to token
  const T* kb = k + (static_cast<long>(b) * t_len * hkv + kvh) * d;
  const T* vb = v + (static_cast<long>(b) * t_len * hkv + kvh) * d;

  // issue the copies of local tile i into its stage of the ring
  auto load_tile = [&](int i) {
    const int t0 = (tile_begin + i) * rows;
    const int n_rows = min(rows, valid - t0);
    T* ks = ring + static_cast<long>(i % stages) * 2 * tile_elems;
    T* vs = ks + tile_elems;
    for (int c = tid; c < n_rows * chunks; c += blockDim.x) {
      const int t = c / chunks;
      const int o = (c - t * chunks) * per_copy;
      const long src = (t0 + t) * row_stride + o;
      copy16_async(ks + static_cast<long>(t) * d + o, kb + src);
      copy16_async(vs + static_cast<long>(t) * d + o, vb + src);
    }
  };

  // prologue: the first stages - 1 tiles in flight, one copy group each
  for (int p = 0; p < stages - 1; ++p) {
    if (p < nt) load_tile(p);
    copy_async_commit();
  }

  for (int i = 0; i < nt; ++i) {
    // refill the stage tile i - 1 used; every thread commits one group per
    // step (maybe empty), so waiting for all but the newest stages - 1
    // groups waits for tile i
    if (i + stages - 1 < nt) load_tile(i + stages - 1);
    copy_async_commit();
    copy_async_wait(stages - 1);
    __syncthreads();

    const int n_rows = min(rows, valid - (tile_begin + i) * rows);
    const T* ks = ring + static_cast<long>(i % stages) * 2 * tile_elems;
    const T* vs = ks + tile_elems;

    // (1) scores: warp w takes tokens w, w + nwarps, ... of the tile
    for (int t = warp; t < n_rows; t += nwarps) {
      const T* krow = ks + static_cast<long>(t) * d;
      float dot[kMaxGroup];
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) dot[h] = 0.f;
      for (int dd = lane; dd < d; dd += 32) {
        const float kv = to_float(krow[dd]);
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) dot[h] += q_s[h * d + dd] * kv;
      }
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h < g) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], o);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h) {
          if (h < g) {
            float s = dot[h];
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            s_s[h * rows + t] = s;
          }
        }
      }
    }
    __syncthreads();

    // (2) online softmax: one warp per query row, tokens across lanes
    for (int h = warp; h < g; h += nwarps) {
      float* sh = s_s + h * rows;
      float mx = kNegInf;
      for (int t = lane; t < n_rows; t += 32) mx = fmaxf(mx, sh[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n_rows; t += 32) {
        const float p = expf(sh[t] - m_new);
        sh[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // (3) acc = acc * alpha + p @ v: thread tid owns output column tid
    if (tid < d) {
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < g) acc[h] *= alpha_s[h];
      for (int t = 0; t < n_rows; ++t) {
        const float vv = to_float(vs[static_cast<long>(t) * d + tid]);
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) acc[h] += s_s[h * rows + t] * vv;
      }
    }
    __syncthreads();   // the stage is refilled at the next step
  }

  if (splits == 1) {
    if (tid < d) {
      T* ob = out + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < g) store(ob + static_cast<long>(h) * d + tid,
                         acc[h] / fmaxf(l_s[h], 1e-30f));
    }
    return;
  }
  if (tid < g) {
    part_ml[(part * g + tid) * 2] = m_s[tid];
    part_ml[(part * g + tid) * 2 + 1] = l_s[tid];
  }
  if (tid < d) {
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h)
      if (h < g) part_acc[(part * g + h) * d + tid] = acc[h];
  }
}

// Merges the splits of one (sequence, query head): grid (B*Hkv, g).
// A split with l = 0 saw no live token and adds exactly 0.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int hq, int hkv, int d,
                               int splits) {
  const int bh = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const long first = static_cast<long>(bh) * splits;
  float m = kNegInf;
  for (int s = 0; s < splits; ++s) {
    const float* ml = part_ml + ((first + s) * g + h) * 2;
    if (ml[1] > 0.f) m = fmaxf(m, ml[0]);
  }
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* ml = part_ml + ((first + s) * g + h) * 2;
    if (ml[1] > 0.f) l += ml[1] * expf(ml[0] - m);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* ob = out + (static_cast<long>(bh) * g + h) * d;   // bh*g = b*hq + kvh*g
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ml = part_ml + ((first + s) * g + h) * 2;
      if (ml[1] > 0.f)
        o += part_acc[((first + s) * g + h) * d + col] * expf(ml[0] - m);
    }
    store(ob + col, o * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid_len, void* out, void* work, int batch,
                   int hq, int hkv, int t_len, int d, int rows, int stages,
                   int splits, float scale, float softcap,
                   cudaStream_t stream) {
  if ((d * static_cast<int>(sizeof(T))) % 16 != 0) return cudaErrorInvalidValue;
  const int g = hq / hkv;
  int threads = ((d + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  const size_t smem =
      static_cast<size_t>(g) * d * 4 +
      ((static_cast<size_t>(g) * rows * 4 + 15) / 16) * 16 +
      static_cast<size_t>(stages) * 2 * rows * d * sizeof(T);
  auto kernel = decode_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  float* part_ml = static_cast<float*>(work);
  float* part_acc =
      part_ml == nullptr
          ? nullptr
          : part_ml + static_cast<long>(batch) * hkv * splits * g * 2;
  kernel<<<dim3(batch * hkv, splits), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid_len),
      static_cast<T*>(out), part_ml, part_acc, hq, hkv, t_len, d, rows,
      stages, scale, softcap);
  if (splits > 1)
    combine_kernel<T><<<dim3(batch * hkv, g), threads, 0, stream>>>(
        part_ml, part_acc, static_cast<T*>(out), hq, hkv, d, splits);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// dtype codes: 0 float32, 1 bfloat16.  softcap <= 0 means "off".  `rows`
// K/V rows per tile, `stages` tiles in flight (1..32); the token walk of
// each (sequence, kv head) is split across `splits` blocks, and with
// splits > 1 `work` holds B*Hkv*splits*(Hq/Hkv)*(D+2) floats.  K/V rows
// must be 16-byte aligned: D*itemsize a multiple of 16.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid_len,
    void* out, void* work, int batch, int hq, int hkv, int t_len, int d,
    int rows, int stages, int splits, float scale, float softcap, int dtype,
    void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxGroup ||
      d <= 0 || d > 1024 || t_len <= 0 || rows <= 0 || stages <= 0 ||
      stages > kMaxStages || splits <= 0 ||
      (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch<float>(q, k, v, valid_len, out, work, batch, hq, hkv, t_len,
                        d, rows, stages, splits, scale, softcap, s);
  else if (dtype == kBFloat16)
    err = launch<__nv_bfloat16>(q, k, v, valid_len, out, work, batch, hq, hkv,
                                t_len, d, rows, stages, splits, scale,
                                softcap, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
