// Paged-KV decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (function `paged_attention`, body
// `_kernel`).  Same function: one query token per sequence attends over its
// KV cache through a page table.
//
//   q          (B, Hq, D)            float32 or bfloat16
//   k/v_pages  (P, page, Hkv, D)     same dtype as q, or int8 with
//   k/v_scale  (P, page)             float32 per-token dequant scales
//   page_table (B, N)                int32 pool page of each logical page
//   valid_len  (B,)                  int32
//   out        (B, Hq, D)            q's dtype
//
// Math: query head h reads kv head h / (Hq/Hkv); float32 online softmax over
// `q * scale`; mask `pos < valid_len`; optional softcap c*tanh(s/c) on the
// raw scores; optional ring `window` (slot j of the table holds logical page
// cur_L - ((cur_L - j) mod N), masked to pos > valid-1-window); a masked
// token contributes exactly 0; out = acc / max(l, 1e-30).
//
// Bound: bytes.  A decode step reads every live K/V row once and does ~4
// flops per element read, far below the card's ridge point, so the kernel
// is as fast as it streams pages.  Design: the token walk of each
// (sequence, kv head) is split across `splits` blocks (grid.y), so a small
// batch still fills the card; the g = Hq/Hkv query rows of the head share
// every K/V row a block loads, so each row is read once per step, not g
// times.  A block walks its share in tiles of kTile tokens: (0) the tile's
// pool rows, (1) every live K and V row of the tile copied into shared
// memory with 16-byte asynchronous copies, all in flight at once, (2) each
// warp scores its tokens against all g rows (lanes split D, a warp
// reduction per row), (3) one warp per row updates the running max/sum,
// (4) each thread owns one of the D output columns and accumulates p*v for
// all g rows in registers.  Tokens past valid_len and masked tokens are
// never loaded.  With one split the block writes the output; otherwise it
// writes its (m, l, acc) and `combine_kernel` merges the splits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;         // tokens per tile (one per lane in (3))
constexpr int kMaxGroup = 16;     // query heads per kv head
constexpr int kMaxHeadDim = 512;
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "the softmax pass gives each lane one token");

enum DType { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <typename QT, typename KVT>
__global__ void paged_attention_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pages,
    const KVT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ valid_len, QT* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int hq,
    int hkv, int d, int page, int n_pages, float scale, float softcap,
    int window, int tiles_per_split) {
  // dynamic: q_s [g][d] f32 scaled query rows | k_s, v_s [kTile][d] KVT
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_s[kMaxGroup][kTile];     // scores, then probabilities
  __shared__ int row_s[kTile];                // pool row of a tile token, -1 = masked
  __shared__ float ks_s[kTile];
  __shared__ float vs_s[kTile];
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
  const int valid = valid_len[b];
  const int* table = page_table + static_cast<long>(b) * n_pages;
  const bool quant = k_scale != nullptr;

  // tokens to walk: a full table stops at valid_len; a ring visits every slot
  int n_tok = 0;
  if (valid > 0) n_tok = window > 0 ? n_pages * page : min(valid, n_pages * page);
  const int cur_l = valid > 0 ? (valid - 1) / page : 0;
  const int t_begin = split * tiles_per_split * kTile;
  const int t_end = min(n_tok, t_begin + tiles_per_split * kTile);
  const long part = static_cast<long>(bh) * splits + split;

  if (t_begin >= t_end) {  // nothing of this row in this split
    if (splits > 1) {
      if (tid < g) {
        part_ml[(part * g + tid) * 2] = kNegInf;
        part_ml[(part * g + tid) * 2 + 1] = 0.f;  // l = 0: acc never read
      }
    } else if (tid < d) {
      QT* ob = out + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;
      for (int h = 0; h < g; ++h) store(ob + static_cast<long>(h) * d + tid, 0.f);
    }
    return;
  }

  float* q_s = reinterpret_cast<float*>(smem);
  KVT* k_s = reinterpret_cast<KVT*>(q_s + g * d);   // g*d*4 is a multiple of 16
  KVT* v_s = k_s + kTile * d;

  const QT* qb = q + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;
  for (int i = tid; i < g * d; i += blockDim.x) q_s[i] = to_float(qb[i]) * scale;
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) acc[h] = 0.f;
  const int chunks = d * static_cast<int>(sizeof(KVT)) / 16;  // per row

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    // (0) pool row of each token of the tile
    if (tid < kTile) {
      const int idx = t0 + tid;
      int row = -1;
      if (idx < t_end) {
        const int j = idx / page;
        const int r = idx - j * page;
        int pos;
        bool ok;
        if (window > 0) {
          int delta = (cur_l - j) % n_pages;
          if (delta < 0) delta += n_pages;
          pos = (cur_l - delta) * page + r;
          ok = pos >= 0 && pos < valid && pos > valid - 1 - window;
        } else {
          pos = idx;
          ok = pos < valid;
        }
        if (ok) row = table[j] * page + r;
      }
      row_s[tid] = row;
      if (quant && row >= 0) {
        ks_s[tid] = k_scale[row];
        vs_s[tid] = v_scale[row];
      }
    }
    __syncthreads();

    // (1) live K/V rows of the tile into shared memory, 16 bytes a copy
    for (int c = tid; c < kTile * chunks; c += blockDim.x) {
      const int t = c / chunks;
      const int o = c - t * chunks;
      const int row = row_s[t];
      if (row < 0) continue;
      const long src = (static_cast<long>(row) * hkv + kvh) * d;
      copy16_async(reinterpret_cast<uint4*>(k_s + t * d) + o,
                   reinterpret_cast<const uint4*>(k_pages + src) + o);
      copy16_async(reinterpret_cast<uint4*>(v_s + t * d) + o,
                   reinterpret_cast<const uint4*>(v_pages + src) + o);
    }
    copy_async_wait_all();
    __syncthreads();

    // (2) scores: warp w takes tokens w, w + nwarps, ... of the tile
    for (int t = warp; t < kTile; t += nwarps) {
      if (row_s[t] < 0) {  // warp-uniform
        if (lane == 0) {
#pragma unroll
          for (int h = 0; h < kMaxGroup; ++h)
            if (h < g) s_s[h][t] = kNegInf;
        }
        continue;
      }
      const KVT* krow = k_s + t * d;
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
        const float ks = quant ? ks_s[t] : 1.f;
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h) {
          if (h < g) {
            float s = dot[h] * ks;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            s_s[h][t] = s;
          }
        }
      }
    }
    __syncthreads();

    // (3) online softmax: one warp per query row, one token per lane
    for (int h = warp; h < g; h += nwarps) {
      float mx = s_s[h][lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      const float p = row_s[lane] >= 0 ? expf(s_s[h][lane] - m_new) : 0.f;
      s_s[h][lane] = p;
      float sum = p;
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

    // (4) acc = acc * alpha + p @ v: thread tid owns output column tid
    if (tid < d) {
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < g) acc[h] *= alpha_s[h];
      for (int t = 0; t < kTile; ++t) {
        if (row_s[t] < 0) continue;
        float vv = to_float(v_s[t * d + tid]);
        if (quant) vv *= vs_s[t];
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) acc[h] += s_s[h][t] * vv;
      }
    }
    __syncthreads();
  }

  if (splits == 1) {
    if (tid < d) {
      QT* ob = out + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;
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
template <typename QT>
__global__ void combine_kernel(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               QT* __restrict__ out, int hq, int hkv, int d,
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
  QT* ob = out + (static_cast<long>(bh) * g + h) * d;   // bh*g = b*hq + kvh*g
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

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale,
                   const void* page_table, const void* valid_len, void* out,
                   void* work, int batch, int hq, int hkv, int d, int page,
                   int n_pages, float scale, float softcap, int window,
                   int splits, cudaStream_t stream) {
  if ((d * static_cast<int>(sizeof(KVT))) % 16 != 0)
    return cudaErrorInvalidValue;
  const int g = hq / hkv;
  int threads = ((d + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  const size_t smem = static_cast<size_t>(g) * d * sizeof(float) +
                      2 * static_cast<size_t>(kTile) * d * sizeof(KVT);
  auto kernel = paged_attention_kernel<QT, KVT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = (n_pages * page + kTile - 1) / kTile;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  float* part_ml = static_cast<float*>(work);
  float* part_acc =
      part_ml == nullptr
          ? nullptr
          : part_ml + static_cast<long>(batch) * hkv * splits * g * 2;
  kernel<<<dim3(batch * hkv, splits), threads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(valid_len), static_cast<QT*>(out), part_ml,
      part_acc, hq, hkv, d, page, n_pages, scale, softcap, window,
      tiles_per_split);
  if (splits > 1)
    combine_kernel<QT><<<dim3(batch * hkv, g), threads, 0, stream>>>(
        part_ml, part_acc, static_cast<QT*>(out), hq, hkv, d, splits);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// dtype codes: 0 float32, 1 bfloat16, 2 int8.  k_scale/v_scale are null
// unless kv_dtype is int8.  softcap <= 0 and window <= 0 mean "off".  The
// token walk of each (sequence, kv head) is split across `splits` blocks;
// with splits > 1, `work` holds B*Hkv*splits*(Hq/Hkv)*(D+2) floats.  Page
// rows must be 16-byte aligned: D*itemsize a multiple of 16.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* valid_len, void* out, void* work, int batch, int hq, int hkv,
    int d, int page, int n_pages, float scale, float softcap, int window,
    int splits, int q_dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxGroup ||
      d <= 0 || d > kMaxHeadDim || page <= 0 || n_pages <= 0 || splits <= 0 ||
      (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kInt8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PA_ARGS                                                        \
  q, k_pages, v_pages, k_scale, v_scale, page_table, valid_len, out, work,  \
      batch, hq, hkv, d, page, n_pages, scale, softcap, window, splits, s
  cudaError_t err;
  if (q_dtype == kFloat32 && kv_dtype == kFloat32)
    err = launch<float, float>(REPRO_PA_ARGS);
  else if (q_dtype == kBFloat16 && kv_dtype == kBFloat16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(REPRO_PA_ARGS);
  else if (q_dtype == kFloat32 && kv_dtype == kInt8)
    err = launch<float, int8_t>(REPRO_PA_ARGS);
  else if (q_dtype == kBFloat16 && kv_dtype == kInt8)
    err = launch<__nv_bfloat16, int8_t>(REPRO_PA_ARGS);
  else
    err = cudaErrorInvalidValue;
#undef REPRO_PA_ARGS
  return static_cast<int>(err);
}
