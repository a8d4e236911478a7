// Paged-KV decode attention for Hopper (sm_90a): bfloat16 q with bfloat16
// or int8 pages on the tensor cores (mma.sync), float32 (and float32 q with
// int8 pages) on the CUDA cores.
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
// token contributes exactly 0; out = acc / max(l, 1e-30).  int8 pages:
// k * k_scale and v * v_scale in float32.
//
// Bound: bytes.  A decode step reads every live K/V row once and does
// 4 g flops per element of K or V, far below the card's ridge point.  At
// the main path's shape (gemma-2b: B 8, 8/1 heads, D 256, 1024 tokens) the
// 8.4 MB of K/V take 2.5 us at 3.35 TB/s, so fixed costs count: the
// loads before the first K/V byte moves (valid_len and the page table),
// the launch, and the merge of the splits.  What held the first
// design back: one 32-token tile a block with three block barriers and a
// serial softmax step, scalar 2-byte shared reads and g FMAs per element on
// the CUDA cores, and a second launch to merge 32 splits whose partials
// were a quarter of the K/V bytes.  int8 pages halve the K/V bytes and add
// 8 bytes of scales a token (D + 4 bytes a token for K, the same for V);
// at a serve drain's lengths (a third of gemma-2b's 1024 tokens) the live
// int8 K/V are 1.4 MB, under half a microsecond of the card's bandwidth, so
// what bounds an int8 call in practice is the same fixed chain.
//
// Tensor-core route (`paged_attention_mma_launch`; bfloat16 q, bfloat16 or
// int8 pages, D 64, 128, 256), the device code in decode_core.cuh: a block
// per (sequence, kv head, split); a block loads its table row (or, for a
// table over 2048 pages, its split's page ids) into shared memory in one
// pass, beside valid_len, then each of its warps walks its own contiguous
// slice of the block's tokens in tiles of 16 through a ring of `stages`
// tiles of its own (no block barrier per tile); S = q K^T and P V are
// mma.sync.m16n8k16 with the g query rows as M (P in two bfloat16 parts);
// the warps merge once through shared memory, and the splits merge in the
// same launch: 2 to 8 splits as one thread-block cluster through
// distributed shared memory, more through global partials and an arrival
// counter the wrapper keeps per device (reset by the merging block).
// Tokens past valid_len and ring-masked tokens are never loaded.  At the
// main path's shape the wrapper runs 4 warps, 3 stages and 8 splits (64
// blocks, one per SM); timed on an H100 by a development sweep (PERF.md's
// K1/K3 findings), 2 and 8 warps, 2 stages, 4 and 16 splits and the counter
// merge were slower or no faster.
//
// int8 pages on the tensor cores (the same walk, `WarpWalk<D, Src, int8_t>`):
// the first port ran them on the CUDA cores with the CUDA-core split rule
// (32 one-tile splits at the serve drain's geometry, whose global partials
// moved more bytes than the K/V), a dependent chain of loads (page id, row,
// scales) before each tile's copies, four block barriers a tile, and every
// product on the CUDA cores; 1.76x SDPA on dequantized K/V (PERF.md's K1
// row).
// Now a warp's ring stage holds the tile's int8 K and V rows (16-byte
// cp.async, zero-filled for masked tokens) and its 16 k_scale and 16
// v_scale floats (4-byte cp.async in the same commit group, zero-filled
// where masked), so the scales ride `stages - 1` tiles ahead with the rows.
// The products build their bfloat16 fragments in registers straight from
// 32-bit and 128-bit shared loads (design (b): int8 -> bfloat16 is exact,
// two values at a time by two masks and one bfloat16 subtraction; no
// bfloat16 copy of the tile is written back to shared memory).  Design
// (a), converting each landed tile into a bfloat16 tile that the bfloat16
// products read as they are, was timed against (b) on an H100 and was
// slower: 3% at the drain's lengths, 11% at full rows, 8% after a decode
// step's other kernels (PERF.md's K1 findings).  The scales stay outside the
// products: S's columns are multiplied by k_scale before the softmax scale
// and softcap, p by v_scale before its bfloat16 split, and the running sum
// takes the unscaled p.  q is never quantized and k * k_scale never rounded
// to bfloat16.  The split rule and merge are the bfloat16 route's (8 splits
// and a cluster merge at the drain's geometry).  A warp's ring region is
// the larger of its stages and its merge rows (two int8 stages are smaller
// than the 16 x (D + 8) floats finish_warps puts there).  At D 256 the
// score windows stay a loop: unrolled, the kernel was 3% faster after one
// GEMM and 9% slower after a decode step's other kernels
// (tools/k1_context.py).
//
// CUDA-core route (`paged_attention_cc_launch`; float32, float32 q with int8
// pages, and bfloat16 at other head dims), kept from the first port apart
// from the merge: the token walk of each (sequence, kv head) is split across
// blocks (grid.y); a block walks its share in tiles of kTile tokens: (0) the
// tile's pool rows, (1) every live K and V row of the tile copied into
// shared memory with 16-byte asynchronous copies, all in flight at once, (2)
// each warp scores its tokens against all g rows (lanes split D, a warp
// reduction per row), (3) one warp per row updates the running max/sum, (4)
// each thread owns one of the D output columns and accumulates p*v for all
// g rows in registers. The splits merge in the launch as above.
#include "decode_core.cuh"

namespace {

using decode::kMaxGroup;
using decode::kMaxSplits;
using decode::kMaxStages;
using decode::kMaxWarps;
using decode::kMinStages;
using decode::kNegInf;

constexpr int kTile = 32;         // CUDA-core route: tokens per tile
constexpr int kMaxHeadDim = 512;
constexpr int kWholeTable = 2048; // tensor-core route: a table row kept whole
static_assert(kTile == 32, "the softmax pass gives each lane one token");

enum DType { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

// ---------------------------------------------------------------------------
// Tensor-core route: bfloat16 q, bfloat16 or int8 pages
// ---------------------------------------------------------------------------

// Token idx of the walk -> its row in the pools, through the block's page
// ids (pid: pool pages of logical slots j0, j0 + 1, ...), or -1 if masked.
// T is the pages' element type; int8 pages also carry their (P, page)
// scale lanes, whose index is the row.  With the row found first and
// scaled to an offset after (and the struct a template), the bfloat16 D
// 128 kernel runs 13-16% faster on an H100 than with one offset() computed
// in place; its machine code differs only in integer address arithmetic
// (14 fewer instructions) and in 206 registers against 179
// (tools/k1_compare.py; PERF.md's K1 findings).  Check that tool's output
// after editing this struct.
template <typename T>
struct PagedRows {
  const T* k;               // k_pages + kvh D
  const T* v;
  const float* ks;          // int8: k_scale, v_scale (else null)
  const float* vs;
  const int* pid;
  long long row_elems;      // Hkv D: one pool row to the next
  int j0, page, n_pages, n_tok, valid, window, cur_l;
  __device__ __forceinline__ long long row(int idx) const {
    if (idx >= n_tok) return -1;
    const int j = idx / page;
    const int r = idx - j * page;
    bool ok;
    if (window > 0) {
      int delta = (cur_l - j) % n_pages;
      if (delta < 0) delta += n_pages;
      const int pos = (cur_l - delta) * page + r;
      ok = pos >= 0 && pos < valid && pos > valid - 1 - window;
    } else {
      ok = idx < valid;
    }
    return ok ? static_cast<long long>(pid[j - j0]) * page + r : -1;
  }
  __device__ __forceinline__ long long offset(int idx) const {
    const long long rw = row(idx);
    return rw >= 0 ? rw * row_elems : -1;
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const T* __restrict__ k_pages,
                               const T* __restrict__ v_pages,
                               const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale,
                               const int* __restrict__ page_table,
                               const int* __restrict__ valid_len,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ part_ml,
                               float* __restrict__ part_acc,
                               int* __restrict__ counter, int hq, int hkv,
                               int page, int n_pages, int stages, float scale,
                               float softcap, int window, int cluster) {
  if (cluster) decode::cluster_arrive();   // this block is running
  using L = decode::MmaLayout<D, T>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t live_s[kMaxWarps][kMaxStages];
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int kvh = bh - b * hkv;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long row0 = static_cast<long long>(b) * hq +
                         static_cast<long long>(kvh) * g;   // q/out rows
  uint8_t* q_s = smem;
  uint8_t* ring = smem + L::kQBytes;
  int* pid_s = reinterpret_cast<int*>(smem + L::smem(warps, stages));
  const decode::Split sp{part_ml, part_acc, counter, bh, split, splits,
                         cluster != 0};
  const decode::Recv recv(smem + L::recv(warps, stages), L::kRecvAccBytes,
                          splits, D);

  // the query rows in flight first, then valid_len and, where the table's
  // row fits (kWholeTable), its page ids, so one memory latency covers
  // both; the live range: a full table stops at valid_len, a ring visits
  // every slot
  decode::load_q<D>(q + row0 * D, g, q_s);
  decode::copy_commit();
  const int valid = valid_len[b];
  const int* table = page_table + static_cast<long>(b) * n_pages;
  const bool whole = n_pages <= kWholeTable;
  if (whole) {
    for (int j = threadIdx.x; j < n_pages; j += blockDim.x) pid_s[j] = table[j];
  }
  int n_tok = 0;
  if (valid > 0)
    n_tok = window > 0 ? n_pages * page : min(valid, n_pages * page);
  const int tiles = (n_tok + decode::kTile - 1) / decode::kTile;
  const int per = (tiles + splits - 1) / splits;
  const int tb = min(tiles, split * per);
  const int te = min(tiles, tb + per);
  if (tb >= te) {   // nothing of this row in this split
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __nv_bfloat16* ob = out + row0 * D;
    if (splits == 1) {
      for (int i = threadIdx.x; i < g * D; i += blockDim.x)
        ob[i] = __float2bfloat16(0.f);
      return;
    }
    decode::finish_empty(ob, sp, g, D, reinterpret_cast<float*>(ring), recv);
    return;
  }

  // a longer table: the split's page ids, in one pass
  const int t_lo = tb * decode::kTile;
  const int t_hi = min(te * decode::kTile, n_tok);
  const int j0 = whole ? 0 : t_lo / page;
  if (!whole) {
    const int j1 = (t_hi + page - 1) / page;
    for (int j = j0 + static_cast<int>(threadIdx.x); j < j1; j += blockDim.x)
      pid_s[j - j0] = table[j];
  }
  __syncthreads();

  // this warp's contiguous slice of the block's tiles
  const int wper = (te - tb + warps - 1) / warps;
  const int wt0 = min(te, tb + warp * wper);
  const int wt1 = min(te, wt0 + wper);
  const PagedRows<T> src{k_pages + static_cast<long long>(kvh) * D,
                         v_pages + static_cast<long long>(kvh) * D,
                         k_scale,
                         v_scale,
                         pid_s,
                         static_cast<long long>(hkv) * D,
                         j0,
                         page,
                         n_pages,
                         n_tok,
                         valid,
                         window,
                         valid > 0 ? (valid - 1) / page : 0};
  decode::WarpWalk<D, PagedRows<T>, T> walk(
      src, ring + static_cast<long>(warp) * L::warp_ring(stages),
      live_s[warp], stages, wt0 * decode::kTile,
      min(wt1 * decode::kTile, t_hi));
  walk.prologue();
  decode::copy_wait(stages - 1);   // group 0, the query rows, has landed
  __syncthreads();                 // ... for every thread's copies

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};   // log2 domain
  float l_run[2] = {0.f, 0.f};
  const bool capped = softcap > 0.f;
  walk.run(decode::smem_u32(q_s), scale * decode::kLog2e,
           capped ? scale / softcap : 0.f,
           capped ? softcap * decode::kLog2e : 0.f, acc, m_run, l_run);
  decode::finish_warps<D, __nv_bfloat16, T>(acc, m_run, l_run, ring, recv,
                                            out + row0 * D, sp, g);
}

// Page ids a block of the tensor-core route holds: the table's whole row,
// or for a longer one its share of the table's 16-token tiles and one more
// page where the share starts mid-page.
int pid_capacity(int page, int n_pages, int splits) {
  if (n_pages <= kWholeTable) return n_pages;
  const int tiles = (n_pages * page + decode::kTile - 1) / decode::kTile;
  const int per = (tiles + splits - 1) / splits;
  return (per * decode::kTile + page - 1) / page + 1;
}

template <int D, typename T>
size_t smem_mma(int warps, int stages, int page, int n_pages, int splits) {
  return decode::MmaLayout<D, T>::smem(warps, stages) +
         static_cast<size_t>(pid_capacity(page, n_pages, splits)) *
             sizeof(int);
}

template <int D, typename T>
cudaError_t set_smem_mma(size_t smem) {
  return cudaFuncSetAttribute(paged_attention_mma_kernel<D, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, typename T>
cudaError_t launch_mma(const void* q, const void* k_pages,
                       const void* v_pages, const void* k_scale,
                       const void* v_scale, const void* page_table,
                       const void* valid_len, void* out, float* part_ml,
                       float* part_acc, int* counter, int batch, int hq,
                       int hkv, int page, int n_pages, int warps, int stages,
                       int splits, int cluster, float scale, float softcap,
                       int window, cudaStream_t stream) {
  using L = decode::MmaLayout<D, T>;
  const int g = hq / hkv;
  if (decode::merge_scratch_bytes(splits, g) >
      L::smem(warps, stages) - L::kQBytes)
    return cudaErrorInvalidValue;
  const size_t smem = smem_mma<D, T>(warps, stages, page, n_pages, splits);
  const cudaError_t err = set_smem_mma<D, T>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * hkv, splits);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;   // the splits of a (sequence, kv head): a cluster
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, paged_attention_mma_kernel<D, T>,
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(valid_len), static_cast<__nv_bfloat16*>(out),
      part_ml, part_acc, counter, hq, hkv, page, n_pages, stages, scale,
      softcap, window, cluster);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

template <int D, typename T>
int occupancy_mma(int warps, int stages, int page, int n_pages, int splits) {
  const size_t smem = smem_mma<D, T>(warps, stages, page, n_pages, splits);
  if (set_smem_mma<D, T>(smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, paged_attention_mma_kernel<D, T>, warps * 32, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <typename QT, typename KVT>
__global__ void paged_attention_cc_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pages,
    const KVT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ valid_len, QT* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int* __restrict__ counter, int hq, int hkv, int d, int page, int n_pages,
    float scale, float softcap, int window, int tiles_per_split) {
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

  QT* ob = out + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;

  if (t_begin >= t_end) {  // nothing of this row in this split
    if (splits == 1) {
      for (int i = tid; i < g * d; i += blockDim.x) store(ob + i, 0.f);
      return;
    }
    if (tid < g) {
      part_ml[(part * g + tid) * 2] = kNegInf;
      part_ml[(part * g + tid) * 2 + 1] = 0.f;  // l = 0: acc never read
    }
    decode::merge_splits(part_ml, part_acc, counter, ob, bh, splits, g, d,
                         reinterpret_cast<float*>(smem));
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
      decode::copy16(reinterpret_cast<uint4*>(k_s + t * d) + o,
                   reinterpret_cast<const uint4*>(k_pages + src) + o);
      decode::copy16(reinterpret_cast<uint4*>(v_s + t * d) + o,
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
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < g) store(ob + static_cast<long>(h) * d + tid,
                         acc[h] / fmaxf(l_s[h], 1e-30f));
    }
    return;
  }
  if (tid < g) {   // m in the log2 domain, as the merge takes it
    part_ml[(part * g + tid) * 2] = m_s[tid] * decode::kLog2e;
    part_ml[(part * g + tid) * 2 + 1] = l_s[tid];
  }
  if (tid < d) {
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h)
      if (h < g) part_acc[(part * g + h) * d + tid] = acc[h];
  }
  decode::merge_splits(part_ml, part_acc, counter, ob, bh, splits, g, d,
                       reinterpret_cast<float*>(smem));
}

template <typename QT, typename KVT>
cudaError_t launch_cc(const void* q, const void* k_pages, const void* v_pages,
                      const void* k_scale, const void* v_scale,
                      const void* page_table, const void* valid_len,
                      void* out, float* part_ml, float* part_acc,
                      int* counter, int batch, int hq, int hkv, int d,
                      int page, int n_pages, float scale, float softcap,
                      int window, int splits, cudaStream_t stream) {
  if ((d * static_cast<int>(sizeof(KVT))) % 16 != 0 || d % 4 != 0)
    return cudaErrorInvalidValue;
  const int g = hq / hkv;
  int threads = ((d + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  size_t smem = static_cast<size_t>(g) * d * sizeof(float) +
                2 * static_cast<size_t>(kTile) * d * sizeof(KVT);
  if (splits > 1 && smem < decode::merge_scratch_bytes(splits, g))
    smem = decode::merge_scratch_bytes(splits, g);
  auto kernel = paged_attention_cc_kernel<QT, KVT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = (n_pages * page + kTile - 1) / kTile;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  kernel<<<dim3(batch * hkv, splits), threads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(valid_len), static_cast<QT*>(out), part_ml,
      part_acc, counter, hq, hkv, d, page, n_pages, scale, softcap, window,
      tiles_per_split);
  return cudaGetLastError();
}

bool bad_common(int batch, int hq, int hkv, int d, int page, int n_pages,
                int splits, const void* work, const void* counter,
                int cluster) {
  return batch <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxGroup ||
         d <= 0 || d > kMaxHeadDim || page <= 0 || n_pages <= 0 ||
         splits <= 0 || splits > kMaxSplits ||
         (splits > 1 && !cluster && (work == nullptr || counter == nullptr));
}

// the split partials in `work`: B Hkv splits g (m, l) pairs, then the
// accumulators
void partials(void* work, int batch, int hkv, int splits, int g,
              float** part_ml, float** part_acc) {
  *part_ml = static_cast<float*>(work);
  *part_acc = *part_ml == nullptr
                  ? nullptr
                  : *part_ml + static_cast<long>(batch) * hkv * splits * g * 2;
}

}  // namespace

// Both entry points launch once on `stream` and return cudaGetLastError()
// (0 = launched).  softcap <= 0 and window <= 0 mean "off".  The token walk
// of each (sequence, kv head) is split across `splits` blocks (1..64); with
// splits > 1, `work` holds B*Hkv*splits*(Hq/Hkv)*(D+2) floats and `counter`
// B*Hkv int32 arrival counters that are 0 before the launch and are 0 again
// after it.  Page rows must be 16-byte aligned: D*itemsize a multiple of 16.

// bfloat16 q on the tensor cores, pages of bfloat16 (kv_dtype 1) or int8
// with their float32 scale lanes (kv_dtype 2; k_scale and v_scale are null
// otherwise): D 64, 128 or 256; `warps` (1..8) warps a block, each with a
// ring of `stages` (2..8) tiles of 16 tokens; with `cluster` (2 to 8
// splits) the splits of a (sequence, kv head) launch as one thread-block
// cluster and merge through distributed shared memory (`work` and
// `counter` are then not used).
extern "C" int paged_attention_mma_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* valid_len, void* out, void* work, void* counter, int batch,
    int hq, int hkv, int d, int page, int n_pages, int warps, int stages,
    int splits, int cluster, float scale, float softcap, int window,
    int kv_dtype, void* stream) {
  if (bad_common(batch, hq, hkv, d, page, n_pages, splits, work, counter,
                 cluster) ||
      warps < 1 || warps > kMaxWarps || stages < kMinStages ||
      stages > kMaxStages ||
      (cluster && (splits < 2 || splits > decode::kMaxClusterSplits)) ||
      (kv_dtype != kBFloat16 && kv_dtype != kInt8) ||
      (kv_dtype == kInt8) != (k_scale != nullptr && v_scale != nullptr) ||
      (kv_dtype != kInt8 && (k_scale != nullptr || v_scale != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float *part_ml, *part_acc;
  partials(work, batch, hkv, splits, hq / hkv, &part_ml, &part_acc);
  int* cnt = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PA_ARGS                                                        \
  q, k_pages, v_pages, k_scale, v_scale, page_table, valid_len, out,        \
      part_ml, part_acc, cnt, batch, hq, hkv, page, n_pages, warps, stages, \
      splits, cluster, scale, softcap, window, s
#define REPRO_PA_D(D)                                                    \
  err = kv_dtype == kInt8                                                \
            ? launch_mma<D, int8_t>(REPRO_PA_ARGS)                       \
            : launch_mma<D, __nv_bfloat16>(REPRO_PA_ARGS)
  cudaError_t err;
  switch (d) {
    case 64:
      REPRO_PA_D(64);
      break;
    case 128:
      REPRO_PA_D(128);
      break;
    case 256:
      REPRO_PA_D(256);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef REPRO_PA_D
#undef REPRO_PA_ARGS
  return static_cast<int>(err);
}

// The CUDA cores: dtype codes 0 float32, 1 bfloat16, 2 int8; k_scale and
// v_scale are null unless kv_dtype is int8.
extern "C" int paged_attention_cc_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* valid_len, void* out, void* work, void* counter, int batch,
    int hq, int hkv, int d, int page, int n_pages, float scale, float softcap,
    int window, int splits, int q_dtype, int kv_dtype, void* stream) {
  if (bad_common(batch, hq, hkv, d, page, n_pages, splits, work, counter, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kInt8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float *part_ml, *part_acc;
  partials(work, batch, hkv, splits, hq / hkv, &part_ml, &part_acc);
  int* cnt = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PA_ARGS                                                        \
  q, k_pages, v_pages, k_scale, v_scale, page_table, valid_len, out,        \
      part_ml, part_acc, cnt, batch, hq, hkv, d, page, n_pages, scale,      \
      softcap, window, splits, s
  cudaError_t err;
  if (q_dtype == kFloat32 && kv_dtype == kFloat32)
    err = launch_cc<float, float>(REPRO_PA_ARGS);
  else if (q_dtype == kBFloat16 && kv_dtype == kBFloat16)
    err = launch_cc<__nv_bfloat16, __nv_bfloat16>(REPRO_PA_ARGS);
  else if (q_dtype == kFloat32 && kv_dtype == kInt8)
    err = launch_cc<float, int8_t>(REPRO_PA_ARGS);
  else if (q_dtype == kBFloat16 && kv_dtype == kInt8)
    err = launch_cc<__nv_bfloat16, int8_t>(REPRO_PA_ARGS);
  else
    err = cudaErrorInvalidValue;
#undef REPRO_PA_ARGS
  return static_cast<int>(err);
}

// Blocks of the tensor-core route resident on one SM (-1 on error), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; kv_dtype as above.
extern "C" int paged_attention_mma_occupancy(int d, int kv_dtype, int warps,
                                             int stages, int page,
                                             int n_pages, int splits) {
#define REPRO_PA_OCC(D)                                                       \
  return kv_dtype == kInt8                                                    \
             ? occupancy_mma<D, int8_t>(warps, stages, page, n_pages, splits) \
             : occupancy_mma<D, __nv_bfloat16>(warps, stages, page, n_pages,  \
                                               splits)
  switch (d) {
    case 64:
      REPRO_PA_OCC(64);
    case 128:
      REPRO_PA_OCC(128);
    case 256:
      REPRO_PA_OCC(256);
    default:
      return -1;
  }
#undef REPRO_PA_OCC
}
