// Flash-decode attention over a contiguous KV cache, for Hopper (sm_90a):
// bfloat16 on the tensor cores (mma.sync), float32 on the CUDA cores.
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
// Bound: bytes. A decode step reads every live K/V row once and does 4 g flops
// per element of K or V (g = Hq/Hkv query rows share each row), far below the
// card's ridge point. What held the first port back was not the bytes: three
// block barriers and a serial softmax step per tile of the plan's 8 rows,
// scalar 2-byte shared reads and g FMAs per element on the CUDA cores, and a
// second launch to merge the splits.
//
// bfloat16 route (`decode_attention_bf16_launch`; D 64, 128, 256), the
// device code in decode_core.cuh: a block per (sequence, kv head, split);
// each of its warps walks its own contiguous slice of the block's live
// tokens in tiles of 16 through a ring of `stages` tiles of its own, with
// no block barrier per tile; S = q K^T and P V are mma.sync.m16n8k16 with
// the g query rows as M (P in two bfloat16 parts, so the output stays
// within one bfloat16 rounding of the float32 reference); the warps merge
// once through shared memory, and the splits merge in the same launch:
// 2 to 8 splits as one thread-block cluster through distributed shared
// memory, more through global partials and an arrival counter the wrapper
// keeps per device (reset by the merging block).  The wrapper maps the
// tune plan's tile and depth onto warps, stages and splits (`kernel_config`
// in decode_attention.py): 4 warps, a ring that keeps the plan's rows in
// flight, one block per SM in all.  At B 8, T 1024 (33.7 MB at phi4-mini's
// 24/8 heads) the kernel reads about 1.8 TB/s, 1.9x its bound.
//
// float32 route (`decode_attention_f32_launch`), on the CUDA cores, kept from
// the first port apart from the merge: `rows` (the plan's bkv) is the tile a
// block stages in shared memory with 16-byte cp.async copies, `stages` (the
// plan's pipeline_depth, capped by shared memory) the tiles in flight. Per
// tile: (1) each warp scores its tokens against all g rows (lanes split D, a
// warp reduction per row), (2) one warp per row updates the running max and
// sum, (3) each thread owns one of the D output columns and accumulates p*v
// for all g rows in registers. The splits merge in the launch as above.
//
// Tried for the bfloat16 route and not kept (timed on an H100 by a
// development sweep; PERF.md's findings on K1 and K3): 2 and 8 warps a block, 1 and 4 stages, more than one block per SM (the
// merge costs more than a second resident block gains), and the counter merge
// where a cluster can hold the splits.
#include "decode_core.cuh"

namespace {

using decode::kMaxGroup;
using decode::kMaxSplits;
using decode::kMaxStages;
using decode::kMaxWarps;
using decode::kMinStages;
using decode::kNegInf;
using decode::kTile;

constexpr int kMaxRingStages = 32;   // float32 route: tiles in flight

enum DType { kFloat32 = 0, kBFloat16 = 1 };

// ---------------------------------------------------------------------------
// bfloat16 route: the tensor cores
// ---------------------------------------------------------------------------

struct ContigRows {
  const __nv_bfloat16* k;   // this (sequence, kv head)'s first row
  const __nv_bfloat16* v;
  long long stride;         // elements from one token to the next: Hkv D
  int valid;
  __device__ __forceinline__ long long offset(int t) const {
    return t < valid ? t * stride : -1;
  }
};

template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    decode_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const int* __restrict__ valid_len,
                                __nv_bfloat16* __restrict__ out,
                                float* __restrict__ part_ml,
                                float* __restrict__ part_acc,
                                int* __restrict__ counter, int hq, int hkv,
                                int t_len, int stages, float scale,
                                float softcap, int cluster) {
  if (cluster) decode::cluster_arrive();   // this block is running
  using L = decode::MmaLayout<D>;
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
  const decode::Split sp{part_ml, part_acc, counter, bh, split, splits,
                         cluster != 0};
  const decode::Recv recv(smem + L::recv(warps, stages), L::kRecvAccBytes,
                          splits, D);

  // the query rows in flight first (commit group 0), then the live range
  decode::load_q<D>(q + row0 * D, g, q_s);
  decode::copy_commit();
  const int valid = min(max(valid_len[b], 0), t_len);
  const int tiles = (valid + kTile - 1) / kTile;
  const int per = (tiles + splits - 1) / splits;
  const int tb = min(tiles, split * per);
  const int te = min(tiles, tb + per);
  if (tb >= te) {   // no live token of this row in this split
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

  // this warp's contiguous slice of the block's tiles
  const int wper = (te - tb + warps - 1) / warps;
  const int wt0 = min(te, tb + warp * wper);
  const int wt1 = min(te, wt0 + wper);
  const long long first = static_cast<long long>(b) * t_len * hkv + kvh;
  const ContigRows src{k + first * D, v + first * D,
                       static_cast<long long>(hkv) * D, valid};
  decode::WarpWalk<D, ContigRows> walk(
      src, ring + static_cast<long>(warp) * stages * L::kStageBytes,
      live_s[warp], stages, wt0 * kTile, min(wt1 * kTile, valid));
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
  decode::finish_warps<D>(acc, m_run, l_run, ring, recv, out + row0 * D, sp,
                          g);
}

template <int D>
cudaError_t set_smem_bf16(size_t smem) {
  return cudaFuncSetAttribute(decode_attention_mma_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* valid_len, void* out, float* part_ml,
                        float* part_acc, int* counter, int batch, int hq,
                        int hkv, int t_len, int warps, int stages,
                        int splits, int cluster, float scale, float softcap,
                        cudaStream_t stream) {
  const int g = hq / hkv;
  const size_t smem = decode::MmaLayout<D>::smem(warps, stages);
  if (decode::merge_scratch_bytes(splits, g) >
      smem - decode::MmaLayout<D>::kQBytes)
    return cudaErrorInvalidValue;
  const cudaError_t err = set_smem_bf16<D>(smem);
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
      &cfg, decode_attention_mma_kernel<D>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(valid_len), static_cast<__nv_bfloat16*>(out),
      part_ml, part_acc, counter, hq, hkv, t_len, stages, scale, softcap,
      cluster);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

template <int D>
int occupancy_bf16(int warps, int stages) {
  const size_t smem = decode::MmaLayout<D>::smem(warps, stages);
  if (set_smem_bf16<D>(smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, decode_attention_mma_kernel<D>, warps * 32, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// ---------------------------------------------------------------------------
// float32 route: the CUDA cores
// ---------------------------------------------------------------------------

__global__ void decode_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ valid_len,
    float* __restrict__ out, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int* __restrict__ counter, int hq,
    int hkv, int t_len, int d, int rows, int stages, float scale,
    float softcap) {
  // dynamic: q_s [g][d] f32 scaled query rows | s_s [g][rows] f32 scores,
  // then probabilities (padded to 16 bytes) | ring of `stages` tiles, each
  // [rows][d] of K then [rows][d] of V; the split merge's scratch after
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
  float* ob = out + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;

  if (nt <= 0) {  // nothing of this row in this split
    if (splits == 1) {
      for (int i = tid; i < g * d; i += blockDim.x) ob[i] = 0.f;
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
  float* s_s = q_s + g * d;
  float* ring = reinterpret_cast<float*>(
      smem + static_cast<size_t>(g) * d * 4 +
      ((static_cast<size_t>(g) * rows * 4 + 15) / 16) * 16);
  const long tile_elems = static_cast<long>(rows) * d;

  const float* qb = q + (static_cast<long>(b) * hq + static_cast<long>(kvh) * g) * d;
  for (int i = tid; i < g * d; i += blockDim.x) q_s[i] = qb[i] * scale;
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) acc[h] = 0.f;

  const int chunks = d / 4;                                  // per row
  const long row_stride = static_cast<long>(hkv) * d;        // token to token
  const float* kb = k + (static_cast<long>(b) * t_len * hkv + kvh) * d;
  const float* vb = v + (static_cast<long>(b) * t_len * hkv + kvh) * d;

  // issue the copies of local tile i into its stage of the ring
  auto load_tile = [&](int i) {
    const int t0 = (tile_begin + i) * rows;
    const int n_rows = min(rows, valid - t0);
    float* ks = ring + static_cast<long>(i % stages) * 2 * tile_elems;
    float* vs = ks + tile_elems;
    for (int c = tid; c < n_rows * chunks; c += blockDim.x) {
      const int t = c / chunks;
      const int o = (c - t * chunks) * 4;
      const long src = (t0 + t) * row_stride + o;
      decode::copy16(ks + static_cast<long>(t) * d + o, kb + src);
      decode::copy16(vs + static_cast<long>(t) * d + o, vb + src);
    }
  };

  // prologue: the first stages - 1 tiles in flight, one copy group each
  for (int p = 0; p < stages - 1; ++p) {
    if (p < nt) load_tile(p);
    decode::copy_commit();
  }

  for (int i = 0; i < nt; ++i) {
    // refill the stage tile i - 1 used; every thread commits one group per
    // step (maybe empty), so waiting for all but the newest stages - 1
    // groups waits for tile i
    if (i + stages - 1 < nt) load_tile(i + stages - 1);
    decode::copy_commit();
    decode::copy_wait(stages - 1);
    __syncthreads();

    const int n_rows = min(rows, valid - (tile_begin + i) * rows);
    const float* ks = ring + static_cast<long>(i % stages) * 2 * tile_elems;
    const float* vs = ks + tile_elems;

    // (1) scores: warp w takes tokens w, w + nwarps, ... of the tile
    for (int t = warp; t < n_rows; t += nwarps) {
      const float* krow = ks + static_cast<long>(t) * d;
      float dot[kMaxGroup];
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) dot[h] = 0.f;
      for (int dd = lane; dd < d; dd += 32) {
        const float kv = krow[dd];
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
        const float vv = vs[static_cast<long>(t) * d + tid];
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) acc[h] += s_s[h * rows + t] * vv;
      }
    }
    __syncthreads();   // the stage is refilled at the next step
  }

  if (splits == 1) {
    if (tid < d) {
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < g) ob[static_cast<long>(h) * d + tid] =
            acc[h] / fmaxf(l_s[h], 1e-30f);
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

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* valid_len, void* out, float* part_ml,
                       float* part_acc, int* counter, int batch, int hq,
                       int hkv, int t_len, int d, int rows, int stages,
                       int splits, float scale, float softcap,
                       cudaStream_t stream) {
  if (d % 4 != 0) return cudaErrorInvalidValue;
  const int g = hq / hkv;
  int threads = ((d + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  size_t smem = static_cast<size_t>(g) * d * 4 +
                ((static_cast<size_t>(g) * rows * 4 + 15) / 16) * 16 +
                static_cast<size_t>(stages) * 2 * rows * d * sizeof(float);
  if (splits > 1 && smem < decode::merge_scratch_bytes(splits, g))
    smem = decode::merge_scratch_bytes(splits, g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_f32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_attention_f32_kernel<<<dim3(batch * hkv, splits), threads, smem,
                                stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(valid_len),
      static_cast<float*>(out), part_ml, part_acc, counter, hq, hkv, t_len,
      d, rows, stages, scale, softcap);
  return cudaGetLastError();
}

bool bad_common(int batch, int hq, int hkv, int t_len, int splits,
                const void* work, const void* counter, int cluster) {
  return batch <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxGroup ||
         t_len <= 0 || splits <= 0 || splits > kMaxSplits ||
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
// (0 = launched).  softcap <= 0 means "off".  The token walk of each
// (sequence, kv head) is split across `splits` blocks (1..64); with
// splits > 1, `work` holds B*Hkv*splits*(Hq/Hkv)*(D+2) floats and
// `counter` B*Hkv int32 arrival counters that are 0 before the launch and
// are 0 again after it.  K/V rows must be 16-byte aligned.

// bfloat16 on the tensor cores: D 64, 128 or 256; `warps` (1..8) warps a
// block, each with a ring of `stages` (1..8) tiles of 16 tokens; with
// `cluster` (2 to 8 splits) the splits of a (sequence, kv head) launch as
// one thread-block cluster and merge through distributed shared memory
// (`work` and `counter` are then not used).
extern "C" int decode_attention_bf16_launch(
    const void* q, const void* k, const void* v, const void* valid_len,
    void* out, void* work, void* counter, int batch, int hq, int hkv,
    int t_len, int d, int warps, int stages, int splits, int cluster,
    float scale, float softcap, void* stream) {
  if (bad_common(batch, hq, hkv, t_len, splits, work, counter, cluster) ||
      warps < 1 || warps > kMaxWarps || stages < kMinStages ||
      stages > kMaxStages ||
      (cluster && (splits < 2 || splits > decode::kMaxClusterSplits)))
    return static_cast<int>(cudaErrorInvalidValue);
  float *part_ml, *part_acc;
  partials(work, batch, hkv, splits, hq / hkv, &part_ml, &part_acc);
  int* cnt = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DA_ARGS                                                       \
  q, k, v, valid_len, out, part_ml, part_acc, cnt, batch, hq, hkv, t_len,  \
      warps, stages, splits, cluster, scale, softcap, s
  cudaError_t err;
  switch (d) {
    case 64:
      err = launch_bf16<64>(REPRO_DA_ARGS);
      break;
    case 128:
      err = launch_bf16<128>(REPRO_DA_ARGS);
      break;
    case 256:
      err = launch_bf16<256>(REPRO_DA_ARGS);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef REPRO_DA_ARGS
  return static_cast<int>(err);
}

// float32 on the CUDA cores: `rows` K/V rows per tile, `stages` tiles in
// flight (1..32); D a multiple of 4, at most 1024.
extern "C" int decode_attention_f32_launch(
    const void* q, const void* k, const void* v, const void* valid_len,
    void* out, void* work, void* counter, int batch, int hq, int hkv,
    int t_len, int d, int rows, int stages, int splits, float scale,
    float softcap, void* stream) {
  if (bad_common(batch, hq, hkv, t_len, splits, work, counter, 0) || d <= 0 ||
      d > 1024 || rows <= 0 || stages <= 0 || stages > kMaxRingStages)
    return static_cast<int>(cudaErrorInvalidValue);
  float *part_ml, *part_acc;
  partials(work, batch, hkv, splits, hq / hkv, &part_ml, &part_acc);
  return static_cast<int>(launch_f32(
      q, k, v, valid_len, out, part_ml, part_acc, static_cast<int*>(counter),
      batch, hq, hkv, t_len, d, rows, stages, splits, scale, softcap,
      static_cast<cudaStream_t>(stream)));
}

// Blocks of the bfloat16 route resident on one SM at head dim d with
// `warps` warps and `stages` stages (-1 on error), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int decode_attention_bf16_occupancy(int d, int warps, int stages) {
  switch (d) {
    case 64:
      return occupancy_bf16<64>(warps, stages);
    case 128:
      return occupancy_bf16<128>(warps, stages);
    case 256:
      return occupancy_bf16<256>(warps, stages);
    default:
      return -1;
  }
}
