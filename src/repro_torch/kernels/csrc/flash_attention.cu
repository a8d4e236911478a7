// Blockwise (flash) attention over a dense sequence for Hopper (sm_90a):
// bfloat16 on the tensor cores (mma.sync), float32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py:128 (`_flash_call` :82, body
// `_attn_kernel` :35).  Same function:
//
//   q    (B, Hq, Sq, D)     float32 or bfloat16; any b/h/s strides, unit D
//   k/v  (B, Hkv, Skv, D)   q's dtype                 stride, 16-byte rows
//   out  (B, Hq, Sq, D)     q's dtype
//
//   out = softmax(mask(softcap(scale * q k^T))) v
//
// Query head h reads kv head h / (Hq/Hkv).  float32 scores, running max,
// running sum and accumulator; the output is rounded once.  The mask keeps
// k_pos < Skv, plus q_pos >= k_pos when causal (aligned top-left, query i
// sees keys <= i, as the Pallas kernel's `q_pos = i`) and
// q_pos - k_pos < window when a window is set.  softcap > 0 applies
// c * tanh(s / c) to the scaled scores.  A masked key contributes exactly
// 0, so a row that sees no key is 0 (the Pallas kernel's value for such a
// row depends on its block padding; no model path has one).
//
// Bound: operations.  Causal prefill at phi4-mini's shape (S 512, D 128,
// 24/8 heads) does 2*Hq*S^2*D flops on (Hq + 2*Hkv + Hq)*S*D elements, some
// 340 flops a byte, above the card's ridge point for the tensor cores.
// Both routes give a block 64 query rows of one (b, h) and walk only the
// key tiles its rows can see: tiles wholly in the future or wholly outside
// the window are never loaded.  The wrapper routes by dtype, each route its
// own entry point, so a bfloat16 call never reaches the CUDA-core body.
//
// bfloat16 route (`flash_attention_bf16_launch`), FlashAttention-2 style:
// S = Q K^T is `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32` on the raw
// bfloat16 q; the float32 scores are then multiplied by the scale, as the
// reference scales q in float32 (rounding q * scale to bfloat16 would change
// the scores: scale = 128^-0.5 is not a power of two).  The online softmax
// runs on the accumulator fragments in float32 registers (row max and sum
// across the 4 lanes of a row by shuffles, 2^x by ex2.approx in the log2
// domain; the mask is evaluated only on tiles some key of which a row of the
// warp cannot see).  P V takes V's fragments by `ldmatrix.trans`.  P
// precision: the reference multiplies p in float32, and p rounded to
// bfloat16 errs by about 2^-9 |v| / sqrt(n) where the output is near 0, more
// than the one-rounding check against the float32 plain version allows.  So
// P is split into a bfloat16 high part and the bfloat16 of the remainder,
// and each goes through the P V product: about 16 bits of p, at twice the
// P V mma cost (1.5x the mma count of plain FA-2).
//
// Design of that route.  8 warps a block: warps w and w + 4 own the same
// 16 query rows and split each K/V tile between them (keys [0, kBc/2) and
// [kBc/2, kBc)), each with its own running max, sum and accumulator, merged
// through shared memory at the end, so the serial chain of products of the
// rows that see the most keys is half as long.  K/V tiles of 64 keys (32 at
// D 256, where the output accumulator alone is 128 registers a thread) go
// through a 3-stage ring of 16-byte cp.async copies, two tiles loading
// while the current one computes.  Every shared tile is swizzled (16-byte
// chunk c of row r at c ^ (r % 8)), so `ldmatrix` reads no bank twice.
// The query tile is read from shared memory once into registers below D
// 256 (at D 256 it is re-read through `ldmatrix` at every k-step: the
// registers are spent).  One block of 8 warps is resident on an SM, and blocks launch
// heaviest causal query tile first across every (b, h), so a long tile
// shares its SM with short ones rather than another long one.
//
// float32 route (`flash_attention_f32_launch`), on the CUDA cores, the
// heaviest causal tile of each (b, h) launched first: each query row
// belongs to D/32 neighbouring lanes; each lane keeps 32 of the
// row's columns of the scaled query and of the accumulator in registers, and
// owns every (D/32)-th 16-byte chunk of a row, so the lanes of a row read
// adjacent chunks and the rows of a warp read the same ones (broadcast, no
// bank conflict).  A block stages 64 K and V rows in shared memory with
// 16-byte cp.async copies, all in flight at once; then in steps of 16 keys
// the lanes of a row reduce their partial dot products with shuffles, and
// every lane applies the mask, the online softmax update and p * v to its
// columns.  Steps whose keys are masked for every row of a warp are skipped
// (warp-uniform, exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockKV = 64;       // K/V rows per shared-memory tile
constexpr int kSub = 16;           // keys per online-softmax step
constexpr int kColsPerLane = 32;   // columns of a query row per lane
constexpr float kNegInf = -1e30f;

// 16 bytes of T <-> floats
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// 16 bytes global -> shared without passing through registers
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

struct Strides {  // elements between neighbours along b, h and s
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D / kColsPerLane))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int sq, int skv, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, float softcap,
                       int causal, int window) {
  constexpr int kLanes = D / kColsPerLane;      // lanes per query row
  constexpr int kCE = Chunk<T>::kElems;          // elements per chunk
  constexpr int kRowChunks = D / kCE;
  constexpr int kNC = kColsPerLane / kCE;        // chunks per lane
  constexpr int kRowsPerWarp = 32 / kLanes;
  static_assert(kRowChunks == kLanes * kNC, "chunks split evenly");
  static_assert(32 % kLanes == 0, "a row's lanes share one warp");

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kBlockKV * D;

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest causal tile first
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int part = tid - row * kLanes;
  const int q_lo = qt * kBlockQ;
  const int q_pos = q_lo + row;
  const bool live = q_pos < sq;
  // the query rows of this lane's warp, for warp-uniform skips
  const int warp_q_lo = q_lo + (tid / 32) * kRowsPerWarp;
  const int warp_q_hi = warp_q_lo + kRowsPerWarp - 1;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  float qr[kColsPerLane];
  float acc[kColsPerLane];
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    float f[kCE];
    if (live) {
      Chunk<T>::load(q + b * qs.b + h * qs.h + q_pos * qs.s +
                         (part + kLanes * i) * kCE, f);
    } else {
#pragma unroll
      for (int e = 0; e < kCE; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kCE; ++e) {
      qr[i * kCE + e] = f[e] * scale;
      acc[i * kCE + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // key tiles any row of the block can see
  const int q_hi = min(q_lo + kBlockQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_begin / kBlockKV;
  const int t_end = (kv_end + kBlockKV - 1) / kBlockKV;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockKV;
    for (int c = tid; c < kBlockKV * kRowChunks; c += blockDim.x) {
      const int r = c / kRowChunks;
      const int o = c - r * kRowChunks;
      T* kd = k_s + r * D + o * kCE;
      T* vd = v_s + r * D + o * kCE;
      if (k0 + r < skv) {
        copy16_async(kd, kb + (k0 + r) * ks.s + o * kCE);
        copy16_async(vd, vb + (k0 + r) * vs.s + o * kCE);
      } else {  // past the sequence: zeros, so p = 0 never meets garbage
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    copy_async_wait_all();
    __syncthreads();

    for (int j0 = 0; j0 < kBlockKV; j0 += kSub) {
      const int kp0 = k0 + j0;
      if (kp0 >= skv) break;                                   // block-uniform
      if (causal && kp0 > warp_q_hi) continue;                 // warp-uniform
      if (window > 0 && warp_q_lo - (kp0 + kSub - 1) >= window) continue;

      float s[kSub];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const T* kr = k_s + (j0 + jj) * D;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kNC; ++i) {
          float f[kCE];
          Chunk<T>::load(kr + (part + kLanes * i) * kCE, f);
#pragma unroll
          for (int e = 0; e < kCE; ++e) dot = fmaf(qr[i * kCE + e], f[e], dot);
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[jj] = dot;
      }

      unsigned seen = 0u;
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int kp = kp0 + jj;
        const bool ok = kp < skv && (!causal || q_pos >= kp) &&
                        (window <= 0 || q_pos - kp < window);
        float x = s[jj];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[jj] = x;
        if (ok) {
          seen |= 1u << jj;
          mx = fmaxf(mx, x);
        }
      }
      const float alpha = expf(m - mx);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        s[jj] = (seen >> jj) & 1u ? expf(s[jj] - mx) : 0.f;   // s becomes p
        psum += s[jj];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const T* vr = v_s + (j0 + jj) * D;
#pragma unroll
        for (int i = 0; i < kNC; ++i) {
          float f[kCE];
          Chunk<T>::load(vr + (part + kLanes * i) * kCE, f);
#pragma unroll
          for (int e = 0; e < kCE; ++e)
            acc[i * kCE + e] = fmaf(s[jj], f[e], acc[i * kCE + e]);
        }
      }
      m = mx;
    }
    __syncthreads();   // the tile is read by every warp before it is replaced
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  T* ob = out + b * os.b + h * os.h + q_pos * os.s;
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    float f[kCE];
#pragma unroll
    for (int e = 0; e < kCE; ++e) f[e] = acc[i * kCE + e] / denom;
    Chunk<T>::store(ob + (part + kLanes * i) * kCE, f);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int batch, int hq, int hkv, int sq, int skv,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, float softcap, int causal, int window,
                       cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kBlockKV) * D * sizeof(float);
  auto kernel = flash_attention_kernel<float, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  kernel<<<grid, kBlockQ * (D / kColsPerLane), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, sq,
      skv, qs, ks, vs, os, scale, softcap, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// The block at head dim D: 64 query rows, 8 warps.  Warps w and w + 4 own
// the same 16 rows and split every K/V tile of kBc keys between them (the
// first and the second kHalf keys), so the serial chain of products of the
// rows that see the most keys is half as long; the two halves' running max,
// sum and accumulator merge through shared memory at the end.  kBc is 32 at
// D 256, where the 128 registers of the output accumulator leave too few
// for more.
template <int D>
struct MmaShape {
  static constexpr int kRows = 64;         // query rows a block
  static constexpr int kThreads = 256;
  static constexpr int kBc = D == 256 ? 32 : 64;
  static constexpr int kHalf = kBc / 2;    // keys of a tile for one warp
  static constexpr int kRowBytes = D * 2;
  static constexpr int kTileBytes = kBc * kRowBytes;
  static constexpr int kStages = 3;        // K/V tiles in the ring
  static constexpr size_t kSmem = static_cast<size_t>(kRows) * kRowBytes +
                                  2 * kStages * kTileBytes;
  // 16-byte chunks of a row; the rows one pass of the block's threads covers
  static constexpr int kChunks = D / 8;
  static constexpr int kRowsPerPass = kThreads / kChunks;
  // the merge: per row group, D/2 accumulator floats, 2 maxima and 2 sums
  // for each of 32 lanes
  static constexpr int kMergeFloats = D / 2 + 4;
  static_assert(4 * kMergeFloats * 32 * 4 <= kSmem, "merge fits");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d (16 x 8, float32) += a (16 x 16, row-major) * b (16 x 8, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x (ex2.approx: relative error about 2^-22; 2^-inf = +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// (x0, x1) -> bfloat16 pairs hi + lo with hi + lo = (x0, x1) to ~16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// byte offset of 16-byte chunk c of row r in a swizzled [rows][D] tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

template <int D>
__global__ void __launch_bounds__(MmaShape<D>::kThreads, 1)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int hq,
                               int hkv, int sq, int skv, Strides qs,
                               Strides ks, Strides vs, Strides os,
                               float scale, float softcap, int causal,
                               int window) {
  using S = MmaShape<D>;
  constexpr int kBc = S::kBc;
  constexpr int kHalf = S::kHalf;
  constexpr int kRows = S::kRows;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* q_s = smem;                                   // [kRows][D]
  uint8_t* k_s = smem + kRows * S::kRowBytes;       // [kStages][kBc][D]
  uint8_t* v_s = k_s + S::kStages * S::kTileBytes;  // [kStages][kBc][D]

  // the heaviest causal query tiles first, across every (b, h)
  const int nq = (sq + kRows - 1) / kRows;
  const int nbh = gridDim.x / nq;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = blockIdx.x % nbh;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rg = warp % 4;      // row group: rows 16 rg .. 16 rg + 15
  const int half = warp / 4;    // which kHalf keys of each tile
  const int q_lo = qt * kRows;

  // this thread's copies: chunk `col` of rows row0 + i * kRowsPerPass
  const int row0 = tid / S::kChunks;
  const int col = tid % S::kChunks;
  {
    const __nv_bfloat16* src = q + b * qs.b + h * qs.h +
                               (q_lo + row0) * qs.s + col * 8;
#pragma unroll
    for (int r = row0; r < kRows; r += S::kRowsPerPass) {
      uint8_t* dst = q_s + swz<D>(r, col);
      if (q_lo + r < sq)
        copy16_async(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      src += S::kRowsPerPass * qs.s;
    }
  }

  // key tiles any row of the block can see
  const int q_hi = min(q_lo + kRows, sq) - 1;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_begin / kBc;
  const int t_end = (kv_end + kBc - 1) / kBc;

  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h + row0 * ks.s + col * 8;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h + row0 * vs.s + col * 8;
  auto load_kv = [&](int t, int buf) {
    const int k0 = t * kBc;
    const __nv_bfloat16* ksrc = kb + k0 * ks.s;
    const __nv_bfloat16* vsrc = vb + k0 * vs.s;
    uint8_t* kt = k_s + buf * S::kTileBytes;
    uint8_t* vt = v_s + buf * S::kTileBytes;
#pragma unroll
    for (int r = row0; r < kBc; r += S::kRowsPerPass) {
      uint8_t* kd = kt + swz<D>(r, col);
      uint8_t* vd = vt + swz<D>(r, col);
      if (k0 + r < skv) {
        copy16_async(kd, ksrc);
        copy16_async(vd, vsrc);
      } else {  // past the sequence: zeros, so p = 0 never meets garbage
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
      }
      ksrc += S::kRowsPerPass * ks.s;
      vsrc += S::kRowsPerPass * vs.s;
    }
  };
  // the ring: tile t_begin + i in buffer i % kStages, kStages - 1 tiles
  // requested ahead; one commit group per tile (empty past the end)
#pragma unroll
  for (int i = 0; i < S::kStages - 1; ++i) {
    if (t_begin + i < t_end) load_kv(t_begin + i, i);
    cp_async_commit();
  }

  // this lane's accumulator rows: qp[0] = wq_lo + lane/4 and qp[1] 8 below;
  // in every 16 x 8 fragment, registers {0, 1} are row qp[0] at columns
  // 2*(lane%4) + {0, 1}, registers {2, 3} row qp[1] at the same columns
  const int wq_lo = q_lo + rg * 16;
  const int qp[2] = {wq_lo + lane / 4, wq_lo + lane / 4 + 8};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};   // running max, log2 domain
  float l_run[2] = {0.f, 0.f};           // this lane's part of the row sum
  const float neg_inf = __int_as_float(0xff800000);
  const float scale_log2 = scale * kLog2e;
  const float scale_cap = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_log2 = softcap * kLog2e;
  // ldmatrix row addresses: A fragments (q) take rows lane % 16 and chunk
  // lane / 16; K fragments rows (lane & 7) + 8 * (lane / 16), chunk
  // (lane / 8) % 2; V fragments (transposed) rows lane % 16, chunk lane / 16
  const uint32_t q_base = smem_u32(q_s);
  const int a_row = rg * 16 + (lane & 15);
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = (lane >> 3) & 1;
  const int v_row = lane & 15;
  const int v_col = lane >> 4;
  constexpr int kVGroup = D == 256 ? 4 : D / 16;   // V fragments in flight
  // below D 256 the warp's q fragments stay in registers (D / 4 of them),
  // read once, instead of being re-read from shared memory every tile
  constexpr bool kQInRegs = D <= 128;
  uint32_t qf[kQInRegs ? D / 16 : 1][4];

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    const int buf = i % S::kStages;
    if (t + S::kStages - 1 < t_end)
      load_kv(t + S::kStages - 1, (i + S::kStages - 1) % S::kStages);
    cp_async_commit();
    cp_async_wait<S::kStages - 1>();   // tile t has landed
    __syncthreads();
    if constexpr (kQInRegs) {
      if (t == t_begin) {
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd)
          ldmatrix_x4(qf[kd], q_base + swz<D>(a_row, 2 * kd + v_col));
      }
    }
    const int k0 = t * kBc + half * kHalf;    // this warp's first key
    const bool skip = wq_lo >= sq || k0 >= skv ||
                      (causal && k0 > wq_lo + 15) ||
                      (window > 0 && wq_lo - (k0 + kHalf - 1) >= window);
    if (!skip) {   // warp-uniform
      const uint32_t k_base =
          smem_u32(k_s + buf * S::kTileBytes + half * kHalf * S::kRowBytes);
      const uint32_t v_base =
          smem_u32(v_s + buf * S::kTileBytes + half * kHalf * S::kRowBytes);
      float s[kHalf / 8][4];
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        // a k-step's fragments are all requested before its products
        uint32_t a[4], kf[kHalf / 16][4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kd][i];
        } else {
          ldmatrix_x4(a, q_base + swz<D>(a_row, 2 * kd + v_col));
        }
#pragma unroll
        for (int p = 0; p < kHalf / 16; ++p)
          ldmatrix_x4(kf[p], k_base + swz<D>(16 * p + k_row, 2 * kd + k_col));
#pragma unroll
        for (int p = 0; p < kHalf / 16; ++p) {
          mma_bf16(s[2 * p], a, kf[p][0], kf[p][1]);
          mma_bf16(s[2 * p + 1], a, kf[p][2], kf[p][3]);
        }
      }

      // scale and softcap the scores into the log2 domain; the mask only
      // where some key of the tile is out of sight for some row of the
      // warp (a warp-uniform test)
      float mx[2] = {m_run[0], m_run[1]};
      auto scores = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float x = softcap > 0.f ? cap_log2 * tanhf(s[j][e] * scale_cap)
                                    : s[j][e] * scale_log2;
            if constexpr (decltype(masked)::value) {
              const int kp = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
              const bool ok = kp < skv && (!causal || qp[r] >= kp) &&
                              (window <= 0 || qp[r] - kp < window);
              x = ok ? x : neg_inf;
            }
            s[j][e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
      };
      const bool all_seen = k0 + kHalf <= skv &&
                            (!causal || k0 + kHalf - 1 <= wq_lo) &&
                            (window <= 0 || wq_lo + 15 - k0 < window);
      if (all_seen)
        scores(std::false_type{});
      else
        scores(std::true_type{});
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // s becomes p; masked: exactly 0
          s[j][e] = fast_exp2(s[j][e] - m_run[e >> 1]);
          l_run[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // acc += P V, P as bfloat16 hi + lo; V fragments by ldmatrix.trans,
      // kVGroup pairs of d-tiles requested before their products
#pragma unroll
      for (int kk = 0; kk < kHalf / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int g = 0; g < D / 16; g += kVGroup) {
          uint32_t vf[kVGroup][4];
#pragma unroll
          for (int i = 0; i < kVGroup; ++i)
            ldmatrix_x4_trans(vf[i], v_base + swz<D>(16 * kk + v_row,
                                                     2 * (g + i) + v_col));
#pragma unroll
          for (int i = 0; i < kVGroup; ++i) {
            const int dp = g + i;
            mma_bf16(acc[2 * dp], ph, vf[i][0], vf[i][1]);
            mma_bf16(acc[2 * dp + 1], ph, vf[i][2], vf[i][3]);
          }
#pragma unroll
          for (int i = 0; i < kVGroup; ++i) {
            const int dp = g + i;
            mma_bf16(acc[2 * dp], pl, vf[i][0], vf[i][1]);
            mma_bf16(acc[2 * dp + 1], pl, vf[i][2], vf[i][3]);
          }
        }
      }
    }
    __syncthreads();   // the tile is read by every warp before it is replaced
  }
  cp_async_wait<0>();
  __syncthreads();   // no copy in flight and no tile read: shared is free

  // merge the two halves of each row group: the second half hands its
  // running max, sum and accumulator to the first through shared memory
  float* merge = reinterpret_cast<float*>(smem) + rg * S::kMergeFloats * 32;
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) merge[(4 * j + e) * 32 + lane] = acc[j][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      merge[(D / 2 + r) * 32 + lane] = m_run[r];
      merge[(D / 2 + 2 + r) * 32 + lane] = l_run[r];
    }
  }
  __syncthreads();
  if (half == 1) return;
  float a_own[2], a_other[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_other = merge[(D / 2 + r) * 32 + lane];
    const float m = fmaxf(m_run[r], m_other);
    a_own[r] = fast_exp2(m_run[r] - m);
    a_other[r] = fast_exp2(m_other - m);
    l_run[r] = l_run[r] * a_own[r] +
               merge[(D / 2 + 2 + r) * 32 + lane] * a_other[r];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = acc[j][e] * a_own[e >> 1] +
                  merge[(4 * j + e) * 32 + lane] * a_other[e >> 1];

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qp[r] >= sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* ob = out + b * os.b + h * os.h + qp[r] * os.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t set_smem_bf16() {
  return cudaFuncSetAttribute(flash_attention_mma_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(MmaShape<D>::kSmem));
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int batch, int hq, int hkv, int sq,
                        int skv, Strides qs, Strides ks, Strides vs,
                        Strides os, float scale, float softcap, int causal,
                        int window, cudaStream_t stream) {
  const cudaError_t err = set_smem_bf16<D>();
  if (err != cudaSuccess) return err;
  using S = MmaShape<D>;
  const dim3 grid(((sq + S::kRows - 1) / S::kRows) * batch * hq);
  flash_attention_mma_kernel<D><<<grid, S::kThreads, S::kSmem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv, qs, ks, vs, os,
          scale, softcap, causal, window);
  return cudaGetLastError();
}

template <int D>
int occupancy_bf16() {
  if (set_smem_bf16<D>() != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_attention_mma_kernel<D>, MmaShape<D>::kThreads,
          MmaShape<D>::kSmem) != cudaSuccess)
    return -1;
  return blocks;
}

#define REPRO_FA_DISPATCH(fn, d, ...)   \
  switch (d) {                          \
    case 64:                            \
      return fn<64>(__VA_ARGS__);       \
    case 128:                           \
      return fn<128>(__VA_ARGS__);      \
    case 256:                           \
      return fn<256>(__VA_ARGS__);      \
    default:                            \
      return cudaErrorInvalidValue;     \
  }

cudaError_t launch(bool bf16, int d, const void* q, const void* k,
                   const void* v, void* out, int batch, int hq, int hkv,
                   int sq, int skv, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, float softcap, int causal,
                   int window, cudaStream_t stream) {
  if (bf16) {
    REPRO_FA_DISPATCH(launch_bf16, d, q, k, v, out, batch, hq, hkv, sq, skv,
                      qs, ks, vs, os, scale, softcap, causal, window, stream)
  }
  REPRO_FA_DISPATCH(launch_f32, d, q, k, v, out, batch, hq, hkv, sq, skv, qs,
                    ks, vs, os, scale, softcap, causal, window, stream)
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (0 =
// launched).  D is 64, 128 or 256.  Strides are in elements, (b, h, s) for
// each of q, k, v and out; the D stride is 1, and every row start must be
// 16-byte aligned.  softcap <= 0 and window <= 0 mean "off"; causal is 0 or
// 1.
#define REPRO_FA_ENTRY(name, bf16)                                            \
  extern "C" int name(                                                        \
      const void* q, const void* k, const void* v, void* out, int batch,      \
      int hq, int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,\
      long long q_ss, long long k_sb, long long k_sh, long long k_ss,         \
      long long v_sb, long long v_sh, long long v_ss, long long o_sb,         \
      long long o_sh, long long o_ss, float scale, float softcap, int causal, \
      int window, void* stream) {                                             \
    if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||      \
        skv < 0)                                                              \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    return static_cast<int>(launch(                                           \
        bf16, d, q, k, v, out, batch, hq, hkv, sq, skv,                       \
        Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},                 \
        Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss}, scale, softcap, \
        causal, window, static_cast<cudaStream_t>(stream)));                  \
  }

// float32 on the CUDA cores
REPRO_FA_ENTRY(flash_attention_f32_launch, false)
// bfloat16 on the tensor cores
REPRO_FA_ENTRY(flash_attention_bf16_launch, true)

#undef REPRO_FA_ENTRY
#undef REPRO_FA_DISPATCH

// Blocks of the bfloat16 route resident on one SM at head dim d (-1 on
// error), from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int flash_attention_bf16_occupancy(int d) {
  switch (d) {
    case 64:
      return occupancy_bf16<64>();
    case 128:
      return occupancy_bf16<128>();
    case 256:
      return occupancy_bf16<256>();
    default:
      return -1;
  }
}
