// Blockwise (flash) attention over a dense sequence for Hopper (sm_90a).
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
// This first kernel does its products on the CUDA cores in float32 (no
// wgmma yet), so it is bound by how fast it issues FMAs and shared-memory
// reads.  Design: one block per (b * Hq + h, 64-row query tile), the
// heaviest causal tiles launched first.  Each query row belongs to D/32
// neighbouring lanes; each lane keeps 32 of the row's columns of the scaled
// query and of the accumulator in registers, and owns every (D/32)-th
// 16-byte chunk of a row, so the lanes of a row read adjacent chunks and
// the rows of a warp read the same ones (broadcast, no bank conflict).  A
// block walks the key tiles its rows can see (tiles wholly in the future
// or wholly outside the window are never loaded): 64 K and V rows staged
// in shared memory with 16-byte cp.async copies, all in flight at once;
// then in steps of 16 keys the lanes of a row reduce their partial dot
// products with shuffles, and every lane applies the mask, the online
// softmax update and p * v to its columns.  Steps whose keys are masked
// for every row of a warp are skipped (warp-uniform, exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockKV = 64;       // K/V rows per shared-memory tile
constexpr int kSub = 16;           // keys per online-softmax step
constexpr int kColsPerLane = 32;   // columns of a query row per lane
constexpr float kNegInf = -1e30f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

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

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&f)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i in the low half (little end)
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// 16 bytes global -> shared without passing through registers
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int hq, int hkv, int sq, int skv, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   float softcap, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kBlockKV) * D * sizeof(T);
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  kernel<<<grid, kBlockQ * (D / kColsPerLane), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, qs,
      ks, vs, os, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* out, int batch, int hq, int hkv, int sq, int skv,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     float scale, float softcap, int causal, int window,
                     cudaStream_t stream) {
#define REPRO_FA_ARGS                                                    \
  q, k, v, out, batch, hq, hkv, sq, skv, qs, ks, vs, os, scale, softcap, \
      causal, window, stream
  switch (d) {
    case 64:
      return launch<T, 64>(REPRO_FA_ARGS);
    case 128:
      return launch<T, 128>(REPRO_FA_ARGS);
    case 256:
      return launch<T, 256>(REPRO_FA_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_ARGS
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// dtype codes: 0 float32, 1 bfloat16.  D is 64, 128 or 256.  Strides are
// in elements, (b, h, s) for each of q, k, v and out; the D stride is 1,
// and every row start must be 16-byte aligned.  softcap <= 0 and
// window <= 0 mean "off"; causal is 0 or 1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int batch, int hq,
    int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, float softcap, int causal,
    int window, int dtype, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch_d<float>(d, q, k, v, out, batch, hq, hkv, sq, skv, qs, ks,
                          vs, os, scale, softcap, causal, window, s);
  else if (dtype == kBFloat16)
    err = launch_d<__nv_bfloat16>(d, q, k, v, out, batch, hq, hkv, sq, skv,
                                  qs, ks, vs, os, scale, softcap, causal,
                                  window, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
