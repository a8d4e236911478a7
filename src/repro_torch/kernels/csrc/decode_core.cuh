// Device code shared by the two decode kernels, K1 (paged_attention.cu) and
// K3 (decode_attention.cu): one query token per sequence attends over its
// cache, the g = Hq/Hkv query rows of a kv head sharing every K/V row.
//
// What is here:
//   - the 16-byte cp.async ring helpers, mma.sync / ldmatrix wrappers and
//     the swizzled shared layout (as flash_attention.cu uses them);
//   - `WarpWalk`, the tensor-core body (bfloat16 q; bfloat16 K/V, or int8
//     K/V with per-token float32 scales, K1 only): one warp walks its own
//     contiguous slice of tokens in tiles of kTile = 16, through a ring of
//     `stages` tiles of its own (no block barrier per tile: the only
//     per-tile synchronisation is the ring's cp.async wait and __syncwarp).
//     S = q K^T is mma.sync.m16n8k16 with the g query rows as M (zero-
//     padded to 16); the scale multiplies the float32 scores; the online
//     softmax runs on the accumulator fragments in the log2 domain; P V
//     takes P as bfloat16 high and low parts (about 16 bits of p), so the
//     output stays within one bfloat16 rounding of the float32 reference.
//     A token that is not live (past valid_len, masked by a ring window) is
//     never read: its copy zero-fills the shared row and its score is -inf,
//     so it adds exactly 0;
//   - `finish_warps`: the warps of a block merge their running max, sum and
//     accumulator once, at the end, through shared memory (rows padded so
//     the fragment stores hit every bank once; every warp's loads in
//     flight together);
//   - the split-KV merge inside the same launch, two ways.  When the 2 to
//     8 splits of a (sequence, kv head) are one thread-block cluster, each
//     block owns a slice of the output's columns and pushes each slice of
//     its partial (m, l, acc) into the owner's shared memory (`Recv`,
//     distributed shared memory stores); after one cluster barrier every
//     block merges its own slice locally: no global partial, fence, atomic
//     or remote load.  Otherwise (more splits, and the CUDA-core routes)
//     `merge_splits`: every block writes its partial to global memory, then
//     takes a ticket from an arrival counter (atomicAdd after
//     __threadfence); the last to arrive merges all splits and resets the
//     counter to 0, so the buffer is zeroed once, when it is allocated, and
//     no launch clears it.  Partials keep m in the log2 domain.
//
// What a launch costs besides its bytes, measured on an H100 at 700 W by
// chip_smoke.py's `[K1 time]` (PERF.md's K1/K3 findings): at K1's main
// shape a third of the bytes (the serve drain's lengths, 0.0099 ms) takes
// four fifths of the time of all of them (0.0122 ms).  A development
// build that stamped each block's phases with %globaltimer put much of the
// rest after the last product: a first cluster merge that pulled the
// partials (two cluster barriers and rounds of remote loads) and a block
// combine bound by shared-memory latency.  Pushing the slices and
// unrolling the combine over warps made K1 faster.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr int kMaxGroup = 16;     // query heads per kv head (the mma's M)
constexpr int kTile = 16;         // tokens of a warp tile: P V's k
constexpr int kMaxWarps = 8;
constexpr int kMinStages = 2;     // a warp's ring: at least double-buffered
constexpr int kAccPad = 8;        // floats that pad a row of the warps' merge
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 64;    // blocks sharing one (sequence, kv head)
constexpr int kMergeBatch = 8;    // counter merge: split partials a thread
constexpr int kMergeItems = 2;    // loads at once, for this many columns
constexpr int kMaxClusterSplits = 8;   // splits one cluster can hold (portable)

// How a block's result reaches the output when a (sequence, kv head)'s
// walk is split: through global partials and an arrival counter, or, when
// the splits form one thread-block cluster, through distributed shared
// memory.
struct Split {
  float* part_ml;
  float* part_acc;
  int* counter;
  int bh, split, splits;
  bool cluster;
};

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; with
// live == false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void copy16_zfill(void* dst, const void* src,
                                             bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` of this thread's newest copy groups are in
// flight (the instruction takes an immediate)
__device__ __forceinline__ void copy_wait(int pending) {
  switch (pending) {
#define REPRO_WAIT(n)                                             \
  case n:                                                         \
    asm volatile("cp.async.wait_group " #n ";\n" ::: "memory");   \
    break;
    REPRO_WAIT(1) REPRO_WAIT(2) REPRO_WAIT(3) REPRO_WAIT(4) REPRO_WAIT(5)
    REPRO_WAIT(6) REPRO_WAIT(7) REPRO_WAIT(8) REPRO_WAIT(9) REPRO_WAIT(10)
    REPRO_WAIT(11) REPRO_WAIT(12) REPRO_WAIT(13) REPRO_WAIT(14)
    REPRO_WAIT(15) REPRO_WAIT(16) REPRO_WAIT(17) REPRO_WAIT(18)
    REPRO_WAIT(19) REPRO_WAIT(20) REPRO_WAIT(21) REPRO_WAIT(22)
    REPRO_WAIT(23) REPRO_WAIT(24) REPRO_WAIT(25) REPRO_WAIT(26)
    REPRO_WAIT(27) REPRO_WAIT(28) REPRO_WAIT(29) REPRO_WAIT(30)
    REPRO_WAIT(31)
#undef REPRO_WAIT
    default:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
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
// byte offset of 16-byte chunk c of row r in a swizzled [rows][D] bfloat16
// tile (D >= 64, so a row has at least 8 chunks): ldmatrix reads no bank
// twice
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---- int8 pages -----------------------------------------------------------
// byte offset of 16-byte chunk c of row r in a [16][D] int8 tile.  The
// products read it with plain shared loads: K as 16-byte chunks of token
// rows t and t + 1 at once, V as 4-byte words of rows 2c, 2c + 1, 2c + 8 and
// 2c + 9 (c = lane % 4).  Flipping chunk bit 2 between odd and even rows and
// bits 1-2 by (r / 2) % 4 spreads both over the banks from D 128 up (at D 64
// the V reads conflict two ways).
template <int D>
__device__ __forceinline__ uint32_t swz8(int r, int c) {
  constexpr int kMask = D / 16 - 1;
  return r * D + ((c ^ (((r & 6) ^ ((r & 1) << 2)) & kMask)) << 4);
}
// 4 bytes global -> shared (cp.async.cg takes 16 bytes only); with
// live == false nothing is read and the 4 bytes are zero-filled
__device__ __forceinline__ void copy4_zfill(void* dst, const void* src,
                                            bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(addr)
               : "memory");
  return r;
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t r;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(r) : "r"(addr) : "memory");
  return r;
}
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 r;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(r.x), "=f"(r.y)
               : "r"(addr)
               : "memory");
  return r;
}
// Two int8 values at bits 0-7 and 16-23 of w (the other bits are ignored)
// -> the bfloat16 pair (low, high), exactly: with m = x & 127 and s the
// sign bit, x = m - 128 s, and 128 + m (0x4300 | m) and 128 + 128 s
// (0x4300 | s << 7) are bfloat16 numbers whose difference is x
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w) {
  const uint32_t a = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Shared memory of the tensor-core body at head dim D with pages of T
// (bfloat16, or int8 with float32 scales): the 16 bfloat16 query rows
// (swizzled), then each warp's ring of `stages` tiles, K then V (and for
// int8 the tile's 16 k_scale and 16 v_scale floats), then the cluster
// merge's receive buffers (other blocks write them while this one may
// still walk, so they have bytes of their own).  After the walk the ring
// holds the warps' merge (16 rows of D + kAccPad floats a warp) and then
// the counter merge's weights.  A bfloat16 ring of kMinStages already holds
// a warp's merge rows; an int8 stage is half as large, so a warp's region
// is the larger of its stages and its merge rows.
template <int D, typename T = __nv_bfloat16>
struct MmaLayout {
  static constexpr bool kInt8 = sizeof(T) == 1;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kTileBytes = kTile * kRowBytes;   // K or V
  static constexpr int kScaleBytes = kInt8 ? 2 * kTile * 4 : 0;
  static constexpr int kStageBytes = 2 * kTileBytes + kScaleBytes;
  static constexpr int kQBytes = 16 * D * 2;
  static constexpr int kMergeBytes = 16 * (D + kAccPad) * 4;
  // a slice of every split's accumulator, [splits][g][ceil(D/4 / splits)]
  // float4, then every split's (m, l) per row, [splits][g] float2
  static constexpr int kRecvAccBytes =
      kMaxGroup * (D / 4 + kMaxClusterSplits) * 16;
  static constexpr int kRecvBytes =
      kRecvAccBytes + kMaxClusterSplits * kMaxGroup * 8;
  __host__ __device__ static constexpr size_t warp_ring(int stages) {
    return static_cast<size_t>(stages) * kStageBytes > kMergeBytes
               ? static_cast<size_t>(stages) * kStageBytes
               : kMergeBytes;
  }
  static_assert(kInt8 || kMergeBytes <= kStageBytes * kMinStages,
                "a bfloat16 warp's merge rows fit its ring");
  static_assert(!kInt8 || (warp_ring(kMinStages) >= kMergeBytes &&
                           kQBytes + kMaxWarps * warp_ring(kMinStages) +
                                   kRecvBytes <= 227 * 1024),
                "an int8 warp's region holds its merge rows, and the "
                "smallest ring of the most warps fits a block");
  __host__ __device__ static constexpr size_t recv(int warps, int stages) {
    return kQBytes + static_cast<size_t>(warps) * warp_ring(stages);
  }
  __host__ __device__ static constexpr size_t smem(int warps, int stages) {
    return recv(warps, stages) + kRecvBytes;
  }
};

// Issues this thread's 16-byte copies of the g query rows into the
// swizzled q tile (rows g..15 zero); one commit group, not committed here.
template <int D>
__device__ __forceinline__ void load_q(const __nv_bfloat16* q_rows, int g,
                                       uint8_t* q_s) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < 16 * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    copy16_zfill(q_s + swz<D>(r, c), q_rows + (r < g ? r * D + c * 8 : 0),
                 r < g);
  }
}

// One warp's walk of tokens [t_lo, t_hi) (t_lo a multiple of kTile) for the
// tensor-core body.  Src supplies the K/V bases and `offset(idx)`: the
// element offset of token idx's row from those bases, or -1 if the token is
// not live.
//
// Pages of int8 (T = int8_t; Src then also supplies `row(idx)`, the row of
// the (P, page) scale lanes `ks`/`vs`, with offset = row * row_elems): the
// stage holds the int8 rows and the tile's scales, landed by the same
// commit group.  The products build their bfloat16 fragments in registers
// from 32-bit and 128-bit shared loads (int8 -> bfloat16 is exact, two
// values at a time: i8x2_bf16), so no bfloat16 copy of the tile is written.
// S's k-steps take the head dims in another order than ldmatrix would
// (k-step 4w + s, lane column group c: dims 64w + 16c + 4s + {0,2} in the
// fragment's first pair, + {1,3} in its second), and q's fragments follow
// that order; P V's n-blocks take the columns in another order too (n-block
// 4u + i, lane row n: column 32u + 4n + i), which finish_warps undoes.
// Scales stay outside the products: S's columns are multiplied by k_scale
// before the softmax scale, and p by v_scale before its bfloat16 split (the
// running sum takes the unscaled p), which is the reference's k * k_scale
// and v * v_scale in float32 up to the order of the sums.
template <int D, class Src, typename T = __nv_bfloat16>
struct WarpWalk {
  using L = MmaLayout<D, T>;
  static constexpr bool kInt8 = L::kInt8;
  static constexpr int kChunks = L::kRowBytes / 16;   // 16-byte chunks a row
  static constexpr int kRowsPerPass = 32 / kChunks;
  static constexpr int kPasses = kTile / kRowsPerPass;

  const Src& src;
  uint8_t* ring;          // this warp's stages
  uint32_t* live;         // this warp's live-token mask per stage
  int stages;
  int t_lo, t_hi, nt;
  int lane;

  __device__ WarpWalk(const Src& s, uint8_t* ring_, uint32_t* live_,
                      int stages_, int lo, int hi)
      : src(s), ring(ring_), live(live_), stages(stages_), t_lo(lo),
        t_hi(hi), nt(hi > lo ? (hi - lo + kTile - 1) / kTile : 0),
        lane(threadIdx.x & 31) {}

  // copies of local tile i into its stage: lanes 0..15 find their token's
  // row, every lane copies one 16-byte chunk of kRowsPerPass rows a pass
  __device__ __forceinline__ void issue(int i) {
    const int t0 = t_lo + i * kTile;
    const int stage = i % stages;
    uint8_t* kst = ring + stage * L::kStageBytes;
    uint8_t* vst = kst + L::kTileBytes;
    long long off = -1;
    if constexpr (kInt8) {
      // lane l copies token (l % 16)'s k_scale (l < 16) or v_scale
      long long row = -1;
      if (lane < kTile && t0 + lane < t_hi) row = src.row(t0 + lane);
      if (row >= 0) off = row * src.row_elems;
      const long long r = __shfl_sync(0xffffffffu, row, lane & (kTile - 1));
      copy4_zfill(vst + L::kTileBytes + lane * 4,
                  (lane < kTile ? src.ks : src.vs) + (r >= 0 ? r : 0),
                  r >= 0);
    } else {
      if (lane < kTile && t0 + lane < t_hi) off = src.offset(t0 + lane);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, off >= 0);
    if (lane == 0) live[stage] = mask;
    const int prow = lane / kChunks;
    const int pch = lane - prow * kChunks;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int tt = p * kRowsPerPass + prow;
      const long long o = __shfl_sync(0xffffffffu, off, tt);
      const long long e =
          (o >= 0 ? o : 0) + pch * static_cast<int>(16 / sizeof(T));
      const uint32_t at = kInt8 ? swz8<D>(tt, pch) : swz<D>(tt, pch);
      copy16_zfill(kst + at, src.k + e, o >= 0);
      copy16_zfill(vst + at, src.v + e, o >= 0);
    }
  }

  // int8: q's A fragments of the four k-steps of 64-dim window w, in the
  // order the int8 K fragments take the dims: rows lane/4 (a[s][0],
  // a[s][2]) and lane/4 + 8 (a[s][1], a[s][3]), dims 64w + 16c + 4s +
  // {0,2} (a[s][0], a[s][1]) and + {1,3} (a[s][2], a[s][3])
  __device__ __forceinline__ void q_window_i8(uint32_t q_base, int w,
                                              uint32_t (*a)[4]) const {
    const int r = lane >> 2;
    const int c = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 lo = lds128(q_base + swz<D>(r, 8 * w + 2 * c + h));
      const uint4 hi = lds128(q_base + swz<D>(r + 8, 8 * w + 2 * c + h));
      a[2 * h][0] = __byte_perm(lo.x, lo.y, 0x5410);
      a[2 * h][1] = __byte_perm(hi.x, hi.y, 0x5410);
      a[2 * h][2] = __byte_perm(lo.x, lo.y, 0x7632);
      a[2 * h][3] = __byte_perm(hi.x, hi.y, 0x7632);
      a[2 * h + 1][0] = __byte_perm(lo.z, lo.w, 0x5410);
      a[2 * h + 1][1] = __byte_perm(hi.z, hi.w, 0x5410);
      a[2 * h + 1][2] = __byte_perm(lo.z, lo.w, 0x7632);
      a[2 * h + 1][3] = __byte_perm(hi.z, hi.w, 0x7632);
    }
  }

  // int8: S's four k-steps of 64-dim window w into s (even) and s2 (odd),
  // q's fragments in a (q_window_i8's order).  K rows lane/4 (tokens 0-7)
  // and lane/4 + 8: a 16-byte chunk of each holds four k-steps' B
  // fragments, converted in registers
  __device__ __forceinline__ void s_window_i8(uint32_t kb,
                                              const uint32_t (*a)[4], int w,
                                              float (&s)[2][4],
                                              float (&s2)[2][4]) const {
    const int t = lane >> 2;
    const int c = lane & 3;
    const uint4 k0 = lds128(kb + swz8<D>(t, 4 * w + c));
    const uint4 k1 = lds128(kb + swz8<D>(t + 8, 4 * w + c));
    const uint32_t kw[2][4] = {{k0.x, k0.y, k0.z, k0.w},
                               {k1.x, k1.y, k1.z, k1.w}};
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4) {
      uint32_t b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {   // bytes 0 and 2, then 1 and 3
        b[j][0] = i8x2_bf16(kw[j][s4]);
        b[j][1] = i8x2_bf16(kw[j][s4] >> 8);
      }
      if (s4 & 1) {
        mma_bf16(s2[0], a[s4], b[0][0], b[0][1]);
        mma_bf16(s2[1], a[s4], b[1][0], b[1][1]);
      } else {
        mma_bf16(s[0], a[s4], b[0][0], b[0][1]);
        mma_bf16(s[1], a[s4], b[1][0], b[1][1]);
      }
    }
  }

  // the first stages - 1 tiles in flight, one commit group each
  __device__ __forceinline__ void prologue() {
    for (int p = 0; p < stages - 1; ++p) {
      if (p < nt) issue(p);
      copy_commit();
    }
  }

  // The walk after prologue(), with q_s visible to the warp.  Leaves this
  // lane's running max (log2 domain) and its part of the running sum of
  // rows lane/4 and lane/4 + 8, and its accumulator fragments.
  __device__ __forceinline__ void run(uint32_t q_base, float scale_log2,
                                      float scale_cap, float cap_log2,
                                      float (&acc)[D / 8][4],
                                      float (&m_run)[2], float (&l_run)[2]) {
    const float neg_inf = __int_as_float(0xff800000);
    const bool capped = cap_log2 > 0.f;
    // ldmatrix rows: A (q) rows lane % 16, chunk lane / 16; K rows
    // (lane & 7) + 8 (lane / 16), chunk (lane / 8) % 2; V (transposed)
    // rows lane % 16, chunk lane / 16
    const int a_row = lane & 15;
    const int a_col = lane >> 4;
    const int k_row = (lane & 7) + (lane >> 4) * 8;
    const int k_col = (lane >> 3) & 1;
    constexpr bool kQInRegs = D <= 128;   // D 256: the registers are spent
    uint32_t qf[kQInRegs ? D / 16 : 1][4];
    if constexpr (kQInRegs && kInt8) {
#pragma unroll
      for (int w = 0; w < D / 64; ++w) q_window_i8(q_base, w, qf + 4 * w);
    } else if constexpr (kQInRegs) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        ldmatrix_x4(qf[kd], q_base + swz<D>(a_row, 2 * kd + a_col));
    }
    const int c4 = lane & 3;   // int8: the lane's column group
    constexpr int kVGroup = D / 16 < 4 ? D / 16 : 4;

    for (int i = 0; i < nt; ++i) {
      if (i + stages - 1 < nt) issue(i + stages - 1);
      copy_commit();
      copy_wait(stages - 1);   // tile i has landed (this lane's copies)
      __syncwarp();            // ... and every lane's
      const int stage = i % stages;
      const uint32_t kb = smem_u32(ring + stage * L::kStageBytes);
      const uint32_t vb = kb + L::kTileBytes;

      // S = q K^T: two independent accumulator chains (even and odd k-steps)
      float s[2][4], s2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
      if constexpr (kInt8 && kQInRegs) {
#pragma unroll
        for (int w = 0; w < D / 64; ++w) s_window_i8(kb, qf + 4 * w, w, s, s2);
      } else if constexpr (kInt8) {
        // D 256: q's fragments are reloaded a window at a time, and the
        // windows stay a loop.  Unrolled, the kernel is 344 instructions
        // longer, 3% faster after one GEMM and 9% slower after a decode
        // step's other kernels on an H100 (tools/k1_context.py; PERF.md's
        // K1 findings)
#pragma unroll 1
        for (int w = 0; w < D / 64; ++w) {
          uint32_t aw[4][4];
          q_window_i8(q_base, w, aw);
          s_window_i8(kb, aw, w, s, s2);
        }
      } else {
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          uint32_t a[4], kf[4];
          if constexpr (kQInRegs) {
#pragma unroll
            for (int x = 0; x < 4; ++x) a[x] = qf[kd][x];
          } else {
            ldmatrix_x4(a, q_base + swz<D>(a_row, 2 * kd + a_col));
          }
          ldmatrix_x4(kf, kb + swz<D>(k_row, 2 * kd + k_col));
          if (kd & 1) {
            mma_bf16(s2[0], a, kf[0], kf[1]);
            mma_bf16(s2[1], a, kf[2], kf[3]);
          } else {
            mma_bf16(s[0], a, kf[0], kf[1]);
            mma_bf16(s[1], a, kf[2], kf[3]);
          }
        }
      }
      // int8: the scales of the tokens this lane's fragments hold, [j][e % 2]
      float ksc[2][2], vsc[2][2];
      if constexpr (kInt8) {
        const uint32_t sb = vb + L::kTileBytes;   // k_scale[16], v_scale[16]
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 k2 = lds_f2(sb + 4 * (8 * j + 2 * c4));
          const float2 v2 = lds_f2(sb + 4 * (kTile + 8 * j + 2 * c4));
          ksc[j][0] = k2.x;
          ksc[j][1] = k2.y;
          vsc[j][0] = v2.x;
          vsc[j][1] = v2.y;
        }
      }

      // scores into the log2 domain (scale, softcap), the live mask, the
      // online softmax; in fragment j register e: row lane/4 + 8 (e/2),
      // token 8 j + 2 (lane % 4) + e % 2 of the tile
      const unsigned mask = live[stage];
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float raw = s[j][e] + s2[j][e];
          if constexpr (kInt8) raw *= ksc[j][e & 1];
          float x = capped ? cap_log2 * tanhf(raw * scale_cap)
                           : raw * scale_log2;
          const int tok = 8 * j + 2 * (lane & 3) + (e & 1);
          x = (mask >> tok) & 1u ? x : neg_inf;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
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
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // s becomes p; not live: exactly 0
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

      // acc += P V, P as bfloat16 hi + lo, V fragments by ldmatrix.trans
      // (int8: P scaled by v_scale first, V fragments built in registers)
      if constexpr (kInt8) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= vsc[j][e & 1];
      }
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
      if constexpr (kInt8) {
        // a word of V rows 2c, 2c + 1, 2c + 8 and 2c + 9 at column 32u + 4n
        // (n = lane/4) is column 4n of the B fragments of n-blocks 4u..4u+3
        const int n = lane >> 2;
#pragma unroll
        for (int u = 0; u < D / 32; ++u) {
          uint32_t vw[4], b[4][2];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            vw[x] = lds32(vb + swz8<D>(2 * c4 + (x & 1) + 8 * (x >> 1),
                                       2 * u + (n >> 2)) +
                          4 * (n & 3));
#pragma unroll
          for (int i = 0; i < 4; ++i) {   // byte i of rows 2c and 2c + 1, ...
            const int sel = i * 0x11 + (4 + i) * 0x1100;
            b[i][0] = i8x2_bf16(__byte_perm(vw[0], vw[1], sel));
            b[i][1] = i8x2_bf16(__byte_perm(vw[2], vw[3], sel));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_bf16(acc[4 * u + i], ph, b[i][0], b[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_bf16(acc[4 * u + i], pl, b[i][0], b[i][1]);
        }
      } else {
#pragma unroll
        for (int g0 = 0; g0 < D / 16; g0 += kVGroup) {
          uint32_t vf[kVGroup][4];
#pragma unroll
          for (int x = 0; x < kVGroup; ++x)
            ldmatrix_x4_trans(vf[x],
                              vb + swz<D>(a_row, 2 * (g0 + x) + a_col));
#pragma unroll
          for (int x = 0; x < kVGroup; ++x) {
            const int dp = g0 + x;
            mma_bf16(acc[2 * dp], ph, vf[x][0], vf[x][1]);
            mma_bf16(acc[2 * dp + 1], ph, vf[x][2], vf[x][3]);
            mma_bf16(acc[2 * dp], pl, vf[x][0], vf[x][1]);
            mma_bf16(acc[2 * dp + 1], pl, vf[x][2], vf[x][3]);
          }
        }
      }
      __syncwarp();   // every lane has read the stage before it is refilled
    }
  }
};

// The split merge inside the launch.  Called by every thread of every block
// of a (sequence, kv head) `bh` after the block wrote its partial: m (log2
// domain) and l at part_ml[2 (part g + r)], acc at part_acc[(part g + r) D],
// part = bh splits + split, for its g rows.  The last block to arrive
// merges the splits into out_rows (g rows of D) and resets counter[bh].
// `scratch` holds 3 splits g floats of shared memory.
template <typename OutT>
__device__ void merge_splits(const float* part_ml, const float* part_acc,
                             int* counter, OutT* out_rows, int bh, int splits,
                             int g, int d, float* scratch) {
  __shared__ int last;
  __threadfence();   // this thread's partial is visible device-wide ...
  __syncthreads();   // ... for every thread of the block, before the ticket
  if (threadIdx.x == 0)
    last = atomicAdd(counter + bh, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();   // the other blocks' partials, read below through L2
  const long base = static_cast<long>(bh) * splits;
  float* m_s = scratch;                  // [splits][g]
  float* w_s = scratch + splits * g;     // [splits][g]: weights, then 0
  float* inv_s = w_s + splits * g;       // [g]
  for (int i = threadIdx.x; i < splits * g; i += blockDim.x) {
    const float2 ml =
        __ldcg(reinterpret_cast<const float2*>(part_ml) + base * g + i);
    m_s[i] = ml.y > 0.f ? ml.x : kNegInf;   // a split with l = 0 saw no token
    w_s[i] = ml.y;
  }
  __syncthreads();
  if (threadIdx.x < g) {
    const int r = threadIdx.x;
    float m = kNegInf;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, m_s[s * g + r]);
    float l = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ls = w_s[s * g + r];
      const float w = ls > 0.f ? fast_exp2(m_s[s * g + r] - m) : 0.f;
      w_s[s * g + r] = w;
      l += ls * w;
    }
    inv_s[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  // each thread takes kMergeItems float4 columns of the output a round,
  // with a batch of kMergeBatch splits' loads of each in flight together
  // (a split without a token, weight 0, is not read)
  const int quads = d / 4;
  const int items = g * quads;
  for (int i0 = threadIdx.x; i0 < items; i0 += kMergeItems * blockDim.x) {
    int row[kMergeItems], col[kMergeItems];
    float4 o[kMergeItems];
#pragma unroll
    for (int x = 0; x < kMergeItems; ++x) {
      const int i = min(i0 + x * static_cast<int>(blockDim.x), items - 1);
      row[x] = i / quads;
      col[x] = (i - row[x] * quads) * 4;
      o[x] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
      float w[kMergeItems][kMergeBatch];
      float4 a[kMergeItems][kMergeBatch];
#pragma unroll
      for (int x = 0; x < kMergeItems; ++x)
#pragma unroll
        for (int u = 0; u < kMergeBatch; ++u) {
          const int s = s0 + u;
          w[x][u] = s < splits ? w_s[s * g + row[x]] : 0.f;
          a[x][u] = w[x][u] != 0.f
                        ? __ldcg(reinterpret_cast<const float4*>(
                              part_acc + ((base + s) * g + row[x]) * d +
                              col[x]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int x = 0; x < kMergeItems; ++x)
#pragma unroll
        for (int u = 0; u < kMergeBatch; ++u) {
          o[x].x += w[x][u] * a[x][u].x;
          o[x].y += w[x][u] * a[x][u].y;
          o[x].z += w[x][u] * a[x][u].z;
          o[x].w += w[x][u] * a[x][u].w;
        }
    }
#pragma unroll
    for (int x = 0; x < kMergeItems; ++x) {
      if (i0 + x * static_cast<int>(blockDim.x) >= items) break;
      const float inv = inv_s[row[x]];
      store4(out_rows + static_cast<long>(row[x]) * d + col[x],
             o[x].x * inv, o[x].y * inv, o[x].z * inv, o[x].w * inv);
    }
  }
  if (threadIdx.x == 0) counter[bh] = 0;   // ready for the next launch
}

// The split merge through a thread-block cluster: the splits of one
// (sequence, kv head) are the blocks of one cluster (rank = split).  Each
// block owns a slice of the output's columns (`per` float4 columns of
// every row).  Every block arrives at a relaxed cluster barrier when it
// starts (cluster_arrive) and waits on it before its first remote store,
// so every block it writes to is running; it then writes each slice of
// its partial, and its (m, l) per row, into the owning block's receive
// buffers (`Recv`, distributed shared memory: stores, no remote loads).
// One cluster barrier later every block merges its own slice from its own
// shared memory and writes it out.  No global partial, fence or atomic.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {   // release, then acquire
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct Recv {
  float4* acc;   // [splits][g][per]
  float2* ml;    // [splits][g]
  int per;       // float4 columns a block owns
  __device__ Recv(uint8_t* base, int recv_acc_bytes, int splits, int d)
      : acc(reinterpret_cast<float4*>(base)),
        ml(reinterpret_cast<float2*>(base + recv_acc_bytes)),
        per((d / 4 + splits - 1) / splits) {}
  // float4 column q of row r of split `from`'s partial, in its owner's
  // buffer
  __device__ __forceinline__ void push(int from, int g, int r, int q,
                                       float4 v) const {
    namespace cg = cooperative_groups;
    const int owner = q / per;
    cg::this_cluster().map_shared_rank(acc, owner)[(from * g + r) * per +
                                                   q - owner * per] = v;
  }
  __device__ __forceinline__ void push_ml(int from, int g, int r, int splits,
                                          float m, float l) const {
    namespace cg = cooperative_groups;
    for (int s = 0; s < splits; ++s)
      cg::this_cluster().map_shared_rank(ml, s)[from * g + r] =
          make_float2(m, l);
  }
};

// After cluster_sync: this block (rank) merges its slice of every row.
template <typename OutT>
__device__ void merge_own_slice(const Recv& rv, OutT* out_rows, int rank,
                                int splits, int g, int d) {
  __shared__ float w_s[kMaxClusterSplits][kMaxGroup];
  __shared__ float inv_s[kMaxGroup];
  if (threadIdx.x < g) {
    const int r = threadIdx.x;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) {
      const float2 ml = rv.ml[s * g + r];
      if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
    }
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 ml = rv.ml[s * g + r];
      const float w = ml.y > 0.f ? fast_exp2(ml.x - mx) : 0.f;
      w_s[s][r] = w;
      sum += ml.y * w;
    }
    inv_s[r] = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  const int q0 = rank * rv.per;
  const int len = max(0, min(rv.per, d / 4 - q0));
  for (int i = threadIdx.x; i < g * len; i += blockDim.x) {
    const int r = i / len;
    const int qq = i - r * len;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxClusterSplits; ++s) {
      const float w = s < splits ? w_s[s][r] : 0.f;
      if (w != 0.f) {   // a split without a token wrote no accumulator
        const float4 a = rv.acc[(s * g + r) * rv.per + qq];
        o.x += w * a.x;
        o.y += w * a.y;
        o.z += w * a.z;
        o.w += w * a.w;
      }
    }
    const float inv = inv_s[r];
    store4(out_rows + static_cast<long>(r) * d + (q0 + qq) * 4, o.x * inv,
           o.y * inv, o.z * inv, o.w * inv);
  }
}

// A block with no live token of a split walk: l = 0, so no merge reads its
// accumulator.  `scratch` is shared memory for the counter merge, `recv`
// the cluster merge's receive buffers.
template <typename OutT>
__device__ void finish_empty(OutT* out_rows, const Split& sp, int g, int d,
                             float* scratch, const Recv& recv) {
  if (sp.cluster) {
    cluster_wait();
    if (threadIdx.x < g)
      recv.push_ml(sp.split, g, threadIdx.x, sp.splits, kNegInf, 0.f);
    cluster_sync();
    merge_own_slice(recv, out_rows, sp.split, sp.splits, g, d);
    return;
  }
  const long part = static_cast<long>(sp.bh) * sp.splits + sp.split;
  if (threadIdx.x < g)
    *reinterpret_cast<float2*>(sp.part_ml + (part * g + threadIdx.x) * 2) =
        make_float2(kNegInf, 0.f);
  merge_splits(sp.part_ml, sp.part_acc, sp.counter, out_rows, sp.bh,
               sp.splits, g, d, scratch);
}

// Bytes of shared scratch merge_splits needs.
__host__ __device__ constexpr size_t merge_scratch_bytes(int splits, int g) {
  return (2 * static_cast<size_t>(splits) * g + g) * sizeof(float);
}

// The end of the tensor-core body: every warp of the block hands its state
// for rows < g to shared memory, the block merges them once and either
// writes the output (one split) or its partial, then the split merge.
// Needs the whole block; the ring's copies must all have completed.  T is
// the walk's page type: int8 walks leave their accumulator's columns in the
// order WarpWalk's int8 P V gives them (acc[4u + i] register e: column
// 32u + 8 (lane % 4) + 4 (e % 2) + i), put back in order here.
template <int D, typename OutT, typename T = __nv_bfloat16>
__device__ void finish_warps(float (&acc)[D / 8][4], float (&m_run)[2],
                             float (&l_run)[2], uint8_t* scratch_bytes,
                             const Recv& recv, OutT* out_rows,
                             const Split& sp, int g) {
  __shared__ float wm_s[kMaxWarps][kMaxGroup];   // each warp's max, then weight
  __shared__ float wl_s[kMaxWarps][kMaxGroup];
  __shared__ float row_m[kMaxGroup];
  __shared__ float row_l[kMaxGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* scratch = reinterpret_cast<float*>(scratch_bytes);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();   // every warp is done with its ring: shared is free
  // [16][D + kAccPad]: the pad spreads the 8 rows a store touches over
  // all 32 banks
  constexpr int kStride = D + kAccPad;
  float* mine = scratch + static_cast<long>(warp) * 16 * kStride;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = lane / 4 + 8 * r;
    if (row >= g) continue;
    if constexpr (sizeof(T) == 1) {
#pragma unroll
      for (int u = 0; u < D / 32; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(mine + row * kStride + 32 * u +
                                     8 * (lane & 3) + 4 * h) =
              make_float4(acc[4 * u][2 * r + h], acc[4 * u + 1][2 * r + h],
                          acc[4 * u + 2][2 * r + h],
                          acc[4 * u + 3][2 * r + h]);
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(mine + row * kStride + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
    if ((lane & 3) == 0) {
      wm_s[warp][row] = m_run[r];
      wl_s[warp][row] = l_run[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < g) {
    const int r = threadIdx.x;
    float m = kNegInf;
    for (int w = 0; w < warps; ++w) m = fmaxf(m, wm_s[w][r]);
    float l = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float wt = fast_exp2(wm_s[w][r] - m);
      wm_s[w][r] = wt;
      l += wl_s[w][r] * wt;
    }
    row_m[r] = m;
    row_l[r] = l;
  }
  __syncthreads();
  const int splits = sp.splits;
  const long part = static_cast<long>(sp.bh) * splits + sp.split;
  constexpr int kQuads = D / 4;
  if (sp.cluster) cluster_wait();   // every block of the cluster is running
  for (int i = threadIdx.x; i < g * kQuads; i += blockDim.x) {
    const int r = i / kQuads;
    const int q = i - r * kQuads;
    // every warp's loads in flight together
    float wt[kMaxWarps];
    float4 a[kMaxWarps];
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      wt[w] = w < warps ? wm_s[w][r] : 0.f;
      a[w] = w < warps ? *reinterpret_cast<const float4*>(
                             scratch + (w * 16 + r) * kStride + q * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      o.x += wt[w] * a[w].x;
      o.y += wt[w] * a[w].y;
      o.z += wt[w] * a[w].z;
      o.w += wt[w] * a[w].w;
    }
    if (splits == 1) {
      const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
      store4(out_rows + static_cast<long>(r) * D + q * 4, o.x * inv,
             o.y * inv, o.z * inv, o.w * inv);
    } else if (sp.cluster) {
      recv.push(sp.split, g, r, q, o);
    } else {
      store4(sp.part_acc + (part * g + r) * D + q * 4, o.x, o.y, o.z, o.w);
    }
  }
  if (splits == 1) return;
  if (sp.cluster) {
    if (threadIdx.x < g)
      recv.push_ml(sp.split, g, threadIdx.x, splits, row_m[threadIdx.x],
                   row_l[threadIdx.x]);
    cluster_sync();   // every block's pushes have landed
    merge_own_slice(recv, out_rows, sp.split, splits, g, D);
    return;
  }
  if (threadIdx.x < g)
    *reinterpret_cast<float2*>(sp.part_ml + (part * g + threadIdx.x) * 2) =
        make_float2(row_m[threadIdx.x], row_l[threadIdx.x]);
  merge_splits(sp.part_ml, sp.part_acc, sp.counter, out_rows, sp.bh, splits,
               g, D, scratch);
}

}  // namespace decode
