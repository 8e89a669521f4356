// Non-causal attention over one or two bf16 KV segments, built for Hopper:
// TMA loads into a ring of shared-memory stages, wgmma for both products,
// one producer warpgroup and two consumer warpgroups.
//
// Replaces the bf16 launches of these Pallas TPU kernels of
// regione_tpu/ops/flash_attention.py (csrc/attention.cu keeps the
// quantized-cache ones, K2q and K6):
//   K1 `_kv_resident_kernel` (via `flash_attention`): dense and write steps,
//      one KV segment [B, H, S, D];
//   K5 `_flash_kernel` (the same call past the resident budget, S > 12,288
//      keys): this kernel streams K/V at any S, so it is K1's launch;
//   K2 `_rows2_resident_kernel` with a bf16 cache (via
//      `flash_attention_rows2`): RAGS steps, fresh rows [B, H, S1, D]
//      followed by the frozen cache [B, H, S2, D], one softmax over both,
//      the cache read in place (no concatenation).
//
// What it computes, per (b, h): out = softmax(q k^T / sqrt(D) + bias) v over
// [k1/v1 rows ‖ k2/v2 rows], with the logits and the softmax in fp32, P cast
// to bf16 (unnormalised) for the PV product, fp32 accumulation and one
// normalisation at the end; bias is an optional fp32 key-column row
// [B, S1 + S2].  The output goes straight into [B, T, H*D].  q, k and v are
// any (b, h, row) strided views with a dense last dim (the model's
// `split_heads` views as they are).
//
// What bounds it on an H100: at the main path's shapes (T = S = 2176..12416,
// D = 128) attention is compute bound, 4*T*S*D flops against
// 2*(T+S)*D*2 bytes per (b, h); the bf16 tensor cores (989 TFLOP/s dense)
// are reached only through wgmma fed from shared memory.  The design:
//   * a CTA owns 128 query rows of one (b, h) (grid ceil(T/128) x H x B):
//     384 threads, warpgroups 0 and 1 consume (64 query rows each),
//     warpgroup 2 produces; `setmaxnreg` moves registers from the producer
//     (40) to the consumers (232), which hold the S and O accumulators
//     (64 + 64 fp32) and P (32 bf16x2) in registers;
//   * one thread of the producer issues TMA loads: Q once (128 x 128 bf16),
//     then K and V tiles of 128 keys into a ring of two stages, each stage
//     released by the consumers through an mbarrier, so copies overlap the
//     math.  A 128-byte swizzle makes a TMA box row at most 64 bf16, so a
//     128 x 128 tile is two 128 x 64 boxes.  A second producer warp writes
//     the tile's 128 bias columns into the stage, times log2(e), with the
//     columns past the segment's end at -inf, so the consumers read one
//     shared row instead of 32 global values a thread and mask nothing.
//     Smem: 32 KB Q + 2 x (64 KB + 512 B);
//   * S = Q K^T: wgmma m64n128k16, A (Q) and B (K) from shared memory, both
//     K-major; O += P V: wgmma m64n128k16 with P in registers (the S
//     accumulator packed into bf16 A fragments) and V as an MN-major B
//     operand (the transpose bit bf16 allows), so V needs no transpose;
//   * two segments are walked one after the other (ceil(S1/128) tiles, then
//     ceil(S2/128)), each tile from its own tensor map with its own strides
//     and row extent, so no tile straddles the seam; TMA zero-fills rows past
//     a segment's end and their logits are masked to -inf before the max.
// Two consumer warpgroups work on the same tiles independently, so one's
// softmax overlaps the other's products; an explicit ping-pong (FA3), a
// persistent scheduler and split-KV for small T are later work.
//
// Numerics kept from csrc/attention.cu: the running max starts at -1e30 (a
// tile whose keys are all masked gives no NaN), the online softmax runs in
// fp32 (in base 2, log2(e) folded into the scale and the bias), P is not
// normalised before its bf16 cast, and the output is normalised once.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;        // head dim (the only one supported)
constexpr int kBQ = 128;       // query rows per CTA: two consumers x 64
constexpr int kBK = 128;       // keys per tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int kConsumers = 256;
constexpr int kBox = 64;                         // bf16 columns per TMA box
constexpr int kHalfBytes = kBQ * kBox * 2;       // one 128 x 64 box: 16 KB
constexpr int kTileBytes = 2 * kHalfBytes;       // a 128 x 128 tile: 32 KB
constexpr int kSmemK = kTileBytes;               // after Q
constexpr int kSmemV = kSmemK + kStages * kTileBytes;
constexpr int kSmemBias = kSmemV + kStages * kTileBytes;  // fp32 [stage][BK]
constexpr int kSmemBar = kSmemBias + kStages * kBK * 4;
// q, full_k[s], full_v[s], full_bias[s], empty[s]
constexpr int kNumBars = 1 + 4 * kStages;
// + barriers + slack to align the base to the 1024-byte swizzle atom
constexpr int kSmemBytes = kSmemBar + 8 * kNumBars + 1024;

struct TmaParams {
  const float* bias;   // [B, S1 + S2] or null
  __nv_bfloat16* out;  // [B, T, H * D]
  int H, T, S1, S2;
  float scale;
};

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

// Wait for the completion of the phase of `bar` with this parity.  A wait
// that never ends (a fault in the pipeline) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
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
    if (spins > (1u << 26)) __trap();
  }
}

// One TMA box of a rank-4 (D, row, H, B) map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
// K-major: `sbo` is the stride of 8-row groups, `lbo` unused.  MN-major:
// `lbo` is the stride between 64-element blocks of MN, `sbo` the stride of
// 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WG_R8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_OUT64                                                     \
  WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),    \
      WG_R8(48), WG_R8(56)

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]^T, A and B K-major in shared
// memory.  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 fragments),
// B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (-inf -> +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the first in the low half (lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1)
attention_tma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk1,
                     const __grid_constant__ CUtensorMap tv1,
                     const __grid_constant__ CUtensorMap tk2,
                     const __grid_constant__ CUtensorMap tv2,
                     const __grid_constant__ TmaParams p) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + kSmemK;
  const uint32_t sv = base + kSmemV;
  const uint32_t bar_q = base + kSmemBar;
  const uint32_t bar_k = bar_q + 8;                 // full_k[s]
  const uint32_t bar_v = bar_k + 8 * kStages;       // full_v[s]
  const uint32_t bar_b = bar_v + 8 * kStages;       // full_bias[s]
  const uint32_t bar_e = bar_b + 8 * kStages;       // empty[s]
  // the bias stages through a generic pointer (plain loads and stores)
  float* const sbias = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + kSmemBias);
  // the softmax runs in base 2: x = (s * scale + bias) * log2(e), where
  // s * scale * log2(e) + bias * log2(e) is one fma, and p = 2^(x - m).
  // A key at bias -1e30 gives x == -1e30 * log2(e), the running max's
  // start, exactly, so a tile masked whole gives p = 1 and no NaN (as the
  // natural-base kernel in csrc/attention.cu does)
  const float kLog2e = 1.4426950408889634f;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int n1 = (p.S1 + kBK - 1) / kBK;
  const int n_tiles = n1 + (p.S2 + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_b + 8 * s, 32);
      mbar_init(bar_e + 8 * s, kConsumers);
    }
    // make the initialised barriers visible to the async (TMA) proxy
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the TMA loads in flight, one warp
    // stages the bias ---------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ptid = tid - 2 * 128;
    if (ptid >= 32 && ptid < 64) {
      const int lane = ptid - 32;
      const float* brow =
          p.bias ? p.bias + static_cast<long long>(b) * (p.S1 + p.S2)
                 : nullptr;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_e + 8 * s, ((it / kStages) & 1) ^ 1);
        const bool seg1 = it < n1;
        const int j0 = (seg1 ? it : it - n1) * kBK;
        const int valid = (seg1 ? p.S1 : p.S2) - j0;  // keys of the tile
        const int boff = (seg1 ? 0 : p.S1) + j0;      // its bias column
#pragma unroll
        for (int c = lane; c < kBK; c += 32) {
          float x = -INFINITY;                        // past the segment
          if (c < valid) x = brow != nullptr ? brow[boff + c] * kLog2e : 0.f;
          sbias[s * kBK + c] = x;
        }
        mbar_arrive(bar_b + 8 * s);  // release: the stores are visible
      }
    } else if (ptid == 0) {
      mbar_expect_tx(bar_q, kTileBytes);
      tma_load(sq, &tq, bar_q, 0, q0, h, b);
      tma_load(sq + kHalfBytes, &tq, bar_q, kBox, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        // round 0 passes at once: the ring starts empty
        mbar_wait(bar_e + 8 * s, ((it / kStages) & 1) ^ 1);
        const bool seg1 = it < n1;
        const CUtensorMap* mk = seg1 ? &tk1 : &tk2;
        const CUtensorMap* mv = seg1 ? &tv1 : &tv2;
        const int j0 = (seg1 ? it : it - n1) * kBK;
        const uint32_t dk = sk + s * kTileBytes;
        const uint32_t dv = sv + s * kTileBytes;
        mbar_expect_tx(bar_k + 8 * s, kTileBytes);
        tma_load(dk, mk, bar_k + 8 * s, 0, j0, h, b);
        tma_load(dk + kHalfBytes, mk, bar_k + 8 * s, kBox, j0, h, b);
        mbar_expect_tx(bar_v + 8 * s, kTileBytes);
        tma_load(dv, mv, bar_v + 8 * s, 0, j0, h, b);
        tma_load(dv + kHalfBytes, mv, bar_v + 8 * s, kBox, j0, h, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ctid = tid % 128;
    const int warp = ctid / 32;
    const int lane = ctid % 32;
    const int g = lane / 4;      // accumulator row group
    const int t = lane % 4;      // thread in group: columns 2t, 2t + 1
    const float kMaskedMax = -1e30f * kLog2e;
    const float scale2 = p.scale * kLog2e;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = kMaskedMax, m1 = kMaskedMax;  // running max, rows g, g + 8
    float l0 = 0.f, l1 = 0.f;        // running sum
    const uint32_t qa = sq + wg * (64 * kBox * 2);  // this warpgroup's rows

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;

      // ---- S = Q K^T: 64 rows x 128 keys, 8 steps over the head dim -----
      float sacc[64];
      mbar_wait(bar_k + 8 * s, parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
        wgmma_ss(sacc, smem_desc(qa + off, 16, 1024),
                 smem_desc(sk + s * kTileBytes + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(sacc);

      // ---- scale and bias (-inf past the segment); online softmax -------
      mbar_wait(bar_b + 8 * s, parity);
      const float* sb = sbias + s * kBK + 2 * t;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float2 bn = *reinterpret_cast<const float2*>(sb + 8 * n);
        sacc[4 * n] = fmaf(sacc[4 * n], scale2, bn.x);
        sacc[4 * n + 1] = fmaf(sacc[4 * n + 1], scale2, bn.y);
        sacc[4 * n + 2] = fmaf(sacc[4 * n + 2], scale2, bn.x);
        sacc[4 * n + 3] = fmaf(sacc[4 * n + 3], scale2, bn.y);
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float a0 = fast_exp2(m0 - mn0);
      const float a1 = fast_exp2(m1 - mn1);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sacc[4 * n + j] = fast_exp2(sacc[4 * n + j] - mn0);
          sacc[4 * n + 2 + j] = fast_exp2(sacc[4 * n + 2 + j] - mn1);
          ls0 += sacc[4 * n + j];
          ls1 += sacc[4 * n + 2 + j];
        }
      }
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[4 * n] *= a0;
        o[4 * n + 1] *= a0;
        o[4 * n + 2] *= a1;
        o[4 * n + 3] *= a1;
      }

      // ---- O += P V: the S accumulator is P's A fragments ---------------
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      mbar_wait(bar_v + 8 * s, parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // 16 keys = two 8-row groups (1024 bytes apart); the two 64-column
        // halves of V are one box (16 KB) apart
        wgmma_rs(o, pa[kk],
                 smem_desc(sv + s * kTileBytes + kk * 2048, kHalfBytes, 1024));
      }
      wg_commit();
      wg_wait_all();
      reg_fence(o);
      mbar_arrive(bar_e + 8 * s);  // this thread is done with the stage
    }

    // ---- normalise and store into [B, T, H*D] ---------------------------
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;
    const int r0 = q0 + wg * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    const long long rs = static_cast<long long>(p.H) * kD;
    __nv_bfloat16* ob = p.out + static_cast<long long>(b) * p.T * rs + h * kD;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = 8 * n + 2 * t;
      if (r0 < p.T)
        *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) =
            pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (r1 < p.T)
        *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the library
// needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A rank-4 (D, row, H, B) map of bf16 rows [B, H, rows, 128] with element
// strides st = (b, h, row), boxes of 64 columns x 128 rows, 128-byte
// swizzle; rows past `rows` read as zeros.  A zero stride (a size-1 dim,
// never stepped over) becomes the packed one, which TMA accepts.
bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                 const long long* st, int B, int H, int rows) {
  const long long row_b = st[2] ? st[2] * 2 : kD * 2;
  const long long h_b = st[1] ? st[1] * 2 : row_b * rows;
  const long long b_b = st[0] ? st[0] * 2 : h_b * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row_b),
                                 static_cast<cuuint64_t>(h_b),
                                 static_cast<cuuint64_t>(b_b)};
  const cuuint32_t box[4] = {kBox, kBK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The C signature of regione_attention_fwd (csrc/attention.cu), bf16 K/V
// only: mode2 must be 0 (ks2 / vs2 unused), else cudaErrorInvalidValue.
// strides: 19 element strides, (b, h, row) for q, k1, v1, k2, v2, then the
// scales' (unused here).  S2 == 0 attends over k1/v1 alone (K1/K5), S1 == 0
// over k2/v2 alone.  Builds the five tensor maps on the host, launches on
// `stream`, allocates nothing, and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue if a map is refused).
extern "C" int regione_attention_tma_fwd(const void* q, const void* k1,
                                         const void* v1, const void* k2,
                                         const void* v2, const void* ks2,
                                         const void* vs2, const void* bias,
                                         void* out, const long long* strides,
                                         int B, int H, int T, int S1, int S2,
                                         int mode2, float scale,
                                         void* stream) {
  (void)ks2;
  (void)vs2;
  if (mode2 != 0 || B <= 0 || H <= 0 || T <= 0 || S1 < 0 || S2 < 0 ||
      S1 + S2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk1, mv1, mk2, mv2;
  bool ok = encode_rows(fn, &mq, q, strides, B, H, T);
  if (S1 > 0)
    ok = ok && encode_rows(fn, &mk1, k1, strides + 3, B, H, S1) &&
         encode_rows(fn, &mv1, v1, strides + 6, B, H, S1);
  if (S2 > 0)
    ok = ok && encode_rows(fn, &mk2, k2, strides + 9, B, H, S2) &&
         encode_rows(fn, &mv2, v2, strides + 12, B, H, S2);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // an absent segment's maps are never read
  if (S1 == 0) {
    mk1 = mk2;
    mv1 = mv2;
  }
  if (S2 == 0) {
    mk2 = mk1;
    mv2 = mv1;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attention_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  TmaParams p;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.T = T;
  p.S1 = S1;
  p.S2 = S2;
  p.scale = scale;
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  attention_tma_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(mq, mk1, mv1,
                                                              mk2, mv2, p);
  return static_cast<int>(cudaGetLastError());
}
