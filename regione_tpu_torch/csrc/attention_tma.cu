// Non-causal attention over one or two KV segments, built for Hopper: TMA
// loads into a ring of shared-memory stages, wgmma for both products, two
// consumer warpgroups (and a producer warpgroup where the second segment is
// quantized).  The second segment is stored as bf16, int8 or int4 (the
// kernel's template argument).
//
// Replaces these Pallas TPU kernels of regione_tpu/ops/flash_attention.py:
//   K1 `_kv_resident_kernel` (via `flash_attention`): dense and write steps,
//      one KV segment [B, H, S, D];
//   K5 `_flash_kernel` (the same call past the resident budget, S > 12,288
//      keys): this kernel streams K/V at any S, so it is K1's launch;
//   K2 `_rows2_resident_kernel` with a bf16 cache (via
//      `flash_attention_rows2`): RAGS steps, fresh rows [B, H, S1, D]
//      followed by the frozen cache [B, H, S2, D], one softmax over both,
//      the cache read in place (no concatenation);
//   K2q the same kernel with an int8 or int4 cache (`_dequant_into`,
//      `_unpack4_f32`), and K6 `_kv_resident_q8_kernel` (a quantized K/V
//      alone: S1 = 0).  The Pallas kernels dequantize a head's cache into
//      VMEM once and never write a bf16 copy to HBM; here the HBM reads stay
//      int8 / int4 too, and the dequantized tiles live only in shared memory.
//
// What it computes, per (b, h): out = softmax(q k^T / sqrt(D) + bias) v over
// [k1/v1 rows ‖ k2/v2 rows], with the logits and the softmax in fp32, P cast
// to bf16 (unnormalised) for the PV product, fp32 accumulation and one
// normalisation at the end; bias is an optional fp32 key-column row
// [B, S1 + S2].  The output goes straight into [B, T, H*D].  q, k and v are
// any (b, h, row) strided views with a dense last dim (the model's
// `split_heads` views as they are).
//
// A quantized second segment holds S2 logical rows with fp32 row scales
// [B, H, S2] (row-dense).  int8: one code per value.  int4 (ops/quant.py
// S-halves packing): S2/2 stored rows, row j < S2/2 in the low nibble of
// stored row j, row j >= S2/2 in the high nibble of stored row j - S2/2.
// Dequantization is code -> fp32 (exact), times the row's scale in fp32, one
// rounding to bf16, as the plain `dequantize_kv_heads*` do, so the K/V that
// enter the wgmma are bit-equal to the plain version's.
//
// What bounds it on an H100: at the main path's shapes (T = 1152..12416,
// S = 2176..12416, D = 128) attention is compute bound, 4*T*S*D flops
// against 2*(T+S)*D*2 bytes per (b, h) (fewer for a quantized cache); the
// bf16 tensor cores (989 TFLOP/s dense) are reached only through wgmma fed
// from shared memory.  Next come the softmax's exp2 (64 a thread a tile, at
// 16 a clock an SM about half as long as the tile's products) and the K/V
// stream from L2 (every 128-row CTA reads all of its head's K/V).  The
// design:
//   * a CTA owns 128 query rows of one (b, h) (grid ceil(T/128) x H x B);
//     warpgroups 0 and 1 consume, 64 query rows each;
//   * bf16 K/V (K1, K5, K2): the block is the two consumer warpgroups alone
//     (256 threads), so ptxas may give each thread up to 255 registers (it
//     uses 232, no spills).  Warpgroup 1 also refills the ring: its thread
//     0 issues the TMA loads (Q once, then K and V tiles of 128 keys), and
//     its threads stage each tile's 128 bias columns into the stage, times
//     log2(e), the columns past the segment's end at -inf, so the
//     softmax reads one shared row and masks nothing.  The bias arrives by
//     cp.async and is scaled in place a refill later (a global load still
//     pending on a register stalls the next wgmma fence), and the TMA issue
//     is a predicate of the instructions, not a branch (ptxas serializes
//     the wgmma of a warpgroup that branches on its thread index);
//   * each consumer warpgroup pipelines its tiles (FA3's intra-warpgroup
//     overlap): round j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}
//     together, runs tile j's softmax once S_j is back while the PV
//     product still runs, then rescales O and packs P_j.  S (64 fp32), O
//     (64) and P (32 bf16x2) are live at once, which is why this mode
//     drops the producer warpgroup: a 384-thread block gets 168 registers
//     a thread in every region (ptxas compiles the whole kernel at the
//     launch bound's count and does not allocate past it after
//     `setmaxnreg.inc`, and the card allocates a block's registers by
//     whole warpgroups, so a 288-thread block costs a 384-thread one).  An
//     explicit ping-pong of the two warpgroups (FA3's named barriers
//     ordering their issue) measured slower in every placement tried;
//   * the ring has three stages of K and V (224 KB with Q), each operand
//     freed by its own barrier: K and the bias once both warpgroups'
//     softmax has read them, V once both PV products are done;
//   * a quantized second segment (K2q, K6) keeps a producer warpgroup of
//     128 writers and so 168 registers a thread: its raw codes (128 rows x
//     128 bytes, one box, no swizzle), K then V, are TMA-loaded into a ring
//     of three 16 KB slots, each released on its own; the writers (one of
//     which also issues the TMA loads) dequantize them and store the bf16
//     values into the same swizzled stage TMA fills for bf16 tiles, then
//     arrive on the stage's "full" barrier (which takes all 128 writers'
//     arrivals, one of which carries TMA's byte count when the tile is
//     bf16), and stage the bias (loaded a tile ahead).  Two stages of
//     K/V fit beside the code slots, and each consumer warpgroup walks the
//     tiles one product at a time (S, softmax, PV), with one barrier
//     freeing a stage; `setmaxnreg` moves registers from the writers (80 /
//     88) to the consumers (208 / 200).  The tile's fp32 row scales go
//     through shared memory, loaded a tile ahead.  Codes become floats by
//     the exponent trick (a byte placed under the exponent of 2^23, minus
//     2^23 + its bias: exact), not by I2F, which runs at a quarter of the
//     rate of the fp32 pipes on sm_90.  At 1152 fresh + 8192 cache rows the
//     dequant, not the tensor cores, sets the pace (with it skipped the
//     launch takes the bf16 kernel's time), and what holds it back is the
//     writers' stalls, not their arithmetic;
//   * S = Q K^T: wgmma m64n128k16, A (Q) and B (K) from shared memory, both
//     K-major, a 128-byte swizzle (a TMA box row is at most 64 bf16, so a
//     128 x 128 tile is two 128 x 64 boxes); O += P V: wgmma m64n128k16
//     with P in registers (the S accumulator packed into bf16 A fragments)
//     and V as an MN-major B operand (the transpose bit bf16 allows), so V
//     needs no transpose;
//   * the segments are walked one after the other (ceil(S1/128) tiles, then
//     the second segment's), each tile from its own tensor map with its own
//     strides and row extent, so no tile straddles the seam; an int4
//     segment is walked as two sub-segments of S2/2 rows over the one packed
//     map (low nibbles, then high nibbles), so no tile straddles row S2/2
//     either.  TMA zero-fills rows past a segment's end and their logits are
//     masked to -inf before the max.
// Measured (H100 80GB HBM3, 700 W): K1 at FLUX's dense [1,24,8704,128]
// with a bias takes 1.745 ms, 53.9% of its 0.941 ms bound (the walk one
// product at a time took 1.781 ms); at Step1X's [2,24,8320,128] 3.132 ms,
// 54.9% of 1.720 ms (3.320).  With its products alone skipped the bf16
// kernel still takes 1.13-1.21x its bound's time: the softmax and the K/V
// stream, more than the products, hold it back.  A persistent scheduler,
// split-KV for small T, and K/V multicast across a two-CTA cluster (it
// halves the L2 stream) are later work.
//
// Numerics: the running max starts at -1e30 (a tile whose keys are all
// masked gives no NaN), the online softmax runs in fp32 (in base 2, log2(e)
// folded into the scale and the bias), P is not normalised before its bf16
// cast, and the output is normalised once.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kD = 128;        // head dim (the only one supported)
constexpr int kBQ = 128;       // query rows per CTA: two consumers x 64
constexpr int kBK = 128;       // keys per tile
constexpr int kConsumers = 256;  // warpgroups 0, 1; any producer after them
constexpr int kConsumerWarps = kConsumers / 32;  // one arrival a warp
constexpr int kLoaderWarps = 4;  // bf16: warpgroup 1 stages the bias
constexpr int kWriters = 128;  // the producer warpgroup (quantized modes)
constexpr int kBox = 64;                         // bf16 columns per TMA box
constexpr int kHalfBytes = kBQ * kBox * 2;       // one 128 x 64 box: 16 KB
constexpr int kTileBytes = 2 * kHalfBytes;       // a 128 x 128 tile: 32 KB
constexpr int kCodeBytes = kBK * kD;             // 128 x 128 codes: 16 KB
constexpr int kCodeSlots = 3;  // K, V, K, V, ... code tiles in turn
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// named barrier of the dequantizing writers (0 is __syncthreads)
constexpr int kWritersBar = 1;

// storage of the second segment's rows (mode2)
constexpr int kBf16 = 0;
constexpr int kInt8 = 1;
constexpr int kInt4 = 2;  // S-halves nibble packing, S2 / 2 stored rows

// the softmax runs in base 2: x = (s * scale + bias) * log2(e), where
// s * scale * log2(e) + bias * log2(e) is one fma, and p = 2^(x - m).  A
// key at bias -1e30 gives x == -1e30 * log2(e), the running max's start,
// exactly, so a tile masked whole gives p = 1 and no NaN
constexpr float kLog2e = 1.4426950408889634f;

// Threads and shared-memory layout of one instantiation.  bf16 K/V: the two
// consumer warpgroups alone (256 threads, so a thread may hold 255
// registers); a quantized mode adds a warpgroup of writers (384 threads,
// 168 registers).  Q, then the K and V stages of the ring; a quantized mode
// adds the ring of 16 KB code slots and two buffers of a tile's K and V row
// scales (fp32 [2][2 * BK]) before the bias.  The ring is as deep as the
// block's shared memory allows: three stages of bf16 K/V (224 KB with Q),
// two beside a quantized mode's 48 KB of code slots.
template <int Mode>
struct Smem {
  static constexpr int kThreads =
      Mode == kBf16 ? kConsumers : kConsumers + kWriters;
  static constexpr int kStages = Mode == kBf16 ? 3 : 2;
  static constexpr int kK = kTileBytes;  // after Q
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kCodes = kV + kStages * kTileBytes;  // code ring
  static constexpr int kScales = kCodes + kCodeSlots * kCodeBytes;
  static constexpr int kBias =
      Mode == kBf16 ? kCodes : kScales + 2 * 2 * kBK * 4;
  static constexpr int kBar = kBias + kStages * kBK * 4;  // fp32 [stage][BK]
  // q, full_k[s], full_v[s], full_bias[s], empty_k[s] (K and the bias),
  // empty_v[s], code_full[slot], code_empty[slot]
  static constexpr int kNumBars = 1 + 5 * kStages + 2 * kCodeSlots;
  // + barriers + slack to align the base to the 1024-byte swizzle atom
  static constexpr int kBytes = kBar + 8 * kNumBars + 1024;
  static_assert(kBytes <= kMaxSmem, "the ring does not fit a block");
};

struct TmaParams {
  const float* bias;   // [B, S1 + S2] or null
  const float* ks2;    // [B, H, S2] row scales of a quantized segment
  const float* vs2;
  long long ks_s[2], vs_s[2];  // their (b, h) element strides
  __nv_bfloat16* out;  // [B, T, H * D]
  int H, T, S1, S2;
  float scale;
};

// Tile `it` of the walk: the bf16 fresh rows, then the second segment (an
// int4 one as two sub-segments of S2/2 rows: low nibbles, then high).
struct Tile {
  bool fresh;  // a tile of the first segment
  bool high;   // int4: the high-nibble sub-segment
  int j0;      // first row in its tensor map
  int valid;   // rows of the tile inside its (sub-)segment
  int key;     // first logical key: its bias column
};

template <int Mode>
struct Walk {
  int n1, rows2, n2h, n_tiles;
  __device__ __forceinline__ explicit Walk(const TmaParams& p) {
    n1 = (p.S1 + kBK - 1) / kBK;
    rows2 = Mode == kInt4 ? p.S2 / 2 : p.S2;
    n2h = (rows2 + kBK - 1) / kBK;
    n_tiles = n1 + (Mode == kInt4 ? 2 * n2h : n2h);
  }
  __device__ __forceinline__ Tile at(int it, const TmaParams& p) const {
    Tile t;
    t.fresh = it < n1;
    if (t.fresh) {
      t.high = false;
      t.j0 = it * kBK;
      t.valid = p.S1 - t.j0;
      t.key = t.j0;
      return t;
    }
    int k = it - n1;
    t.high = Mode == kInt4 && k >= n2h;
    if (t.high) k -= n2h;
    t.j0 = k * kBK;
    t.valid = rows2 - t.j0;
    t.key = p.S1 + (t.high ? rows2 : 0) + t.j0;
    return t;
  }
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
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for the A fragments a register-sourced wgmma reads: they stay
// live (and unmoved) until the wait that follows it
__device__ __forceinline__ void reg_fence(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
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

// Sixteen int8 codes (int4: the low or high nibbles of sixteen packed
// bytes) -> sixteen bf16 values code * scale in out[0..7] (column order,
// two a word).  A code c is made unsigned (c + 128, or c + 8 for a nibble)
// by flipping its sign bit, placed as the low byte of the fp32 2^23 + u
// (exact) and 2^23 + 128 (+ 8) taken off: c as fp32, exactly.  Then one
// fp32 product and one rounding to bf16, as the plain version computes.
template <int Mode>
__device__ __forceinline__ void dequant16(uint4 w, float sc, bool high,
                                          uint32_t (&out)[8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  const float bias = Mode == kInt8 ? 8388736.f : 8388616.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t u;
    if (Mode == kInt8) {
      u = words[q] ^ 0x80808080u;
    } else {
      const uint32_t x = words[q] ^ 0x88888888u;
      u = (high ? x >> 4 : x) & 0x0F0F0F0Fu;
    }
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + e)) - bias;
      f[e] = __fmul_rn(c, sc);  // never fused into a neighbour
    }
    out[2 * q] = pack_bf16(f[0], f[1]);
    out[2 * q + 1] = pack_bf16(f[2], f[3]);
  }
}

// One staged 128 x 128 code tile -> the bf16 stage, in the layout TMA
// writes under the 128-byte swizzle: column halves [0, 64) and [64, 128)
// 16 KB apart, 16-byte chunk c of row r at chunk c ^ (r & 7).  `scale`:
// the tile's 128 row scales in shared memory (0 past the segment's end,
// where TMA filled zero codes).  Thread `wt` of kWriters takes 16 codes
// (one 16-byte chunk c) of rows r0, r0 + 16, ..., r0 + 112: eight
// neighbouring threads take chunks 0-3 of one row and 4-7 of the next (or
// the other way round), so their 16-byte reads of the codes and both of
// their swizzled 16-byte stores fall on eight distinct bank groups.  A
// thread's rows differ by multiples of 8, so its swizzle is fixed and every
// address is one base plus a constant; the codes and scales of a batch are
// loaded before any is converted.
template <int Mode>
__device__ __forceinline__ void dequant_tile(const uint8_t* codes,
                                             uint8_t* stage,
                                             const float* scale, bool high,
                                             int wt) {
  constexpr int kIters = kBK * (kD / 16) / kWriters;  // chunks a thread
  constexpr int kRowStep = kWriters / 8;              // rows between them
  constexpr int kBatch = Mode == kInt8 ? 4 : 8;  // no spills at either
  const int g = wt >> 3;
  const int c = wt & 7;
  const int r0 = 2 * (g >> 1) + ((c >> 2) ^ (g & 1));
  const int q = (2 * c) & 7;
  const uint8_t* src = codes + r0 * kD + c * 16;
  const float* sc = scale + r0;
  uint8_t* dst = stage + (c >> 2) * kHalfBytes + r0 * 128;
  const int o0 = (q ^ (r0 & 7)) << 4;
  const int o1 = ((q + 1) ^ (r0 & 7)) << 4;
#pragma unroll
  for (int m0 = 0; m0 < kIters; m0 += kBatch) {
    uint4 w[kBatch];
    float s[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      w[j] = *reinterpret_cast<const uint4*>(src + (m0 + j) * kRowStep * kD);
      s[j] = sc[(m0 + j) * kRowStep];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      uint32_t v[8];
      dequant16<Mode>(w[j], s[j], high, v);
      uint8_t* row = dst + (m0 + j) * kRowStep * 128;
      *reinterpret_cast<uint4*>(row + o0) = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(row + o1) = make_uint4(v[4], v[5], v[6], v[7]);
    }
  }
}

// One fp32 from global into shared memory by cp.async (zero-filled where
// `in` is false, reading nothing), committed as a group of its own;
// cp_async_wait<N> waits until at most N of this thread's groups are
// pending.
__device__ __forceinline__ void cp_async_f32(uint32_t dst, const float* src,
                                             bool in) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
      "cp.async.commit_group;\n" ::"r"(dst),
      "l"(src), "r"(in ? 4 : 0)
      : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's generic shared-memory stores visible to the async
// proxy (wgmma reads its operands through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the kWriters dequantizing threads alone
__device__ __forceinline__ void writers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kWritersBar), "n"(kWriters)
               : "memory");
}

// Row wt's K and V scales of a quantized tile, 0 past the (sub-)segment's
// end.
__device__ __forceinline__ void load_scales(const float* krow,
                                            const float* vrow,
                                            const Tile& tl, int S1, int wt,
                                            float& k, float& v) {
  const bool in = wt < tl.valid;
  k = in ? __ldg(krow + (tl.key - S1) + wt) : 0.f;
  v = in ? __ldg(vrow + (tl.key - S1) + wt) : 0.f;
}

// Column c of a tile's staged bias: the bias times log2(e), 0 without a
// bias, -inf past the segment's end.
__device__ __forceinline__ float bias_col(const float* brow, const Tile& tl,
                                          int c) {
  if (c >= tl.valid) return -INFINITY;
  return brow != nullptr ? brow[tl.key + c] * kLog2e : 0.f;
}

// A bf16 tile of rows [j0, j0 + 128) (Q, or K or V into a stage): two
// boxes, completing `bar`, issued by the threads where `on` holds.  The
// predicate is the instructions' own, not a branch: ptxas serializes the
// wgmma of a warpgroup that branches on its thread index between them.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int j0, int h, int b,
                                          bool on = true) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %8, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %9;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%2, {%4, %5, %6, %7}], [%3];\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%1], [%2, {%10, %5, %6, %7}], [%3];\n"
      "}\n" ::"r"(dst),
      "r"(dst + kHalfBytes), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
      "r"(0), "r"(j0), "r"(h), "r"(b), "r"(static_cast<int>(on)),
      "r"(kTileBytes), "r"(kBox)
      : "memory");
}

// S = Q K^T for this warpgroup's 64 rows x 128 keys: 8 steps over the head
// dim, issued and committed as one group (not waited for).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t qa,
                                        uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
    wgmma_ss(s, smem_desc(qa + off, 16, 1024), smem_desc(kt + off, 16, 1024),
             kk > 0);
  }
  wg_commit();
}

// O += P V over the tile's 128 keys, P the packed A fragments, issued and
// committed as one group.
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[8][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    // 16 keys = two 8-row groups (1024 bytes apart); the two 64-column
    // halves of V are one box (16 KB) apart
    wgmma_rs(o, pa[kk], smem_desc(vt + kk * 2048, kHalfBytes, 1024));
  }
  wg_commit();
}

// This warp is done with a stage's operand: one arrival a warp, after
// every lane's reads.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The online softmax of one tile's logits, in place: scale and bias (sb:
// the staged bias at this thread's column pair; -inf past the segment),
// the running max m and sum l of rows g and g + 8 updated, s turned into
// the unnormalised P, and a = 2^(m_old - m_new), by which O is rescaled
// before this tile's PV product.
__device__ __forceinline__ void softmax_tile(float (&s)[64], const float* sb,
                                             float scale2, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float2 bn = *reinterpret_cast<const float2*>(sb + 8 * n);
    s[4 * n] = fmaf(s[4 * n], scale2, bn.x);
    s[4 * n + 1] = fmaf(s[4 * n + 1], scale2, bn.y);
    s[4 * n + 2] = fmaf(s[4 * n + 2], scale2, bn.x);
    s[4 * n + 3] = fmaf(s[4 * n + 3], scale2, bn.y);
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  a0 = fast_exp2(m0 - mn0);
  a1 = fast_exp2(m1 - mn1);
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[4 * n + j] = fast_exp2(s[4 * n + j] - mn0);
      s[4 * n + 2 + j] = fast_exp2(s[4 * n + 2 + j] - mn1);
      ls0 += s[4 * n + j];
      ls1 += s[4 * n + 2 + j];
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
}

// O *= a (rows g, g + 8), then P (the softmax's s) packed into the bf16 A
// fragments of the PV product.
__device__ __forceinline__ void rescale_and_pack(float (&o)[64],
                                                 const float (&s)[64],
                                                 float a0, float a1,
                                                 uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    o[4 * n] *= a0;
    o[4 * n + 1] *= a0;
    o[4 * n + 2] *= a1;
    o[4 * n + 3] *= a1;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int Mode>
__global__ void __launch_bounds__(Smem<Mode>::kThreads, 1)
attention_tma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk1,
                     const __grid_constant__ CUtensorMap tv1,
                     const __grid_constant__ CUtensorMap tk2,
                     const __grid_constant__ CUtensorMap tv2,
                     const __grid_constant__ TmaParams p) {
  constexpr bool kQuant = Mode != kBf16;
  constexpr int kStages = Smem<Mode>::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sq = base;
  const uint32_t sk = base + Smem<Mode>::kK;
  const uint32_t sv = base + Smem<Mode>::kV;
  const uint32_t scodes = base + Smem<Mode>::kCodes;  // code ring (quantized)
  const uint32_t bar_q = base + Smem<Mode>::kBar;
  const uint32_t bar_k = bar_q + 8;                 // full_k[s]
  const uint32_t bar_v = bar_k + 8 * kStages;       // full_v[s]
  const uint32_t bar_b = bar_v + 8 * kStages;       // full_bias[s]
  const uint32_t bar_ek = bar_b + 8 * kStages;      // empty_k[s]
  const uint32_t bar_ev = bar_ek + 8 * kStages;     // empty_v[s]
  const uint32_t bar_cf = bar_ev + 8 * kStages;     // code_full[slot]
  const uint32_t bar_ce = bar_cf + 8 * kCodeSlots;  // code_empty[slot]
  // the bias stages through a generic pointer (plain loads and stores)
  float* const sbias = reinterpret_cast<float*>(gbase + Smem<Mode>::kBias);

  const int tid = threadIdx.x;
  // warp-uniform, and known to be so by the compiler: else ptxas takes
  // the branches on it as divergent and serializes the wgmma
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const Walk<Mode> walk(p);
  const int n1 = walk.n1;
  const int n_tiles = walk.n_tiles;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      // a quantized mode's stages are full once every writer has arrived
      // (and, for a bf16 tile, TMA's bytes have landed)
      mbar_init(bar_k + 8 * s, kQuant ? kWriters : 1);
      mbar_init(bar_v + 8 * s, kQuant ? kWriters : 1);
      mbar_init(bar_b + 8 * s, kQuant ? kWriters : kLoaderWarps);
      mbar_init(bar_ek + 8 * s, kConsumerWarps);
      mbar_init(bar_ev + 8 * s, kConsumerWarps);
    }
    for (int c = 0; c < kCodeSlots; ++c) {
      mbar_init(bar_cf + 8 * c, 1);
      mbar_init(bar_ce + 8 * c, kWriters);
    }
    // make the initialised barriers visible to the async (TMA) proxy
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const float* brow =
      p.bias ? p.bias + static_cast<long long>(b) * (p.S1 + p.S2) : nullptr;
  if (tid >= kConsumers) {  // a quantized mode's writers
    if constexpr (kQuant) {
      const int ptid = tid - kConsumers;
      // ---- producer, quantized second segment: all 128 threads stage the
      // bias and dequantize; thread 0 also issues the TMA loads, each code
      // tile's as soon as its ring slot is read ---------------------------
      // (per mode: the budgets at which ptxas spills nothing)
      if constexpr (Mode == kInt8)
        asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
      else
        asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n");
      const int wt = ptid;
      const int n_codes = 2 * (n_tiles - n1);  // K, V per quantized tile
      // code tile n (K of quantized tile n / 2, or its V) into slot
      // n % kCodeSlots, once the slot's last round is read
      auto load_codes = [&](int n) {
        const int slot = n % kCodeSlots;
        mbar_wait(bar_ce + 8 * slot, ((n / kCodeSlots) & 1) ^ 1);
        mbar_expect_tx(bar_cf + 8 * slot, kCodeBytes);
        tma_load(scodes + slot * kCodeBytes, (n & 1) ? &tv2 : &tk2,
                 bar_cf + 8 * slot, 0, walk.at(n1 + n / 2, p).j0, h, b);
      };
      if (wt == 0) {
        load_tile(sq, &tq, bar_q, q0, h, b);
        for (int n = 0; n < kCodeSlots && n < n_codes; ++n) load_codes(n);
      }
      // the row scales go through shared memory, each quantized tile's
      // loaded while the one before is dequantized
      const float* krow = p.ks2 + b * p.ks_s[0] + h * p.ks_s[1];
      const float* vrow = p.vs2 + b * p.vs_s[0] + h * p.vs_s[1];
      float* const sscale =
          reinterpret_cast<float*>(gbase + Smem<Mode>::kScales);
      float pre_k = 0.f, pre_v = 0.f;
      if (n1 < n_tiles)
        load_scales(krow, vrow, walk.at(n1, p), p.S1, wt, pre_k, pre_v);
      // bias column wt, loaded a tile ahead too
      float pre_b = bias_col(brow, walk.at(0, p), wt);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_ev + 8 * s, ((it / kStages) & 1) ^ 1);
        const Tile tl = walk.at(it, p);
        if (tl.fresh) {
          // bf16 rows: thread 0's arrivals carry TMA's byte counts
          if (wt == 0) {
            load_tile(sk + s * kTileBytes, &tk1, bar_k + 8 * s, tl.j0, h, b);
            load_tile(sv + s * kTileBytes, &tv1, bar_v + 8 * s, tl.j0, h, b);
          } else {
            mbar_arrive(bar_k + 8 * s);
            mbar_arrive(bar_v + 8 * s);
          }
        }
        sbias[s * kBK + wt] = pre_b;
        mbar_arrive(bar_b + 8 * s);
        if (it + 1 < n_tiles) pre_b = bias_col(brow, walk.at(it + 1, p), wt);
        if (tl.fresh) continue;
        // scale buffer (it - n1) & 1: its readers of two tiles ago are past
        // the last tile's writers_sync
        float* const ss = sscale + ((it - n1) & 1) * 2 * kBK;
        ss[wt] = pre_k;
        ss[kBK + wt] = pre_v;
        if (it + 1 < n_tiles)
          load_scales(krow, vrow, walk.at(it + 1, p), p.S1, wt, pre_k, pre_v);
        writers_sync();
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const int n = 2 * (it - n1) + kv;
          const int slot = n % kCodeSlots;
          mbar_wait(bar_cf + 8 * slot, (n / kCodeSlots) & 1);
          dequant_tile<Mode>(
              gbase + Smem<Mode>::kCodes + slot * kCodeBytes,
              gbase + (kv ? Smem<Mode>::kV : Smem<Mode>::kK) + s * kTileBytes,
              ss + kv * kBK, tl.high, wt);
          fence_proxy_async();       // before the consumers' wgmma read
          mbar_arrive((kv ? bar_v : bar_k) + 8 * s);
          mbar_arrive(bar_ce + 8 * slot);  // the codes are read
          if (wt == 0 && n + kCodeSlots < n_codes) load_codes(n + kCodeSlots);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------
    if constexpr (Mode == kInt8)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    else if constexpr (Mode == kInt4)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
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
    float a0, a1;                    // the rescale of O by the last softmax
    float sacc[64];                  // S of the tile in flight
    uint32_t pa[8][4];               // P of the tile before it, bf16
    const uint32_t qa = sq + wg * (64 * kBox * 2);  // this warpgroup's rows

    if constexpr (kQuant) {
      // each warpgroup walks the tiles on its own, one product at a time
      // (168 registers hold S and O, or O and P, but not all three)
      mbar_wait(bar_q, 0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        mbar_wait(bar_k + 8 * s, parity);
        wg_fence();
        issue_qk(sacc, qa, sk + s * kTileBytes);
        wg_wait<0>();
        reg_fence(sacc);
        mbar_wait(bar_b + 8 * s, parity);
        softmax_tile(sacc, sbias + s * kBK + 2 * t, scale2, m0, m1, l0, l1,
                     a0, a1);
        rescale_and_pack(o, sacc, a0, a1, pa);
        mbar_wait(bar_v + 8 * s, parity);
        wg_fence();
        issue_pv(o, pa, sv + s * kTileBytes);
        wg_wait<0>();
        reg_fence(o);
        release(bar_ev + 8 * s, lane);  // K, V and the bias
      }
    } else {
      // Warpgroup 1 refills the ring, after its own products of the round:
      // its thread 0 issues the TMA loads of tile it's K (V) once every
      // warp has released the slot's last K (V), and its threads stage the
      // tile's bias with K, a column each.  The bias comes by cp.async,
      // which leaves no load pending on a register (a wgmma fence would
      // wait for it), raw into the stage, and is scaled and masked there
      // one refill later, as `bias_col` computes it.  Round 0 of each slot
      // passes at once: the ring starts empty.
      auto publish_bias = [&](int it) {
        const int s = it % kStages;
        float& x = sbias[s * kBK + ctid];
        x = ctid < walk.at(it, p).valid ? x * kLog2e : -INFINITY;
        release(bar_b + 8 * s, lane);
      };
      auto refill_k = [&](int it) {
        const int s = it % kStages;
        const Tile tl = walk.at(it, p);
        mbar_wait(bar_ek + 8 * s, ((it / kStages) & 1) ^ 1);
        load_tile(sk + s * kTileBytes, tl.fresh ? &tk1 : &tk2, bar_k + 8 * s,
                  tl.j0, h, b, ctid == 0);
        // 0 without a bias or past the segment's end
        const bool in = brow != nullptr && ctid < tl.valid;
        cp_async_f32(smem_u32(sbias + s * kBK + ctid),
                     in ? brow + tl.key + ctid
                        : reinterpret_cast<const float*>(p.out),
                     in);
        if (it > 0) {
          cp_async_wait<1>();
          publish_bias(it - 1);
        }
        if (it == n_tiles - 1) {
          cp_async_wait<0>();
          publish_bias(it);
        }
      };
      auto refill_v = [&](int it) {
        const int s = it % kStages;
        const Tile tl = walk.at(it, p);
        mbar_wait(bar_ev + 8 * s, ((it / kStages) & 1) ^ 1);
        load_tile(sv + s * kTileBytes, tl.fresh ? &tv1 : &tv2, bar_v + 8 * s,
                  tl.j0, h, b, ctid == 0);
      };
      if (wg == 1) {
        load_tile(sq, &tq, bar_q, q0, h, b, ctid == 0);
        for (int it = 0; it < kStages && it < n_tiles; ++it) {
          refill_k(it);
          refill_v(it);
        }
      }
      mbar_wait(bar_q, 0);

      // round 0: S_0 alone
      mbar_wait(bar_k, 0);
      wg_fence();
      issue_qk(sacc, qa, sk);
      wg_wait<0>();
      reg_fence(sacc);
      mbar_wait(bar_b, 0);
      softmax_tile(sacc, sbias + 2 * t, scale2, m0, m1, l0, l1, a0, a1);
      release(bar_ek, lane);  // K_0 and its bias are read
      if (wg == 1 && kStages < n_tiles) refill_k(kStages);
      rescale_and_pack(o, sacc, a0, a1, pa);

      // round it: S_it = Q K_it^T and O += P_{it-1} V_{it-1} in flight
      // together; tile it's softmax runs while the PV product does
      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const int sp = (it - 1) % kStages;
        const uint32_t pparity = ((it - 1) / kStages) & 1;
        mbar_wait(bar_k + 8 * s, parity);
        wg_fence();
        issue_qk(sacc, qa, sk + s * kTileBytes);
        mbar_wait(bar_v + 8 * sp, pparity);
        issue_pv(o, pa, sv + sp * kTileBytes);
        wg_wait<1>();  // S_it
        reg_fence(sacc);
        mbar_wait(bar_b + 8 * s, parity);
        softmax_tile(sacc, sbias + s * kBK + 2 * t, scale2, m0, m1, l0, l1,
                     a0, a1);
        release(bar_ek + 8 * s, lane);
        wg_wait<0>();  // O += P_{it-1} V_{it-1}
        reg_fence(o);
        reg_fence(pa);
        release(bar_ev + 8 * sp, lane);
        // (with no product in flight: ptxas serializes the wgmma around a
        // divergent branch inside the pipeline)
        if (wg == 1) {
          if (it + kStages < n_tiles) refill_k(it + kStages);
          if (it - 1 + kStages < n_tiles) refill_v(it - 1 + kStages);
        }
        rescale_and_pack(o, sacc, a0, a1, pa);
      }

      // the last round: PV of the last tile alone
      const int sp = (n_tiles - 1) % kStages;
      mbar_wait(bar_v + 8 * sp, ((n_tiles - 1) / kStages) & 1);
      wg_fence();
      issue_pv(o, pa, sv + sp * kTileBytes);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pa);
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

// A rank-4 (D, row, H, B) map of rows [B, H, rows, 128] with element
// strides st = (b, h, row); rows past `rows` read as zeros.  bf16 rows:
// boxes of 64 columns x 128 rows, 128-byte swizzle.  int8 code rows
// (`codes`): one box of 128 columns x 128 rows (128 bytes a row), no
// swizzle.  A zero stride (a size-1 dim, never stepped over) becomes the
// packed one, which TMA accepts.
bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                 const long long* st, int B, int H, int rows, bool codes) {
  const long long esize = codes ? 1 : 2;
  const long long row_b = st[2] ? st[2] * esize : kD * esize;
  const long long h_b = st[1] ? st[1] * esize : row_b * rows;
  const long long b_b = st[0] ? st[0] * esize : h_b * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row_b),
                                 static_cast<cuuint64_t>(h_b),
                                 static_cast<cuuint64_t>(b_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(codes ? kD : kBox),
                             kBK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map,
            codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared-memory allowance of one instantiation, set once per
// device and process (not at every launch).
template <int Mode>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(attention_tma_kernel<Mode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<Mode>::kBytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int Mode>
int launch(const void* q, const void* k1, const void* v1, const void* k2,
           const void* v2, const TmaParams& p, const long long* strides,
           int B, int T, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int H = p.H, S1 = p.S1;
  const int rows2 = Mode == kInt4 ? p.S2 / 2 : p.S2;
  CUtensorMap mq, mk1, mv1, mk2, mv2;
  bool ok = encode_rows(fn, &mq, q, strides, B, H, T, false);
  if (S1 > 0)
    ok = ok && encode_rows(fn, &mk1, k1, strides + 3, B, H, S1, false) &&
         encode_rows(fn, &mv1, v1, strides + 6, B, H, S1, false);
  if (rows2 > 0)
    ok = ok &&
         encode_rows(fn, &mk2, k2, strides + 9, B, H, rows2, Mode != kBf16) &&
         encode_rows(fn, &mv2, v2, strides + 12, B, H, rows2, Mode != kBf16);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // an absent segment's maps are never read
  if (S1 == 0) {
    mk1 = mk2;
    mv1 = mv2;
  }
  if (rows2 == 0) {
    mk2 = mk1;
    mv2 = mv1;
  }
  const cudaError_t err = allow_smem<Mode>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  attention_tma_kernel<Mode>
      <<<grid, Smem<Mode>::kThreads, Smem<Mode>::kBytes, stream>>>(
      mq, mk1, mv1, mk2, mv2, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 19 element strides, (b, h, row) for q, k1, v1, k2, v2, each in
// its tensor's own dtype, then (b, h) for the scales ks2, vs2.  mode2: the
// storage of k2/v2: 0 bf16 rows (ks2, vs2 unused), 1 int8 codes, 2 int4
// S-halves packed (S2 / 2 stored rows, S2 even), with ks2/vs2 the fp32 row
// scales [B, H, S2].  S2 == 0 attends over k1/v1 alone (K1/K5), S1 == 0
// over k2/v2 alone (K6 in a quantized mode).  Builds the five tensor maps on
// the host, launches on `stream`, allocates nothing, and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for arguments it
// does not take or a map that is refused).
extern "C" int regione_attention_tma_fwd(const void* q, const void* k1,
                                         const void* v1, const void* k2,
                                         const void* v2, const void* ks2,
                                         const void* vs2, const void* bias,
                                         void* out, const long long* strides,
                                         int B, int H, int T, int S1, int S2,
                                         int mode2, float scale,
                                         void* stream) {
  if (mode2 < kBf16 || mode2 > kInt4 || B <= 0 || H <= 0 || T <= 0 ||
      S1 < 0 || S2 < 0 || S1 + S2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode2 != kBf16 &&
      (S2 <= 0 || ks2 == nullptr || vs2 == nullptr ||
       (mode2 == kInt4 && S2 % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  TmaParams p;
  p.bias = static_cast<const float*>(bias);
  p.ks2 = static_cast<const float*>(ks2);
  p.vs2 = static_cast<const float*>(vs2);
  for (int j = 0; j < 2; ++j) {
    p.ks_s[j] = strides[15 + j];
    p.vs_s[j] = strides[17 + j];
  }
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.T = T;
  p.S1 = S1;
  p.S2 = S2;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode2) {
    case kInt8:
      return launch<kInt8>(q, k1, v1, k2, v2, p, strides, B, T, st);
    case kInt4:
      return launch<kInt4>(q, k1, v1, k2, v2, p, strides, B, T, st);
    default:
      return launch<kBf16>(q, k1, v1, k2, v2, p, strides, B, T, st);
  }
}
