// K10 `kv_quant_store_kernel`: one layer's K or V image rows, quantized
// straight into the int8 / int4 K/V cache in one pass.
//
// It replaces no Pallas kernel.  The JAX package quantizes the cache in
// its jitted write phase (regione_tpu/ops/quant.py:296 `quantize_kv_heads`
// and :336 `quantize_kv_heads4`, through `MMDiTConfig._quantize_kv` at
// regione_tpu/models/mmdit.py:189 and 275), where XLA fuses the row amax,
// the scale, the division, the rounding, the clamp and the cache's update
// into loop fusions over the rows.  Eager PyTorch ran the
// same expression (regione_tpu_torch/ops/quant.py `_quantize`) as about
// nine fp32 passes and two copies into the cache; this kernel is the
// port's counterpart of XLA's fusion.
//
// Bits: the codes and scales equal the eager expression's on the card,
// bit for bit, so the cache K2q reads is unchanged:
//   * amax: the largest |x| of the row's 128 bf16 values (exact, NaN
//     propagating as torch's amax);
//   * scale = amax * (1 / qmax) + 1e-12 in fp32.  PyTorch's CUDA true
//     division by a Python scalar multiplies by the fp32 reciprocal
//     (BinaryDivTrueKernel.cu); `+ 1e-12` adds the double 1e-12 cast to
//     fp32.  `__fmul_rn` / `__fadd_rn` keep nvcc from contracting the two
//     into an fma;
//   * code = clamp(round_half_even(x / scale), -qmax, qmax): an IEEE
//     division (`__fdiv_rn`, never a reciprocal multiply), then
//     `__float2int_rn`;
//   * int4 (qmax 7): byte (s, d) of the packed rows holds row s's code in
//     its low nibble and row s + S/2's in its high nibble, as
//     `quantize_kv_heads4` packs them.
//
// What bounds it on an H100: bytes.  It does 0.5 flop a byte.  One of
// Qwen's writes reads [2, 24, 8192, 128] bf16 (100.7 MB) and writes as many
// int8 codes (50.3 MB) and 393,216 fp32 scales (1.6 MB): 152.6 MB, 45.5 us
// at 3.35 TB/s.  The source (one layer's K or V, a strided view of the
// joint [B, H, T + S, 128] buffer) does not fit in the 50 MB L2, so the
// design keeps HBM busy and touches each byte once:
//   * a half-warp per row: a row's 256 bytes are 16 loads of 16 bytes, one
//     a lane, read where the view lies (any batch, head and row strides);
//   * the row's amax: each lane's 8 values in bf16x2, then a 16-lane xor
//     shuffle;
//   * each half-warp keeps kRows rows in flight (int4: the kRows pairs, 2 x
//     kRows loads), issued before any arithmetic;
//   * each lane stores its 8 codes as one 8-byte store: a row's codes are
//     128 contiguous bytes;
//   * a warp's 8 consecutive rows put their scales in 8 lanes, which store
//     them as one 32-byte run (int4: the low and the high rows' runs);
//   * instructions come close to the bytes at the SM clock the 700 W cap
//     leaves under load: each value takes an IEEE division, and finding
//     each row's (batch, head, row) by 32-bit integer divisions would cost
//     about as much again, so a thread divides once, for its first row,
//     and steps from there.
// No shared memory, no temporaries, no synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 128;
constexpr int kRowLanes = kHeadDim / 8;      // lanes a row, 8 values each
constexpr int kRows = 4;                     // rows in flight a half-warp
constexpr int kWarpRows = 2 * kRows;         // consecutive rows a warp
constexpr int kThreads = 256;
constexpr int kBlockRows = kThreads / 32 * kWarpRows;

struct QuantArgs {
  const bf16* x;       // [B, H, S, 128], any batch / head / row strides
  int8_t* rows;        // [B, H, S, 128] (int4: [B, H, S/2, 128])
  float* scales;       // [B, H, S], dense in S
  long long x_sb, x_sh, x_ss, r_sb, r_sh, r_ss, s_sb, s_sh;
  int heads;
  int units;           // output rows a (batch, head): S, or S/2 in int4
  int total;           // batch * heads * units
  float inv_qmax, eps;
};

struct Unit {
  int b, h, s;
};

__device__ __forceinline__ Unit unit_at(const QuantArgs& a, int u) {
  const int bh = u / a.units;
  return {bh / a.heads, bh % a.heads, u - bh * a.units};
}

// t moved `step` output rows on: a thread divides once for all its rows
// (a 32-bit division costs about as much as a lane's share of a row)
__device__ __forceinline__ void advance(const QuantArgs& a, Unit& t,
                                        int step) {
  t.s += step;
  while (t.s >= a.units) {
    t.s -= a.units;
    if (++t.h == a.heads) {
      t.h = 0;
      ++t.b;
    }
  }
}

__device__ __forceinline__ float row_amax(const uint4& v) {
  const auto* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  __nv_bfloat162 m = __habs2(p[0]);
#pragma unroll
  for (int i = 1; i < 4; ++i) m = __hmax2_nan(m, __habs2(p[i]));
#pragma unroll
  for (int off = kRowLanes / 2; off >= 1; off /= 2)
    m = __hmax2_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  return __bfloat162float(__hmax_nan(m.x, m.y));
}

template <int kQmax>
__device__ __forceinline__ void codes(const uint4& v, float scale,
                                      int (&q)[8]) {
  const auto* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    q[2 * i] = min(max(__float2int_rn(__fdiv_rn(f.x, scale)), -kQmax),
                   kQmax);
    q[2 * i + 1] = min(max(__float2int_rn(__fdiv_rn(f.y, scale)), -kQmax),
                       kQmax);
  }
}

template <bool kInt4>
__global__ void __launch_bounds__(kThreads)
kv_quant_store_kernel(const QuantArgs a) {
  constexpr int kSrc = kInt4 ? 2 : 1;        // source rows an output row
  constexpr int kQmax = kInt4 ? 7 : 127;
  const int lane = threadIdx.x % 32;
  const int half = lane / kRowLanes;
  const int col = 8 * (lane % kRowLanes);
  const int base =
      (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * kWarpRows;

  uint4 v[kRows][kSrc];
  int8_t* dst[kRows];
  Unit t = unit_at(a, base + half);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int u = base + 2 * j + half;
#pragma unroll
    for (int k = 0; k < kSrc; ++k) v[j][k] = make_uint4(0, 0, 0, 0);
    dst[j] = nullptr;
    if (u < a.total) {
      const bf16* src = a.x + t.b * a.x_sb + t.h * a.x_sh + t.s * a.x_ss +
                        col;
#pragma unroll
      for (int k = 0; k < kSrc; ++k)
        v[j][k] = *reinterpret_cast<const uint4*>(
            src + (long long)k * a.units * a.x_ss);
      dst[j] = a.rows + t.b * a.r_sb + t.h * a.r_sh + t.s * a.r_ss + col;
    }
    advance(a, t, 2);
  }

  float scale[kRows][kSrc];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    int q[kSrc][8];
#pragma unroll
    for (int k = 0; k < kSrc; ++k) {
      scale[j][k] = __fadd_rn(__fmul_rn(row_amax(v[j][k]), a.inv_qmax),
                              a.eps);
      codes<kQmax>(v[j][k], scale[j][k], q[k]);
    }
    uint32_t word[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      word[w] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * w + i;
        const uint32_t lo = q[0][d], hi = q[kSrc - 1][d];
        const uint32_t byte = kInt4 ? (hi << 4) | (lo & 15u) : lo;
        word[w] |= (byte & 0xffu) << (8 * i);
      }
    }
    if (dst[j] != nullptr)
      *reinterpret_cast<uint2*>(dst[j]) = make_uint2(word[0], word[1]);
  }

  // lane l < 8 * kSrc stores the scale of the warp's row l % 8 (the high
  // row of the pair for l >= 8), held by half-warp l % 2 after the shuffle
  const int r = lane % kWarpRows;
  const int k_of = lane / kWarpRows;
  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int k = 0; k < kSrc; ++k) {
      const float got =
          __shfl_sync(0xffffffffu, scale[j][k], (r % 2) * kRowLanes);
      if (r / 2 == j && k_of == k) mine = got;
    }
  }
  const int u = base + r;
  if (k_of < kSrc && u < a.total) {
    const Unit at = unit_at(a, u);
    a.scales[at.b * a.s_sb + at.h * a.s_sh + at.s +
             (long long)k_of * a.units] = mine;
  }
}

}  // namespace

// strides (elements): x_sb, x_sh, x_ss, rows_sb, rows_sh, rows_ss,
// scales_sb, scales_sh.  bits 8: rows [B, H, S, 128]; bits 4: rows [B, H,
// S/2, 128], S even.  Scales [B, H, S] fp32, dense in S.
extern "C" int regione_kv_quant_store_fwd(const void* x, void* rows,
                                          void* scales,
                                          const long long* strides,
                                          int batch, int heads, int seq,
                                          int bits, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && seq % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  QuantArgs a;
  a.x = static_cast<const bf16*>(x);
  a.rows = static_cast<int8_t*>(rows);
  a.scales = static_cast<float*>(scales);
  a.x_sb = strides[0];
  a.x_sh = strides[1];
  a.x_ss = strides[2];
  a.r_sb = strides[3];
  a.r_sh = strides[4];
  a.r_ss = strides[5];
  a.s_sb = strides[6];
  a.s_sh = strides[7];
  a.heads = heads;
  a.units = bits == 4 ? seq / 2 : seq;
  const long long total = (long long)batch * heads * a.units;
  if (total > INT_MAX - kBlockRows)
    return static_cast<int>(cudaErrorInvalidValue);
  a.total = static_cast<int>(total);
  // as PyTorch forms `amax / qmax` (a Python float) on the card: the fp32
  // reciprocal, computed on the host
  const float qmax = bits == 4 ? 7.0f : 127.0f;
  a.inv_qmax = 1.0f / qmax;
  a.eps = static_cast<float>(1e-12);
  const unsigned blocks =
      static_cast<unsigned>((total + kBlockRows - 1) / kBlockRows);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    kv_quant_store_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  else
    kv_quant_store_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
