// Non-causal attention over one or two KV segments, bf16 in, fp32 softmax.
//
// Replaces four Pallas TPU kernels of regione_tpu/ops/flash_attention.py:
//   K1 `_kv_resident_kernel` (via `flash_attention`): dense and write steps,
//      one KV segment [B, H, S, D].
//   K5 `_flash_kernel` (the same call past the resident budget, S > 12,288
//      keys): this kernel streams K/V at any S, so it is K1's launch.
//   K2 `_rows2_resident_kernel` with a bf16 cache (via `flash_attention_rows2`):
//      RAGS steps, fresh rows [B, H, S1, D] followed by the frozen cache
//      [B, H, S2, D], one softmax over both, the cache read in place.
//   K2q the same with an int8 or int4 cache (`_dequant_into`,
//      `_unpack4_f32`), and K6 `_kv_resident_q8_kernel`: a quantized K/V
//      segment with no fresh rows (S1 = 0).
// All are the same algorithm over one or two pointer ranges, so one kernel
// serves them (S2 = 0 for K1/K5, S1 = 0 for K6).
//
// What it computes, per (b, h): out = softmax(q k^T / sqrt(D) + bias) v, with
// the logits and softmax in fp32, P cast to bf16 for the PV product, and fp32
// accumulation; bias is an optional fp32 key-column row [B, S1 + S2].  The
// output goes straight into [B, T, H*D] (the `sdpa` contract).
//
// The quantized second segment (mode2 = 1 int8, 2 int4) holds S2 logical rows
// with fp32 row scales [B, H, S2] (row-dense).  int8: one code per value.
// int4 (ops/quant.py S-halves packing): S2/2 stored rows, row j < S2/2 in the
// low nibble of stored row j, row j >= S2/2 in the high nibble of stored row
// j - S2/2; a tile that straddles S2/2 mixes both, row by row.  The dequant
// happens inside the tile load: code -> fp32, times the row's scale in fp32,
// one rounding to bf16, as the plain `dequantize_kv_heads*` do, so the K/V
// that enter the mma are bit-equal to the plain version's.  No dequantized
// copy of the cache is made: the TPU kernel's point (HBM reads stay int8 or
// int4) carried over to the H100's HBM.
//
// What bounds it on an H100: at the slice's shapes (T = S = 2176..12416,
// D = 128) attention is compute bound: 4*T*S*D flops against 2*(T+S)*D*2
// bytes per (b, h).  The TPU kernel kept a whole head's K and V resident in
// VMEM and took one full-row softmax; a Hopper SM has at most 227 KB of shared
// memory, so this kernel streams K/V in 64-row tiles instead and keeps an
// online softmax (fp32 running max, sum and accumulator in registers).  Each
// CTA owns 64 query rows of one (b, h), four warps with 16 rows each; the
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in, fp32
// accumulate).  Loads are plain synchronous 16-byte loads into padded shared
// memory: the first version is simple and right; TMA, wgmma and a multi-stage
// pipeline are later work.
//
// Differences from the TPU kernel, on purpose:
//   * the running max starts at -1e30 (as `_flash_kernel` does), not -inf, so
//     a tile whose keys are all masked never computes exp(-inf - -inf);
//   * ragged edges are masked here (keys past S1 + S2 get p = 0 and zero-filled
//     K/V tiles), so callers pad nothing and the bias needs no tile padding;
//   * P is not normalised before its bf16 cast (online softmax), so results
//     differ from the full-row softmax by bf16 rounding of P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;         // head dim (the only one supported)
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // four warps, 16 query rows each
constexpr int kLds = kD + 8;    // padded shared row (bf16): conflict-free reads
constexpr int kChunk = 16;      // head-dim values a thread loads per step

// storage of the second segment's rows
constexpr int kBf16 = 0;
constexpr int kInt8 = 1;
constexpr int kInt4 = 2;        // S-halves nibble packing, S2 / 2 stored rows

struct AttnParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k1;
  const __nv_bfloat16* v1;
  const void* k2;               // bf16, or int8 codes / packed nibbles
  const void* v2;
  const float* ks2;             // [B, H, S2] row scales (quantized mode2)
  const float* vs2;
  const float* bias;            // [B, S1 + S2] or null
  __nv_bfloat16* out;           // [B, T, H * D]
  // element strides (b, h, row) of q, k1, v1, k2, v2 in their own dtypes;
  // the last dim is dense
  long long q_s[3], k1_s[3], v1_s[3], k2_s[3], v2_s[3];
  long long ks2_s[2], vs2_s[2]; // (b, h) strides of the scales; rows dense
  int B, H, T, S1, S2, mode2;
  float scale;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint4 ld128(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Sixteen int8 codes (int4: the low or high nibbles of sixteen packed bytes)
// -> sixteen bf16 values code * scale, rounded once from fp32; lo holds
// values 0..7, hi 8..15.  Bytes are sign-extended by arithmetic shifts of the
// 32-bit word (as `_unpack4_f32` does through int32).
__device__ __forceinline__ void dequant16(uint4 w, float sc, int mode,
                                          bool high, uint4& lo, uint4& hi) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t out[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      int c0, c1;
      if (mode == kInt8) {
        c0 = static_cast<int>(words[q] << (24 - 8 * e)) >> 24;
        c1 = static_cast<int>(words[q] << (16 - 8 * e)) >> 24;
      } else if (high) {
        c0 = static_cast<int>(words[q] << (24 - 8 * e)) >> 28;
        c1 = static_cast<int>(words[q] << (16 - 8 * e)) >> 28;
      } else {
        c0 = static_cast<int>(words[q] << (28 - 8 * e)) >> 28;
        c1 = static_cast<int>(words[q] << (20 - 8 * e)) >> 28;
      }
      out[q * 2 + e / 2] = pack_bf16(static_cast<float>(c0) * sc,
                                     static_cast<float>(c1) * sc);
    }
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// Values [c, c + 16) of key and value row j2 of the second segment as bf16.
__device__ __forceinline__ void load_seg2(const AttnParams& p, int b, int h,
                                          int j2, int c, uint4* kv) {
  if (p.mode2 == kBf16) {
    const __nv_bfloat16* kr = static_cast<const __nv_bfloat16*>(p.k2) +
                              b * p.k2_s[0] + h * p.k2_s[1] +
                              j2 * p.k2_s[2] + c;
    const __nv_bfloat16* vr = static_cast<const __nv_bfloat16*>(p.v2) +
                              b * p.v2_s[0] + h * p.v2_s[1] +
                              j2 * p.v2_s[2] + c;
    kv[0] = ld128(kr);
    kv[1] = ld128(kr + 8);
    kv[2] = ld128(vr);
    kv[3] = ld128(vr + 8);
    return;
  }
  int row = j2;
  bool high = false;
  if (p.mode2 == kInt4) {
    const int half = p.S2 / 2;
    high = j2 >= half;
    row = high ? j2 - half : j2;
  }
  const int8_t* kr = static_cast<const int8_t*>(p.k2) + b * p.k2_s[0] +
                     h * p.k2_s[1] + row * p.k2_s[2] + c;
  const int8_t* vr = static_cast<const int8_t*>(p.v2) + b * p.v2_s[0] +
                     h * p.v2_s[1] + row * p.v2_s[2] + c;
  const float ksc = p.ks2[b * p.ks2_s[0] + h * p.ks2_s[1] + j2];
  const float vsc = p.vs2[b * p.vs2_s[0] + h * p.vs2_s[1] + j2];
  dequant16(ld128(kr), ksc, p.mode2, high, kv[0], kv[1]);
  dequant16(ld128(vr), vsc, p.mode2, high, kv[2], kv[3]);
}

__global__ void __launch_bounds__(kThreads)
attention_kernel(const __grid_constant__ AttnParams p) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kLds];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;      // fragment row group
  const int tg = lane & 3;      // thread in group
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = p.S1 + p.S2;

  // ---- this warp's 16 query rows as mma A fragments (registers) ----------
  const int r0 = blockIdx.x * kBQ + warp * 16 + g;
  const int r1 = r0 + 8;
  const __nv_bfloat16* qb = p.q + b * p.q_s[0] + h * p.q_s[1];
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = r0 < p.T ? ld32(qb + r0 * p.q_s[2] + c) : 0u;
    qf[kk][1] = r1 < p.T ? ld32(qb + r1 * p.q_s[2] + c) : 0u;
    qf[kk][2] = r0 < p.T ? ld32(qb + r0 * p.q_s[2] + c + 8) : 0u;
    qf[kk][3] = r1 < p.T ? ld32(qb + r1 * p.q_s[2] + c + 8) : 0u;
  }

  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;   // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;         // running sum

  const float* brow = p.bias ? p.bias + (long long)b * S : nullptr;
  const __nv_bfloat16* k1b = p.k1 + b * p.k1_s[0] + h * p.k1_s[1];
  const __nv_bfloat16* v1b = p.v1 + b * p.v1_s[0] + h * p.v1_s[1];

  for (int j0 = 0; j0 < S; j0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    // ---- K/V tile -> shared memory, 16 values per step, zero past S -----
    // (a quantized second segment is dequantized here, on its way in)
    for (int i = tid; i < kBK * (kD / kChunk); i += kThreads) {
      const int r = i / (kD / kChunk);
      const int c = (i % (kD / kChunk)) * kChunk;
      const int j = j0 + r;
      uint4 kv[4] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0),
                     make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      if (j < p.S1) {
        const __nv_bfloat16* kr = k1b + j * p.k1_s[2] + c;
        const __nv_bfloat16* vr = v1b + j * p.v1_s[2] + c;
        kv[0] = ld128(kr);
        kv[1] = ld128(kr + 8);
        kv[2] = ld128(vr);
        kv[3] = ld128(vr + 8);
      } else if (j < S) {
        load_seg2(p, b, h, j - p.S1, c, kv);
      }
      *reinterpret_cast<uint4*>(&ks[r * kLds + c]) = kv[0];
      *reinterpret_cast<uint4*>(&ks[r * kLds + c + 8]) = kv[1];
      *reinterpret_cast<uint4*>(&vs[r * kLds + c]) = kv[2];
      *reinterpret_cast<uint4*>(&vs[r * kLds + c + 8]) = kv[3];
    }
    __syncthreads();

    // ---- logits: 16 rows x 64 keys per warp ------------------------------
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const __nv_bfloat16* kr = &ks[(nt * 8 + g) * kLds + kk * 16 + tg * 2];
        mma_bf16(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // ---- scale, bias, ragged-edge mask; online softmax --------------------
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + nt * 8 + tg * 2 + e;
        if (j < S) {
          const float bj = brow ? brow[j] : 0.f;
          s[nt][e] = s[nt][e] * p.scale + bj;
          s[nt][2 + e] = s[nt][2 + e] * p.scale + bj;
        } else {
          s[nt][e] = -INFINITY;
          s[nt][2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0);
    const float a1 = __expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = __expf(s[nt][e] - mn0);
        s[nt][2 + e] = __expf(s[nt][2 + e] - mn1);
        ls0 += s[nt][e];
        ls1 += s[nt][2 + e];
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
    for (int dt = 0; dt < kD / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // ---- O += P V: the logits' C fragments are P's A fragments -----------
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + tg * 2;
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const int col = dt * 8 + g;
        const uint32_t b0 =
            pack_raw(vs[key * kLds + col], vs[(key + 1) * kLds + col]);
        const uint32_t b1 =
            pack_raw(vs[(key + 8) * kLds + col], vs[(key + 9) * kLds + col]);
        mma_bf16(o[dt], pa, b0, b1);
      }
    }
  }

  // ---- normalise and store into [B, T, H*D] --------------------------------
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const long long row_stride = (long long)p.H * kD;
  __nv_bfloat16* ob = p.out + (long long)b * p.T * row_stride + h * kD;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (r0 < p.T)
      *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + c) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < p.T)
      *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + c) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

// strides: 19 element strides: (b, h, row) for q, k1, v1, k2, v2 in order,
// each in its tensor's own dtype, then (b, h) for the scales ks2, vs2.
// S2 == 0 runs the one-segment kernel (k2/v2 unused); S1 == 0 attends over
// the second segment alone.  mode2: 0 bf16 k2/v2, 1 int8 codes, 2 int4
// S-halves packed (S2 / 2 stored rows, S2 even); ks2/vs2 are the fp32 row
// scales [B, H, S2] of a quantized segment (null for bf16).  Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() of the launch.
extern "C" int regione_attention_fwd(const void* q, const void* k1,
                                     const void* v1, const void* k2,
                                     const void* v2, const void* ks2,
                                     const void* vs2, const void* bias,
                                     void* out, const long long* strides,
                                     int B, int H, int T, int S1, int S2,
                                     int mode2, float scale, void* stream) {
  AttnParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k1 = static_cast<const __nv_bfloat16*>(k1);
  p.v1 = static_cast<const __nv_bfloat16*>(v1);
  p.k2 = k2;
  p.v2 = v2;
  p.ks2 = static_cast<const float*>(ks2);
  p.vs2 = static_cast<const float*>(vs2);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  long long* dst[5] = {p.q_s, p.k1_s, p.v1_s, p.k2_s, p.v2_s};
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[i * 3 + j];
  for (int j = 0; j < 2; ++j) {
    p.ks2_s[j] = strides[15 + j];
    p.vs2_s[j] = strides[17 + j];
  }
  p.B = B;
  p.H = H;
  p.T = T;
  p.S1 = S1;
  p.S2 = S2;
  p.mode2 = mode2;
  p.scale = scale;
  if (mode2 < kBf16 || mode2 > kInt4 || (mode2 == kInt4 && S2 % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
