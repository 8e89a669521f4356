// The MMDiT blocks' elementwise chains, each in one pass over its rows:
//   K7 `fused_adaln_kernel`: AdaLN  layernorm(x) * (1 + scale) + shift,
//      optionally after the gated residual  x <- x + gate * y, or that
//      residual alone;
//   K8 `fused_qk_norm_rope_kernel`: qk-RMSNorm, interleaved RoPE and the
//      head-major packing of q / k (v: the packing alone) at a row offset;
//   K9 `fused_gelu_pack_kernel`: [attn ‖ gelu_tanh(mlp_h)] (or the GELU
//      alone);
//   K11 `fused_swiglu_pack_kernel`: [attn ‖ silu(a) * b] of h = [a ‖ b]
//      (or the gate alone): FLUX.2's SwiGLU MLP.
//
// None of them replaces a Pallas kernel.  The JAX package jits each
// sampler phase (regione_tpu/core/sampler.py:140-151), and inside those
// programs XLA fuses each of these fp32 chains into one loop fusion: the
// expressions at regione_tpu/models/mmdit.py:140-143, 171-172, 202-208,
// 238, 260-264, 286 and 558 over regione_tpu/models/layers.py:161-180 and
// 225-236.  Eager PyTorch runs every `.float()`, mean, rsqrt, mul, stack,
// cat and `.to()` of them as its own launch, each an fp32 round trip
// through device memory; these kernels are the port's counterpart of the
// fusions.
//
// Rounding: each kernel rounds to bf16 where the plain PyTorch version
// (regione_tpu_torch/ops/fused.py, the JAX expressions with bf16 operands)
// does, computes in fp32 in between with explicit `__fmul_rn` /
// `__fadd_rn` (no contraction into fmas the plain version does not do),
// so kernel and plain version differ only by the order of fp32 sums and
// by the device's rsqrt / tanh.  K7: gate * y, the new x, the LN output,
// 1 + scale, the product and the sum.  K8: the RMSNorm output, then the
// rotated value.  K9: the GELU output once.  K11: silu(a), then the
// product (F.silu and the bf16 multiply, each rounding once).
//
// What bounds them on an H100: bytes.  Each does a few flops per element
// (K8 about 10 per value), far below the ~20 flops a byte at which the
// fp32 units (67 TFLOP/s) would take longer than HBM (3.35 TB/s).  The
// least time is the bytes of the inputs read once and the outputs written
// once over 3.35 TB/s; at the headline's single block (B 2, 8320 rows,
// hidden 1536, 12 heads; [2, 8320, 1536] bf16 is 51 MB): K7 with the
// residual 4 x 51 MB = 61 us, K8 for q 51 + 51 MB plus the fp32 tables
// 8.5 MB = 33 us, K9 51 + 204 MB read and 256 MB written = 153 us.  The
// designs keep to one read of each input and one write of each output:
//   * K7: one warp per row, the row held in registers as packed bf16 (the
//     values the plain version rounds to, so nothing is lost): each lane
//     owns kChunks 16-byte chunks (8 values), so h = 1536 is 6 chunks a
//     lane, 3072 is 12 and FLUX.2's 6144 is 24.  The residual is added as
//     the chunks arrive; the mean and the variance are two passes over the
//     registers (as layers.layernorm and jnp.var compute them), each a
//     warp-shuffle reduction, then the modulation streams out.  The
//     modulation vectors (shift, scale, gate: [B, 1, h] views of
//     `_modulation`'s chunk, any batch stride) are read per row and stay
//     in L2.
//   * K8: 16 lanes per (row, head): a head's 128 values are 16 loads of
//     16 bytes, the RMSNorm a 16-lane xor-shuffle sum, and each lane's 8
//     values are 4 whole RoPE pairs, so the rotation needs no exchange.
//     Consecutive half-warps take consecutive heads of a row, so the reads
//     of the projection's row are coalesced whatever its stride (the fused
//     `linear1` split views), and each half-warp writes 256 contiguous
//     bytes of the head-major destination.  The RoPE tables are fp32 [S,
//     128] (batch stride 0) or [B, S, 128]; each (row, head) reads its
//     row's 1 KB of them, which the row's other heads find in L1 / L2.
//   * K9: one thread per 16-byte chunk of the output row: a chunk left of
//     `inner` is copied from the attention output, one right of it is the
//     GELU of the strided MLP half.  No stage in shared memory: every
//     chunk is read once and written once.
//   * K11: K9's layout, the GELU chunk replaced by the gate's: a thread
//     right of `inner` reads chunk j of a and chunk j of b (mlp columns
//     further along the same strided row), so a warp's loads of each
//     half are coalesced, every input byte is read once and the output
//     written once.  At FLUX.2's single block (8704 rows, inner 6144, mlp
//     18432) that is 107 + 642 MB read and 428 MB written: 351 us at
//     3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-6f;
constexpr int kAdalnWarps = 4;            // rows a CTA
constexpr int kMaxChunks = 24;            // h <= 24 * 256
constexpr int kHeadDim = 128;
constexpr int kHeadLanes = kHeadDim / 8;  // lanes a (row, head)
constexpr int kRopeThreads = 256;
constexpr int kGeluThreads = 256;
constexpr int kSwigluThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const auto* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  auto* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// K7: AdaLN with the gated residual
// ---------------------------------------------------------------------------

struct AdalnArgs {
  const bf16* x;       // [B, S, h], any batch / row stride
  const bf16* y;       // [B, S, h] or null (no residual)
  const bf16* gate;    // [B, 1, h] (batch stride gate_sb) or null
  const bf16* shift;   // [B, 1, h] or null (no AdaLN output)
  const bf16* scale;
  bf16* x_out;         // dense [B, S, h]: x + gate * y (residual modes)
  bf16* out;           // dense [B, S, h]: the AdaLN output, or null
  long long x_sb, x_ss, y_sb, y_ss, gate_sb, shift_sb, scale_sb;
  int batch, rows, h;
};

template <int kChunks>
__global__ void __launch_bounds__(kAdalnWarps * 32)
fused_adaln_kernel(const AdalnArgs a) {
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * kAdalnWarps + threadIdx.x / 32;
  if (row >= (long long)a.batch * a.rows) return;   // the whole warp
  const long long b = row / a.rows;
  const long long s = row % a.rows;
  const long long dense = row * a.h;
  const bf16* xr = a.x + b * a.x_sb + s * a.x_ss;
  uint4 v[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = 8 * (lane + 32 * j);
    if (c < a.h) v[j] = load16(xr + c);
  }
  if (a.y != nullptr) {
    const bf16* yr = a.y + b * a.y_sb + s * a.y_ss;
    const bf16* g = a.gate + b * a.gate_sb;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = 8 * (lane + 32 * j);
      if (c < a.h) {
        float xf[8], yf[8], gf[8];
        unpack(v[j], xf);
        unpack(load16(yr + c), yf);
        unpack(load16(g + c), gf);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xf[i] = __fadd_rn(xf[i], round_bf16(__fmul_rn(gf[i], yf[i])));
        v[j] = pack(xf);
        store16(a.x_out + dense + c, v[j]);
      }
    }
  }
  if (a.out == nullptr) return;
  const float inv_h = 1.0f / a.h;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (8 * (lane + 32 * j) < a.h) {
      float f[8];
      unpack(v[j], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += f[i];
    }
  }
  const float mu = warp_sum(sum) * inv_h;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (8 * (lane + 32 * j) < a.h) {
      float f[8];
      unpack(v[j], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = __fsub_rn(f[i], mu);
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_h + kEps);
  const bf16* sh = a.shift + b * a.shift_sb;
  const bf16* sc = a.scale + b * a.scale_sb;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = 8 * (lane + 32 * j);
    if (c < a.h) {
      float f[8], shf[8], scf[8];
      unpack(v[j], f);
      unpack(load16(sh + c), shf);
      unpack(load16(sc + c), scf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float n = round_bf16(__fmul_rn(__fsub_rn(f[i], mu), rstd));
        const float one_scale = round_bf16(__fadd_rn(1.0f, scf[i]));
        f[i] = __fadd_rn(round_bf16(__fmul_rn(n, one_scale)), shf[i]);
      }
      store16(a.out + dense + c, pack(f));
    }
  }
}

template <int kChunks>
void launch_adaln(const AdalnArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.batch * a.rows;
  const long long blocks = (rows + kAdalnWarps - 1) / kAdalnWarps;
  fused_adaln_kernel<kChunks>
      <<<(unsigned)blocks, kAdalnWarps * 32, 0, stream>>>(a);
}

// ---------------------------------------------------------------------------
// K8: qk-RMSNorm + interleaved RoPE + head-major packing
// ---------------------------------------------------------------------------

struct RopeArgs {
  const bf16* x;       // [B, S, H * 128], any batch / row stride
  const bf16* scale;   // [128] RMSNorm scale, or null (no norm)
  const float* cos;    // [S, 128] or [B, S, 128] fp32, or null (no RoPE)
  const float* sin;
  bf16* out;           // [B, H, S, 128] strided, already at the row offset
  long long x_sb, x_ss, rope_sb, rope_ss, out_sb, out_sh, out_ss;
  int batch, rows, heads;
};

__global__ void __launch_bounds__(kRopeThreads)
fused_qk_norm_rope_kernel(const RopeArgs a) {
  const int lane = threadIdx.x % kHeadLanes;
  const long long n = (long long)a.batch * a.rows * a.heads;
  const long long item = (long long)blockIdx.x * (kRopeThreads / kHeadLanes)
      + threadIdx.x / kHeadLanes;
  // a lane past the end repeats the last item (its 16-lane shuffles need
  // every lane of the warp) and stores nothing
  const long long it = item < n ? item : n - 1;
  const long long head = it % a.heads;
  const long long r = it / a.heads;
  const long long b = r / a.rows;
  const long long s = r % a.rows;
  const int c = 8 * lane;
  float f[8];
  unpack(load16(a.x + b * a.x_sb + s * a.x_ss + head * kHeadDim + c), f);
  if (a.scale != nullptr) {
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += f[i] * f[i];
#pragma unroll
    for (int off = kHeadLanes / 2; off >= 1; off /= 2)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rs = rsqrtf(sq * (1.0f / kHeadDim) + kEps);
    float g[8];
    unpack(load16(a.scale + c), g);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = round_bf16(__fmul_rn(__fmul_rn(f[i], rs), g[i]));
  }
  if (a.cos != nullptr) {
    const long long t = b * a.rope_sb + s * a.rope_ss + c;
    const float4 c0 = *reinterpret_cast<const float4*>(a.cos + t);
    const float4 c1 = *reinterpret_cast<const float4*>(a.cos + t + 4);
    const float4 s0 = *reinterpret_cast<const float4*>(a.sin + t);
    const float4 s1 = *reinterpret_cast<const float4*>(a.sin + t + 4);
    const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    // pair (x[2i], x[2i+1]) -> (x[2i] cos - x[2i+1] sin,
    //                           x[2i+1] cos + x[2i] sin)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float e = f[2 * p], o = f[2 * p + 1];
      f[2 * p] = __fadd_rn(__fmul_rn(e, cs[2 * p]), __fmul_rn(-o, sn[2 * p]));
      f[2 * p + 1] = __fadd_rn(__fmul_rn(o, cs[2 * p + 1]),
                               __fmul_rn(e, sn[2 * p + 1]));
    }
  }
  if (item < n)
    store16(a.out + b * a.out_sb + head * a.out_sh + s * a.out_ss + c,
            pack(f));
}

// ---------------------------------------------------------------------------
// K9: [attn ‖ gelu_tanh(mlp_h)]
// ---------------------------------------------------------------------------

struct GeluArgs {
  const bf16* attn;    // [B, S, inner] or null (inner 0: the GELU alone)
  const bf16* h;       // [B, S, mlp], any batch / row stride
  bf16* out;           // dense [B, S, inner + mlp]
  long long attn_sb, attn_ss, h_sb, h_ss;
  int batch, rows, inner, mlp;
};

// PyTorch's tanh-approximate GELU (F.gelu(approximate="tanh")) in fp32
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.0f + tanhf(inner));
}

__global__ void __launch_bounds__(kGeluThreads)
fused_gelu_pack_kernel(const GeluArgs a) {
  const int width = a.inner + a.mlp;
  const int chunks = width / 8;
  const long long t = (long long)blockIdx.x * kGeluThreads + threadIdx.x;
  if (t >= (long long)a.batch * a.rows * chunks) return;
  const long long r = t / chunks;
  const int c = 8 * (int)(t % chunks);
  const long long b = r / a.rows;
  const long long s = r % a.rows;
  bf16* o = a.out + r * width + c;
  if (c < a.inner) {
    store16(o, load16(a.attn + b * a.attn_sb + s * a.attn_ss + c));
    return;
  }
  float f[8];
  unpack(load16(a.h + b * a.h_sb + s * a.h_ss + (c - a.inner)), f);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = gelu_tanh(f[i]);
  store16(o, pack(f));
}

// ---------------------------------------------------------------------------
// K11: [attn ‖ silu(a) * b]
// ---------------------------------------------------------------------------

struct SwigluArgs {
  const bf16* attn;    // [B, S, inner] or null (inner 0: the gate alone)
  const bf16* h;       // [B, S, 2 * mlp] = [a ‖ b], any batch / row stride
  bf16* out;           // dense [B, S, inner + mlp]
  long long attn_sb, attn_ss, h_sb, h_ss;
  int batch, rows, inner, mlp;
};

// PyTorch's silu (x / (1 + exp(-x)) in fp32) rounded to bf16, times b:
// F.silu(a) * b on bf16 tensors, before the product's own rounding
__device__ __forceinline__ float swiglu(float a, float b) {
  const float s = round_bf16(__fdiv_rn(a, __fadd_rn(1.0f, expf(-a))));
  return __fmul_rn(s, b);
}

__global__ void __launch_bounds__(kSwigluThreads)
fused_swiglu_pack_kernel(const SwigluArgs a) {
  const int width = a.inner + a.mlp;
  const int chunks = width / 8;
  const long long t = (long long)blockIdx.x * kSwigluThreads + threadIdx.x;
  if (t >= (long long)a.batch * a.rows * chunks) return;
  const long long r = t / chunks;
  const int c = 8 * (int)(t % chunks);
  const long long b = r / a.rows;
  const long long s = r % a.rows;
  bf16* o = a.out + r * width + c;
  if (c < a.inner) {
    store16(o, load16(a.attn + b * a.attn_sb + s * a.attn_ss + c));
    return;
  }
  const bf16* hr = a.h + b * a.h_sb + s * a.h_ss + (c - a.inner);
  float fa[8], fb[8];
  unpack(load16(hr), fa);
  unpack(load16(hr + a.mlp), fb);
#pragma unroll
  for (int i = 0; i < 8; ++i) fa[i] = swiglu(fa[i], fb[i]);
  store16(o, pack(fa));
}

}  // namespace

// strides: x_sb, x_ss, y_sb, y_ss, gate_sb, shift_sb, scale_sb (elements).
// Modes: y, gate and x_out all given (residual) or all null; shift, scale
// and out all given (AdaLN) or all null; at least one of the two.
extern "C" int regione_adaln_fwd(const void* x, const void* y,
                                 const void* gate, const void* shift,
                                 const void* scale, void* x_out, void* out,
                                 const long long* strides, int batch,
                                 int rows, int h, void* stream) {
  const bool residual = y != nullptr;
  const bool ln = out != nullptr;
  if (batch < 1 || rows < 1 || h < 8 || h % 8 || h > kMaxChunks * 256 ||
      (gate != nullptr) != residual || (x_out != nullptr) != residual ||
      (shift != nullptr) != ln || (scale != nullptr) != ln ||
      !(residual || ln))
    return static_cast<int>(cudaErrorInvalidValue);
  AdalnArgs a;
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<const bf16*>(y);
  a.gate = static_cast<const bf16*>(gate);
  a.shift = static_cast<const bf16*>(shift);
  a.scale = static_cast<const bf16*>(scale);
  a.x_out = static_cast<bf16*>(x_out);
  a.out = static_cast<bf16*>(out);
  a.x_sb = strides[0];
  a.x_ss = strides[1];
  a.y_sb = strides[2];
  a.y_ss = strides[3];
  a.gate_sb = strides[4];
  a.shift_sb = strides[5];
  a.scale_sb = strides[6];
  a.batch = batch;
  a.rows = rows;
  a.h = h;
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte chunks a lane: the presets' widths (h 1536: 6, h 3072: 12,
  // FLUX.2's h 6144: 24), and any other h up to 6144 in the next wider
  // instantiation
  const int chunks = (h / 8 + 31) / 32;
  if (chunks <= 6) launch_adaln<6>(a, s);
  else if (chunks <= 12) launch_adaln<12>(a, s);
  else if (chunks <= 16) launch_adaln<16>(a, s);
  else launch_adaln<kMaxChunks>(a, s);
  return static_cast<int>(cudaGetLastError());
}

// strides: x_sb, x_ss, rope_sb, rope_ss, out_sb, out_sh, out_ss (elements).
// scale null: no RMSNorm; cos / sin null: no RoPE (both null: v's packing).
extern "C" int regione_qk_norm_rope_fwd(const void* x, const void* scale,
                                        const void* cos, const void* sin,
                                        void* out, const long long* strides,
                                        int batch, int rows, int heads,
                                        void* stream) {
  if (batch < 1 || rows < 1 || heads < 1 ||
      (cos == nullptr) != (sin == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RopeArgs a;
  a.x = static_cast<const bf16*>(x);
  a.scale = static_cast<const bf16*>(scale);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.out = static_cast<bf16*>(out);
  a.x_sb = strides[0];
  a.x_ss = strides[1];
  a.rope_sb = strides[2];
  a.rope_ss = strides[3];
  a.out_sb = strides[4];
  a.out_sh = strides[5];
  a.out_ss = strides[6];
  a.batch = batch;
  a.rows = rows;
  a.heads = heads;
  const long long items = (long long)batch * rows * heads;
  const long long per_block = kRopeThreads / kHeadLanes;
  const long long blocks = (items + per_block - 1) / per_block;
  fused_qk_norm_rope_kernel<<<(unsigned)blocks, kRopeThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// strides: attn_sb, attn_ss, h_sb, h_ss (elements).  attn null: inner 0.
extern "C" int regione_gelu_pack_fwd(const void* attn, const void* h,
                                     void* out, const long long* strides,
                                     int batch, int rows, int inner, int mlp,
                                     void* stream) {
  if (batch < 1 || rows < 1 || inner < 0 || inner % 8 || mlp < 8 ||
      mlp % 8 || (attn == nullptr) != (inner == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  GeluArgs a;
  a.attn = static_cast<const bf16*>(attn);
  a.h = static_cast<const bf16*>(h);
  a.out = static_cast<bf16*>(out);
  a.attn_sb = strides[0];
  a.attn_ss = strides[1];
  a.h_sb = strides[2];
  a.h_ss = strides[3];
  a.batch = batch;
  a.rows = rows;
  a.inner = inner;
  a.mlp = mlp;
  const long long total = (long long)batch * rows * ((inner + mlp) / 8);
  const long long blocks = (total + kGeluThreads - 1) / kGeluThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fused_gelu_pack_kernel<<<(unsigned)blocks, kGeluThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// strides: attn_sb, attn_ss, h_sb, h_ss (elements).  attn null: inner 0.
// h holds 2 * mlp columns: a, then b.
extern "C" int regione_swiglu_pack_fwd(const void* attn, const void* h,
                                       void* out, const long long* strides,
                                       int batch, int rows, int inner,
                                       int mlp, void* stream) {
  if (batch < 1 || rows < 1 || inner < 0 || inner % 8 || mlp < 8 ||
      mlp % 8 || (attn == nullptr) != (inner == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  SwigluArgs a;
  a.attn = static_cast<const bf16*>(attn);
  a.h = static_cast<const bf16*>(h);
  a.out = static_cast<bf16*>(out);
  a.attn_sb = strides[0];
  a.attn_ss = strides[1];
  a.h_sb = strides[2];
  a.h_ss = strides[3];
  a.batch = batch;
  a.rows = rows;
  a.inner = inner;
  a.mlp = mlp;
  const long long total = (long long)batch * rows * ((inner + mlp) / 8);
  const long long blocks = (total + kSwigluThreads - 1) / kSwigluThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fused_swiglu_pack_kernel<<<(unsigned)blocks, kSwigluThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
