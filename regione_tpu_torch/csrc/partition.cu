// Fused adaptive partition K3: latents -> edited-token mask in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` of
// regione_tpu/ops/partition_kernel.py (via `fused_partition`):
//   sim = dot(x, c) * rsqrt(|x|^2 |c|^2 + 1e-12)   per token, fp32
//   mask = sim <= threshold
//   optional 3x3-cross erosion then 5x5-square dilation, out-of-grid = 0
//   -> uint8 0/1 [S], S = grid_h * grid_w
// for each of a batch of images in the same launch (a group of requests,
// each with its own partition: the JAX package runs the kernel under `vmap`
// over them).
//
// What bounds it on an H100: bytes, 2 * S * d * 4 read and S written (2 MB
// at a 64 x 64 grid of d = 64: 0.6 us at 3.35 TB/s); at the grids of real
// images, in practice, the launch and one round trip to memory.  The design
// spreads the work over the card and keeps to one round trip:
// - One CTA per output tile, a launch of ceil(gw / TW) x ceil(gh / TH) x B
//   CTAs: blockIdx.z is the image, whose inputs start `stride` floats past
//   the previous image's and whose mask starts S bytes past it.  Images
//   share nothing, so the batch only adds CTAs.  With morphology a CTA thresholds its tile plus a halo of 3 cells
//   (1 for the erosion, 2 for the dilation), erodes the tile plus 2, and
//   dilates the tile; without, it thresholds the tile alone.  Window cells
//   outside the grid are 0 (the zero padding of `lax.conv` 'same').  The
//   byte maps live in static shared memory sized by the tile (at most 884
//   bytes), never by S, so no grid is too large.
// - The tile adapts to the grid and the batch.  8 x 8 tiles while those of
//   all B images fit in one wave (kOneWave CTAs: two 512-thread CTAs on each
//   of an H100's 132 SMs; 64 an image at grid 64), which spreads small grids
//   over the most SMs; past that 16 x 16
//   tiles, which cut the halo's rereads (mostly from L2) from 3.1x the
//   tile's tokens to 1.9x, the cost that sets the pace at large grids.
// - Memory-level parallelism instead of a serial walk: 16 lanes reduce one
//   token (16 x float4 cover a d = 64 row), and each lane group issues the
//   loads of its next kBatch tokens before it reduces any.  kBatch 4 keeps
//   a CTA at 64 registers a thread, so two CTAs share an SM.  Rows with
//   d % 4 != 0 or pointers off 16 bytes take the same loop with scalar
//   loads.
// - Halo consistency: a token's arithmetic depends on the token alone.
//   Lane l of its group sums elements (float4 chunks) l, l + 16, ... in
//   order with explicit fmas, then a fixed xor tree over the 16 lanes, so
//   every CTA whose window holds the token, of either tile size, reaches
//   the same decision, and one tile's morphology agrees with its
//   neighbours'.  So an image's mask does not depend on the batch it came
//   in (nor on the tile size the batch picked): bit for bit its B = 1
//   mask.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 3;                     // erosion 1 + dilation 2
constexpr int kThreads = 512;
constexpr int kGroup = 16;                   // lanes that reduce one token
constexpr int kGroups = kThreads / kGroup;
constexpr int kBatch = 4;                    // tokens a group loads at once
constexpr long long kOneWave = 2 * 132;      // 8 x 8 tiles up to this many

__device__ __forceinline__ void accumulate(float a, float c, float& dot,
                                           float& nx, float& nc) {
  dot = __fmaf_rn(a, c, dot);
  nx = __fmaf_rn(a, a, nx);
  nc = __fmaf_rn(c, c, nc);
}

// Threshold decisions for the win_h x win_w window whose corner is grid
// cell (row0, col0), into mask (row stride kStride).  kVec: rows are read
// as float4 (d % 4 == 0, both base pointers on 16 bytes).
template <int kStride, bool kVec>
__device__ void threshold_window(const float* __restrict__ x0,
                                 const float* __restrict__ cond,
                                 float threshold, int grid_h, int grid_w,
                                 int d, int row0, int col0, int win_h,
                                 int win_w, uint8_t* mask) {
  const int lane = threadIdx.x % kGroup;
  const int group = threadIdx.x / kGroup;
  const int n_win = win_h * win_w;
  const int units = kVec ? d / 4 : d;        // loads per row
  // every thread runs the same number of rounds: the shuffles below need
  // all 32 lanes of a warp
  for (int round = 0; round < n_win; round += kGroups * kBatch) {
    long long row[kBatch];                   // row offset in loads
    bool in[kBatch];
    float dot[kBatch], nx[kBatch], nc[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int w = round + u * kGroups + group;
      const int y = row0 + w / win_w;
      const int x = col0 + w % win_w;
      in[u] = w < n_win && y >= 0 && y < grid_h && x >= 0 && x < grid_w;
      row[u] = in[u] ? ((long long)y * grid_w + x) * units : 0;
      dot[u] = nx[u] = nc[u] = 0.f;
    }
    for (int k = lane; k < units; k += kGroup) {
      if constexpr (kVec) {
        const float4* xv = reinterpret_cast<const float4*>(x0);
        const float4* cv = reinterpret_cast<const float4*>(cond);
        float4 a[kBatch], c[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {   // all loads first
          a[u] = in[u] ? __ldg(xv + row[u] + k) : make_float4(0, 0, 0, 0);
          c[u] = in[u] ? __ldg(cv + row[u] + k) : make_float4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          accumulate(a[u].x, c[u].x, dot[u], nx[u], nc[u]);
          accumulate(a[u].y, c[u].y, dot[u], nx[u], nc[u]);
          accumulate(a[u].z, c[u].z, dot[u], nx[u], nc[u]);
          accumulate(a[u].w, c[u].w, dot[u], nx[u], nc[u]);
        }
      } else {
        float a[kBatch], c[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          a[u] = in[u] ? __ldg(x0 + row[u] + k) : 0.f;
          c[u] = in[u] ? __ldg(cond + row[u] + k) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          accumulate(a[u], c[u], dot[u], nx[u], nc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off, kGroup);
        nx[u] += __shfl_xor_sync(0xffffffffu, nx[u], off, kGroup);
        nc[u] += __shfl_xor_sync(0xffffffffu, nc[u], off, kGroup);
      }
      const int w = round + u * kGroups + group;
      if (lane == 0 && w < n_win) {
        const float sim = dot[u] * rsqrtf(__fmaf_rn(nx[u], nc[u], 1e-12f));
        mask[(w / win_w) * kStride + w % win_w] = in[u] && sim <= threshold;
      }
    }
  }
}

// Two CTAs an SM (at most 64 registers a thread): the batch's stride and
// image offset otherwise take ptxas to 86 registers on the float4 path and
// one CTA an SM, 0.0179 against 0.0142 ms at 256 x 256
// (scripts/torch_partition_variants.py, "min_blocks_2").
template <int kTileH, int kTileW, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
partition_kernel(const float* __restrict__ x0, const float* __restrict__ cond,
                 float threshold, int grid_h, int grid_w, int d,
                 int erosion_dilation, long long stride,
                 uint8_t* __restrict__ out) {
  constexpr int kWinH = kTileH + 2 * kHalo;  // thresholded window
  constexpr int kWinW = kTileW + 2 * kHalo;
  constexpr int kEroH = kTileH + 4;          // eroded cells around the tile
  constexpr int kEroW = kTileW + 4;
  __shared__ uint8_t mask[kWinH * kWinW];
  __shared__ uint8_t eroded[kEroH * kEroW];
  x0 += blockIdx.z * stride;                 // this CTA's image
  cond += blockIdx.z * stride;
  out += blockIdx.z * ((long long)grid_h * grid_w);
  const int i0 = blockIdx.y * kTileH;        // the tile's first grid cell
  const int j0 = blockIdx.x * kTileW;
  const int halo = erosion_dilation ? kHalo : 0;
  threshold_window<kWinW, kVec>(x0, cond, threshold, grid_h, grid_w, d,
                                i0 - halo, j0 - halo, kTileH + 2 * halo,
                                kTileW + 2 * halo, mask);
  __syncthreads();

  if (!erosion_dilation) {
    for (int t = threadIdx.x; t < kTileH * kTileW; t += kThreads) {
      const int i = i0 + t / kTileW, j = j0 + t % kTileW;
      if (i < grid_h && j < grid_w)
        out[(long long)i * grid_w + j] = mask[(t / kTileW) * kWinW
                                              + t % kTileW];
    }
    return;
  }
  // 3x3 cross erosion: the cell and its four neighbours must all be set.
  // Eroded cell (ey, ex) is window cell (ey + 1, ex + 1); cells outside the
  // grid are 0 in the window, so they erode to 0
  for (int t = threadIdx.x; t < kEroH * kEroW; t += kThreads) {
    const uint8_t* m = mask + (t / kEroW + 1) * kWinW + t % kEroW + 1;
    eroded[t] = m[0] & m[-kWinW] & m[kWinW] & m[-1] & m[1];
  }
  __syncthreads();
  // 5x5 square dilation: any set cell in the window; output (oy, ox) is
  // eroded cell (oy + 2, ox + 2)
  for (int t = threadIdx.x; t < kTileH * kTileW; t += kThreads) {
    const int oy = t / kTileW, ox = t % kTileW;
    const int i = i0 + oy, j = j0 + ox;
    if (i >= grid_h || j >= grid_w) continue;
    uint8_t v = 0;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) v |= eroded[(oy + dy) * kEroW + ox + dx];
    out[(long long)i * grid_w + j] = v;
  }
}

template <int kTileH, int kTileW>
void launch(const float* x0, const float* cond, float threshold, int grid_h,
            int grid_w, int d, int erosion_dilation, int batch,
            long long stride, uint8_t* out, bool vec, cudaStream_t stream) {
  const dim3 grid((grid_w + kTileW - 1) / kTileW,
                  (grid_h + kTileH - 1) / kTileH, batch);
  if (vec)
    partition_kernel<kTileH, kTileW, true><<<grid, kThreads, 0, stream>>>(
        x0, cond, threshold, grid_h, grid_w, d, erosion_dilation, stride,
        out);
  else
    partition_kernel<kTileH, kTileW, false><<<grid, kThreads, 0, stream>>>(
        x0, cond, threshold, grid_h, grid_w, d, erosion_dilation, stride,
        out);
}

}  // namespace

// x0, cond: fp32 [batch, grid_h * grid_w, d], image b starting b * stride
// floats in (stride >= grid_h * grid_w * d; dense rows).  out: uint8
// [batch, grid_h * grid_w].  Any grid, any d >= 1, 1 <= batch <= 65535;
// float4 loads where d and stride are multiples of 4 and both inputs lie
// on 16 bytes.  One launch.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a batch the launch cannot hold.
extern "C" int regione_partition_fwd(const void* x0, const void* cond,
                                     float threshold, int grid_h, int grid_w,
                                     int d, int erosion_dilation, int batch,
                                     long long stride, void* out,
                                     void* stream) {
  if (batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && stride % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(cond))
       & 15) == 0;
  const auto* x = static_cast<const float*>(x0);
  const auto* c = static_cast<const float*>(cond);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long small_tiles =
      (long long)((grid_h + 7) / 8) * ((grid_w + 7) / 8) * batch;
  if (small_tiles <= kOneWave)
    launch<8, 8>(x, c, threshold, grid_h, grid_w, d, erosion_dilation, batch,
                 stride, o, vec, s);
  else
    launch<16, 16>(x, c, threshold, grid_h, grid_w, d, erosion_dilation,
                   batch, stride, o, vec, s);
  return static_cast<int>(cudaGetLastError());
}
