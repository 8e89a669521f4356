// Fused adaptive partition: latents -> edited-token mask in one kernel.
//
// Replaces the Pallas TPU kernel `_kernel` of
// regione_tpu/ops/partition_kernel.py (via `fused_partition`):
//   sim = dot(x, c) * rsqrt(|x|^2 |c|^2 + 1e-12)   per token, fp32
//   mask = sim <= threshold
//   optional 3x3-cross erosion then 5x5-square dilation, out-of-grid = 0
//   -> uint8 0/1 [S], S = grid_h * grid_w
//
// What bounds it on an H100: nothing of the card's size.  It runs once per
// edit over at most 4096 tokens of 64 fp32 (2 MB read), so it is bound by
// launch latency and one CTA's memory latency.  The design keeps it to one
// launch: one CTA per image, a warp per token for the reductions, and the
// 0/1 maps of the two morphology passes in shared memory (2 bytes a token),
// zero padded at the grid's edge, the same formula as the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
partition_kernel(const float* __restrict__ x0, const float* __restrict__ cond,
                 float threshold, int grid_h, int grid_w, int d,
                 int erosion_dilation, uint8_t* __restrict__ out) {
  extern __shared__ uint8_t smem[];
  const int S = grid_h * grid_w;
  uint8_t* mask = smem;
  uint8_t* eroded = smem + S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int t = warp; t < S; t += n_warps) {
    const float* xr = x0 + (long long)t * d;
    const float* cr = cond + (long long)t * d;
    float dot = 0.f, nx = 0.f, nc = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float a = xr[i];
      const float c = cr[i];
      dot += a * c;
      nx += a * a;
      nc += c * c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
      nx += __shfl_xor_sync(0xffffffffu, nx, off);
      nc += __shfl_xor_sync(0xffffffffu, nc, off);
    }
    if (lane == 0) mask[t] = (dot * rsqrtf(nx * nc + 1e-12f)) <= threshold;
  }
  __syncthreads();

  if (!erosion_dilation) {
    for (int t = threadIdx.x; t < S; t += blockDim.x) out[t] = mask[t];
    return;
  }
  // 3x3 cross erosion: the cell and its four neighbours must all be set
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    const int i = t / grid_w;
    const int j = t - i * grid_w;
    uint8_t v = mask[t];
    v &= i > 0 ? mask[t - grid_w] : 0;
    v &= i < grid_h - 1 ? mask[t + grid_w] : 0;
    v &= j > 0 ? mask[t - 1] : 0;
    v &= j < grid_w - 1 ? mask[t + 1] : 0;
    eroded[t] = v;
  }
  __syncthreads();
  // 5x5 square dilation: any set cell in the window
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    const int i = t / grid_w;
    const int j = t - i * grid_w;
    uint8_t v = 0;
    for (int dy = -2; dy <= 2; ++dy) {
      const int y = i + dy;
      if (y < 0 || y >= grid_h) continue;
      for (int dx = -2; dx <= 2; ++dx) {
        const int x = j + dx;
        if (x >= 0 && x < grid_w) v |= eroded[y * grid_w + x];
      }
    }
    out[t] = v;
  }
}

}  // namespace

// x0, cond: fp32 [grid_h * grid_w, d], dense.  out: uint8 [grid_h * grid_w].
// Needs 2 * S bytes of shared memory (S <= 24576).  Returns cudaGetLastError().
extern "C" int regione_partition_fwd(const void* x0, const void* cond,
                                     float threshold, int grid_h, int grid_w,
                                     int d, int erosion_dilation, void* out,
                                     void* stream) {
  const int S = grid_h * grid_w;
  partition_kernel<<<1, kThreads, 2 * S, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(cond),
      threshold, grid_h, grid_w, d, erosion_dilation,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
