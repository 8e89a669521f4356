"""Fused adaptive partition K3: latents -> edited-token mask in one kernel.

`fused_partition` runs the hand-written CUDA kernel `csrc/partition.cu`
(`regione_partition_fwd`), which replaces the Pallas TPU kernel `_kernel`
of `regione_tpu/ops/partition_kernel.py`:

  cosine(x0, cond) = dot * rsqrt(|x|^2 |c|^2 + 1e-12) -> sim <= threshold
  -> 3x3-cross erosion -> 5x5-square dilation (out-of-grid cells are 0)
  -> bool mask [S]

The kernel takes any grid and any D, and a batch of images (a group of
requests, each with its own partition, as the JAX package runs the kernel
under `vmap`): one launch of a CTA per output tile of every image (8 x 8,
or 16 x 16 when the 8 x 8 tiles of all images pass one wave), each
thresholding its tile plus a 3-cell halo (see the source's note).  On a
CPU tensor `fused_partition` computes the plain PyTorch version
(`partition_reference`, the same formula); on a CUDA tensor it launches
the kernel or raises (`ops.launch`).  `fused_partition.launches` counts
kernel launches (one per call, whatever the batch), beside its `.host_ns`
and `.launch_ns` (`ops.launch.launch`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from regione_tpu_torch.ops import launch
from regione_tpu_torch.utils import telemetry


def remove_scattered_points(mask2d):
    """3x3-cross erosion, then 5x5-square dilation, of a [..., H, W] mask
    (each [H, W] map on its own); out-of-grid cells count as 0.  Returns
    bool [..., H, W]."""
    m = mask2d.float()
    p = F.pad(m, (1, 1, 1, 1))
    eroded = (m * p[..., :-2, 1:-1] * p[..., 2:, 1:-1] * p[..., 1:-1, :-2]
              * p[..., 1:-1, 2:])
    p = F.pad(eroded, (2, 2, 2, 2))
    h, w = m.shape[-2:]
    out = torch.zeros_like(m)
    for dy in range(5):
        for dx in range(5):
            out = torch.maximum(out, p[..., dy:dy + h, dx:dx + w])
    return out > 0.5


def partition_reference(x0, cond, threshold, grid_h, grid_w,
                        erosion_dilation=True):
    """Plain version of K3: x0, cond [S, D] or [B, S, D] -> bool [S] or
    [B, S], each image on its own."""
    x = x0.float()
    c = cond.float()
    dot = (x * c).sum(-1)
    nx = (x * x).sum(-1)
    nc = (c * c).sum(-1)
    sim = dot * torch.rsqrt(nx * nc + 1e-12)
    mask = sim <= threshold
    lead = mask.shape[:-1]
    if erosion_dilation:
        mask = remove_scattered_points(mask.reshape(*lead, grid_h, grid_w))
    return mask.reshape(*lead, -1)


def fused_partition(x0, cond, threshold, grid_h: int, grid_w: int,
                    erosion_dilation: bool = True):
    """K3: x0, cond [S, D] (batch squeezed) or [B, S, D] (one image per
    row), threshold a float -> bool [S] or [B, S], in one launch.
    CPU: plain version.  CUDA: the kernel (fp32, dense), or raises."""
    t0 = telemetry.clock()
    if not launch.on_card(x0, "partition"):
        return partition_reference(x0, cond, threshold, grid_h, grid_w,
                                   erosion_dilation)
    s = grid_h * grid_w
    for name, x in (("x0", x0), ("cond", cond)):
        if x.device != x0.device or x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes fp32 on {x0.device}, "
                            f"got {x.dtype} on {x.device}")
        if x.dim() not in (2, 3) or x.shape[-2] != s or \
                not x.is_contiguous():
            raise ValueError(f"{name}: needs a dense [{s}, D] or [B, {s}, D] "
                             f"tensor, got {tuple(x.shape)}")
    if cond.shape != x0.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} vs cond {tuple(cond.shape)}")
    batch = x0.shape[0] if x0.dim() == 3 else 1
    d = x0.shape[-1]
    out = torch.empty(x0.shape[:-1], dtype=torch.uint8, device=x0.device)
    launch.launch(fused_partition, t0, "regione_partition_fwd", x0.device,
                  x0.data_ptr(), cond.data_ptr(), float(threshold), grid_h,
                  grid_w, d, int(erosion_dilation), batch, s * d,
                  out.data_ptr())
    return out.view(torch.bool)


telemetry.register_counters(fused_partition)
