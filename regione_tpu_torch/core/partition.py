"""Adaptive region partition: edited/unedited token selection.

Counterpart of `regione_tpu/core/partition.py`: per-token similarity of the
one-step x0 estimate to the condition latent, a threshold, and the
scattered-point cleanup (3x3-cross erosion, 5x5-square dilation, zero
padded; `ops.partition_kernel.remove_scattered_points`), giving a bool mask
[S] over the noise tokens.  `select_edited_masks` gives one mask per image
of a batch of requests ([B, S]), as the JAX package's `select_edited_mask`
does under `vmap`.  Cosine similarity goes through the fused partition
kernel K3 (`ops.partition_kernel`: one launch for the whole batch), which
takes the plain path for CPU tensors; the other four kinds run in PyTorch.
"""

from __future__ import annotations

import torch

from regione_tpu_torch.ops.partition_kernel import (fused_partition,
                                                    remove_scattered_points)


def token_similarity(x, ref, kind: str = "cosine"):
    """Per-token similarity of two [B, S, D] tensors -> [B, S], fp32.
    "euclidean" rescales by each image's own min and max (the JAX function
    sees one image at a time: batch 1, or one request under `vmap`)."""
    x = x.float()
    ref = ref.float()
    if kind == "cosine":
        xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
        rn = ref * torch.rsqrt((ref * ref).sum(-1, keepdim=True) + 1e-12)
        return (xn * rn).sum(-1)
    if kind == "dot":
        return (x * ref).sum(-1)
    if kind == "euclidean":
        s = -torch.sqrt(((x - ref) ** 2).sum(-1))
        lo = s.amin(-1, keepdim=True)
        return (s - lo) / (s.amax(-1, keepdim=True) - lo + 1e-12)
    if kind == "mse":
        return -((x - ref) ** 2).mean(-1)
    if kind == "diff_std":
        return torch.std(x - ref, dim=-1, unbiased=False)
    raise ValueError(f"unknown similarity kind {kind!r}")


def select_edited_masks(x0_estimate, condition_latent, threshold: float, *,
                        grid_h: int, grid_w: int,
                        erosion_dilation: bool = True,
                        similarity_type: str = "cosine"):
    """Edited-token masks [B, S] (True = edited), one per image, from the
    x0 estimates and the condition latents, both [B, S, D]."""
    if similarity_type == "cosine":
        return fused_partition(x0_estimate.float().contiguous(),
                               condition_latent.float().contiguous(),
                               threshold, grid_h, grid_w, erosion_dilation)
    mask = token_similarity(x0_estimate, condition_latent,
                            similarity_type) <= threshold
    if erosion_dilation:
        b = mask.shape[0]
        mask = remove_scattered_points(mask.reshape(b, grid_h, grid_w)
                                       ).reshape(b, -1)
    return mask


def select_edited_mask(x0_estimate, condition_latent, threshold: float, *,
                       grid_h: int, grid_w: int, erosion_dilation: bool = True,
                       similarity_type: str = "cosine"):
    """Edited-token mask [S] (True = edited) from the x0 estimate and the
    condition latent, both [B, S, D] with batch 1 semantics (the first
    image decides)."""
    return select_edited_masks(
        x0_estimate[:1], condition_latent[:1], threshold, grid_h=grid_h,
        grid_w=grid_w, erosion_dilation=erosion_dilation,
        similarity_type=similarity_type)[0]
