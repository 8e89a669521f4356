"""Pixel-space PSNR probe: the port of `regione_tpu/eval/pixelprobe.py`.

The reference measures PSNR on DECODED images (`evaluation/
metric_all_task.py:12-143` computes skimage PSNR over PNG pairs), while a
latent edit reports latent-space PSNR.  This module decodes both the dense
and the RegionE latents through the family-matched VAE decoder (production
topology, seeded random weights) and reports PSNR over the clipped [0, 1]
pixel buffers, peak 1.0 (the skimage `data_range` convention for float
images), and SSIM beside it.

The decoder is a deep nonlinear map shared by both inputs, so pixel PSNR
measures how the RegionE-vs-dense latent error propagates through convs,
norms and upsampling, which the latent number cannot say.  Absolute
fidelity against the reference's published 30.5-32.1 dB needs real
weights.

Memory: the probe runs right after the largest models, so only the
decoder's weights reach the device: the VAE is drawn on the host and its
encoder stays there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from regione_tpu_torch.eval.metrics import psnr, ssim


def _psnr01(a: np.ndarray, b: np.ndarray) -> float:
    return psnr(np.asarray(a), np.asarray(b), data_range=1.0)


def _ssim01(a: np.ndarray, b: np.ndarray) -> float:
    """Mean SSIM over a batch of [B, H, W, C] float images in [0, 1]
    (eval.metrics.ssim is skimage-faithful per image)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.mean([ssim(x, y, data_range=1.0)
                          for x, y in zip(a, b)]))


def decoder_for_family(family: str, seed: int = 0, device="cuda"):
    """(cfg, vae) of the production decoder of a model family.

    family: "flux" (AutoencoderKL — Step1X-Edit / FLUX.1-Kontext,
    models/vae.py) or "wan" (Wan 2.1 — Qwen-Image family,
    models/vae_wan.py).  Weights are seeded random (`torch.Generator` on
    the host) at the production topology, bf16; only `vae.decoder` is moved
    to `device`, the encoder stays on the host."""
    from regione_tpu_torch.eval import resolve_device
    from regione_tpu_torch.weights.from_jax import init_vae_params

    dev = resolve_device(device)
    if family == "wan":
        from regione_tpu_torch.models.vae_wan import WanVAEConfig as Config
    else:
        from regione_tpu_torch.models.vae import VAEConfig as Config
    cfg = Config(dtype=torch.bfloat16)
    vae = init_vae_params(cfg, torch.Generator().manual_seed(seed + 7),
                          device="cpu")
    vae.decoder.to(dev)
    return cfg, vae


def family_for_preset(preset: str) -> str:
    return "wan" if preset.startswith("qwen") else "flux"


@torch.inference_mode()
def decode_tokens(vae, tokens, grid_h: int, grid_w: int) -> np.ndarray:
    """Latent tokens [B, S, 4 * C_lat] -> [B, H, W, 3] fp32 images in
    [0, 1] on the host, decoded where `vae.decoder` lies."""
    from regione_tpu_torch.models.vae import unpack_latents

    dev = next(vae.decoder.parameters()).device
    z = unpack_latents(torch.as_tensor(np.asarray(tokens, np.float32)
                                       if not torch.is_tensor(tokens)
                                       else tokens).float().to(dev),
                       grid_h, grid_w)
    img = vae.decode(vae.denormalize_latents(z))
    img = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0)
    return img.permute(0, 2, 3, 1).cpu().numpy()


def pixel_psnr_vs_dense(out_dense, out_re, grid_h: int, grid_w: int,
                        family: str = "flux", seed: int = 0,
                        device="cuda") -> dict[str, Any]:
    """Decode both latents ([1, S, 4*C_lat] tokens, numpy or tensors) on
    `device` and PSNR the pixels.

    Returns {"psnr_pixel_vs_dense": float, "ssim_pixel_vs_dense": float,
    "pixel_decoder": str}, the JAX package's keys and rounding; raises on
    decode failure.  SSIM mirrors the reference's second pixel metric
    (evaluation/metric_all_task.py skimage SSIM over PNG pairs)."""
    cfg, vae = decoder_for_family(family, seed, device)
    img_d = decode_tokens(vae, out_dense, grid_h, grid_w)
    img_r = decode_tokens(vae, out_re, grid_h, grid_w)
    kind = "wan-2.1" if family == "wan" else "autoencoder-kl"
    dtype = {torch.bfloat16: "bf16", torch.float32: "fp32"}.get(
        cfg.dtype, str(cfg.dtype))
    return {
        "psnr_pixel_vs_dense": round(_psnr01(img_d, img_r), 2),
        "ssim_pixel_vs_dense": round(_ssim01(img_d, img_r), 4),
        "pixel_decoder": f"{kind} production topology, random weights, "
                         f"{dtype}, {img_d.shape[1]}x{img_d.shape[2]}px",
    }
