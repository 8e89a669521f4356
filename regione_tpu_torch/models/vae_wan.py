"""Wan 2.1 VAE (Qwen-Image family), single-frame image path, in PyTorch.

Counterpart of `regione_tpu/models/vae_wan.py`.  Qwen-Image-Edit ships a
causal-3D video VAE but only ever encodes one still frame; for one frame
each causal 3-D kernel reduces to its last temporal tap, so the model runs
as plain 2-D convs (the JAX package's converter folds the kernels, and
`weights.from_jax.vae_from_jax` takes its param pytree).  NCHW, OIHW conv
weights, names mirroring the JAX pytree.  Against the AutoencoderKL
(`models/vae.py`):
  * RMS norms over channels: x / max(||x||_2, 1e-12) * sqrt(C) * gamma,
    in fp32 (`RMSNorm`, {"gamma"});
  * the mid-block attention has one fused qkv projection, then "proj";
  * the encoder ends with a 1x1 `quant_conv`, the decoder starts with a
    1x1 `post_quant_conv`, and each decoder upsample conv halves the
    channels;
  * latents are normalised per channel: (z - latents_mean) / latents_std.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from regione_tpu_torch.models.vae import (AutoencoderKL, Level, MidBlock,
                                          ResnetBlock, from_tokens,
                                          make_conv, spatial_attention,
                                          to_tokens)

# Wan 2.1 VAE defaults (diffusers AutoencoderKLWan config for Qwen-Image)
_WAN_LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
_WAN_LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    in_channels: int = 3
    latent_channels: int = 16       # z_dim
    base_dim: int = 96
    dim_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    latents_mean: tuple = _WAN_LATENTS_MEAN
    latents_std: tuple = _WAN_LATENTS_STD
    dtype: Any = torch.float32

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @property
    def encoder_dims(self) -> list[int]:
        return [self.base_dim * m for m in (1,) + tuple(self.dim_mult)]

    @property
    def decoder_dims(self) -> list[int]:
        m = tuple(self.dim_mult)
        return [self.base_dim * u for u in (m[-1],) + m[::-1]]


class RMSNorm(nn.Module):
    """L2 norm over channels times sqrt(C) * gamma, fp32 math."""

    def __init__(self, c: int, device, dtype):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(c, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        n = torch.linalg.vector_norm(xf, dim=1, keepdim=True)
        y = xf / torch.clamp(n, min=1e-12) * math.sqrt(x.shape[1])
        return (y * self.gamma.float().view(1, -1, 1, 1)).to(x.dtype)


class AttnBlock(nn.Module):
    """Mid-block attention ({"norm", "qkv", "proj"})."""

    def __init__(self, c: int, norm, device, dtype):
        super().__init__()
        self.norm = norm(c)
        self.qkv = nn.utils.skip_init(nn.Linear, c, 3 * c, device=device,
                                      dtype=dtype)
        self.proj = nn.utils.skip_init(nn.Linear, c, c, device=device,
                                       dtype=dtype)

    def forward(self, x):
        y = to_tokens(self.norm(x))
        o = spatial_attention(y, lambda t: self.qkv(t).chunk(3, dim=-1),
                              self.proj)
        return x + from_tokens(o, x)


class Encoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device):
        super().__init__()
        dt, dims, z = cfg.dtype, cfg.encoder_dims, cfg.latent_channels
        rms = functools.partial(RMSNorm, device=device, dtype=dt)
        self.conv_in = make_conv(cfg.in_channels, dims[0], 3, device, dt)
        levels = []
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            resnets = [ResnetBlock(cout if j else cin, cout, rms, device, dt)
                       for j in range(cfg.num_res_blocks)]
            down = (make_conv(cout, cout, 3, device, dt, stride=2, padding=0)
                    if i != len(cfg.dim_mult) - 1 else None)
            levels.append(Level(resnets, "downsample" if down else None,
                                down))
        self.down = nn.ModuleList(levels)
        self.mid = MidBlock(dims[-1], rms, AttnBlock, device, dt)
        self.norm_out = rms(dims[-1])
        self.conv_out = make_conv(dims[-1], 2 * z, 3, device, dt)
        self.quant_conv = make_conv(2 * z, 2 * z, 1, device, dt)

    def forward(self, x):
        x = self.conv_in(x)
        for level in self.down:
            x = level(x)
        x = self.conv_out(F.silu(self.norm_out(self.mid(x))))
        return self.quant_conv(x)


class Decoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device):
        super().__init__()
        dt, dims, z = cfg.dtype, cfg.decoder_dims, cfg.latent_channels
        rms = functools.partial(RMSNorm, device=device, dtype=dt)
        self.post_quant_conv = make_conv(z, z, 1, device, dt)
        self.conv_in = make_conv(z, dims[0], 3, device, dt)
        self.mid = MidBlock(dims[0], rms, AttnBlock, device, dt)
        levels = []
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            d = cin if i == 0 else cin // 2     # the upsample halved it
            resnets = [ResnetBlock(cout if j else d, cout, rms, device, dt)
                       for j in range(cfg.num_res_blocks + 1)]
            up = (make_conv(cout, cout // 2, 3, device, dt)
                  if i != len(cfg.dim_mult) - 1 else None)
            levels.append(Level(resnets, "upsample" if up else None, up))
        self.up = nn.ModuleList(levels)
        self.norm_out = rms(dims[-1])
        self.conv_out = make_conv(dims[-1], cfg.in_channels, 3, device, dt)

    def forward(self, z):
        x = self.mid(self.conv_in(self.post_quant_conv(z)))
        for level in self.up:
            x = level(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class WanVAE(AutoencoderKL):
    """The Wan encoder / decoder with the per-channel latent normalisation;
    `encode` and `decode` as `AutoencoderKL`'s."""

    encoder_cls, decoder_cls = Encoder, Decoder

    def _stats(self, z):
        mean = torch.tensor(self.cfg.latents_mean, dtype=z.dtype,
                            device=z.device).view(1, -1, 1, 1)
        std = torch.tensor(self.cfg.latents_std, dtype=z.dtype,
                           device=z.device).view(1, -1, 1, 1)
        return mean, std

    def normalize_latents(self, z):
        mean, std = self._stats(z)
        return (z - mean) / std

    def denormalize_latents(self, z):
        mean, std = self._stats(z)
        return z * std + mean
