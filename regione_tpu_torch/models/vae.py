"""Variational autoencoder (AutoencoderKL, FLUX family) in PyTorch.

Counterpart of `regione_tpu/models/vae.py`, used by Step1X-Edit and FLUX.1
Kontext: 16 latent channels, spatial factor 8, latents normalised by
`(z - shift_factor) * scaling_factor`.  Qwen-Image's Wan VAE is
`models/vae_wan.py`; `vae_module(cfg)` picks the family from the config.

The JAX package is NHWC with HWIO kernels; the port is NCHW with torch's
OIHW conv weights (`weights.from_jax.vae_from_jax` transposes).  Module and
parameter names mirror the JAX param pytree: conv {"w", "b"} is
`weight` / `bias`, group norm {"scale", "bias"}, the lists "down" / "up" /
"resnets" are `ModuleList`s.  Group norms compute their statistics in fp32
(eps 1e-6); the mid-block attention is single-head with fp32 logits.  A
downsample pads the bottom and right edges by one and runs a stride-2 conv
with no padding; an upsample is nearest x2 then a 3x3 conv.

Also the token packing: the DiT consumes latents patchified 2 x 2 into
[B, (H/2)(W/2), 4C] tokens, each token's channels in (dy, dx, c) order as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    dtype: Any = torch.float32

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def make_conv(cin: int, cout: int, k: int, device, dtype,
              stride: int = 1, padding: int | None = None) -> nn.Conv2d:
    """A k x k conv ("same" padding unless given) whose storage is left
    uninitialised: weights come from `weights.from_jax` or
    `weights.from_jax.init_vae_params`."""
    return nn.utils.skip_init(
        nn.Conv2d, cin, cout, k, stride=stride,
        padding=k // 2 if padding is None else padding, device=device,
        dtype=dtype)


def downsample(conv: nn.Conv2d, x):
    """Pad bottom / right by one, then the stride-2 conv (padding 0)."""
    return conv(F.pad(x, (0, 1, 0, 1)))


def upsample(conv: nn.Conv2d, x):
    return conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def spatial_attention(y, qkv, out_proj):
    """Single-head self-attention over the H*W positions of `y`
    [B, H*W, C]: q, k, v from `qkv(y)`, fp32 logits / sqrt(C)."""
    q, k, v = qkv(y)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    att = torch.softmax(logits / math.sqrt(y.shape[-1]), dim=-1)
    return out_proj(torch.matmul(att.to(y.dtype), v))


def to_tokens(x):
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def from_tokens(t, like):
    return t.transpose(1, 2).reshape(like.shape)


class GroupNorm(nn.Module):
    """Group norm with fp32 statistics ({"scale", "bias"})."""

    def __init__(self, c: int, groups: int, device, dtype):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(torch.empty(c, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(c, device=device, dtype=dtype))

    def forward(self, x):
        y = F.group_norm(x.float(), self.groups, self.scale.float(),
                         self.bias.float(), eps=1e-6)
        return y.to(x.dtype)


class ResnetBlock(nn.Module):
    """(norm, SiLU, 3x3 conv) twice plus the input, through a 1x1
    `shortcut` when the channels change; `norm(c)` makes the family's norm
    (group norm here, RMS norm for Wan)."""

    def __init__(self, cin: int, cout: int, norm, device, dtype):
        super().__init__()
        self.norm1 = norm(cin)
        self.conv1 = make_conv(cin, cout, 3, device, dtype)
        self.norm2 = norm(cout)
        self.conv2 = make_conv(cout, cout, 3, device, dtype)
        if cin != cout:
            self.shortcut = make_conv(cin, cout, 1, device, dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Mid-block attention ({"norm", "q", "k", "v", "out"})."""

    def __init__(self, c: int, norm, device, dtype):
        super().__init__()
        self.norm = norm(c)
        for name in ("q", "k", "v", "out"):
            setattr(self, name, nn.utils.skip_init(
                nn.Linear, c, c, device=device, dtype=dtype))

    def forward(self, x):
        y = to_tokens(self.norm(x))
        o = spatial_attention(y, lambda t: (self.q(t), self.k(t), self.v(t)),
                              self.out)
        return x + from_tokens(o, x)


class MidBlock(nn.Module):
    """resnet, attention (`attn(c, norm, device, dtype)`), resnet."""

    def __init__(self, c: int, norm, attn, device, dtype):
        super().__init__()
        self.res1 = ResnetBlock(c, c, norm, device, dtype)
        self.attn = attn(c, norm, device, dtype)
        self.res2 = ResnetBlock(c, c, norm, device, dtype)

    def forward(self, x):
        return self.res2(self.attn(self.res1(x)))


class Level(nn.Module):
    """One resolution level: its resnets, then an optional resample conv
    (`downsample` in the encoder, `upsample` in the decoder)."""

    def __init__(self, resnets, resample: str | None = None, conv=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if resample is not None:
            setattr(self, resample, conv)

    def forward(self, x):
        for rn in self.resnets:
            x = rn(x)
        if hasattr(self, "downsample"):
            x = downsample(self.downsample, x)
        if hasattr(self, "upsample"):
            x = upsample(self.upsample, x)
        return x


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def _group_norm(cfg: VAEConfig, device):
    return functools.partial(GroupNorm, groups=cfg.norm_num_groups,
                             device=device, dtype=cfg.dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device):
        super().__init__()
        dt, chans = cfg.dtype, cfg.block_out_channels
        g = _group_norm(cfg, device)
        self.conv_in = make_conv(cfg.in_channels, chans[0], 3, device, dt)
        levels, cin = [], chans[0]
        for i, cout in enumerate(chans):
            resnets = [ResnetBlock(cout if j else cin, cout, g, device, dt)
                       for j in range(cfg.layers_per_block)]
            down = (make_conv(cout, cout, 3, device, dt, stride=2, padding=0)
                    if i < len(chans) - 1 else None)
            levels.append(Level(resnets, "downsample" if down else None,
                                down))
            cin = cout
        self.down = nn.ModuleList(levels)
        self.mid = MidBlock(chans[-1], g, AttnBlock, device, dt)
        self.norm_out = g(chans[-1])
        self.conv_out = make_conv(chans[-1], 2 * cfg.latent_channels, 3,
                                  device, dt)

    def forward(self, x):
        x = self.conv_in(x)
        for level in self.down:
            x = level(x)
        x = self.mid(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device):
        super().__init__()
        dt, chans = cfg.dtype, cfg.block_out_channels
        g = _group_norm(cfg, device)
        c_mid = chans[-1]
        self.conv_in = make_conv(cfg.latent_channels, c_mid, 3, device, dt)
        self.mid = MidBlock(c_mid, g, AttnBlock, device, dt)
        rev, levels, cin = list(reversed(chans)), [], c_mid
        for i, cout in enumerate(rev):
            resnets = [ResnetBlock(cout if j else cin, cout, g, device, dt)
                       for j in range(cfg.layers_per_block + 1)]
            up = (make_conv(cout, cout, 3, device, dt)
                  if i < len(rev) - 1 else None)
            levels.append(Level(resnets, "upsample" if up else None, up))
            cin = cout
        self.up = nn.ModuleList(levels)
        self.norm_out = g(chans[0])
        self.conv_out = make_conv(chans[0], cfg.in_channels, 3, device, dt)

    def forward(self, z):
        x = self.mid(self.conv_in(z))
        for level in self.up:
            x = level(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class AutoencoderKL(nn.Module):
    """encoder / decoder with the family's latent normalisation; the
    interface `pipelines.base` uses for both VAE families (`WanVAE`
    subclasses it with its own encoder, decoder and normalisation)."""

    encoder_cls, decoder_cls = Encoder, Decoder

    def __init__(self, cfg: VAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.encoder = self.encoder_cls(cfg, device)
        self.decoder = self.decoder_cls(cfg, device)

    def encode(self, images, generator: torch.Generator | None = None):
        """images [B, 3, H, W] in [-1, 1] -> latents [B, C, H/f, W/f] (f
        the spatial factor): the posterior mode, or a sample drawn from
        `generator` (mean + std * eps)."""
        moments = self.encoder(images.to(self.cfg.dtype))
        mean, logvar = moments.chunk(2, dim=1)
        if generator is None:
            return mean
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        return mean + std * torch.randn(mean.shape, generator=generator,
                                        device=mean.device, dtype=mean.dtype)

    def decode(self, latents):
        """latents [B, C, h, w] (de-normalised) -> images [B, 3, fh, fw]."""
        return self.decoder(latents.to(self.cfg.dtype))

    def normalize_latents(self, z):
        """encoder output -> the DiT's latent space."""
        return (z - self.cfg.shift_factor) * self.cfg.scaling_factor

    def denormalize_latents(self, z):
        """the DiT's latent space -> decoder input."""
        return z / self.cfg.scaling_factor + self.cfg.shift_factor


def vae_module(cfg):
    """The VAE class implementing `cfg`: `AutoencoderKL` here, `WanVAE`
    for a `WanVAEConfig`; both take (cfg, device) and expose encode /
    decode / normalize_latents / denormalize_latents."""
    from regione_tpu_torch.models import vae_wan
    if isinstance(cfg, vae_wan.WanVAEConfig):
        return vae_wan.WanVAE
    return AutoencoderKL


# ---------------------------------------------------------------------------
# token packing (2 x 2 patchify)
# ---------------------------------------------------------------------------

def pack_latents(z):
    """[B, C, H, W] -> [B, (H/2)(W/2), 4C] tokens, channels (dy, dx, c)."""
    b, c, h, w = z.shape
    z = z.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    return z.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents(tokens, grid_h: int, grid_w: int):
    """[B, S, 4C] -> [B, C, 2 * grid_h, 2 * grid_w]."""
    b, s, c4 = tokens.shape
    if s != grid_h * grid_w:
        raise ValueError(f"{s} tokens for a {grid_h} x {grid_w} grid")
    c = c4 // 4
    z = tokens.reshape(b, grid_h, grid_w, 2, 2, c).permute(0, 5, 1, 3, 2, 4)
    return z.reshape(b, c, 2 * grid_h, 2 * grid_w)
