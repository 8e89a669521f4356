"""Building blocks of the flow-matching DiT backbone, in PyTorch.

Counterpart of `regione_tpu/models/layers.py`, with its conventions:
  * norms and the RoPE rotation compute in fp32 and cast back;
  * RoPE is the diffusers Flux convention: consecutive-pair rotation with
    cos/sin interleave-repeated to head_dim;
  * attention takes q/k/v head-major [B, H, T, D] and returns [B, T, H*D];
    its bias is an additive key-column row [B, 1, 1, S].
A linear's weight is torch's [out, in] (the JAX package stores [in, out]).
Attention goes through the port's kernels (`regione_tpu_torch.ops`), which
take the plain PyTorch path for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from regione_tpu_torch.ops.flash_attention import attention, attention_rows2


# ---------------------------------------------------------------------------
# parameter holders (names mirror the JAX param pytree)
# ---------------------------------------------------------------------------

def make_linear(d_in: int, d_out: int, device, dtype) -> nn.Linear:
    """An nn.Linear whose storage is left uninitialised: weights come from
    `weights.from_jax` or `weights.init_params`."""
    return nn.utils.skip_init(nn.Linear, d_in, d_out, device=device,
                              dtype=dtype)


class Scale(nn.Module):
    """RMSNorm scale ({"scale": [dim]})."""

    def __init__(self, dim: int, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))


class AffineNorm(nn.Module):
    """LayerNorm affine pair ({"scale": [dim], "bias": [dim]})."""

    def __init__(self, dim: int, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))

    def forward(self, x):
        return layernorm(x, scale=self.scale, bias=self.bias)


class MLP(nn.Module):
    """Two linears ({"in", "out"}); the caller applies the activation.
    JAX's "in" key is `in_` here."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, device, dtype):
        super().__init__()
        self.in_ = make_linear(d_in, d_hidden, device, dtype)
        self.out = make_linear(d_hidden, d_out, device, dtype)


def mlp_embed_module(d_in: int, d_hidden: int, device, dtype) -> MLP:
    """Time/vector embed MLP: d_in -> d_hidden -> d_hidden."""
    return MLP(d_in, d_hidden, d_hidden, device, dtype)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None):
    """x @ weight.T + bias in x's dtype; weight is [out, in]."""
    return F.linear(x, weight, bias)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMS norm over the last dim in fp32, cast back."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x, eps: float = 1e-6, scale=None, bias=None):
    """LayerNorm in fp32, cast back; AdaLN uses the affine-free form."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def timestep_embedding(t, dim: int, max_period: float = 10000.0,
                       time_factor: float = 1000.0):
    """Sinusoidal embedding [cos ‖ sin] of t * 1000 (Flux convention; fp32)."""
    t = t.float() * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[..., None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp_embed(mod: MLP, x):
    """Two-layer SiLU MLP used for time/vector embeds."""
    return mod.out(F.silu(mod.in_(x)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_table(ids, axes_dims: Sequence[int], theta: float = 10000.0):
    """ids [S, A] -> (cos, sin), each [S, head_dim] fp32, frequencies
    interleave-repeated x2."""
    cos_parts, sin_parts = [], []
    for a, d in enumerate(axes_dims):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                              device=ids.device) * 2.0 / d))
        angles = ids[:, a].float()[:, None] * freqs[None]
        angles = torch.repeat_interleave(angles, 2, dim=-1)
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def _rotate_pairs(x):
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1)
    return rot.reshape(x.shape)


def apply_rope(x, rope):
    """x [B, H, S, D]; rope (cos, sin) each [S, D] (shared) or [B, S, D]
    (one table per batch row, broadcast over the heads).  fp32 rotation."""
    cos, sin = rope
    if cos.dim() == 3:
        cos, sin = cos[:, None], sin[:, None]
    xf = x.float()
    return (xf * cos + _rotate_pairs(xf) * sin).to(x.dtype)


def concat_rope(a, b):
    """Tables of [a's rows ‖ b's rows]; a shared [T, D] table `a` (text) is
    broadcast to the batch of a per-row [B, S, D] table `b` (image)."""
    def cat(x, y):
        if x.dim() < y.dim():
            x = x.expand(y.shape[0], -1, -1)
        return torch.cat([x, y], -2)
    return cat(a[0], b[0]), cat(a[1], b[1])


def gather_rope(rope, ids):
    """Rope rows by padded ids [K] -> [K, D], or per-row ids [B, K] ->
    [B, K, D]; ids >= S read zeros (the JAX `mode='fill'` gather) through a
    zero sink row appended at index S."""
    cos, sin = rope
    s = cos.shape[0]
    idx = torch.clamp(ids, max=s).long()
    zero = cos.new_zeros((1, cos.shape[1]))
    return torch.cat([cos, zero], 0)[idx], torch.cat([sin, zero], 0)[idx]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def split_heads(x, heads: int):
    """[B, S, H*d] -> [B, H, S, d] (a transposed view, no copy)."""
    b, s, hd = x.shape
    return x.view(b, s, heads, hd // heads).transpose(1, 2)


def _bias_row(bias):
    return None if bias is None else bias.reshape(bias.shape[0],
                                                  bias.shape[-1])


def sdpa(q, k, v, bias=None):
    """q [B, H, T, d], k/v [B, H, S, d], bias [B, 1, 1, S] or None
    -> [B, T, H*d] (kernel K1)."""
    return attention(q, k, v, _bias_row(bias))


def sdpa_cached(q, txt_kv, k_cache, v_cache, bias=None):
    """RAGS attention against the head-major cache [B, H, S, d], read in
    place: q over [fresh rows ‖ cache] in one softmax (kernel K2, or K2q for
    a quantized cache).
    txt_kv: (k, v) [B, H, T1, d] fresh rows, or None: q over the cache
        alone (kernel K1, or K6 for a quantized cache).
    k_cache/v_cache: [B, H, S, d], or (int8 rows, fp32 scales [B, H, S])
        when the cache is quantized; int4 rows hold S/2 packed rows
        (`ops.quant`), told by the row count.
    bias: [B, 1, 1, T1 + S] or None.
    On the CPU the wrappers dequantize, concatenate and attend (the JAX
    fallback); there is no VMEM gate on the card."""
    scales = {}
    if isinstance(k_cache, tuple):
        (k_cache, k_s), (v_cache, v_s) = k_cache, v_cache
        scales = dict(k_scale=k_s, v_scale=v_s)
    if txt_kv is None:
        return attention(q, k_cache, v_cache, _bias_row(bias), **scales)
    return attention_rows2(q, txt_kv[0], txt_kv[1], k_cache, v_cache,
                           _bias_row(bias), **scales)
