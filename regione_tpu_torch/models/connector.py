"""Step1X-Edit text connector (timestep-conditioned token refiner), PyTorch.

Counterpart of `regione_tpu/models/connector.py` (`connector_apply`): the
VL features are refined per timestep by `depth` blocks of
LayerNorm -> self-attention -> LayerNorm -> SiLU MLP with gate-only AdaLN
modulation from silu(temb + cemb), and the pooled vector y comes from the
masked mean of the RAW features.  Its attention (28 heads x 128 at full
width) runs through kernel K1.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from regione_tpu_torch.models.layers import (
    MLP,
    AffineNorm,
    make_linear,
    mlp_embed,
    mlp_embed_module,
    sdpa,
    split_heads,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class ConnectorConfig:
    in_dim: int = 3584          # VL encoder feature dim (Qwen2.5-VL)
    hidden: int = 3584
    heads: int = 28
    depth: int = 2
    pooled_dim: int = 768
    time_embed_dim: int = 256
    mlp_ratio: float = 4.0
    dtype: Any = torch.bfloat16


class _Attn(nn.Module):
    def __init__(self, h: int, device, dtype):
        super().__init__()
        self.q = make_linear(h, h, device, dtype)
        self.k = make_linear(h, h, device, dtype)
        self.v = make_linear(h, h, device, dtype)
        self.out = make_linear(h, h, device, dtype)


class ConnectorBlock(nn.Module):
    def __init__(self, cfg: ConnectorConfig, device):
        super().__init__()
        h, dt = cfg.hidden, cfg.dtype
        self.heads = cfg.heads
        self.norm1 = AffineNorm(h, device, dt)
        self.norm2 = AffineNorm(h, device, dt)
        self.attn = _Attn(h, device, dt)
        self.mlp = MLP(h, int(h * cfg.mlp_ratio), h, device, dt)
        self.mod = make_linear(h, 2 * h, device, dt)

    def forward(self, x, c, bias):
        gate_msa, gate_mlp = self.mod(c)[:, None, :].chunk(2, dim=-1)
        h = self.norm1(x)
        q = split_heads(self.attn.q(h), self.heads)
        k = split_heads(self.attn.k(h), self.heads)
        v = split_heads(self.attn.v(h), self.heads)
        x = x + gate_msa * self.attn.out(sdpa(q, k, v, bias=bias))
        h2 = self.norm2(x)
        return x + gate_mlp * self.mlp.out(F.silu(self.mlp.in_(h2)))


class Connector(nn.Module):
    def __init__(self, cfg: ConnectorConfig, device):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.in_proj = make_linear(cfg.in_dim, h, device, dt)
        self.t_embed = mlp_embed_module(cfg.time_embed_dim, h, device, dt)
        self.c_embed = mlp_embed_module(cfg.in_dim, h, device, dt)
        self.global_proj = make_linear(cfg.in_dim, cfg.pooled_dim, device, dt)
        self.scale_factor = nn.Parameter(torch.empty(1, device=device,
                                                     dtype=dt))
        self.blocks = nn.ModuleList(ConnectorBlock(cfg, device)
                                    for _ in range(cfg.depth))

    def forward(self, feats, t, mask=None):
        """feats [B, T, in_dim]; t [B] sigma; mask [B, T] bool or None.
        Returns (refined [B, T, hidden], y [B, pooled_dim])."""
        cfg, dt = self.cfg, self.cfg.dtype
        if mask is None:
            mask_f = feats.new_ones(feats.shape[:2], dtype=torch.float32)
        else:
            mask_f = mask.float()
        denom = torch.clamp(mask_f.sum(-1, keepdim=True), min=1.0)
        ctx = (feats.float() * mask_f[..., None]).sum(1) / denom
        y = self.global_proj(
            (ctx * (1.0 + self.scale_factor.float())).to(dt))
        x = self.in_proj(feats.to(dt))
        temb = mlp_embed(self.t_embed,
                         timestep_embedding(t, cfg.time_embed_dim).to(dt))
        cemb = mlp_embed(self.c_embed, ctx.to(dt))
        c = F.silu(temb + cemb)
        bias = None
        if mask is not None:
            bias = torch.where(mask, 0.0, -1e9).float()[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, c, bias)
        return x, y
