"""Multi-modal DiT (MMDiT) backbone with the Region-Instruction KV cache.

Counterpart of `regione_tpu/models/mmdit.py` for the Step1X-Edit / FLUX
topology (double-stream blocks, then single-stream txt-concat blocks) and
the Qwen-Image-Edit topology (joint double-stream blocks only,
depth_single = 0, and an RMSNorm of the raw text features, `txt_norm`):
AdaLN-zero modulation, qk-RMSNorm and RoPE over any number of axes; FLUX.1
Kontext adds its distilled guidance scale to the timestep embedding
(`guidance_embed`).  FLUX.2 [dev] keeps the FLUX topology and changes three
things together, under one field of `MMDiTConfig` (`flux2_block`): a SwiGLU
MLP, its input projection 2 x mlp_hidden wide, gated by kernel K11;
modulation computed once a forward by three linears shared by every block
of a kind (`double_mod_img`, `double_mod_txt`, `single_mod`, in the
`model.modulation` span); and no bias in any linear.
Three cache modes:

  mode="dense" : plain attention, no cache traffic;
  mode="write" : dense attention AND store the image-stream K/V in the cache
                 (filled in place: the port updates the cache tensors rather
                 than returning new ones, which keeps one copy on the card);
  mode="rags"  : the hidden stream holds the gathered edited tokens; they
                 attend over [fresh rows ‖ frozen cache] with the stale cache
                 rows of edited ids masked by the bias (kernel K2, or K2q
                 for a quantized cache).  RAGS writes nothing to the cache.

The cache (`models.kv_cache`, which owns its format and layout) stores
attention-ready K (qk-norm and RoPE applied) and raw V, head-major over the
image rows ([noise ‖ condition]) only: in the model dtype, or quantized
(int8, int4), which RAGS steps read through kernel K2q.
The blocks' elementwise chains (AdaLN, the gated residuals, qk-RMSNorm +
RoPE with the head-major packing, GELU or the SwiGLU gate) run through
`ops.fused`, kernels K7-K9 and K11 on the card; the double block's q / k /
v are written straight into one buffer over [txt ‖ img] rows each, with no
concatenation.
The depth runs as a Python loop over `nn.ModuleList`s; linear1 of the single
blocks is one matmul, quantized or not (the JAX package's deferred-MLP split
was an XLA rematerialisation fix with the same math, and its `_slice_out`
halves are output columns of that one product; under W8A8 its input is
quantized once, as JAX's `row_projector` does).  Any linear may be an
`nn.Linear` or a quantized one (`ops.quant.quantize_params`).
Under tensor parallelism (`parallel.sharding.shard_params`) each rank holds
its heads (`Attention.heads`, `SingleBlock.heads / inner / mlp_hidden`
count the rank's own), its `ShardedLinear`s and a cache of its heads
(`kv_cache.init_cache(..., tp=)`); the attention kernels run unchanged on
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from regione_tpu_torch.models import kv_cache
from regione_tpu_torch.models.connector import Connector, ConnectorConfig
from regione_tpu_torch.ops.fused import (adaln, gated_residual, gelu_pack,
                                         qk_norm_rope, residual_adaln,
                                         swiglu_pack)
from regione_tpu_torch.utils import telemetry
from regione_tpu_torch.models.layers import (
    MLP,
    Scale,
    act_int8,
    concat_rope,
    make_linear,
    mlp_embed,
    mlp_embed_module,
    project_rows,
    rmsnorm,
    sdpa,
    sdpa_cached,
    split_heads,
    timestep_embedding,
)

MODE_DENSE = "dense"
MODE_WRITE = "write"
MODE_RAGS = "rags"

# additive bias of a masked key column (pad slots, stale cache rows)
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 64
    out_channels: int = 64
    hidden: int = 3072
    heads: int = 24
    head_dim: int = 128
    mlp_ratio: float = 4.0
    depth_double: int = 19
    depth_single: int = 38
    txt_in_dim: int = 4096
    pooled_dim: int = 768          # 0 -> no pooled-vector embed
    guidance_embed: bool = False   # FLUX.1 distilled guidance embed
    axes_dims: tuple = (16, 56, 56)
    rope_theta: float = 10000.0
    time_embed_dim: int = 256
    txt_norm: bool = False         # RMSNorm of the raw text features
                                   # before txt_in (Qwen-Image)
    connector: ConnectorConfig | None = None   # Step1X text refiner
    cache_int8: bool = False       # the KV cache's format: read and set
    cache_int4: bool = False       # through `kv_cache.cache_format`
    act_int8: bool = False         # W8A8: int8-weight linears quantize
                                   # their input rows and run an int8
                                   # product (`layers.act_int8`); no-op
                                   # without int8 weights (ops.quant)
    flux2_block: bool = False      # FLUX.2's block: a SwiGLU MLP (silu(a)
                                   # * b of the input projection's [a ‖ b]),
                                   # the blocks' modulation from three
                                   # linears a forward, no bias in any linear
    dtype: Any = torch.bfloat16

    @property
    def inner(self) -> int:
        return self.heads * self.head_dim

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden * self.mlp_ratio)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _modulation(lin: nn.Linear, temb_act, n: int):
    return lin(temb_act)[:, None, :].chunk(n, dim=-1)


def _mlp_act(swiglu: bool, attn, h):
    """[attn ‖ act(h)] (attn None: act(h) alone): the tanh GELU (K9), or
    under SwiGLU silu(a) * b of h = [a ‖ b] (K11)."""
    return swiglu_pack(attn, h) if swiglu else gelu_pack(attn, h)


class Attention(nn.Module):
    """One stream's q/k/v/out projections and qk-RMSNorm scales."""

    def __init__(self, d_model: int, cfg: MMDiTConfig, device):
        super().__init__()
        dt, inner, b = cfg.dtype, cfg.inner, not cfg.flux2_block
        self.heads, self.head_dim = cfg.heads, cfg.head_dim
        self.q = make_linear(d_model, inner, device, dt, b)
        self.k = make_linear(d_model, inner, device, dt, b)
        self.v = make_linear(d_model, inner, device, dt, b)
        self.out = make_linear(inner, d_model, device, dt, b)
        self.norm_q = Scale(cfg.head_dim, device, dt)
        self.norm_k = Scale(cfg.head_dim, device, dt)

    def qkv(self, x, rope, out, row0: int):
        """This stream's q, k, v heads, qk-RMSNorm and RoPE applied to q
        and k (kernel K8), written into the head-major buffers `out`
        (q, k, v) [B, H, S_total, dh] at rows row0 .. row0 + S."""
        q, k, v = project_rows(x, (self.q, self.k, self.v))
        qk_norm_rope(q, self.heads, self.norm_q.scale, rope, out=out[0],
                     row0=row0)
        qk_norm_rope(k, self.heads, self.norm_k.scale, rope, out=out[1],
                     row0=row0)
        qk_norm_rope(v, self.heads, out=out[2], row0=row0)   # packing alone


class DoubleBlock(nn.Module):
    """Double-stream block: separate img/txt projections, joint attention
    with the txt rows first.  Under `flux2_block` it holds no modulation
    linear: the forward hands it the shared chunks (`mods`)."""

    def __init__(self, cfg: MMDiTConfig, device):
        super().__init__()
        h, dt, b = cfg.hidden, cfg.dtype, not cfg.flux2_block
        if not cfg.flux2_block:
            self.img_mod = make_linear(h, 6 * h, device, dt, b)
            self.txt_mod = make_linear(h, 6 * h, device, dt, b)
        self.img_attn = Attention(h, cfg, device)
        self.txt_attn = Attention(h, cfg, device)
        self.swiglu = cfg.flux2_block
        self.img_mlp = MLP(h, cfg.mlp_hidden, h, device, dt, b, self.swiglu)
        self.txt_mlp = MLP(h, cfg.mlp_hidden, h, device, dt, b, self.swiglu)

    def forward(self, img, txt, temb_act, rope_img, rope_txt, mode,
                cache_k=None, cache_v=None, bias=None, mods=None):
        """Returns (img, txt, (k_img, v_img) in write mode else None).
        `mods`: the image and the text stream's six chunks, computed once
        a forward (`flux2_block`); None: from this block's own linears."""
        if mods is None:
            mods = (_modulation(self.img_mod, temb_act, 6),
                    _modulation(self.txt_mod, temb_act, 6))
        ((i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2),
         (t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2)) = mods

        img_n = adaln(img, i_shift1, i_scale1)
        txt_n = adaln(txt, t_shift1, t_scale1)
        # q, k, v over [txt ‖ img] rows: each stream writes its rows
        t_len = txt.shape[1]
        shape = (img.shape[0], self.img_attn.heads, t_len + img.shape[1],
                 self.img_attn.head_dim)
        q, k, v = (img.new_empty(shape) for _ in range(3))
        self.txt_attn.qkv(txt_n, rope_txt, (q, k, v), 0)
        self.img_attn.qkv(img_n, rope_img, (q, k, v), t_len)

        new_kv = None
        if mode == MODE_RAGS:
            attn = sdpa_cached(q, (k, v), cache_k, cache_v, bias=bias)
        else:
            if mode == MODE_WRITE:
                new_kv = (k[:, :, t_len:], v[:, :, t_len:])
            attn = sdpa(q, k, v, bias=bias)

        attn_txt, attn_img = attn[:, :t_len], attn[:, t_len:]
        img, img_n2 = residual_adaln(img, i_gate1,
                                     self.img_attn.out(attn_img), i_shift2,
                                     i_scale2)
        txt, txt_n2 = residual_adaln(txt, t_gate1,
                                     self.txt_attn.out(attn_txt), t_shift2,
                                     t_scale2)
        img = gated_residual(img, i_gate2, self.img_mlp.out(
            _mlp_act(self.swiglu, None, self.img_mlp.in_(img_n2))))
        txt = gated_residual(txt, t_gate2, self.txt_mlp.out(
            _mlp_act(self.swiglu, None, self.txt_mlp.in_(txt_n2))))
        return img, txt, new_kv


class SingleBlock(nn.Module):
    """Flux-style single-stream block over [txt ‖ img]: one fused qkv+MLP
    projection, parallel attention and MLP, one output projection.  Under
    `flux2_block` it holds no modulation linear (`mods`, as in
    `DoubleBlock`); under SwiGLU linear1's MLP part is both halves."""

    def __init__(self, cfg: MMDiTConfig, device):
        super().__init__()
        h, dt, b = cfg.hidden, cfg.dtype, not cfg.flux2_block
        self.heads, self.inner, self.mlp_hidden = (cfg.heads, cfg.inner,
                                                   cfg.mlp_hidden)
        self.swiglu = cfg.flux2_block
        if not cfg.flux2_block:
            self.mod = make_linear(h, 3 * h, device, dt, b)
        self.linear1 = make_linear(
            h, 3 * cfg.inner + (2 if self.swiglu else 1) * cfg.mlp_hidden,
            device, dt, b)
        self.linear2 = make_linear(cfg.inner + cfg.mlp_hidden, h, device, dt,
                                   b)
        self.norm_q = Scale(cfg.head_dim, device, dt)
        self.norm_k = Scale(cfg.head_dim, device, dt)

    def forward(self, x, temb_act, rope, mode, cache_k=None, cache_v=None,
                bias=None, t_txt: int = 0, mods=None):
        """Returns (x, (k_img, v_img) in write mode else None); the image
        rows of the stream start at `t_txt`.  `mods`: the shared (shift,
        scale, gate), or None for this block's own."""
        shift, scale, gate = mods if mods is not None else \
            _modulation(self.mod, temb_act, 3)
        x_n = adaln(x, shift, scale)
        inner = self.inner
        h = self.linear1(x_n)
        q, k, v, mlp_h = h.split([inner, inner, inner,
                                  h.shape[-1] - 3 * inner], dim=-1)
        q = qk_norm_rope(q, self.heads, self.norm_q.scale, rope)
        k = qk_norm_rope(k, self.heads, self.norm_k.scale, rope)
        v = split_heads(v, self.heads)      # attention reads the view

        new_kv = None
        if mode == MODE_RAGS:
            attn = sdpa_cached(q, (k, v), cache_k, cache_v, bias=bias)
        else:
            if mode == MODE_WRITE:
                new_kv = (k[:, :, t_txt:], v[:, :, t_txt:])
            attn = sdpa(q, k, v, bias=bias)
        out = self.linear2(_mlp_act(self.swiglu, attn, mlp_h))
        return gated_residual(x, gate, out), new_kv


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def rags_bias(sel_img_ids, s_kv: int, t_txt: int, batch: int, txt_bias):
    """[B, 1, 1, t_txt + cap + s_kv] key bias of a RAGS step: keys are
    [txt ‖ edited (fresh) ‖ cached image rows].  `sel_img_ids` is [cap]
    (shared by the batch) or [B, cap] (one id set per row: a group of
    requests, each with its own partition).  Pad slots (id == s_kv) and
    each row's stale cache rows at its edited ids are -1e30; the stale-row
    scatter drops the sentinel through a sink column at index s_kv."""
    ids = sel_img_ids.expand(batch, -1) if sel_img_ids.dim() == 1 \
        else sel_img_ids
    device = ids.device
    if txt_bias is not None:
        base_txt = txt_bias[:, 0, 0, :t_txt].float()
        base_img = txt_bias[:, 0, 0, t_txt:].float()
    else:
        base_txt = torch.zeros((batch, t_txt), device=device)
        base_img = torch.zeros((batch, s_kv), device=device)
    fresh = torch.where(ids < s_kv, 0.0, NEG_INF).float()
    stale = torch.zeros((batch, s_kv + 1), device=device)
    stale.scatter_(1, torch.clamp(ids, max=s_kv).long(), NEG_INF)
    return torch.cat([base_txt, fresh, base_img + stale[:, :s_kv]],
                     dim=-1)[:, None, None, :]


class MMDiT(nn.Module):
    """The backbone; parameter names mirror the JAX param pytree (the
    block stacks "double" / "single" become `double_blocks.<i>` /
    `single_blocks.<i>`, since `nn.Module.double` is a method; JAX's "w" is
    `weight` transposed, "b" is `bias`, "in" is `in_`).  `tp` and `mesh`
    are set by `parallel.sharding.shard_params` (None: unsharded)."""

    def __init__(self, cfg: MMDiTConfig, device):
        super().__init__()
        self.cfg = cfg
        self.tp = None      # layers.TPGroup of a sharded model
        self.mesh = None
        h, dt, b = cfg.hidden, cfg.dtype, not cfg.flux2_block
        self.x_embedder = make_linear(cfg.in_channels, h, device, dt, b)
        self.time_in = mlp_embed_module(cfg.time_embed_dim, h, device, dt, b)
        self.txt_in = make_linear(cfg.txt_in_dim, h, device, dt, b)
        self.final_mod = make_linear(h, 2 * h, device, dt, b)
        self.final_proj = make_linear(h, cfg.out_channels, device, dt, b)
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg, device)
                                    for _ in range(cfg.depth_double))
        if cfg.flux2_block:
            self.double_mod_img = make_linear(h, 6 * h, device, dt, b)
            self.double_mod_txt = make_linear(h, 6 * h, device, dt, b)
            self.single_mod = make_linear(h, 3 * h, device, dt, b)
        if cfg.pooled_dim:
            self.vector_in = mlp_embed_module(cfg.pooled_dim, h, device, dt,
                                              b)
        if cfg.guidance_embed:
            self.guidance_in = mlp_embed_module(cfg.time_embed_dim, h,
                                                device, dt, b)
        if cfg.connector is not None:
            self.connector = Connector(cfg.connector, device)
        if cfg.txt_norm:
            self.txt_norm = Scale(cfg.txt_in_dim, device, dt)
        if cfg.depth_single:
            self.single_blocks = nn.ModuleList(SingleBlock(cfg, device)
                                        for _ in range(cfg.depth_single))

    @property
    def tp_size(self) -> int:
        return 1 if self.tp is None else self.tp.size

    def forward(self, img, txt, t, rope_img, rope_txt, pooled=None,
                guidance=None, *, mode: str = MODE_DENSE, cache=None,
                sel_img_ids=None, txt_bias=None):
        """img [B, T_img, C]; txt [B, T_txt, txt_in_dim]; t [B] sigma in
        the model dtype; guidance [B] fp32 (FLUX's distilled guidance scale,
        embedded like a timestep); rope_* (cos, sin) over the img / txt rows.
        In rags mode T_img == cap and `sel_img_ids` [cap] (or [B, cap], one
        id set per batch row, with rope_img then [B, cap, dh] tables) maps
        rows into the cache (sentinel s_kv for pad slots).  Returns (v [B, T_img, C_out],
        cache); write mode fills `cache` in place (zeroed if None).  Under
        `cfg.act_int8` the int8 linears run W8A8 (`layers.act_int8`)."""
        with act_int8(self.cfg.act_int8):
            return self._forward(img, txt, t, rope_img, rope_txt, pooled,
                                 guidance, mode=mode, cache=cache,
                                 sel_img_ids=sel_img_ids, txt_bias=txt_bias)

    def _forward(self, img, txt, t, rope_img, rope_txt, pooled, guidance, *,
                 mode, cache, sel_img_ids, txt_bias):
        """`forward`, in host-only `utils.telemetry` spans: `model.embed`
        (holding `model.modulation` under `flux2_block`),
        `model.double_block` / `model.single_block` (attr `index`) and
        `model.final`; in write mode each block's span holds two
        `model.cache_write` spans (K, V), which time the device."""
        cfg = self.cfg
        if mode == MODE_WRITE and cache is None:
            cache = kv_cache.init_cache(cfg, img.shape[0], img.shape[1],
                                        img.device, self.tp_size)
        with telemetry.span("model.embed"):
            x, txt_h, temb_act = self._embed(img, txt, t, pooled, guidance,
                                             txt_bias)
            double_kw, single_kw = self._shared_mods(temb_act)
        t_txt = txt_h.shape[1]

        rags = mode == MODE_RAGS
        bias = txt_bias
        if rags:
            bias = rags_bias(sel_img_ids, kv_cache.image_rows(cache), t_txt,
                             x.shape[0], txt_bias)
        for i, blk in enumerate(self.double_blocks):
            with telemetry.span("model.double_block", index=i):
                ck = kv_cache.layer_kv(cache, "dk", i) if rags else None
                cv = kv_cache.layer_kv(cache, "dv", i) if rags else None
                x, txt_h, kv = blk(x, txt_h, temb_act, rope_img, rope_txt,
                                   mode, ck, cv, bias, **double_kw)
                if kv is not None:
                    kv_cache.store_kv(cfg, cache, "dk", i, kv[0])
                    kv_cache.store_kv(cfg, cache, "dv", i, kv[1])

        if cfg.depth_single:
            stream = torch.cat([txt_h, x], dim=1)
            rope_stream = concat_rope(rope_txt, rope_img)
            for i, blk in enumerate(self.single_blocks):
                with telemetry.span("model.single_block", index=i):
                    ck = kv_cache.layer_kv(cache, "sk", i) if rags else None
                    cv = kv_cache.layer_kv(cache, "sv", i) if rags else None
                    stream, kv = blk(stream, temb_act, rope_stream, mode, ck,
                                     cv, bias, t_txt=t_txt, **single_kw)
                    if kv is not None:
                        kv_cache.store_kv(cfg, cache, "sk", i, kv[0])
                        kv_cache.store_kv(cfg, cache, "sv", i, kv[1])
            x = stream[:, t_txt:]

        with telemetry.span("model.final"):
            shift, scale = _modulation(self.final_mod, temb_act, 2)
            return self.final_proj(adaln(x, shift, scale)), cache

    def _shared_mods(self, temb_act):
        """The blocks' keyword arguments: under `flux2_block` the chunks of
        the three shared modulation linears, computed here once a forward
        (the `model.modulation` span), as `mods`; else none."""
        if not self.cfg.flux2_block:
            return {}, {}
        with telemetry.span("model.modulation"):
            double = (_modulation(self.double_mod_img, temb_act, 6),
                      _modulation(self.double_mod_txt, temb_act, 6))
            single = _modulation(self.single_mod, temb_act, 3)
        return {"mods": double}, {"mods": single}

    def _embed(self, img, txt, t, pooled, guidance, txt_bias):
        """The image, time, guidance and text embeds and the connector:
        (x, txt_h, silu(temb))."""
        cfg, dt = self.cfg, self.cfg.dtype
        x = self.x_embedder(img.to(dt))
        temb = mlp_embed(self.time_in,
                         timestep_embedding(t, cfg.time_embed_dim).to(dt))
        if cfg.pooled_dim and pooled is not None and cfg.connector is None:
            temb = temb + mlp_embed(self.vector_in, pooled.to(dt))
        if cfg.guidance_embed and guidance is not None:
            temb = temb + mlp_embed(
                self.guidance_in,
                timestep_embedding(guidance, cfg.time_embed_dim).to(dt))
        txt_in = txt.to(dt)
        if cfg.connector is not None:
            txt_mask = None
            if txt_bias is not None:
                txt_mask = txt_bias[:, 0, 0, :txt.shape[1]] > -1.0
            txt_in, y = self.connector(txt_in, t, txt_mask)
            if cfg.pooled_dim:
                temb = temb + mlp_embed(self.vector_in, y.to(dt))
        temb_act = F.silu(temb)
        if cfg.txt_norm:
            txt_in = rmsnorm(txt_in, self.txt_norm.scale)
        return x, self.txt_in(txt_in), temb_act
