"""Multi-modal DiT (MMDiT) backbone with the Region-Instruction KV cache.

Counterpart of `regione_tpu/models/mmdit.py` for the Step1X-Edit / FLUX
topology (double-stream blocks, then single-stream txt-concat blocks) and
the Qwen-Image-Edit topology (joint double-stream blocks only,
depth_single = 0, and an RMSNorm of the raw text features, `txt_norm`):
AdaLN-zero modulation, qk-RMSNorm and 3-axis RoPE; FLUX.1 Kontext adds its
distilled guidance scale to the timestep embedding (`guidance_embed`).
Three cache modes:

  mode="dense" : plain attention, no cache traffic;
  mode="write" : dense attention AND store the image-stream K/V in the cache
                 (filled in place: the port updates the cache tensors rather
                 than returning new ones, which keeps one copy on the card);
  mode="rags"  : the hidden stream holds the gathered edited tokens; they
                 attend over [fresh rows ‖ frozen cache] with the stale cache
                 rows of edited ids masked by the bias (kernel K2, or K2q
                 for a quantized cache).  RAGS writes nothing to the cache.

The cache stores attention-ready K (qk-norm and RoPE applied) and raw V,
head-major [L, B, H, S, dh] over the image rows ([noise ‖ condition]) only:
in the model dtype, or quantized (`cache_int8`, `cache_int4`: `ops.quant`
rows plus fp32 row-scale leaves "dk_s" ... of [L, B, H, S]; int4 keeps S/2
packed rows), which RAGS steps read through kernel K2q.
The blocks' elementwise chains (AdaLN, the gated residuals, qk-RMSNorm +
RoPE with the head-major packing, GELU) run through `ops.fused`, kernels
K7-K9 on the card; the double block's q / k / v are written straight
into one buffer over [txt ‖ img] rows each, with no concatenation.
The depth runs as a Python loop over `nn.ModuleList`s; linear1 of the single
blocks is one matmul, quantized or not (the JAX package's deferred-MLP split
was an XLA rematerialisation fix with the same math, and its `_slice_out`
halves are output columns of that one product; under W8A8 its input is
quantized once, as JAX's `row_projector` does).  Any linear may be an
`nn.Linear` or a quantized one (`ops.quant.quantize_params`).
Under tensor parallelism (`parallel.sharding.shard_params`) each rank holds
its heads (`Attention.heads`, `SingleBlock.heads / inner / mlp_hidden`
count the rank's own), its `ShardedLinear`s and a cache of its heads
(`init_cache(..., tp=)`); the attention kernels run unchanged on them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from regione_tpu_torch.models.connector import Connector, ConnectorConfig
from regione_tpu_torch.ops.fused import (adaln, gated_residual, gelu_pack,
                                         qk_norm_rope, residual_adaln)
from regione_tpu_torch.ops.quant import quantize_kv_heads, quantize_kv_heads4
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
    cache_int8: bool = False       # KV cache as int8 + per-(row, head)
                                   # fp32 scales (ops.quant)
    cache_int4: bool = False       # KV cache as S-halves packed int4 +
                                   # scales; exclusive with cache_int8
    act_int8: bool = False         # W8A8: int8-weight linears quantize
                                   # their input rows and run an int8
                                   # product (`layers.act_int8`); no-op
                                   # without int8 weights (ops.quant)
    dtype: Any = torch.bfloat16

    @property
    def inner(self) -> int:
        return self.heads * self.head_dim

    @property
    def cache_quant(self) -> bool:
        """Quantized-cache structure: (rows, scales) / "_s" leaves."""
        assert not (self.cache_int8 and self.cache_int4), \
            "cache_int8 and cache_int4 are mutually exclusive"
        return self.cache_int8 or self.cache_int4

    def quantize_kv(self, x):
        """Head-major K/V [..., S, dh] -> (rows, scales) of the cache."""
        return (quantize_kv_heads4 if self.cache_int4
                else quantize_kv_heads)(x)

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden * self.mlp_ratio)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _modulation(lin: nn.Linear, temb_act, n: int):
    return lin(temb_act)[:, None, :].chunk(n, dim=-1)


class Attention(nn.Module):
    """One stream's q/k/v/out projections and qk-RMSNorm scales."""

    def __init__(self, d_model: int, cfg: MMDiTConfig, device):
        super().__init__()
        dt, inner = cfg.dtype, cfg.inner
        self.heads, self.head_dim = cfg.heads, cfg.head_dim
        self.q = make_linear(d_model, inner, device, dt)
        self.k = make_linear(d_model, inner, device, dt)
        self.v = make_linear(d_model, inner, device, dt)
        self.out = make_linear(inner, d_model, device, dt)
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
    with the txt rows first."""

    def __init__(self, cfg: MMDiTConfig, device):
        super().__init__()
        h, dt = cfg.hidden, cfg.dtype
        self.img_mod = make_linear(h, 6 * h, device, dt)
        self.txt_mod = make_linear(h, 6 * h, device, dt)
        self.img_attn = Attention(h, cfg, device)
        self.txt_attn = Attention(h, cfg, device)
        self.img_mlp = MLP(h, cfg.mlp_hidden, h, device, dt)
        self.txt_mlp = MLP(h, cfg.mlp_hidden, h, device, dt)

    def forward(self, img, txt, temb_act, rope_img, rope_txt, mode,
                cache_k=None, cache_v=None, bias=None):
        """Returns (img, txt, (k_img, v_img) in write mode else None)."""
        (i_shift1, i_scale1, i_gate1,
         i_shift2, i_scale2, i_gate2) = _modulation(self.img_mod, temb_act, 6)
        (t_shift1, t_scale1, t_gate1,
         t_shift2, t_scale2, t_gate2) = _modulation(self.txt_mod, temb_act, 6)

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
            gelu_pack(None, self.img_mlp.in_(img_n2))))
        txt = gated_residual(txt, t_gate2, self.txt_mlp.out(
            gelu_pack(None, self.txt_mlp.in_(txt_n2))))
        return img, txt, new_kv


class SingleBlock(nn.Module):
    """Flux-style single-stream block over [txt ‖ img]: one fused qkv+MLP
    projection, parallel attention and MLP, one output projection."""

    def __init__(self, cfg: MMDiTConfig, device):
        super().__init__()
        h, dt = cfg.hidden, cfg.dtype
        self.heads, self.inner, self.mlp_hidden = (cfg.heads, cfg.inner,
                                                   cfg.mlp_hidden)
        self.mod = make_linear(h, 3 * h, device, dt)
        self.linear1 = make_linear(h, 3 * cfg.inner + cfg.mlp_hidden,
                                   device, dt)
        self.linear2 = make_linear(cfg.inner + cfg.mlp_hidden, h, device, dt)
        self.norm_q = Scale(cfg.head_dim, device, dt)
        self.norm_k = Scale(cfg.head_dim, device, dt)

    def forward(self, x, temb_act, rope, mode, cache_k=None, cache_v=None,
                bias=None, t_txt: int = 0):
        """Returns (x, (k_img, v_img) in write mode else None); the image
        rows of the stream start at `t_txt`."""
        shift, scale, gate = _modulation(self.mod, temb_act, 3)
        x_n = adaln(x, shift, scale)
        inner = self.inner
        q, k, v, mlp_h = self.linear1(x_n).split(
            [inner, inner, inner, self.mlp_hidden], dim=-1)
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
        out = self.linear2(gelu_pack(attn, mlp_h))
        return gated_residual(x, gate, out), new_kv


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_cache(cfg: MMDiTConfig, batch: int, s_kv_img: int, device,
               tp: int = 1):
    """Zeroed KV cache: {"dk", "dv"} (and {"sk", "sv"} with single blocks)
    of [L, B, H, S, dh], image rows only (txt rows re-embed every step).
    Quantized: int8 rows (S/2 packed rows under int4) and fp32 scale
    leaves "dk_s" ... of [L, B, H, S] filled with 1e-12, as in JAX.  `tp`:
    a tensor-parallel rank's cache holds its H / tp heads."""
    quant = cfg.cache_quant
    rows = s_kv_img
    if cfg.cache_int4:
        if s_kv_img % 2:
            raise ValueError(f"an int4 cache needs an even row count, got "
                             f"{s_kv_img}")
        rows //= 2
    depths = {"dk": cfg.depth_double, "dv": cfg.depth_double}
    if cfg.depth_single:
        depths.update(sk=cfg.depth_single, sv=cfg.depth_single)
    cache = {}
    for key, depth in depths.items():
        cache[key] = torch.zeros(
            (depth, batch, cfg.heads // tp, rows, cfg.head_dim),
            dtype=torch.int8 if quant else cfg.dtype, device=device)
        if quant:
            cache[key + "_s"] = torch.full(
                (depth, batch, cfg.heads // tp, s_kv_img), 1e-12,
                dtype=torch.float32, device=device)
    return cache


def _layer_kv(cache, key: str, i: int):
    """Layer i's cache entry: a tensor, or (rows, scales) when quantized."""
    if key + "_s" in cache:
        return cache[key][i], cache[key + "_s"][i]
    return cache[key][i]


def _store_kv(cfg: MMDiTConfig, cache, key: str, i: int, x):
    """Write mode: layer i's K or V rows into the cache, in place
    (quantized rows and scales under cache_int8 / cache_int4), in a span
    `model.cache_write` (CUDA events on x; attrs: the block index, the
    cache `key`, the rows, the bytes written and the format: int8, int4
    or the model dtype's name)."""
    fmt = ("int4" if cfg.cache_int4 else "int8" if cfg.cache_int8
           else str(cfg.dtype).removeprefix("torch."))
    with telemetry.span("model.cache_write", events_on=x, index=i, key=key,
                        rows=x.shape[-2], format=fmt) as sp:
        if cfg.cache_quant:
            rows, scales = cfg.quantize_kv(x)
            cache[key][i].copy_(rows)
            cache[key + "_s"][i].copy_(scales)
            written = (rows.numel() * rows.element_size()
                       + scales.numel() * scales.element_size())
        else:
            cache[key][i].copy_(x)
            written = x.numel() * x.element_size()
        sp.set(bytes=written)


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
        h, dt = cfg.hidden, cfg.dtype
        self.x_embedder = make_linear(cfg.in_channels, h, device, dt)
        self.time_in = mlp_embed_module(cfg.time_embed_dim, h, device, dt)
        self.txt_in = make_linear(cfg.txt_in_dim, h, device, dt)
        self.final_mod = make_linear(h, 2 * h, device, dt)
        self.final_proj = make_linear(h, cfg.out_channels, device, dt)
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg, device)
                                    for _ in range(cfg.depth_double))
        if cfg.pooled_dim:
            self.vector_in = mlp_embed_module(cfg.pooled_dim, h, device, dt)
        if cfg.guidance_embed:
            self.guidance_in = mlp_embed_module(cfg.time_embed_dim, h,
                                                device, dt)
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
        """`forward`, in host-only `utils.telemetry` spans: `model.embed`,
        `model.double_block` / `model.single_block` (attr `index`) and
        `model.final`; in write mode each block's span holds two
        `model.cache_write` spans (K, V), which time the device."""
        cfg = self.cfg
        if mode == MODE_WRITE and cache is None:
            cache = init_cache(cfg, img.shape[0], img.shape[1], img.device,
                               self.tp_size)
        with telemetry.span("model.embed"):
            x, txt_h, temb_act = self._embed(img, txt, t, pooled, guidance,
                                             txt_bias)
        t_txt = txt_h.shape[1]

        bias = txt_bias
        if mode == MODE_RAGS:
            # the cached row count: read off the scales under a quantized
            # cache (an int4 rows leaf holds S/2 packed rows)
            s_kv = cache["dk_s" if cfg.cache_quant else "dk"].shape[3]
            bias = rags_bias(sel_img_ids, s_kv, t_txt, x.shape[0], txt_bias)

        rags = mode == MODE_RAGS
        for i, blk in enumerate(self.double_blocks):
            with telemetry.span("model.double_block", index=i):
                ck = _layer_kv(cache, "dk", i) if rags else None
                cv = _layer_kv(cache, "dv", i) if rags else None
                x, txt_h, kv = blk(x, txt_h, temb_act, rope_img, rope_txt,
                                   mode, ck, cv, bias)
                if kv is not None:
                    _store_kv(cfg, cache, "dk", i, kv[0])
                    _store_kv(cfg, cache, "dv", i, kv[1])

        if cfg.depth_single:
            stream = torch.cat([txt_h, x], dim=1)
            rope_stream = concat_rope(rope_txt, rope_img)
            for i, blk in enumerate(self.single_blocks):
                with telemetry.span("model.single_block", index=i):
                    ck = _layer_kv(cache, "sk", i) if rags else None
                    cv = _layer_kv(cache, "sv", i) if rags else None
                    stream, kv = blk(stream, temb_act, rope_stream, mode, ck,
                                     cv, bias, t_txt=t_txt)
                    if kv is not None:
                        _store_kv(cfg, cache, "sk", i, kv[0])
                        _store_kv(cfg, cache, "sv", i, kv[1])
            x = stream[:, t_txt:]

        with telemetry.span("model.final"):
            shift, scale = _modulation(self.final_mod, temb_act, 2)
            return self.final_proj(adaln(x, shift, scale)), cache

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
