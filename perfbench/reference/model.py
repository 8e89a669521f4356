"""The plain MMDiT forward of the benchmark's reference: plain PyTorch ops
over a dict of weights, with no kernel, no fused op and nothing of the
program.

It follows the published FLUX.1 / Step1X-Edit block equations as the JAX
package writes them (`regione_tpu/models/mmdit.py`, `layers.py`,
`connector.py`): AdaLN-zero modulation, qk-RMSNorm, 3-axis RoPE with
consecutive-pair rotation, double-stream blocks with the text rows first,
then single-stream blocks over [txt ‖ img], FLUX's distilled guidance
embedding and Step1X's Qwen2.5-VL connector.  Precision is the
configuration's: weights and activations in its dtype (bf16 at the
published widths), norms, RoPE and the softmax in fp32, every linear
accumulated in fp32 by the matmul.  Attention is
`F.scaled_dot_product_attention` over the keys a query needs.

Three modes (`forward(mode=...)`):
  "dense": every image row, no cache;
  "write": the same, and the image rows' K / V of every block stored;
  "rags":  the image stream holds the edited rows only; their queries see
           [txt ‖ the edited rows' fresh K / V ‖ the stored K / V of every
           other image row] (`keep`): the frozen cache of RegionE, with the
           edited rows' stale entries left out rather than masked.

`Linear` decides how a linear multiplies: in the configuration's dtype, or
with both operands rounded to a lower precision first (the control; per
row of the activations and per output channel of the weights).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # largest finite float8 e4m3


def round_rows(x, dtype):
    """x rounded to `dtype` along its last axis, each row scaled to the
    format's range first (fp8), and returned in x's dtype."""
    if dtype == torch.float8_e4m3fn:
        xf = x.float()
        s = xf.abs().amax(-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
        return ((xf / s).to(dtype).float() * s).to(x.dtype)
    return x.to(dtype).to(x.dtype)


class Linear:
    """y = x W^T + b over the weights dict; `lower`: the dtype both
    operands are rounded to first (None: the configuration's own)."""

    def __init__(self, weights: dict, lower=None):
        self.w = weights
        self.lower = lower

    def __call__(self, x, name: str):
        w, b = self.w[name + ".weight"], self.w.get(name + ".bias")
        if self.lower is not None:
            x, w = round_rows(x, self.lower), round_rows(w, self.lower)
        return F.linear(x, w, b)

    def embed(self, x, name: str):
        """The two-layer SiLU MLP of the time / vector / guidance embeds."""
        return self(F.silu(self(x, name + ".in_")), name + ".out")


def layernorm(x, scale=None, bias=None, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True)
                                  + eps)
    if scale is not None:
        out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def modulate(x, shift, scale):
    return layernorm(x) * (1 + scale) + shift


def timestep_embedding(t, dim: int):
    """[cos ‖ sin] of t * 1000 at dim / 2 frequencies, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * 1000.0 * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def rope_tables(ids, axes_dims, theta: float):
    """ids [S, 3] -> (cos, sin) [S, head_dim], each frequency twice."""
    cos, sin = [], []
    for a, d in enumerate(axes_dims):
        freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                        device=ids.device) / d)
        ang = (ids[:, a].float()[:, None] * freqs[None]).repeat_interleave(
            2, -1)
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def grid_ids(h: int, w: int, axis0: int, device):
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([torch.full_like(ys, axis0), ys, xs], -1).reshape(
        -1, 3).float()


def rope(x, table):
    """x [B, H, S, D] rotated by (cos, sin) [S, D] in fp32: each pair
    (a, b) -> (a cos - b sin, b cos + a sin)."""
    cos, sin = table
    xf = x.float()
    pairs = xf.reshape(*xf.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).reshape(xf.shape)
    return (xf * cos + rot * sin).to(x.dtype)


def heads(x, n: int):
    b, s, d = x.shape
    return x.reshape(b, s, n, d // n).transpose(1, 2)


def attend(q, k, v):
    """softmax(q k^T / sqrt(D)) v over [B, H, T, D] -> [B, T, H * D]."""
    out = F.scaled_dot_product_attention(q, k, v)
    b, h, t, d = out.shape
    return out.transpose(1, 2).reshape(b, t, h * d)


def _joint(q, k, v, t_txt: int, key, mode, store: dict, keep):
    """Attention of one block; stores (write) or reads (rags) the image
    rows' K / V in `store` under the block's `key`.  q / k / v: [B, H,
    t_txt + rows, D], the text rows first."""
    if mode == "write":
        store[key] = (k[:, :, t_txt:].clone(), v[:, :, t_txt:].clone())
    elif mode == "rags":
        ck, cv = store[key]
        k = torch.cat([k, ck.index_select(2, keep)], 2)
        v = torch.cat([v, cv.index_select(2, keep)], 2)
    return attend(q, k, v)


def double_block(lin, w, p, img, txt, temb_act, rope_img, rope_txt, m,
                 mode, store, keep):
    n = m["heads"]
    mi = lin(temb_act, p + "img_mod")[:, None].chunk(6, -1)
    mt = lin(temb_act, p + "txt_mod")[:, None].chunk(6, -1)
    img_n, txt_n = modulate(img, mi[0], mi[1]), modulate(txt, mt[0], mt[1])

    def qkv(x, a, table):
        q, k, v = (heads(lin(x, f"{p}{a}.{c}"), n) for c in "qkv")
        q = rope(rmsnorm(q, w[f"{p}{a}.norm_q.scale"]), table)
        k = rope(rmsnorm(k, w[f"{p}{a}.norm_k.scale"]), table)
        return q, k, v

    tq, tk, tv = qkv(txt_n, "txt_attn", rope_txt)
    iq, ik, iv = qkv(img_n, "img_attn", rope_img)
    t_txt = txt.shape[1]
    attn = _joint(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2),
                  torch.cat([tv, iv], 2), t_txt, p, mode, store, keep)
    img = img + mi[2] * lin(attn[:, t_txt:], p + "img_attn.out")
    txt = txt + mt[2] * lin(attn[:, :t_txt], p + "txt_attn.out")

    def mlp(x, s, name):
        h = F.gelu(lin(modulate(x, s[3], s[4]), name + ".in_"),
                   approximate="tanh")
        return x + s[5] * lin(h, name + ".out")

    return mlp(img, mi, p + "img_mlp"), mlp(txt, mt, p + "txt_mlp")


def single_block(lin, w, p, x, t_txt, temb_act, table, m, mode, store,
                 keep):
    n, inner = m["heads"], m["heads"] * m["head_dim"]
    shift, scale, gate = lin(temb_act, p + "mod")[:, None].chunk(3, -1)
    h = lin(modulate(x, shift, scale), p + "linear1")
    q, k, v, mlp = h.split([inner, inner, inner, h.shape[-1] - 3 * inner],
                           -1)
    q = rope(rmsnorm(heads(q, n), w[p + "norm_q.scale"]), table)
    k = rope(rmsnorm(heads(k, n), w[p + "norm_k.scale"]), table)
    attn = _joint(q, k, heads(v, n), t_txt, p, mode, store, keep)
    out = lin(torch.cat([attn, F.gelu(mlp, approximate="tanh")], -1),
              p + "linear2")
    return x + gate * out


def connector(lin, w, c, feats, t):
    """Step1X's text refiner: feats [B, T, in_dim] -> (refined [B, T,
    hidden], pooled y [B, pooled_dim]); every text row valid."""
    dt = feats.dtype
    mean = feats.float().mean(1)
    y = lin((mean * (1.0 + w["connector.scale_factor"].float())).to(dt),
            "connector.global_proj")
    x = lin(feats, "connector.in_proj")
    temb = lin.embed(timestep_embedding(t, c["time_embed_dim"]).to(dt),
                     "connector.t_embed")
    cvec = F.silu(temb + lin.embed(mean.to(dt), "connector.c_embed"))
    for j in range(c["depth"]):
        p = f"connector.blocks.{j}."
        g_attn, g_mlp = lin(cvec, p + "mod")[:, None].chunk(2, -1)
        h = layernorm(x, w[p + "norm1.scale"], w[p + "norm1.bias"])
        q, k, v = (heads(lin(h, p + "attn." + s), c["heads"]) for s in "qkv")
        x = x + g_attn * lin(attend(q, k, v), p + "attn.out")
        h = layernorm(x, w[p + "norm2.scale"], w[p + "norm2.bias"])
        x = x + g_mlp * lin(F.silu(lin(h, p + "mlp.in_")), p + "mlp.out")
    return x, y


def forward(lin, m: dict, img, txt, t, rope_img, rope_txt, pooled=None,
            guidance=None, mode: str = "dense", store: dict | None = None,
            keep=None):
    """img [B, rows, C] (model dtype); txt [B, T, features] (the
    connector's in_dim where there is one, else txt_in_dim); t [B] sigma
    in the model dtype; guidance [B] fp32; rope tables over the image rows
    and the text rows.  Returns the velocity [B, rows, C_out]."""
    w = lin.w
    dt = img.dtype
    x = lin(img, "x_embedder")
    temb = lin.embed(timestep_embedding(t, m["time_embed_dim"]).to(dt),
                     "time_in")
    conn = m.get("connector")
    if m["pooled_dim"] and pooled is not None and conn is None:
        temb = temb + lin.embed(pooled, "vector_in")
    if m["guidance_embed"] and guidance is not None:
        temb = temb + lin.embed(
            timestep_embedding(guidance, m["time_embed_dim"]).to(dt),
            "guidance_in")
    if conn is not None:
        txt, y = connector(lin, w, conn, txt, t)
        if m["pooled_dim"]:
            temb = temb + lin.embed(y, "vector_in")
    temb_act = F.silu(temb)
    txt_h = lin(txt, "txt_in")
    store = {} if store is None else store
    for i in range(m["depth_double"]):
        x, txt_h = double_block(lin, w, f"double_blocks.{i}.", x, txt_h,
                                temb_act, rope_img, rope_txt, m, mode,
                                store, keep)
    t_txt = txt_h.shape[1]
    if m["depth_single"]:
        stream = torch.cat([txt_h, x], 1)
        table = (torch.cat([rope_txt[0], rope_img[0]], 0),
                 torch.cat([rope_txt[1], rope_img[1]], 0))
        for i in range(m["depth_single"]):
            stream = single_block(lin, w, f"single_blocks.{i}.", stream,
                                  t_txt, temb_act, table, m, mode, store,
                                  keep)
        x = stream[:, t_txt:]
    shift, scale = lin(temb_act, "final_mod")[:, None].chunk(2, -1)
    return lin(modulate(x, shift, scale), "final_proj")
