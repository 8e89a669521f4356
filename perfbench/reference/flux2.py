"""The plain RegionE edit of FLUX.2 [dev], over the edit of `sampler.py`.

What FLUX.2 [dev] (huggingface.co/black-forest-labs/FLUX.2-dev:
transformer/config.json, diffusers' Flux2Transformer2DModel and
Flux2Pipeline) changes in that edit, each written here from the model's
description:

  * no linear has a bias;
  * modulation is computed once a forward from silu(temb), by three
    linears: `double_mod_img` and `double_mod_txt` (h -> 6 h: shift,
    scale, gate for attention, then for the MLP), read by every double
    block's image and text stream, and `single_mod` (h -> 3 h), read by
    every single block;
  * temb is the timestep embedding plus the guidance embedding, each 256
    sinusoidal channels of t * 1000, then linear, SiLU, linear; no pooled
    text vector;
  * the MLP is a SwiGLU: the input projection gives [a ‖ b], 2 x mlp
    wide, the activation is silu(a) * b; the single block's `linear1`
    gives q, k, v and both halves (3 inner + 2 mlp), `linear2` maps
    [attn ‖ silu(a) * b] (inner + mlp) back to h;
  * rotary ids on four axes (t, h, w, l), interleaved pairs as FLUX.1:
    noise rows (0, y, x, 0), the reference image's rows (10, y, x, 0),
    text rows (0, 0, 0, l); theta 2000;
  * the sigmas: linspace(1, 1/N, N) under the exponential time shift with
    the empirical mu of diffusers' `compute_empirical_mu(L, N)` (the
    configuration's `schedule` group), the terminal 0 appended;
  * the stored K / V in the cache format the configuration states: under
    `cache_int8` kept as int8 codes and fp32 scales (per row and head,
    scale = amax |x| / 127 + 1e-12, codes x / scale rounded half to even
    and clamped to +-127: `qwen_image.int8_round_trip`), dequantized to
    the model dtype where a RAGS step reads them.  The codes take half the
    memory of the model dtype, which the 60 GiB of weights leave little of.

Departures from the published model: the prompt's text rows are all valid
(no padding mask), as the harness gives them; the final layer's AdaLN reads
its two chunks as (shift, scale), the order of the program's state dict
(diffusers stores them as (scale, shift): with random weights either order
is the same model); the sigmas are computed in float64 and rounded to
float32 once.  The blocks' own equations (layernorm, qk-RMSNorm, the
joint attention over [txt ‖ img], the K / V cache of RegionE) are
`model.py`'s.  Products in float32 run with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import inputs
from perfbench.reference import model as M
from perfbench.reference import plan as P
from perfbench.reference import sampler

REF_T = 10.0        # the t axis of the (first) reference image's rows
INT8_MAX = 127.0


def layout(config: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, draw, fan_in) of every weight, by the program's
    state-dict names: no bias, the three shared modulation linears, the
    SwiGLU widths."""
    m = config["model"]
    h, d = m["hidden"], m["head_dim"]
    inner, mlp = m["heads"] * d, int(h * m["mlp_ratio"])
    e = m["time_embed_dim"]
    out: list = []

    def lin(name, d_in, d_out):
        out.append((name + ".weight", (d_out, d_in), inputs.W, d_in))

    def norms(p):
        for n in ("norm_q", "norm_k"):
            out.append((f"{p}{n}.scale", (d,), inputs.NORM, 0))

    lin("x_embedder", m["in_channels"], h)
    for name in ("time_in", "guidance_in"):
        lin(name + ".in_", e, h)
        lin(name + ".out", h, h)
    lin("txt_in", m["txt_in_dim"], h)
    lin("double_mod_img", h, 6 * h)
    lin("double_mod_txt", h, 6 * h)
    lin("single_mod", h, 3 * h)
    lin("final_mod", h, 2 * h)
    lin("final_proj", h, m["out_channels"])
    for i in range(m["depth_double"]):
        p = f"double_blocks.{i}."
        for a in ("img_attn", "txt_attn"):
            for c in "qkv":
                lin(f"{p}{a}.{c}", h, inner)
            lin(f"{p}{a}.out", inner, h)
            norms(f"{p}{a}.")
        for s in ("img_mlp", "txt_mlp"):
            lin(f"{p}{s}.in_", h, 2 * mlp)
            lin(f"{p}{s}.out", mlp, h)
    for i in range(m["depth_single"]):
        p = f"single_blocks.{i}."
        lin(p + "linear1", h, 3 * inner + 2 * mlp)
        lin(p + "linear2", inner + mlp, h)
        norms(p)
    return out


def empirical_mu(steps: int, seq_len: int, sched: dict) -> float:
    """diffusers' `compute_empirical_mu(image_seq_len, num_steps)`."""
    m200 = sched["a2"] * seq_len + sched["b2"]
    if seq_len > sched["long_seq_len"]:
        return m200
    m10 = sched["a1"] * seq_len + sched["b1"]
    a = (m200 - m10) / 190.0
    return a * steps + (m200 - 200.0 * a)


def sigmas(steps: int, seq_len: int, sched: dict) -> np.ndarray:
    """steps + 1 sigmas, the terminal 0 appended, fp32."""
    mu = empirical_mu(steps, seq_len, sched)
    s = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    s = math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))
    return np.concatenate([s, [0.0]]).astype(np.float32)


def rotary_ids(grid: int, t_txt: int, device):
    """([2 S, 4] ids of the noise and the reference rows, [t_txt, 4] ids of
    the text rows)."""
    ys, xs = torch.meshgrid(torch.arange(grid, device=device),
                            torch.arange(grid, device=device), indexing="ij")
    zero = torch.zeros_like(ys)
    img = torch.cat([torch.stack([torch.full_like(ys, t), ys, xs, zero],
                                 -1).reshape(-1, 4) for t in (0, REF_T)])
    txt = torch.zeros((t_txt, 4), device=device)
    txt[:, 3] = torch.arange(t_txt, device=device)
    return img.float(), txt


def int8_codes(x):
    """x [..., S, D] as the int8 cache holds it: (codes, fp32 scales
    [..., S, 1])."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / INT8_MAX + 1e-12
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def joint(q, k, v, t_txt: int, key, mode, store: dict, keep, m: dict):
    """`model._joint` with the configuration's cache format: the image
    rows' K / V stored (write) as int8 codes under `cache_int8`, else as
    they are; read (rags) at the kept rows, dequantized to k's dtype."""
    if mode == "write":
        kv = (k[:, :, t_txt:], v[:, :, t_txt:])
        store[key] = tuple(int8_codes(x) if m.get("cache_int8")
                           else x.clone() for x in kv)
    elif mode == "rags":
        ck, cv = (
            (x[0].index_select(2, keep).float()
             * x[1].index_select(2, keep)).to(k.dtype)
            if isinstance(x, tuple) else x.index_select(2, keep)
            for x in store[key])
        k = torch.cat([k, ck], 2)
        v = torch.cat([v, cv], 2)
    return M.attend(q, k, v)


def swiglu(h):
    """silu(a) * b of h = [a ‖ b]."""
    a, b = h.chunk(2, -1)
    return F.silu(a) * b


def double_block(lin, w, p, img, txt, mods, rope_img, rope_txt, m, mode,
                 store, keep):
    n = m["heads"]
    mi, mt = mods
    img_n, txt_n = M.modulate(img, mi[0], mi[1]), M.modulate(txt, mt[0],
                                                           mt[1])

    def qkv(x, a, table):
        q, k, v = (M.heads(lin(x, f"{p}{a}.{c}"), n) for c in "qkv")
        q = M.rope(M.rmsnorm(q, w[f"{p}{a}.norm_q.scale"]), table)
        k = M.rope(M.rmsnorm(k, w[f"{p}{a}.norm_k.scale"]), table)
        return q, k, v

    tq, tk, tv = qkv(txt_n, "txt_attn", rope_txt)
    iq, ik, iv = qkv(img_n, "img_attn", rope_img)
    t_txt = txt.shape[1]
    attn = joint(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2),
                 torch.cat([tv, iv], 2), t_txt, p, mode, store, keep, m)
    img = img + mi[2] * lin(attn[:, t_txt:], p + "img_attn.out")
    txt = txt + mt[2] * lin(attn[:, :t_txt], p + "txt_attn.out")

    def mlp(x, s, name):
        h = swiglu(lin(M.modulate(x, s[3], s[4]), name + ".in_"))
        return x + s[5] * lin(h, name + ".out")

    return mlp(img, mi, p + "img_mlp"), mlp(txt, mt, p + "txt_mlp")


def single_block(lin, w, p, x, t_txt, mods, table, m, mode, store, keep):
    n, inner = m["heads"], m["heads"] * m["head_dim"]
    shift, scale, gate = mods
    h = lin(M.modulate(x, shift, scale), p + "linear1")
    q, k, v, mlp = h.split([inner, inner, inner, h.shape[-1] - 3 * inner],
                           -1)
    q = M.rope(M.rmsnorm(M.heads(q, n), w[p + "norm_q.scale"]), table)
    k = M.rope(M.rmsnorm(M.heads(k, n), w[p + "norm_k.scale"]), table)
    attn = joint(q, k, M.heads(v, n), t_txt, p, mode, store, keep, m)
    out = lin(torch.cat([attn, swiglu(mlp)], -1), p + "linear2")
    return x + gate * out


def forward(lin, m: dict, img, txt, t, rope_img, rope_txt, guidance=None,
            mode: str = "dense", store: dict | None = None, keep=None):
    """`model.forward` for FLUX.2: img [B, rows, C], txt [B, T, txt_in_dim]
    (model dtype), t [B] sigma in the model dtype, guidance [B] fp32.
    Returns the velocity [B, rows, C_out]."""
    w = lin.w
    dt = img.dtype
    e = m["time_embed_dim"]
    x = lin(img, "x_embedder")
    temb = lin.embed(M.timestep_embedding(t, e).to(dt), "time_in")
    if guidance is not None:
        temb = temb + lin.embed(M.timestep_embedding(guidance, e).to(dt),
                                "guidance_in")
    temb_act = F.silu(temb)
    double = tuple(lin(temb_act, name)[:, None].chunk(6, -1)
                   for name in ("double_mod_img", "double_mod_txt"))
    single = lin(temb_act, "single_mod")[:, None].chunk(3, -1)
    txt_h = lin(txt, "txt_in")
    store = {} if store is None else store
    for i in range(m["depth_double"]):
        x, txt_h = double_block(lin, w, f"double_blocks.{i}.", x, txt_h,
                                double, rope_img, rope_txt, m, mode, store,
                                keep)
    t_txt = txt_h.shape[1]
    stream = torch.cat([txt_h, x], 1)
    table = (torch.cat([rope_txt[0], rope_img[0]], 0),
             torch.cat([rope_txt[1], rope_img[1]], 0))
    for i in range(m["depth_single"]):
        stream = single_block(lin, w, f"single_blocks.{i}.", stream, t_txt,
                              single, table, m, mode, store, keep)
    x = stream[:, t_txt:]
    shift, scale = lin(temb_act, "final_mod")[:, None].chunk(2, -1)
    return lin(M.modulate(x, shift, scale), "final_proj")


def forward_items(config: dict, rows: int, s_kv: int, batch: int,
                  rags: bool) -> list[tuple]:
    """The work items of one forward (see `perfbench/work.py`): the
    linears (no bias; `work.gemm_work` counts N bytes of one, under a
    thousandth of a weight's bytes here), the attentions and each SwiGLU
    gate (K11) as an op of the `swiglu` group moving its input once and
    its output once: 2 mlp read and mlp written a row in a double block,
    inner + 2 mlp read and inner + mlp written in a single block."""
    m = config["model"]
    t = config["text"]["t_txt"]
    h, d, nh = m["hidden"], m["head_dim"], m["heads"]
    inner, mlp = nh * d, int(m["hidden"] * m["mlp_ratio"])
    b, e, by = batch, m["time_embed_dim"], 2
    keys = t + (s_kv if rags else rows)
    items = [("gemm", b * rows, h, m["in_channels"]),
             ("gemm", b, h, e), ("gemm", b, h, h),          # timestep
             ("gemm", b, h, e), ("gemm", b, h, h),          # guidance
             ("gemm", b, 6 * h, h), ("gemm", b, 6 * h, h),  # shared
             ("gemm", b, 3 * h, h),                          # modulation
             ("gemm", b * t, h, m["txt_in_dim"])]
    for _ in range(m["depth_double"]):
        for n in (rows, t):
            items += [("gemm", b * n, inner, h)] * 3
            items += [("gemm", b * n, h, inner), ("gemm", b * n, 2 * mlp, h),
                      ("op", "swiglu", by * b * n * 3 * mlp),
                      ("gemm", b * n, h, mlp)]
        items.append(("attn", b, nh, t + rows, keys, d))
    for _ in range(m["depth_single"]):
        n = t + rows
        items += [("gemm", b * n, 3 * inner + 2 * mlp, h),
                  ("attn", b, nh, n, keys, d),
                  ("op", "swiglu", by * b * n * (2 * inner + 3 * mlp)),
                  ("gemm", b * n, h, inner + mlp)]
    items += [("gemm", b, 2 * h, h), ("gemm", b * rows, m["out_channels"], h)]
    return items


class Reference(sampler.Reference):
    """The plain FLUX.2 [dev] edit (see the module docstring)."""

    def __init__(self, config: dict, weights: dict, grid: int, device,
                 lower=None):
        """`sampler.Reference`'s state, with this module's sigmas and
        four-axis rotary tables (the base builds three-axis ones)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.c = config
        self.m = config["model"]
        self.dt = getattr(torch, config["dtype"])
        self.lin = M.Linear(weights, lower)
        self.knobs = P.Knobs.of(config["regione"])
        self.grid = grid
        self.s = grid * grid
        sig = sigmas(self.knobs.num_inference_steps, self.s,
                     config["schedule"])
        self.plan = P.build_plan(self.knobs, sig, config["gamma"])
        self.cfg_scale = float(config["guidance"].get("true_cfg_scale",
                                                      1.0))
        self.batch_cfg = self.cfg_scale > 1.0
        img, txt = rotary_ids(grid, config["text"]["t_txt"], device)
        axes, theta = self.m["axes_dims"], self.m["rope_theta"]
        self.rope_img = M.rope_tables(img, axes, theta)
        self.rope_txt = M.rope_tables(txt, axes, theta)

    def velocity(self, rows, sigma: float, req, mode="dense", store=None,
                 edited=None, keep=None):
        """`sampler.Reference.velocity` over this module's `forward`."""
        dt, n = self.dt, rows.shape[1]
        if mode == "rags":
            img = rows.to(dt)
            table = (self.rope_img[0][edited], self.rope_img[1][edited])
        else:
            img = torch.cat([rows.to(dt), req["cond"].to(dt)], 1)
            table = self.rope_img
        if self.batch_cfg:
            img = torch.cat([img, img])
        t = torch.full((img.shape[0],), float(np.float32(sigma)), dtype=dt,
                       device=img.device)
        v = forward(self.lin, self.m, img, req["txt"], t, table,
                    self.rope_txt, guidance=req.get("guidance"), mode=mode,
                    store=store, keep=keep)
        v = v[:, :n].float()
        if not self.batch_cfg:
            return v
        pos, neg = v.chunk(2)
        return self.combine(pos, neg, sigma)
