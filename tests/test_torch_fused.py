"""The fused block kernels' wrappers (`regione_tpu_torch.ops.fused`: K7
AdaLN with the gated residual, K8 qk-RMSNorm + RoPE + head packing, K9
GELU + concatenation, K11 the SwiGLU gate + concatenation) against the JAX
package's expressions, and the blocks that call them against the eager
blocks they replace.

On the CPU every wrapper takes its plain version.  The same numpy inputs go
through the JAX expression (`regione_tpu.models.layers`) and the wrapper:

  * fp32: within 1e-6 of the output's scale (the fp32 sums of the norms run
    in another order in the two frameworks);
  * bf16: within one bf16 ulp of the output's scale.  The JAX expressions
    run op by op on bf16 operands, so they round where the wrapper does
    (K7: gate * y, the new x, the LN output, 1 + scale, the product, the
    sum; K8: the RMSNorm output, then the rotation); only K9's reference is
    `jax.nn.gelu` in fp32 rounded once to bf16, which is what PyTorch's
    `F.gelu` and the kernel compute (a jitted bf16 `jax.nn.gelu` keeps
    other rounding points), and K11's `jax.nn.silu` in fp32 rounded once,
    times b in the dtype (PyTorch's `F.silu(a) * b`).

The block-level cases hold `DoubleBlock` / `SingleBlock` (dense, write and
RAGS mode) and the whole forward bit for bit against the eager blocks the
port ran before the fused kernels (copied below), packed q / k / v and the
cache rows `new_kv` included.  The `cuda`-marked tests hold each kernel
against its plain version on the card (K7 up to FLUX.2's h 6144, K11 at
its two blocks' shapes), and K7's outputs at h 3072, the width of every
configuration measured before FLUX.2, bit for bit against digests of the
kernel before its 6144-wide instantiation was added.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.models import layers as jl
from regione_tpu_torch.models import kv_cache
from regione_tpu_torch.models import mmdit as tm
from regione_tpu_torch.models.layers import (apply_rope, gather_rope,
                                             layernorm, project_rows,
                                             rmsnorm, rope_table, split_heads)
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.ops import fused
from regione_tpu_torch.weights.from_jax import init_params
from torch_cpu import fake_lib  # noqa: F401 (fixture)
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
B, S = 2, 5          # S off every multiple of 8: a ragged row count


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _pair(a, dtype):
    """(torch, jax) copies of the numpy array `a` in `dtype`'s pair."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _assert_within(got, want, dtype):
    """got (torch) against want (numpy fp32): 1e-6 of the scale in fp32,
    one bf16 ulp of the scale in bf16."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    tol = 1e-6 * scale if dtype == "fp32" else \
        2.0 ** (np.floor(np.log2(scale)) - 7)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol, (err, tol, scale)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _mods(h, n, seed, dtype):
    """n modulation vectors [B, 1, h]: chunks of one [B, 1, n*h] tensor (the
    strided views `_modulation` gives the kernel)."""
    t, j = _pair(_rand((B, 1, n * h), seed, 0.3), dtype)
    return t.chunk(n, dim=-1), jnp.split(j, n, axis=-1)


@pytest.mark.parametrize("strided_x", [False, True])
@pytest.mark.parametrize("mode", ["adaln", "residual_adaln",
                                  "gated_residual"])
@pytest.mark.parametrize("h", [1536, 3072, 6144])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_adaln_matches_jax(dtype, h, mode, strided_x):
    """strided_x: x is rows 3.. of a wider stream (the final layer's
    `stream[:, t_txt:]` view)."""
    xt, xj = _pair(_rand((B, S + 3, h), 0, 2.0) + 0.5, dtype)
    if strided_x:
        xt, xj = xt[:, 3:], xj[:, 3:]
    else:
        xt, xj = xt[:, :S].contiguous(), xj[:, :S]
    yt, yj = _pair(_rand((B, S, h), 1), dtype)
    (shift, scale, gate), (jshift, jscale, jgate) = _mods(h, 3, 2, dtype)

    def jax_adaln(x):
        return jl.layernorm(x) * (1 + jscale) + jshift
    if mode == "adaln":
        _assert_within(fused.adaln(xt, shift, scale), jax_adaln(xj), dtype)
        return
    jx = xj + jgate * yj
    if mode == "gated_residual":
        _assert_within(fused.gated_residual(xt, gate, yt), jx, dtype)
        return
    new_x, out = fused.residual_adaln(xt, gate, yt, shift, scale)
    _assert_within(new_x, jx, dtype)
    _assert_within(out, jax_adaln(jx), dtype)


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def _tables(per_batch: bool):
    """fp32 RoPE tables over S rows: shared [S, 128] (rope_table) or one per
    batch row [B, S, 128] (gather_rope of padded ids, as RAGS steps
    build them; the last id of row 1 is a pad slot)."""
    ids = np.stack([np.zeros(12), np.arange(12) // 4, np.arange(12) % 4],
                   -1).astype(np.float32)
    axes = (16, 56, 56)
    tab = rope_table(torch.from_numpy(ids), axes)
    jtab = jl.rope_table(jnp.asarray(ids), axes)
    if not per_batch:
        return tuple(t[:S] for t in tab), tuple(t[:S] for t in jtab)
    sel = np.array([[0, 3, 5, 7, 11], [2, 4, 6, 9, 12]], np.int32)
    got = gather_rope(tab, torch.from_numpy(sel))
    want = tuple(jnp.stack([jl.gather_rope(jtab, jnp.asarray(r))[i]
                            for r in sel]) for i in (0, 1))
    return got, want


def _jax_qk(xj, heads, scale, rope, per_batch):
    x = jl.split_heads(xj, heads)
    if scale is not None:
        x = jl.rmsnorm(x, scale)
    if rope is None:
        return x
    if not per_batch:
        return jl.apply_rope(x, rope)
    return jnp.concatenate([jl.apply_rope(x[b:b + 1], (rope[0][b],
                                                       rope[1][b]))
                            for b in range(x.shape[0])], 0)


@pytest.mark.parametrize("layout", ["new", "packed", "linear1_packed"])
@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("heads", [6, 24])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_qk_norm_rope_matches_jax(dtype, heads, per_batch, layout):
    """layout: a new tensor from a projection's output; written at row 7 of
    a packed [B, H, 7 + S + 4, 128] buffer; the same from a column slice of
    the fused linear1's output (row stride 3 * inner + mlp)."""
    inner = heads * 128
    if layout == "linear1_packed":               # k's columns
        xt, xj = _pair(_rand((B, S, 3 * inner + 2 * inner), 3), dtype)
        xt, xj = xt[..., inner:2 * inner], xj[..., inner:2 * inner]
        assert xt.stride(1) == 5 * inner
    else:
        xt, xj = _pair(_rand((B, S, inner), 3), dtype)
    st, sj = _pair(1.0 + _rand((128,), 4, 0.2), dtype)
    rope, jrope = _tables(per_batch)
    want = _jax_qk(xj, heads, sj, jrope, per_batch)
    if layout == "new":
        _assert_within(fused.qk_norm_rope(xt, heads, st, rope), want, dtype)
        return
    out = torch.full((B, heads, 7 + S + 4, 128), 7.0, dtype=xt.dtype)
    assert fused.qk_norm_rope(xt, heads, st, rope, out=out, row0=7) is out
    _assert_within(out[:, :, 7:7 + S], want, dtype)
    outside = torch.cat([out[:, :, :7], out[:, :, 7 + S:]], 2)
    assert bool((outside == 7.0).all())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_packing_alone_copies_the_heads(dtype):
    """No scale, no rope: v's packing, exact."""
    xt, xj = _pair(_rand((B, S, 6 * 128), 5), dtype)
    out = torch.zeros((B, 6, 2 + S, 128), dtype=xt.dtype)
    fused.qk_norm_rope(xt, 6, out=out, row0=2)
    np.testing.assert_array_equal(
        out[:, :, 2:].float().numpy(),
        np.asarray(jl.split_heads(xj, 6).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strided_h", [False, True])
@pytest.mark.parametrize("with_attn", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gelu_pack_matches_jax(dtype, with_attn, strided_h):
    """strided_h: the MLP half of linear1's output (row stride 3 * inner +
    mlp); the reference is jax.nn.gelu in fp32 on the same (rounded)
    inputs, rounded once to the dtype."""
    inner, mlp = 256, 1024
    wide_t, wide_j = _pair(_rand((B, S, 3 * inner + mlp), 6, 2.0), dtype)
    if strided_h:
        ht, hj = wide_t[..., 3 * inner:], wide_j[..., 3 * inner:]
    else:
        ht = wide_t[..., 3 * inner:].contiguous()
        hj = wide_j[..., 3 * inner:]
    at, aj = _pair(_rand((B, S, inner), 7), dtype)
    g = jax.nn.gelu(hj.astype(jnp.float32), approximate=True).astype(
        hj.dtype)
    want = jnp.concatenate([aj, g], -1) if with_attn else g
    got = fused.gelu_pack(at if with_attn else None, ht)
    _assert_within(got, want.astype(jnp.float32), dtype)
    if with_attn:
        assert torch.equal(got[..., :inner], at)


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strided_h", [False, True])
@pytest.mark.parametrize("with_attn", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_swiglu_pack_matches_jax(dtype, with_attn, strided_h):
    """strided_h: the MLP part of FLUX.2's linear1 output (row stride 3 *
    inner + 2 * mlp); the reference is jax.nn.silu in fp32 on the same
    (rounded) a, rounded once to the dtype, times b in the dtype."""
    inner, mlp = 256, 768
    wide_t, wide_j = _pair(_rand((B, S, 3 * inner + 2 * mlp), 8, 2.0),
                           dtype)
    if strided_h:
        ht, hj = wide_t[..., 3 * inner:], wide_j[..., 3 * inner:]
    else:
        ht = wide_t[..., 3 * inner:].contiguous()
        hj = wide_j[..., 3 * inner:]
    at, aj = _pair(_rand((B, S, inner), 9), dtype)
    a, b = hj[..., :mlp], hj[..., mlp:]
    g = jax.nn.silu(a.astype(jnp.float32)).astype(hj.dtype) * b
    want = jnp.concatenate([aj, g], -1) if with_attn else g
    got = fused.swiglu_pack(at if with_attn else None, ht)
    assert got.shape == (B, S, (inner if with_attn else 0) + mlp)
    _assert_within(got, want.astype(jnp.float32), dtype)
    if with_attn:
        assert torch.equal(got[..., :inner], at)


def test_swiglu_pack_rounds_as_the_plain_bf16_gate():
    """bf16: silu(a) rounded once, then the product rounded once, as
    `F.silu(a) * b` on bf16 tensors computes them."""
    h = torch.from_numpy(_rand((B, S, 2 * 64), 10, 3.0)).to(torch.bfloat16)
    a, b = h[..., :64], h[..., 64:]
    silu = (a.float() / (1.0 + torch.exp(-a.float()))).to(torch.bfloat16)
    assert torch.equal(fused.swiglu_pack(None, h),
                       (silu.float() * b.float()).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the blocks and the forward, bit for bit against the eager blocks
# ---------------------------------------------------------------------------

def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def _eager_qkv(att, x, rope):
    q, k, v = project_rows(x, (att.q, att.k, att.v))
    q = rmsnorm(split_heads(q, att.heads), att.norm_q.scale)
    k = rmsnorm(split_heads(k, att.heads), att.norm_k.scale)
    v = split_heads(v, att.heads)
    return apply_rope(q, rope), apply_rope(k, rope), v


def _eager_double(blk, img, txt, temb_act, rope_img, rope_txt, mode,
                  cache_k=None, cache_v=None, bias=None):
    """`DoubleBlock.forward` as the port ran it before the fused kernels."""
    (i_shift1, i_scale1, i_gate1,
     i_shift2, i_scale2, i_gate2) = tm._modulation(blk.img_mod, temb_act, 6)
    (t_shift1, t_scale1, t_gate1,
     t_shift2, t_scale2, t_gate2) = tm._modulation(blk.txt_mod, temb_act, 6)
    img_n = layernorm(img) * (1 + i_scale1) + i_shift1
    txt_n = layernorm(txt) * (1 + t_scale1) + t_shift1
    q_i, k_i, v_i = _eager_qkv(blk.img_attn, img_n, rope_img)
    q_t, k_t, v_t = _eager_qkv(blk.txt_attn, txt_n, rope_txt)
    q = torch.cat([q_t, q_i], dim=2)
    k = torch.cat([k_t, k_i], dim=2)
    v = torch.cat([v_t, v_i], dim=2)
    new_kv = None
    if mode == tm.MODE_RAGS:
        attn = tm.sdpa_cached(q, (k, v), cache_k, cache_v, bias=bias)
    else:
        if mode == tm.MODE_WRITE:
            new_kv = (k_i, v_i)
        attn = tm.sdpa(q, k, v, bias=bias)
    t_len = txt.shape[1]
    attn_txt, attn_img = attn[:, :t_len], attn[:, t_len:]
    img = img + i_gate1 * blk.img_attn.out(attn_img)
    txt = txt + t_gate1 * blk.txt_attn.out(attn_txt)
    img_n2 = layernorm(img) * (1 + i_scale2) + i_shift2
    img = img + i_gate2 * blk.img_mlp.out(_gelu(blk.img_mlp.in_(img_n2)))
    txt_n2 = layernorm(txt) * (1 + t_scale2) + t_shift2
    txt = txt + t_gate2 * blk.txt_mlp.out(_gelu(blk.txt_mlp.in_(txt_n2)))
    return img, txt, new_kv


def _eager_single(blk, x, temb_act, rope, mode, cache_k=None, cache_v=None,
                  bias=None, t_txt: int = 0):
    """`SingleBlock.forward` as the port ran it before the fused kernels."""
    shift, scale, gate = tm._modulation(blk.mod, temb_act, 3)
    x_n = layernorm(x) * (1 + scale) + shift
    inner = blk.inner
    q, k, v, mlp_h = blk.linear1(x_n).split(
        [inner, inner, inner, blk.mlp_hidden], dim=-1)
    q = apply_rope(rmsnorm(split_heads(q, blk.heads), blk.norm_q.scale),
                   rope)
    k = apply_rope(rmsnorm(split_heads(k, blk.heads), blk.norm_k.scale),
                   rope)
    v = split_heads(v, blk.heads)
    new_kv = None
    if mode == tm.MODE_RAGS:
        attn = tm.sdpa_cached(q, (k, v), cache_k, cache_v, bias=bias)
    else:
        if mode == tm.MODE_WRITE:
            new_kv = (k[:, :, t_txt:], v[:, :, t_txt:])
        attn = tm.sdpa(q, k, v, bias=bias)
    out = blk.linear2(torch.cat([attn, _gelu(mlp_h)], dim=-1))
    return x + gate * out, new_kv


def _eager_final(x, shift, scale):
    return layernorm(x) * (1 + scale) + shift


def _model(preset, dtype):
    dt = DTYPES[dtype][0]
    cfg = dataclasses.replace(get_config(preset), dtype=dt)
    if cfg.connector is not None:
        cfg = dataclasses.replace(cfg, connector=dataclasses.replace(
            cfg.connector, dtype=dt))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():          # biases and norm scales away from 0 / 1
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.dtype))
    return cfg, model


def _capture(monkeypatch):
    """Record the q / k / v every attention call of the blocks receives."""
    seen = []
    sdpa, sdpa_cached = tm.sdpa, tm.sdpa_cached

    def rec(q, k, v, bias=None):
        seen.append((q, k, v))
        return sdpa(q, k, v, bias=bias)

    def rec_cached(q, txt_kv, k_cache, v_cache, bias=None):
        seen.append((q, *txt_kv))
        return sdpa_cached(q, txt_kv, k_cache, v_cache, bias=bias)
    monkeypatch.setattr(tm, "sdpa", rec)
    monkeypatch.setattr(tm, "sdpa_cached", rec_cached)
    return seen


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


GRID, T_TXT, CAP = 4, 3, 5


def _block_inputs(cfg, mode, seed=0):
    """(img, txt, temb_act, rope_img, rope_txt, cache_k, cache_v, bias) of
    one block call; RAGS: CAP gathered rows with per-row tables over a
    2 * GRID^2 cache, the last slot of row 1 a pad."""
    dt, h = cfg.dtype, cfg.hidden
    s_kv = 2 * GRID * GRID
    ids = np.stack([np.zeros(s_kv + T_TXT), np.arange(s_kv + T_TXT) // 4,
                    np.arange(s_kv + T_TXT) % 4], -1).astype(np.float32)
    tab = rope_table(torch.from_numpy(ids), cfg.axes_dims)
    rope_txt = tuple(t[:T_TXT] for t in tab)
    rope_img = tuple(t[T_TXT:] for t in tab)
    rows = s_kv
    ck = cv = None
    bias = torch.zeros((B, 1, 1, T_TXT + s_kv))
    bias[1, ..., T_TXT - 1] = -1e9
    if mode == tm.MODE_RAGS:
        sel = torch.tensor([[0, 5, 9, 20, 31], [2, 3, 17, 30, s_kv]])
        rope_img = gather_rope(rope_img, sel)
        rows = CAP
        shape = (B, cfg.heads, s_kv, cfg.head_dim)
        ck = torch.from_numpy(_rand(shape, seed + 4)).to(dt)
        cv = torch.from_numpy(_rand(shape, seed + 5)).to(dt)
        bias = tm.rags_bias(sel, s_kv, T_TXT, B, bias)
    img = torch.from_numpy(_rand((B, rows, h), seed + 1)).to(dt)
    txt = torch.from_numpy(_rand((B, T_TXT, h), seed + 2)).to(dt)
    temb_act = torch.from_numpy(_rand((B, h), seed + 3)).to(dt)
    return img, txt, temb_act, rope_img, rope_txt, ck, cv, bias


MODES = [tm.MODE_DENSE, tm.MODE_WRITE, tm.MODE_RAGS]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_double_block_is_bit_equal_to_the_eager_block(monkeypatch, dtype,
                                                      mode):
    cfg, model = _model("tiny", dtype)
    blk = model.double_blocks[0]
    img, txt, temb, rope_img, rope_txt, ck, cv, bias = _block_inputs(cfg,
                                                                     mode)
    seen = _capture(monkeypatch)
    with torch.no_grad():
        want = _eager_double(blk, img, txt, temb, rope_img, rope_txt, mode,
                             ck, cv, bias)
        got = blk(img, txt, temb, rope_img, rope_txt, mode, ck, cv, bias)
    (wq, wk, wv), (gq, gk, gv) = seen
    for a, b in ((gq, wq), (gk, wk), (gv, wv), (got[0], want[0]),
                 (got[1], want[1])):
        _equal(a, b)
    assert (got[2] is None) == (want[2] is None) == (mode != tm.MODE_WRITE)
    if mode == tm.MODE_WRITE:
        _equal(got[2][0], want[2][0])
        _equal(got[2][1], want[2][1])
        assert got[2][0].data_ptr() == gk[:, :, T_TXT:].data_ptr()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_single_block_is_bit_equal_to_the_eager_block(monkeypatch, dtype,
                                                      mode):
    cfg, model = _model("tiny", dtype)
    blk = model.single_blocks[0]
    img, txt, temb, rope_img, rope_txt, ck, cv, bias = _block_inputs(cfg,
                                                                     mode)
    x = torch.cat([txt, img], 1)
    rope = tm.concat_rope(rope_txt, rope_img)
    seen = _capture(monkeypatch)
    with torch.no_grad():
        want = _eager_single(blk, x, temb, rope, mode, ck, cv, bias, T_TXT)
        got = blk(x, temb, rope, mode, ck, cv, bias, t_txt=T_TXT)
    for a, b in zip(seen[1], seen[0]):
        _equal(a, b)
    _equal(got[0], want[0])
    if mode == tm.MODE_WRITE:
        _equal(got[1][0], want[1][0])
        _equal(got[1][1], want[1][1])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("preset", ["tiny-step1x", "tiny-qwen"])
def test_forward_is_bit_equal_to_the_eager_blocks(monkeypatch, preset, mode):
    """The whole bf16 forward (write mode's cache too) against the same
    forward with the eager blocks and final layer put back."""
    cfg, model = _model(preset, "bf16")
    rng = np.random.default_rng(9)
    s_kv = 2 * GRID * GRID
    img_rows = CAP if mode == tm.MODE_RAGS else s_kv
    ids = np.stack([np.zeros(s_kv), np.arange(s_kv) // 4,
                    np.arange(s_kv) % 4], -1).astype(np.float32)
    rope_img = rope_table(torch.from_numpy(ids), cfg.axes_dims)
    rope_txt = rope_table(torch.zeros((T_TXT, 3)), cfg.axes_dims)
    sel = None
    cache = None
    if mode == tm.MODE_RAGS:
        sel = torch.tensor([0, 5, 9, 20, s_kv])
        rope_img = gather_rope(rope_img, sel)
        cache = kv_cache.init_cache(cfg, B, s_kv, "cpu")
        for t in cache.values():
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape)))
    txt_dim = cfg.connector.in_dim if cfg.connector else cfg.txt_in_dim
    args = (torch.from_numpy(rng.standard_normal(
                (B, img_rows, cfg.in_channels), np.float32)),
            torch.from_numpy(rng.standard_normal((B, T_TXT, txt_dim),
                                                 np.float32)),
            torch.tensor([0.7, 0.7]).to(cfg.dtype), rope_img, rope_txt,
            torch.from_numpy(rng.standard_normal((B, cfg.pooled_dim),
                                                 np.float32))
            if cfg.pooled_dim else None)
    kw = dict(mode=mode, sel_img_ids=sel)

    def run():
        c = None if cache is None else {k: t.clone()
                                        for k, t in cache.items()}
        with torch.no_grad():
            return model(*args, cache=c, **kw)
    got, got_cache = run()
    with monkeypatch.context() as mp:
        mp.setattr(tm.DoubleBlock, "forward", _eager_double)
        mp.setattr(tm.SingleBlock, "forward", _eager_single)
        mp.setattr(tm, "adaln", _eager_final)
        want, want_cache = run()
    _equal(got, want)
    if mode != tm.MODE_DENSE:
        assert got_cache.keys() == want_cache.keys()
        for key in got_cache:
            _equal(got_cache[key], want_cache[key])


def test_cpu_calls_launch_nothing():
    fused.reset_launches()
    x = torch.randn(1, 3, 256)
    m = torch.randn(1, 1, 256)
    fused.adaln(x, m, m)
    fused.residual_adaln(x, m, x, m, m)
    fused.gated_residual(x, m, x)
    fused.qk_norm_rope(x, 2, torch.ones(128))
    fused.gelu_pack(x, x)
    fused.swiglu_pack(x, x)
    assert (fused.adaln.launches, fused.residual_adaln.launches,
            fused.gated_residual.launches, fused.qk_norm_rope.launches,
            fused.gelu_pack.launches, fused.swiglu_pack.launches) == (0,) * 6


_WRAPPERS = {
    "adaln": lambda x, m: fused.adaln(x, m, m),
    "residual_adaln": lambda x, m: fused.residual_adaln(x, m, x, m, m),
    "gated_residual": lambda x, m: fused.gated_residual(x, m, x),
    "qk_norm_rope": lambda x, m: fused.qk_norm_rope(
        x, 2, torch.ones(128, dtype=torch.bfloat16)),
    "gelu_pack": lambda x, m: fused.gelu_pack(x, x),
    "swiglu_pack": lambda x, m: fused.swiglu_pack(x, x),
}


@pytest.mark.parametrize("rows", [0, 3])
@pytest.mark.parametrize("name", list(_WRAPPERS))
def test_a_counter_counts_only_launches(fake_lib, name, rows):
    """The kernel path rehearsed on the CPU at the launch seam (`fake_lib`:
    `ops.launch` says launch, the library records instead of launching): a
    wrapper's counter goes up by one where its C entry was called, and an
    empty batch neither launches nor counts."""
    fused.reset_launches()
    x = torch.zeros(1, rows, 256, dtype=torch.bfloat16)
    m = torch.zeros(1, 1, 256, dtype=torch.bfloat16)
    _WRAPPERS[name](x, m)
    counts = {k: getattr(fused, k).launches for k in _WRAPPERS}
    assert counts == {k: int(k == name and rows > 0) for k in _WRAPPERS}
    assert len(fake_lib.calls) == counts[name]


@pytest.mark.parametrize("h,launches", [(6144, 1), (6152, 0)])
def test_adaln_takes_h_up_to_6144(fake_lib, h, launches):
    """K7's widest instantiation holds 24 chunks a lane: 6144 launches,
    one chunk more raises before the launch."""
    x = torch.zeros(1, 2, h, dtype=torch.bfloat16)
    m = torch.zeros(1, 1, h, dtype=torch.bfloat16)
    if launches:
        fused.adaln(x, m, m)
    else:
        with pytest.raises(ValueError, match="h <= 6144"):
            fused.adaln(x, m, m)
    assert len(fake_lib.calls) == launches
    if launches:
        (entry, args), = fake_lib.calls
        assert entry == "regione_adaln_fwd" and args[-2] == h


def test_swiglu_pack_passes_its_halves(fake_lib):
    """K11's launch: h's row stride, inner and mlp (half h's columns)."""
    wide = torch.zeros(2, 3, 3 * 256 + 2 * 512, dtype=torch.bfloat16)
    attn = torch.zeros(2, 3, 256, dtype=torch.bfloat16)
    out = fused.swiglu_pack(attn, wide[..., 3 * 256:])
    assert out.shape == (2, 3, 256 + 512) and out.is_contiguous()
    (entry, args), = fake_lib.calls
    assert entry == "regione_swiglu_pack_fwd"
    assert list(args[3]) == [3 * 256, 256, 3 * (3 * 256 + 2 * 512),
                             3 * 256 + 2 * 512]
    assert args[4:8] == (2, 3, 256, 512)
    with pytest.raises(ValueError, match="two halves"):
        fused.swiglu_pack(None, wide[..., :8])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_within(got, want, label):
    """Kernel against plain version on the card, bf16: 2e-2 of the output's
    scale (chip_smoke.py's bound for K1-K9; about one bf16 ulp is
    expected)."""
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert bool(torch.isfinite(got).all()), label
    assert err <= 2e-2 * scale, (label, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("h,heads,rows", [(1536, 12, 37), (3072, 24, 8),
                                         (768, 6, 131), (256, 2, 1),
                                         (6144, 48, 19)])
def test_fused_kernels_match_plain_on_the_card(cuda_device, h, heads, rows):
    dev, bf = cuda_device, torch.bfloat16
    rng = np.random.default_rng(h + rows)

    def t(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(
            shape, np.float32)).to(dev, bf)
    stream = t(B, rows + 4, h)
    x = stream[:, 4:]                                   # strided rows
    y = t(B, rows, h)
    shift, scale, gate = t(B, 1, 3 * h, scale=0.3).chunk(3, dim=-1)
    before = fused.adaln.launches
    _card_within(fused.adaln(x, shift, scale),
                 fused.adaln_reference(x, shift, scale), "adaln")
    assert fused.adaln.launches == before + 1
    got = fused.residual_adaln(x, gate, y, shift, scale)
    new_x = fused.gated_residual_reference(x, gate, y)
    _card_within(got[0], new_x, "residual")
    _card_within(got[1], fused.adaln_reference(new_x, shift, scale),
                 "residual_adaln")
    _card_within(fused.gated_residual(x, gate, y), new_x, "gated_residual")

    inner = heads * 128
    wide = t(B, rows, 3 * inner + 4 * inner)
    norm = (1.0 + 0.2 * torch.randn(128, generator=torch.Generator()
                                    .manual_seed(0))).to(dev, bf)
    ids = torch.stack([torch.zeros(rows), torch.arange(rows) // 7,
                       torch.arange(rows) % 7], -1).to(dev)
    tab = rope_table(ids, (16, 56, 56))
    per_batch = tuple(torch.stack([c, c.flip(0)]) for c in tab)
    for rope in (tab, per_batch):
        for src in (wide[..., :inner], wide[..., :inner].contiguous()):
            out = torch.zeros((B, heads, 3 + rows, 128), dtype=bf,
                              device=dev)
            fused.qk_norm_rope(src, heads, norm, rope, out=out, row0=3)
            want = fused.qk_norm_rope_reference(src, heads, norm, rope)
            _card_within(out[:, :, 3:], want, "qk_norm_rope")
            assert bool((out[:, :, :3] == 0).all())
    packed = fused.qk_norm_rope(wide[..., 2 * inner:3 * inner], heads)
    assert torch.equal(packed, split_heads(wide[..., 2 * inner:3 * inner],
                                           heads))
    attn = t(B, rows, inner)
    mlp_h = wide[..., 3 * inner:]
    _card_within(fused.gelu_pack(attn, mlp_h),
                 fused.gelu_pack_reference(attn, mlp_h), "gelu_pack")
    _card_within(fused.gelu_pack(None, mlp_h),
                 fused.gelu_pack_reference(None, mlp_h), "gelu")
    # K11 from the SwiGLU part of a FLUX.2-style linear1 output (row stride
    # 3 inner + 4 inner), and the gate alone: the plain gate's bits
    gated = wide[..., 3 * inner:]
    before = fused.swiglu_pack.launches
    for a in (attn, None):
        got = fused.swiglu_pack(a, gated)
        torch.cuda.synchronize()
        assert torch.equal(got, fused.swiglu_pack_reference(a, gated)), \
            ("swiglu_pack", a is None)
    assert fused.swiglu_pack.launches == before + 2


def _k7_3072_digests(dev) -> dict:
    """SHA-1 of K7's outputs at FLUX.1's width (B 2, 37 rows of a strided
    stream, h 3072) in each mode, from seeded inputs."""
    import hashlib
    bf = torch.bfloat16
    rng = np.random.default_rng(3072)

    def t(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(
            shape, np.float32)).to(dev, bf)
    x = t(2, 41, 3072, scale=2.0)[:, 4:]
    y = t(2, 37, 3072)
    shift, scale, gate = t(2, 1, 3 * 3072, scale=0.3).chunk(3, dim=-1)
    outs = {"adaln": (fused.adaln(x, shift, scale),),
            "residual_adaln": fused.residual_adaln(x, gate, y, shift, scale),
            "gated_residual": (fused.gated_residual(x, gate, y),)}
    torch.cuda.synchronize()
    return {k: hashlib.sha1(b"".join(o.view(torch.int16).cpu().numpy()
                                     .tobytes() for o in v)).hexdigest()
            for k, v in outs.items()}


# K7 at h 3072 before its 24-chunk instantiation came in: `_k7_3072_digests`
# over the earlier tree's package on an H100
K7_3072 = {"adaln": "595fc4e5ad2f218bae6c59e6a9d159fdf7a3057d",
           "residual_adaln": "a783f4988f971b4af2a0b342dc4d05da94f45c43",
           "gated_residual": "4586b1a881afd380ec8d6484a833119d1a067864"}


@pytest.mark.cuda
def test_k7_at_3072_is_bit_equal_to_the_earlier_kernel(cuda_device):
    """The 12-chunk instantiation, which every FLUX.1, Step1X and Qwen
    configuration runs, gives the bits it gave before h 6144 was added."""
    assert _k7_3072_digests(cuda_device) == K7_3072
