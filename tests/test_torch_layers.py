"""The port's layer primitives against `regione_tpu.models.layers`.

Same numpy inputs through both, on the CPU in fp32.  Tolerance 1e-5 for
the elementwise primitives and 1e-5 relative for the matmul ones: fp32
evaluated in another order by the two frameworks.  The last test checks
the bf16 rounding of sigma in `dense_forward` directly, which the fp32
tiny presets cannot see.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.models import layers as jl
from regione_tpu_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_linear():
    x, w, b = _rand((3, 5, 16), 0), _rand((16, 24), 1), _rand((24,), 2)
    want = jl.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x))
    got = tl.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                    torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("affine", [False, True])
def test_norms(affine):
    x = _rand((2, 7, 32), 3, scale=3.0) + 1.5
    scale, bias = _rand((32,), 4), _rand((32,), 5)
    np.testing.assert_allclose(
        tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    kw_j = dict(scale=jnp.asarray(scale), bias=jnp.asarray(bias)) \
        if affine else {}
    kw_t = dict(scale=torch.from_numpy(scale), bias=torch.from_numpy(bias)) \
        if affine else {}
    np.testing.assert_allclose(
        tl.layernorm(torch.from_numpy(x), **kw_t).numpy(),
        np.asarray(jl.layernorm(jnp.asarray(x), **kw_j)), **TOL)


def test_timestep_embedding_and_mlp_embed():
    t = np.array([0.0, 0.3141, 0.999], np.float32)
    want = jl.timestep_embedding(jnp.asarray(t), 32)
    got = tl.timestep_embedding(torch.from_numpy(t), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    p = jl.init_mlp_embed(jax.random.PRNGKey(0), 32, 16)
    mod = tl.mlp_embed_module(32, 16, "cpu", torch.float32)
    with torch.no_grad():
        for name in ("in", "out"):
            lin = mod.in_ if name == "in" else mod.out
            lin.weight.copy_(torch.from_numpy(np.array(p[name]["w"]).T))
            lin.bias.copy_(torch.from_numpy(np.array(p[name]["b"])))
        got = tl.mlp_embed(mod, torch.from_numpy(np.array(want)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jl.mlp_embed(p, want)), **TOL)


def _ids(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 2, n), rng.integers(0, 64, n),
                     rng.integers(0, 64, n)], -1).astype(np.float32)


def test_rope_table_apply_concat():
    axes = (16, 56, 56)
    ids_a, ids_b = _ids(12, 6), _ids(5, 7)
    ja = jl.rope_table(jnp.asarray(ids_a), axes)
    ta = tl.rope_table(torch.from_numpy(ids_a), axes)
    for g, w in zip(ta, ja):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    jb = jl.rope_table(jnp.asarray(ids_b), axes)
    tb = tl.rope_table(torch.from_numpy(ids_b), axes)
    for g, w in zip(tl.concat_rope(ta, tb), jl.concat_rope(ja, jb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    x = _rand((2, 3, 12, 128), 8)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), ta).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), ja)), **TOL)


def test_gather_rope_sentinel_ids_read_zeros():
    ids_np = _ids(10, 9)
    rope_j = jl.rope_table(jnp.asarray(ids_np), (4, 6, 6))
    rope_t = tl.rope_table(torch.from_numpy(ids_np), (4, 6, 6))
    sel = np.array([3, 0, 9, 10, 10, 15], np.int32)   # 10 = S, 15 > S
    want = jl.gather_rope(rope_j, jnp.asarray(sel))
    got = tl.gather_rope(rope_t, torch.from_numpy(sel))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert (g[3:] == 0).all()


def test_split_heads_is_a_view():
    x = torch.from_numpy(_rand((2, 5, 3 * 16), 10))
    got = tl.split_heads(x, 3)
    want = jl.split_heads(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.data_ptr() == x.data_ptr()


@pytest.mark.parametrize("with_bias", [False, True])
def test_sdpa_and_sdpa_cached(with_bias):
    b, h, t, t1, s, d = 2, 2, 6, 5, 9, 16
    q, k, v = _rand((b, h, t, d), 11), _rand((b, h, s, d), 12), \
        _rand((b, h, s, d), 13)
    kt, vt = _rand((b, h, t1, d), 14), _rand((b, h, t1, d), 15)
    bias = bias2 = None
    if with_bias:
        bias = np.zeros((b, 1, 1, s), np.float32)
        bias[0, ..., 2] = -1e9
        bias2 = np.zeros((b, 1, 1, t1 + s), np.float32)
        bias2[1, ..., [0, t1 + 3]] = -1e30

    def j(x):
        return None if x is None else jnp.asarray(x)

    def tt(x):
        return None if x is None else torch.from_numpy(x)

    np.testing.assert_allclose(
        tl.sdpa(tt(q), tt(k), tt(v), tt(bias)).numpy(),
        np.asarray(jl.sdpa(j(q), j(k), j(v), j(bias))), **TOL)
    np.testing.assert_allclose(
        tl.sdpa_cached(tt(q), (tt(kt), tt(vt)), tt(k), tt(v),
                       tt(bias2)).numpy(),
        np.asarray(jl.sdpa_cached(j(q), (j(kt), j(vt)), j(k), j(v),
                                  j(bias2))), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("fresh", [True, False])
def test_sdpa_cached_with_a_quantized_cache(bits, fresh):
    """A (rows, scales) cache: int8, or int4 told by its S/2 rows; with
    fresh rows (K2q) and without (K6); the JAX CPU path dequantizes,
    concatenates and attends, and so does the port's."""
    from regione_tpu.ops import quant as jq
    b, h, t, t1, s, d = 2, 2, 6, 5, 10, 16
    q = _rand((b, h, t, d), 20)
    kt, vt = _rand((b, h, t1, d), 21), _rand((b, h, t1, d), 22)
    quant = jq.quantize_kv_heads if bits == 8 else jq.quantize_kv_heads4
    kc = quant(jnp.asarray(_rand((b, h, s, d), 23)))
    vc = quant(jnp.asarray(_rand((b, h, s, d), 24)))
    n = (t1 if fresh else 0) + s
    bias = np.zeros((b, 1, 1, n), np.float32)
    bias[1, ..., [0, n - 2]] = -1e30
    jtxt = (jnp.asarray(kt), jnp.asarray(vt)) if fresh else None
    ttxt = (torch.from_numpy(kt), torch.from_numpy(vt)) if fresh else None
    want = jl.sdpa_cached(jnp.asarray(q), jtxt, kc, vc, jnp.asarray(bias))

    def tt(pair):
        return tuple(torch.from_numpy(np.array(a)) for a in pair)

    got = tl.sdpa_cached(torch.from_numpy(q), ttxt, tt(kc), tt(vc),
                         torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_forward_rounds_sigma_to_the_model_dtype(monkeypatch):
    """At bf16 the backbone sees sigma rounded to bf16 (JAX:
    `jnp.full((b,), sigma, cfg.dtype)`), in the dense and the RAGS hook."""
    import regione_tpu.pipelines.base as jbase
    from regione_tpu.models.presets import get_config as j_get_config
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.pipelines.base import EditInputs, EditPipelineBase
    from regione_tpu_torch.weights.from_jax import init_params

    sigma = 0.7093             # not a bf16 value
    seen_j, seen_t = [], []

    def j_fwd(params, cfg, img, txt, t, *a, **kw):
        seen_j.append(np.asarray(t.astype(jnp.float32)))
        return jnp.zeros(img.shape[:2] + (cfg.out_channels,), cfg.dtype), None

    monkeypatch.setattr(jbase, "mmdit_forward", j_fwd)
    jcfg = dataclasses.replace(j_get_config("tiny"), dtype=jnp.bfloat16)
    gamma = jbase.gamma_for("step1x-edit")
    jpipe = jbase.EditPipelineBase(jcfg, {}, gamma=gamma)
    s, c = 4, jcfg.in_channels
    jctx = jbase.EditInputs(txt=jnp.zeros((1, 2, 16)),
                            cond_latent=jnp.zeros((1, s, c)),
                            rope_img=None, rope_txt=None)
    jpipe.dense_forward(jnp.zeros((1, s, c)), jnp.float32(sigma), None,
                        jctx, False)

    cfg = dataclasses.replace(get_config("tiny"), dtype=torch.bfloat16)
    tpipe = EditPipelineBase(init_params(cfg, torch.Generator(), device="cpu"),
                             gamma=gamma)

    def t_fwd(img, txt, t, *a, **kw):
        seen_t.append(t)
        return torch.zeros(img.shape[:2] + (cfg.out_channels,),
                           dtype=cfg.dtype), kw.get("cache")

    tpipe.model = t_fwd
    tctx = EditInputs(txt=torch.zeros((1, 2, 16)),
                      cond_latent=torch.zeros((1, s, c)),
                      rope_img=(torch.zeros(2 * s, 16),) * 2, rope_txt=None,
                      s_noise=s)
    tpipe.dense_forward(torch.zeros((1, s, c)), sigma, None, tctx, False)
    tpipe.rags_forward(torch.zeros((1, 2, c)), sigma, None,
                       torch.tensor([0, s], dtype=torch.int32), tctx)
    want = np.float32(np.asarray(jnp.bfloat16(sigma), np.float32))
    assert want != np.float32(sigma)
    assert seen_j[0].tolist() == [want]
    for t in seen_t:
        assert t.dtype == torch.bfloat16
        assert t.float().numpy().tolist() == [want]
