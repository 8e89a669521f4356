"""The port's MMDiT backbone against the JAX one, at the tiny presets.

The same params (JAX `init_mmdit`, moved over by `weights.from_jax`) and the
same numpy inputs go through `regione_tpu.models.mmdit.mmdit_forward` and
the port's `MMDiT` in dense, write and rags mode, on the CPU in fp32 (the
port's attention takes its plain path there).  Tolerance 1e-4: fp32 with
matmuls and softmax summed in another order by the two frameworks.

With a quantized cache (`cache_int8`, `cache_int4`), the write-mode cache
leaves are held as `tests/test_torch_quant.py` holds the formats: codes
equal but for one step on at most 0.1% of them (the K/V they quantize
already differ in the last fp32 bits), scales to the file's 1e-4.  The
RAGS step then reads the JAX package's cache in both frameworks and agrees
to 1e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.models import mmdit as jm
from regione_tpu.models.layers import gather_rope as j_gather_rope
from regione_tpu.models.layers import rope_table as j_rope_table
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.pipelines.base import latent_grid_ids, txt_ids
from regione_tpu_torch.models import kv_cache
from regione_tpu_torch.models import mmdit as tm
from regione_tpu_torch.models.layers import gather_rope, rope_table
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.weights.from_jax import (convert_params, init_params,
                                                mmdit_from_jax)
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
GRID, T_TXT, B = 4, 4, 2
S_KV = 2 * GRID * GRID


def _models(preset, seed=0):
    jcfg = j_get_config(preset)
    params = jm.init_mmdit(jax.random.PRNGKey(seed), jcfg)
    model = mmdit_from_jax(jax.tree.map(np.asarray, params),
                           get_config(preset), device="cpu")
    return jcfg, params, model


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([latent_grid_ids(GRID, GRID, 0),
                          latent_grid_ids(GRID, GRID, 1)], 0)
    bias = np.zeros((B, 1, 1, T_TXT + S_KV), np.float32)
    bias[1, ..., T_TXT - 1] = -1e9          # one padded txt row
    return dict(
        img=rng.standard_normal((B, S_KV, cfg.in_channels)).astype(np.float32),
        txt=rng.standard_normal((B, T_TXT, cfg.txt_in_dim)).astype(np.float32),
        t=np.array([0.7, 0.7], np.float32),
        pooled=rng.standard_normal((B, cfg.pooled_dim)).astype(np.float32),
        ids=ids, bias=bias)


def _jax_run(params, jcfg, x, mode, cache=None, sel=None, img=None):
    rope_img = j_rope_table(jnp.asarray(x["ids"]), jcfg.axes_dims)
    rope_txt = j_rope_table(jnp.asarray(txt_ids(T_TXT)), jcfg.axes_dims)
    if sel is not None:
        rope_img = j_gather_rope(rope_img, jnp.asarray(sel))
        sel = jnp.asarray(sel)
    out, cache = jm.mmdit_forward(
        params, jcfg, jnp.asarray(x["img"] if img is None else img),
        jnp.asarray(x["txt"]), jnp.asarray(x["t"]), rope_img, rope_txt,
        pooled=jnp.asarray(x["pooled"]), mode=mode, cache=cache,
        sel_img_ids=sel, txt_bias=jnp.asarray(x["bias"]))
    return out, cache


def _torch_run(model, cfg, x, mode, cache=None, sel=None, img=None):
    rope_img = rope_table(torch.from_numpy(x["ids"]), cfg.axes_dims)
    rope_txt = rope_table(torch.from_numpy(txt_ids(T_TXT)), cfg.axes_dims)
    if sel is not None:
        sel = torch.from_numpy(sel)
        rope_img = gather_rope(rope_img, sel)
    with torch.inference_mode():
        return model(
            torch.from_numpy(x["img"] if img is None else img),
            torch.from_numpy(x["txt"]), torch.from_numpy(x["t"]), rope_img,
            rope_txt, pooled=torch.from_numpy(x["pooled"]), mode=mode,
            cache=cache, sel_img_ids=sel, txt_bias=torch.from_numpy(x["bias"]))


@pytest.mark.parametrize("preset", ["tiny", "tiny-step1x", "tiny-qwen"])
def test_dense_write_rags_match_jax(preset):
    jcfg, params, model = _models(preset)
    cfg = model.cfg
    x = _inputs(cfg)

    want, _ = _jax_run(params, jcfg, x, jm.MODE_DENSE)
    got, _ = _torch_run(model, cfg, x, tm.MODE_DENSE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    want_w, jcache = _jax_run(params, jcfg, x, jm.MODE_WRITE)
    got_w, tcache = _torch_run(model, cfg, x, tm.MODE_WRITE)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
    assert set(tcache) == set(jcache) == (
        {"dk", "dv", "sk", "sv"} if cfg.depth_single else {"dk", "dv"})
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)

    # rags: 3 edited rows + 2 pad slots (sentinel S_KV) over the frozen cache
    sel = np.array([1, 6, 13, S_KV, S_KV], np.int32)
    img = np.random.default_rng(2).standard_normal(
        (B, len(sel), cfg.in_channels)).astype(np.float32)
    want_r, jcache_r = _jax_run(params, jcfg, x, jm.MODE_RAGS, jcache, sel,
                                img)
    got_r, tcache_r = _torch_run(model, cfg, x, tm.MODE_RAGS, tcache, sel,
                                 img)
    np.testing.assert_allclose(got_r.numpy()[:, :3], np.asarray(want_r)[:, :3],
                               **TOL)
    # RAGS writes nothing to the cache
    for key in jcache:
        np.testing.assert_array_equal(tcache_r[key].numpy(),
                                      tcache[key].numpy())


def _code_flips(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max(initial=0) <= 1
    assert (diff > 0).sum() <= 1e-3 * diff.size


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("preset", ["tiny", "tiny-qwen"])
def test_quantized_cache_matches_jax(preset, bits):
    """Write mode fills int8 / int4 rows and scale leaves as JAX does; RAGS
    reads them (the S/2 packed rows of int4 included); `txt_norm` carries a
    non-trivial scale; with no single blocks there are no sk/sv leaves."""
    flag = {"cache_int8": True} if bits == 8 else {"cache_int4": True}
    jcfg = dataclasses.replace(j_get_config(preset), **flag)
    params = jax.tree.map(np.asarray, jm.init_mmdit(jax.random.PRNGKey(0),
                                                    jcfg))
    if jcfg.txt_norm:
        params["txt_norm"]["scale"] = np.random.default_rng(5).uniform(
            0.5, 1.5, jcfg.txt_in_dim).astype(np.float32)
    model = mmdit_from_jax(params, dataclasses.replace(get_config(preset),
                                                       **flag),
                           device="cpu")
    cfg = model.cfg
    x = _inputs(cfg)
    tol = dict(rtol=1e-5, atol=1e-5)

    want_w, jcache = _jax_run(params, jcfg, x, jm.MODE_WRITE)
    got_w, tcache = _torch_run(model, cfg, x, tm.MODE_WRITE)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
    keys = {"dk", "dv"} | ({"sk", "sv"} if cfg.depth_single else set())
    assert set(tcache) == set(jcache) == keys | {k + "_s" for k in keys}
    rows = S_KV if bits == 8 else S_KV // 2
    for key in keys:
        assert tcache[key].dtype == torch.int8
        assert tcache[key].shape[3] == rows and tcache[key + "_s"].shape[3] \
            == S_KV
        np.testing.assert_allclose(tcache[key + "_s"].numpy(),
                                   np.asarray(jcache[key + "_s"]), **TOL)
        if bits == 8:
            _code_flips(tcache[key].numpy(), np.asarray(jcache[key]))
        else:
            from regione_tpu_torch.ops.quant import unpack_int4
            for g, w in zip(unpack_int4(tcache[key]),
                            unpack_int4(torch.from_numpy(
                                np.array(jcache[key])))):
                _code_flips(g.numpy(), w.numpy())

    want, _ = _jax_run(params, jcfg, x, jm.MODE_DENSE)
    got, _ = _torch_run(model, cfg, x, tm.MODE_DENSE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    sel = np.array([1, 6, 13, S_KV, S_KV], np.int32)
    img = np.random.default_rng(2).standard_normal(
        (B, len(sel), cfg.in_channels)).astype(np.float32)
    shared = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    want_r, _ = _jax_run(params, jcfg, x, jm.MODE_RAGS, jcache, sel, img)
    got_r, _ = _torch_run(model, cfg, x, tm.MODE_RAGS, shared, sel, img)
    np.testing.assert_allclose(got_r.numpy()[:, :3],
                               np.asarray(want_r)[:, :3], **tol)


def test_cache_int8_and_int4_are_exclusive():
    cfg = dataclasses.replace(get_config("tiny"), cache_int8=True,
                              cache_int4=True)
    with pytest.raises(AssertionError, match="mutually exclusive"):
        kv_cache.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError, match="even row count"):
        kv_cache.init_cache(dataclasses.replace(cfg, cache_int8=False), 1, 7,
                            "cpu")


def test_rags_bias_masks_pads_and_stale_rows():
    sel = torch.tensor([2, 5, 8, 8], dtype=torch.int32)
    bias = tm.rags_bias(sel, 8, 3, 2, None)[:, 0, 0]
    assert bias.shape == (2, 3 + 4 + 8)
    assert (bias[:, :3] == 0).all()                          # txt
    np.testing.assert_array_equal(
        bias[0, 3:7].numpy(),
        np.float32([0, 0, tm.NEG_INF, tm.NEG_INF]))             # fresh
    stale = np.zeros(8, np.float32)
    stale[[2, 5]] = tm.NEG_INF
    np.testing.assert_array_equal(bias[1, 7:].numpy(), stale)  # cache rows


def _leaf_paths(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return [".".join(str(k.key) for k in path) for path, _ in flat]


@pytest.mark.parametrize("preset", ["tiny", "tiny-step1x", "tiny-qwen",
                                    "step1x-edit", "qwen-image-edit"])
def test_from_jax_consumes_every_leaf_once(preset):
    """Every leaf of the JAX pytree becomes exactly the port's parameters:
    a strict load, and each leaf path consumed once.  The full-width preset
    goes through jax.eval_shape and the meta device (no weights)."""
    jcfg = j_get_config(preset)
    key = jax.random.PRNGKey(0)
    if preset.startswith("tiny"):
        params = jax.tree.map(np.asarray, jm.init_mmdit(key, jcfg))
        device = "cpu"
    else:
        params = jax.eval_shape(lambda k: jm.init_mmdit(k, jcfg), key)
        device = "meta"
    state, consumed = convert_params(params, device)
    assert sorted(consumed) == sorted(_leaf_paths(params))
    assert len(set(consumed)) == len(consumed)
    model = mmdit_from_jax(params, get_config(preset), device)
    assert set(state) == set(model.state_dict())
    n_jax = sum(int(np.prod(leaf.shape))
                for leaf in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    if preset == "step1x-edit":
        assert 12.2e9 < n_jax < 12.4e9
    if preset == "qwen-image-edit":
        assert "single_blocks.0.linear1.weight" not in state
        assert state["txt_norm.scale"].shape == (3584,)
        assert 20.4e9 < n_jax < 20.5e9


def test_presets_match_jax():
    """The port's presets carry the JAX presets' numbers."""
    for name in ("step1x-edit", "step1x-edit:dev", "tiny", "tiny-step1x",
                 "qwen-image-edit", "qwen-image-edit-plus",
                 "qwen-image-edit:dev", "tiny-qwen"):
        j, t = j_get_config(name), get_config(name)
        for field in ("in_channels", "out_channels", "hidden", "heads",
                      "head_dim", "mlp_ratio", "depth_double", "depth_single",
                      "txt_in_dim", "pooled_dim", "axes_dims", "rope_theta",
                      "time_embed_dim", "txt_norm", "cache_int8",
                      "cache_int4"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert np.dtype(j.dtype).itemsize == t.dtype.itemsize
        assert (j.connector is None) == (t.connector is None)
        if j.connector is not None:
            for field in ("in_dim", "hidden", "heads", "depth", "pooled_dim",
                          "time_embed_dim", "mlp_ratio"):
                assert getattr(t.connector, field) == getattr(j.connector,
                                                              field)


def test_init_params_distributions():
    g = torch.Generator().manual_seed(0)
    model = init_params(get_config("tiny-step1x"), g, device="cpu")
    lin = model.double_blocks[0].img_attn.q
    lim = 1.0 / np.sqrt(lin.in_features)
    assert lin.weight.abs().max() <= lim and lin.weight.std() > lim / 3
    assert (lin.bias == 0).all()
    assert (model.double_blocks[0].img_attn.norm_q.scale == 1).all()
    assert model.connector.scale_factor.item() == pytest.approx(-0.91)
    qwen = init_params(get_config("tiny-qwen"), g, device="cpu")
    assert (qwen.txt_norm.scale == 1).all()
    assert not hasattr(qwen, "single_blocks")


def test_from_jax_keeps_bf16_bits():
    """bf16 leaves (the full-width presets' dtype) convert bit for bit."""
    w = jax.random.normal(jax.random.PRNGKey(3), (4, 6), jnp.bfloat16)
    state, _ = convert_params({"final_proj": {"w": w,
                                              "b": jnp.ones(6, jnp.bfloat16)}},
                              "cpu")
    got = state["final_proj.weight"]
    assert got.dtype == torch.bfloat16 and got.shape == (6, 4)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(w.astype(jnp.float32)).T)
