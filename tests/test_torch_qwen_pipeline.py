"""The port's Qwen-Image-Edit latent path against the JAX one, end to end.

`QwenImageEditPipeline.edit_latents` at the `tiny-qwen` preset (joint double
blocks only, `txt_norm`) with batch-2 true CFG at scale 4 and the
norm-preserving combine, with a bf16-layout, an int8 and an int4 KV cache;
and `QwenImageEditPlusPipeline` with two condition grids (S_cond > S_noise).
Same params and numpy inputs in both frameworks, on the CPU in fp32, and
the JAX package's schedule in both (`jax_schedule`).  Stats
must be equal; latents agree to 5e-4, the bound of tests/test_torch_pipeline.py
(fp32 over 28 Euler steps, the CFG scale amplifying summation-order
differences).  The Qwen rotary ids, `combine_cfg` and `calculate_dimensions`
are held exactly.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.core.config import DEFAULT_PARAMS
from regione_tpu.core.gamma import gamma_for
from regione_tpu.models.mmdit import init_mmdit
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.pipelines import qwen_image_edit as jqie
from regione_tpu.pipelines.base import EditInputs as JEditInputs
from regione_tpu_torch.models import kv_cache
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.pipelines import qwen_image_edit as tqie
from regione_tpu_torch.pipelines.base import EditInputs
from regione_tpu_torch.weights.from_jax import mmdit_from_jax
from tests.torch_cpu import jax_schedule  # noqa: F401 (fixture)
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

# the port's Qwen pipelines run JAX's (FLUX.1's) schedule here: the JAX
# package has no other (tests/torch_cpu.py)
pytestmark = pytest.mark.usefixtures("jax_schedule")

GRID, T_TXT = 8, 4
S = GRID * GRID
TOL = dict(rtol=5e-4, atol=5e-4)
CACHES = {"bf16": {}, "int8": {"cache_int8": True},
          "int4": {"cache_int4": True}}


@functools.lru_cache(maxsize=None)
def _params(seed):
    return jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(seed),
                                               j_get_config("tiny-qwen")))


def _pipes(cls_name, cache, re):
    params = _params(0)
    jcfg = dataclasses.replace(j_get_config("tiny-qwen"), **CACHES[cache])
    tcfg = dataclasses.replace(get_config("tiny-qwen"), **CACHES[cache])
    return (getattr(jqie, cls_name)(jcfg, params, re),
            getattr(tqie, cls_name)(
                mmdit_from_jax(params, tcfg, device="cpu"), re))


def _edit_both(jpipe, tpipe, seed, cond_grids=None, **kw):
    rng = np.random.default_rng(seed)
    s_cond = sum(h * w for h, w in cond_grids) if cond_grids else S
    c_in = tpipe.cfg.in_channels
    txt = rng.standard_normal((2, T_TXT, tpipe.cfg.txt_in_dim)).astype(
        np.float32)
    cond = (0.5 * rng.standard_normal((1, s_cond, c_in))).astype(np.float32)
    lat0 = rng.standard_normal((1, S, c_in)).astype(np.float32)
    rope_img, rope_txt = jpipe.build_rope(GRID, GRID, T_TXT, cond_grids)
    jctx = JEditInputs(txt=jnp.asarray(txt), cond_latent=jnp.asarray(cond),
                       rope_img=rope_img, rope_txt=rope_txt)
    want, jstats = jpipe.edit_latents(jnp.asarray(lat0), jctx, GRID, GRID,
                                      **kw)
    rope_img, rope_txt = tpipe.build_rope(GRID, GRID, T_TXT, cond_grids)
    tctx = EditInputs(txt=torch.from_numpy(txt),
                      cond_latent=torch.from_numpy(cond), rope_img=rope_img,
                      rope_txt=rope_txt)
    got, tstats = tpipe.edit_latents(torch.from_numpy(lat0), tctx, GRID,
                                     GRID, **kw)
    return np.asarray(want), jstats, got.numpy(), tstats


def _qwen_re(**kw):
    """The Qwen knobs, with a threshold that leaves the tiny random model's
    partition partial."""
    return DEFAULT_PARAMS["qwen-image-edit"].replace(
        threshold=0.0, erosion_dilation=False, capacity_granularity=8, **kw)


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_qwen_edit_matches_jax(cache):
    jpipe, tpipe = _pipes("QwenImageEditPipeline", cache, _qwen_re())
    assert tpipe.true_cfg_scale == 4.0 and tpipe.do_cfg
    assert kv_cache.cache_format(tpipe.cfg) == cache
    want, jstats, got, tstats = _edit_both(jpipe, tpipe, seed=1)
    assert 0 < tstats.edited_tokens < S, "degenerate partition"
    assert tstats.rags_steps > 0 and tstats.reuse_steps > 0
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert got.shape == want.shape == (1, S, tpipe.cfg.out_channels)
    np.testing.assert_allclose(got, want, **TOL)


def test_qwen_dense_edit_matches_jax():
    jpipe, tpipe = _pipes("QwenImageEditPipeline", "int8", _qwen_re())
    want, jstats, got, tstats = _edit_both(jpipe, tpipe, seed=2,
                                           dense_only=True)
    assert jstats is None and tstats is None
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cache", ["bf16", "int4"])
def test_plus_multi_reference_edit_matches_jax(cache):
    """Plus with the target grid and a 4 x 6 reference (the geometry of
    tests/test_multiref.py), each reference on its own frame tag."""
    jpipe, tpipe = _pipes("QwenImageEditPlusPipeline", cache, _qwen_re())
    assert tpipe.backend == "qwen-image-edit-plus"
    np.testing.assert_array_equal(tpipe.gamma,
                                  gamma_for("qwen-image-edit-plus"))
    want, jstats, got, tstats = _edit_both(
        jpipe, tpipe, seed=3, cond_grids=[(GRID, GRID), (4, 6)])
    assert 0 < tstats.edited_tokens < S and tstats.rags_steps > 0
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("grids", [None, [(8, 8)], [(8, 8), (4, 6)],
                                   [(6, 10), (64, 64), (64, 64)]])
def test_qwen_rope_ids_match_jax(grids):
    jpipe, tpipe = _pipes("QwenImageEditPlusPipeline", "bf16", _qwen_re())
    for got, want in zip(tpipe.rope_position_ids(8, 8, 5, grids),
                         jpipe.rope_position_ids(8, 8, 5, grids)):
        np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(tpipe.build_rope(8, 8, 5, grids),
                         jpipe.build_rope(8, 8, 5, grids)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_combine_cfg_matches_jax():
    jpipe, tpipe = _pipes("QwenImageEditPipeline", "bf16", _qwen_re())
    rng = np.random.default_rng(4)
    v_pos = rng.standard_normal((1, 9, 8)).astype(np.float32)
    v_neg = rng.standard_normal((1, 9, 8)).astype(np.float32)
    v_neg[0, 3] = v_pos[0, 3]          # a zero combined row: the 1e-12 floor
    v_pos[0, 5] = 0.0
    v_neg[0, 5] = 0.0
    want = jpipe.combine_cfg(jnp.asarray(v_pos), jnp.asarray(v_neg), 0.5)
    got = tpipe.combine_cfg(torch.from_numpy(v_pos), torch.from_numpy(v_neg),
                            0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert np.isfinite(got.numpy()).all()


def test_dimensions_and_knobs_match_jax():
    jpipe, tpipe = _pipes("QwenImageEditPipeline", "bf16", None)
    for area, ratio in ((1024 * 1024, 1.0), (384 * 384, 4 / 3),
                        (1024 * 1024, 0.37), (32 * 32, 2.5)):
        assert tqie.calculate_dimensions(area, ratio) == \
            jqie.calculate_dimensions(area, ratio)
    for w, h in ((512, 512), (1920, 1080), (300, 700)):
        assert tpipe.target_resolution(w, h) == jpipe.target_resolution(w, h)
    np.testing.assert_array_equal(tpipe.gamma, gamma_for("qwen-image-edit"))
    assert (tqie.CONDITION_IMAGE_AREA, tqie.VAE_IMAGE_AREA) == \
        (jqie.CONDITION_IMAGE_AREA, jqie.VAE_IMAGE_AREA)
