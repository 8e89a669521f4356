"""The port's FLUX.1 Kontext path against the JAX one.

The guidance embedding of the backbone (`MMDiTConfig.guidance_embed`, fp32
guidance into the timestep embedding), the preferred-resolution snap, and
`FluxKontextPipeline.edit_latents` at the `tiny-flux` preset with guidance
2.5, the same params and numpy inputs in both frameworks, fp32 on the CPU.
The backbone forward agrees to 1e-4 (tests/test_torch_mmdit.py's bound);
the edit's stats are equal and its latents agree to 5e-4
(tests/test_torch_pipeline.py's bound: 28 fp32 Euler steps).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regione_tpu.core.config import RegionEParams
from regione_tpu.core.gamma import gamma_for
from regione_tpu.models import mmdit as jm
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.pipelines import flux_kontext as jfk
from regione_tpu.pipelines.base import EditInputs as JEditInputs
from regione_tpu_torch.models.presets import PRESETS, get_config
from regione_tpu_torch.pipelines import flux_kontext as tfk
from regione_tpu_torch.pipelines.base import EditInputs
from regione_tpu_torch.weights.from_jax import (convert_params, init_params,
                                                mmdit_from_jax)
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GRID, T_TXT = 8, 4
S = GRID * GRID
TOL = dict(rtol=5e-4, atol=5e-4)


@functools.lru_cache(maxsize=None)
def _params(seed):
    return jax.tree.map(np.asarray, jm.init_mmdit(jax.random.PRNGKey(seed),
                                                  j_get_config("tiny-flux")))


@pytest.mark.parametrize("size,want", [((800, 800), (1024, 1024)),
                                       ((1920, 1080), (1392, 752)),
                                       ((900, 900), (1024, 1024)),
                                       ((700, 1500), (688, 1504)),
                                       ((64, 48), (1184, 880))])
def test_resolution_snap_matches_jax(size, want):
    assert tfk.snap_kontext_resolution(*size) == want
    assert jfk.snap_kontext_resolution(*size) == want
    assert tfk.PREFERRED_KONTEXT_RESOLUTIONS == \
        jfk.PREFERRED_KONTEXT_RESOLUTIONS


@pytest.mark.parametrize("name", ["flux-kontext", "flux-kontext:dev",
                                  "tiny-flux", "step1x-edit-v1p2"])
def test_presets_match_jax(name):
    j, t = j_get_config(name), get_config(name)
    for f in ("hidden", "heads", "head_dim", "depth_double", "depth_single",
              "txt_in_dim", "pooled_dim", "guidance_embed", "axes_dims",
              "time_embed_dim", "mlp_ratio", "in_channels", "out_channels",
              "txt_norm"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.connector is None) == (j.connector is None)
    assert name in PRESETS


def test_guidance_forward_matches_jax():
    """Dense backbone forward with guidance [2.5, 7.5] (fp32, not rounded
    to the model dtype); the guidance_in leaves map by name."""
    params = _params(0)
    jcfg, cfg = j_get_config("tiny-flux"), get_config("tiny-flux")
    model = mmdit_from_jax(params, cfg, device="cpu")
    assert "guidance_in.in_.weight" in convert_params(params, "cpu")[0]
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 2 * S, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, T_TXT, cfg.txt_in_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32)
    t = np.array([0.6, 0.6], np.float32)
    g = np.array([2.5, 7.5], np.float32)
    jpipe = jfk.FluxKontextPipeline(jcfg, params)
    tpipe = tfk.FluxKontextPipeline(model)
    jrope = jpipe.build_rope(GRID, GRID, T_TXT)
    trope = tpipe.build_rope(GRID, GRID, T_TXT)
    want, _ = jm.mmdit_forward(params, jcfg, jnp.asarray(img),
                               jnp.asarray(txt), jnp.asarray(t), *jrope,
                               pooled=jnp.asarray(pooled),
                               guidance=jnp.asarray(g))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(img), torch.from_numpy(txt),
                       torch.from_numpy(t), *trope,
                       pooled=torch.from_numpy(pooled),
                       guidance=torch.from_numpy(g))
        no_g, _ = model(torch.from_numpy(img), torch.from_numpy(txt),
                        torch.from_numpy(t), *trope,
                        pooled=torch.from_numpy(pooled))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert not torch.allclose(got[0], got[1])
    assert not torch.allclose(got, no_g)


def test_init_params_draws_guidance_in():
    model = init_params(get_config("tiny-flux"),
                        torch.Generator().manual_seed(0), device="cpu")
    w = model.guidance_in.in_.weight
    lim = 1.0 / np.sqrt(w.shape[1])
    assert w.abs().max() <= lim and w.std() > lim / 3
    assert not model.guidance_in.out.bias.any()


def _edit_both(guidance, re, dense_only=False):
    params = _params(11)
    jpipe = jfk.FluxKontextPipeline(j_get_config("tiny-flux"), params, re,
                                    gamma=gamma_for("flux-kontext"),
                                    guidance_scale=guidance)
    tpipe = tfk.FluxKontextPipeline(
        mmdit_from_jax(params, get_config("tiny-flux"), device="cpu"), re,
        guidance_scale=guidance)
    assert not tpipe.do_cfg and tpipe.backend == "flux-kontext"
    np.testing.assert_array_equal(tpipe.gamma, gamma_for("flux-kontext"))
    cfg = tpipe.cfg
    rng = np.random.default_rng(2)
    txt = rng.standard_normal((1, T_TXT, cfg.txt_in_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32)
    cond = rng.standard_normal((1, S, cfg.in_channels)).astype(np.float32)
    lat0 = rng.standard_normal((1, S, cfg.in_channels)).astype(np.float32)
    jctx = JEditInputs(txt=jnp.asarray(txt), cond_latent=jnp.asarray(cond),
                       rope_img=None, rope_txt=None,
                       pooled=jnp.asarray(pooled),
                       guidance=jnp.full((1,), guidance, jnp.float32))
    jctx.rope_img, jctx.rope_txt = jpipe.build_rope(GRID, GRID, T_TXT)
    want, jstats = jpipe.edit_latents(jnp.asarray(lat0), jctx, GRID, GRID,
                                      dense_only=dense_only)
    trope = tpipe.build_rope(GRID, GRID, T_TXT)
    tctx = EditInputs(txt=torch.from_numpy(txt),
                      cond_latent=torch.from_numpy(cond), rope_img=trope[0],
                      rope_txt=trope[1], pooled=torch.from_numpy(pooled),
                      guidance=torch.full((1,), guidance))
    got, tstats = tpipe.edit_latents(torch.from_numpy(lat0), tctx, GRID,
                                     GRID, dense_only=dense_only)
    return np.asarray(want), jstats, got.numpy(), tstats


RE = RegionEParams(threshold=0.0, erosion_dilation=False,
                   cache_threshold=0.05, capacity_granularity=8)


def test_flux_edit_matches_jax():
    want, jstats, got, tstats = _edit_both(2.5, RE)
    assert 0 < tstats.edited_tokens < S and tstats.rags_steps > 0
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    np.testing.assert_allclose(got, want, **TOL)


def test_flux_dense_edit_matches_jax():
    want, _, got, tstats = _edit_both(2.5, RE, dense_only=True)
    assert tstats is None
    np.testing.assert_allclose(got, want, **TOL)


def test_guidance_value_changes_the_edit():
    _, _, got, _ = _edit_both(2.5, RE)
    _, _, got2, _ = _edit_both(7.5, RE)
    assert not np.allclose(got, got2)


def test_true_cfg_switches_to_a_batch_of_two():
    model = mmdit_from_jax(_params(11), get_config("tiny-flux"),
                           device="cpu")
    assert not tfk.FluxKontextPipeline(model).do_cfg
    pipe = tfk.FluxKontextPipeline(model, true_cfg_scale=2.0)
    assert pipe.do_cfg and pipe.guidance_scale == 2.5
    assert pipe.target_resolution(900, 900) == (1024, 1024)
    assert pipe.encoder_images([np.zeros((4, 4, 3), np.uint8)], 16, 16) is None
