"""The port's Step1X-Edit latent path against the JAX one, end to end.

`Step1XEditPipeline.edit_latents` at the `tiny` preset with batch-2 true
CFG (scale 6, the norm-processed combine), dense-only and RegionE, with the
same params and numpy inputs in both frameworks, on the CPU in fp32.  The
(seed, threshold) pair leaves the adaptive partition partial, so the
gathered RAGS steps, the frozen-cache bias and the AVD reuse runs all run.
Stats must be equal; latents agree to 5e-4 (the tolerance of the JAX
package's own sampler-vs-oracle test, tests/test_sampler_tiny.py: fp32
over 28 Euler steps, CFG scale 6 amplifying summation-order differences).
"""

import contextlib
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.core.config import RegionEParams
from regione_tpu.core.gamma import gamma_for
from regione_tpu.models.mmdit import init_mmdit
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.pipelines.base import EditInputs as JEditInputs
from regione_tpu.pipelines.base import EditPipelineBase as JEditPipelineBase
from regione_tpu.pipelines.step1x_edit import (
    Step1XEditPipeline as JStep1XEditPipeline)
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.pipelines.base import EditInputs, EditPipelineBase
from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
from regione_tpu_torch.weights.from_jax import mmdit_from_jax
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GRID, T_TXT = 8, 4
S = GRID * GRID
TOL = dict(rtol=5e-4, atol=5e-4)


@functools.lru_cache(maxsize=None)
def _params(preset, seed):
    """JAX params as numpy leaves, drawn once per (preset, seed) for the
    whole file (read-only)."""
    return jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(seed),
                                               j_get_config(preset)))


def _pipes(preset, re):
    params = _params(preset, 0)
    jpipe = JStep1XEditPipeline(j_get_config(preset), params, re)
    model = mmdit_from_jax(params, get_config(preset), device="cpu")
    return jpipe, Step1XEditPipeline(model, re)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    return dict(
        txt=rng.standard_normal((2, T_TXT, cfg.txt_in_dim)).astype(np.float32),
        pooled=rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32),
        cond=(0.5 * rng.standard_normal((1, S, cfg.in_channels))
              ).astype(np.float32),
        lat0=rng.standard_normal((1, S, cfg.in_channels)).astype(np.float32))


def _run_both(jpipe, tpipe, x, **kw):
    rope_img, rope_txt = jpipe.build_rope(GRID, GRID, T_TXT)
    jctx = JEditInputs(txt=jnp.asarray(x["txt"]),
                       cond_latent=jnp.asarray(x["cond"]), rope_img=rope_img,
                       rope_txt=rope_txt, pooled=jnp.asarray(x["pooled"]))
    want, jstats = jpipe.edit_latents(jnp.asarray(x["lat0"]), jctx, GRID,
                                      GRID, **kw)
    rope_img, rope_txt = tpipe.build_rope(GRID, GRID, T_TXT)
    tctx = EditInputs(txt=torch.from_numpy(x["txt"]),
                      cond_latent=torch.from_numpy(x["cond"]),
                      rope_img=rope_img, rope_txt=rope_txt,
                      pooled=torch.from_numpy(x["pooled"]))
    got, tstats = tpipe.edit_latents(torch.from_numpy(x["lat0"]), tctx, GRID,
                                     GRID, **kw)
    return np.asarray(want), jstats, got.numpy(), tstats


@pytest.mark.parametrize("erosion_dilation,threshold",
                         [(False, 0.0), (True, 0.2)])
def test_regione_edit_matches_jax(erosion_dilation, threshold):
    re = RegionEParams(threshold=threshold, cache_threshold=0.05,
                       erosion_dilation=erosion_dilation,
                       capacity_granularity=8)
    jpipe, tpipe = _pipes("tiny", re)
    x = _inputs(tpipe.cfg, seed=1)
    want, jstats, got, tstats = _run_both(jpipe, tpipe, x)
    assert 0 < tstats.edited_tokens < S, "degenerate partition"
    assert tstats.rags_steps > 0 and tstats.reuse_steps > 0
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_dense_edit_matches_jax():
    re = RegionEParams(capacity_granularity=8)
    jpipe, tpipe = _pipes("tiny", re)
    x = _inputs(tpipe.cfg, seed=2)
    want, jstats, got, tstats = _run_both(jpipe, tpipe, x, dense_only=True)
    assert jstats is None and tstats is None
    np.testing.assert_allclose(got, want, **TOL)


def test_forced_mask_and_warmup_one_match_jax():
    """A forced partition, and warmup_step == 1 (the partition is step 0 and
    the caller's latents are copied, not updated)."""
    re = RegionEParams(warmup_step=1, cache_threshold=0.05,
                       capacity_granularity=8)
    jpipe, tpipe = _pipes("tiny-step1x", re)
    x = _inputs(tpipe.cfg, seed=3)
    forced = np.zeros((GRID, GRID), bool)
    forced[2:5, 1:6] = True
    rope_img, rope_txt = jpipe.build_rope(GRID, GRID, T_TXT)
    jctx = JEditInputs(txt=jnp.asarray(x["txt"]),
                       cond_latent=jnp.asarray(x["cond"]), rope_img=rope_img,
                       rope_txt=rope_txt, pooled=jnp.asarray(x["pooled"]))
    want, jstats = jpipe.edit_latents(
        jnp.asarray(x["lat0"]), jctx, GRID, GRID,
        forced_mask=jnp.asarray(forced.reshape(-1)))
    rope_img, rope_txt = tpipe.build_rope(GRID, GRID, T_TXT)
    tctx = EditInputs(txt=torch.from_numpy(x["txt"]),
                      cond_latent=torch.from_numpy(x["cond"]),
                      rope_img=rope_img, rope_txt=rope_txt,
                      pooled=torch.from_numpy(x["pooled"]))
    lat0 = torch.from_numpy(x["lat0"].copy())
    got, tstats = tpipe.edit_latents(
        lat0, tctx, GRID, GRID, forced_mask=torch.from_numpy(
            forced.reshape(-1)))
    assert tstats.edited_tokens == int(forced.sum())
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    np.testing.assert_array_equal(lat0.numpy(), x["lat0"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", [
    dict(refresh_step=(12, 16)),               # two refresh split-steps
    dict(post_step=0),                          # no SMS tail
    dict(rags_capacity=16),                     # pinned, below the count
])
def test_sampler_variants_match_jax(variant):
    """The generic pipeline (no CFG) through the sampler's other branches."""
    kw = dict(threshold=0.2, cache_threshold=0.05, capacity_granularity=8)
    kw.update(variant)
    re = RegionEParams(**kw)
    params = _params("tiny", 1)
    gamma = gamma_for("step1x-edit")
    jpipe = JEditPipelineBase(j_get_config("tiny"), params, re, gamma=gamma)
    tpipe = EditPipelineBase(mmdit_from_jax(params, get_config("tiny"),
                                            device="cpu"), re,
                             gamma=gamma)
    x = _inputs(tpipe.cfg, seed=4)
    x["txt"], x["pooled"] = x["txt"][:1], x["pooled"][:1]
    with (pytest.warns(UserWarning, match="exceed pinned rags_capacity")
          if "rags_capacity" in variant else contextlib.nullcontext()):
        want, jstats, got, tstats = _run_both(jpipe, tpipe, x)
    assert 0 < tstats.edited_tokens < S
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    np.testing.assert_allclose(got, want, **TOL)



def test_multi_reference_rope_ids_match_jax():
    """One axis-0 tag per condition grid: the ids and tables of
    [noise ‖ reference 1 ‖ reference 2] equal the JAX package's."""
    gamma = gamma_for("step1x-edit")
    jpipe = JEditPipelineBase(j_get_config("tiny"), _params("tiny", 0),
                              gamma=gamma)
    tpipe = EditPipelineBase(mmdit_from_jax(_params("tiny", 0),
                                            get_config("tiny"), device="cpu"),
                             gamma=gamma)
    for grids in (None, [(8, 8), (4, 6)]):
        for got, want in zip(
                tpipe.rope_position_ids(8, 8, 8, cond_grids=grids),
                jpipe.rope_position_ids(8, 8, 8, cond_grids=grids)):
            np.testing.assert_array_equal(got, np.asarray(want))
        for got, want in zip(tpipe.build_rope(8, 8, 8, cond_grids=grids),
                             jpipe.build_rope(8, 8, 8, cond_grids=grids)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
    kv_ids, _ = tpipe.rope_position_ids(8, 8, 8, cond_grids=[(8, 8), (4, 6)])
    assert kv_ids.shape == (64 + 64 + 24, 3)
    assert set(kv_ids[128:, 0]) == {2.0}


def test_multi_reference_edit_matches_jax():
    """S_cond > S_noise (the target grid plus a 4 x 6 reference, the
    geometry of tests/test_multiref.py) through the generic pipeline."""
    re = RegionEParams(threshold=0.0, erosion_dilation=False,
                       cache_threshold=0.05, capacity_granularity=8)
    params = _params("tiny", 1)
    gamma = gamma_for("step1x-edit")
    jpipe = JEditPipelineBase(j_get_config("tiny"), params, re, gamma=gamma)
    tpipe = EditPipelineBase(mmdit_from_jax(params, get_config("tiny"),
                                            device="cpu"), re,
                             gamma=gamma)
    grids = [(GRID, GRID), (4, 6)]
    rng = np.random.default_rng(6)
    cfg = tpipe.cfg
    txt = rng.standard_normal((1, T_TXT, cfg.txt_in_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32)
    cond = rng.standard_normal((1, S + 24, cfg.in_channels)).astype(
        np.float32)
    lat0 = rng.standard_normal((1, S, cfg.in_channels)).astype(np.float32)
    rope_img, rope_txt = jpipe.build_rope(GRID, GRID, T_TXT, cond_grids=grids)
    jctx = JEditInputs(txt=jnp.asarray(txt), cond_latent=jnp.asarray(cond),
                       rope_img=rope_img, rope_txt=rope_txt,
                       pooled=jnp.asarray(pooled))
    want, jstats = jpipe.edit_latents(jnp.asarray(lat0), jctx, GRID, GRID)
    rope_img, rope_txt = tpipe.build_rope(GRID, GRID, T_TXT, cond_grids=grids)
    tctx = EditInputs(txt=torch.from_numpy(txt),
                      cond_latent=torch.from_numpy(cond), rope_img=rope_img,
                      rope_txt=rope_txt, pooled=torch.from_numpy(pooled))
    got, tstats = tpipe.edit_latents(torch.from_numpy(lat0), tctx, GRID,
                                     GRID)
    assert rope_img[0].shape[0] == 2 * S + 24
    assert 0 < tstats.edited_tokens < S and tstats.rags_steps > 0
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
