"""The port's batched latent edit against the JAX package's.

`edit_latents_batch` for a group of three requests at the `tiny` preset
(grid 8, t_txt 4, fp32 on the CPU), the same params and numpy inputs in
both frameworks: with batch-2 CFG (`Step1XEditPipeline`, scale 6, the
norm-processed combine) and without (`EditPipelineBase`), each over the
unquantized, the int8 and the int4 cache.  The three requests' partitions
differ (28, 29 and 40 of 64 tokens edited with CFG: more than one capacity
granule of 8 apart), so every image's pad slots, stale cache rows and
rope rows are its own.  Stats must be equal per image; latents agree to
2e-4 (the tolerance of the JAX package's own batched-against-single check,
tests/test_batch_sampling.py).  Then the port's batch against its own
per-image edits at the group's pinned capacity (1e-5: the same fp32
arithmetic, batched), the rope-table check and a `mesh` (a one-rank
gloo mesh here; the sharded cases are tests/test_torch_parallel_mesh.py).
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

GRID, T_TXT, B = 8, 4, 3
S = GRID * GRID
RE = RegionEParams(threshold=0.0, erosion_dilation=False,
                   cache_threshold=0.05, capacity_granularity=8)
CACHES = {"plain": {}, "int8": dict(cache_int8=True),
          "int4": dict(cache_int4=True)}


@functools.lru_cache(maxsize=None)
def _params(cache):
    """JAX params (numpy leaves) of `tiny` with a cache format's flags."""
    cfg = dataclasses.replace(j_get_config("tiny"), **CACHES[cache])
    return jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(0), cfg))


def _pipes(cfg_guided, cache, re=RE):
    """(JAX pipeline, port pipeline) on the same params: Step1X with
    batch-2 CFG, or the generic pipeline without CFG."""
    params = _params(cache)
    jcfg = dataclasses.replace(j_get_config("tiny"), **CACHES[cache])
    tcfg = dataclasses.replace(get_config("tiny"), **CACHES[cache])
    model = mmdit_from_jax(params, tcfg, device="cpu")
    if cfg_guided:
        return JStep1XEditPipeline(jcfg, params, re), \
            Step1XEditPipeline(model, re)
    gamma = gamma_for("step1x-edit")
    return (JEditPipelineBase(jcfg, params, re, gamma=gamma),
            EditPipelineBase(model, re, gamma=gamma))


def _requests(bc, seed=0, n=B):
    """n requests' numpy inputs; bc prompt rows each ([pos; neg] with CFG)."""
    rng = np.random.default_rng(seed)
    cfg = get_config("tiny")
    return [dict(
        txt=rng.standard_normal((bc, T_TXT, cfg.txt_in_dim)).astype(
            np.float32),
        pooled=rng.standard_normal((bc, cfg.pooled_dim)).astype(np.float32),
        cond=rng.standard_normal((1, S, cfg.in_channels)).astype(np.float32),
        lat0=rng.standard_normal((1, S, cfg.in_channels)).astype(np.float32))
        for _ in range(n)]


def _tctx(pipe, x, rope=None):
    rope_img, rope_txt = rope or pipe.build_rope(GRID, GRID, T_TXT)
    return EditInputs(txt=torch.from_numpy(x["txt"]),
                      cond_latent=torch.from_numpy(x["cond"]),
                      rope_img=rope_img, rope_txt=rope_txt,
                      pooled=torch.from_numpy(x["pooled"]))


def _jctx(pipe, x):
    rope_img, rope_txt = pipe.build_rope(GRID, GRID, T_TXT)
    return JEditInputs(txt=jnp.asarray(x["txt"]),
                       cond_latent=jnp.asarray(x["cond"]), rope_img=rope_img,
                       rope_txt=rope_txt, pooled=jnp.asarray(x["pooled"]))


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("cfg_guided", [True, False], ids=["cfg", "no-cfg"])
def test_edit_latents_batch_matches_jax(cfg_guided, cache):
    jpipe, tpipe = _pipes(cfg_guided, cache)
    xs = _requests(2 if cfg_guided else 1)
    want, jstats = jpipe.edit_latents_batch(
        [jnp.asarray(x["lat0"]) for x in xs], [_jctx(jpipe, x) for x in xs],
        GRID, GRID)
    got, tstats = tpipe.edit_latents_batch(
        [torch.from_numpy(x["lat0"]) for x in xs],
        [_tctx(tpipe, x) for x in xs], GRID, GRID)
    counts = [st.edited_tokens for st in tstats]
    assert max(counts) - min(counts) > RE.capacity_granularity, counts
    assert all(0 < c < S for c in counts) and tstats[0].rags_steps > 0
    assert [dataclasses.asdict(st) for st in tstats] == \
        [dataclasses.asdict(st) for st in jstats]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == (1, S, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=f"image {i}")


@pytest.mark.parametrize("cfg_guided", [True, False], ids=["cfg", "no-cfg"])
def test_batch_matches_per_image_at_the_shared_capacity(cfg_guided):
    """Each image of the group against its own `edit_latents` with the
    group's capacity pinned: the same steps and the same arithmetic, so
    1e-5; each image keeps its own edited-token count."""
    _, tpipe = _pipes(cfg_guided, "plain")
    xs = _requests(2 if cfg_guided else 1)
    got, stats = tpipe.edit_latents_batch(
        [torch.from_numpy(x["lat0"]) for x in xs],
        [_tctx(tpipe, x) for x in xs], GRID, GRID)
    cap = stats[0].capacity
    assert all(st.capacity == cap for st in stats)
    _, single = _pipes(cfg_guided, "plain", RE.replace(rags_capacity=cap))
    for i, x in enumerate(xs):
        want, st = single.edit_latents(torch.from_numpy(x["lat0"]),
                                       _tctx(single, x), GRID, GRID)
        assert stats[i].edited_tokens == st.edited_tokens
        torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-5)


def test_forced_masks_give_each_image_its_partition():
    """`forced_masks`: one mask per image, counts as given, and each image
    equals its own forced single edit at the shared capacity."""
    _, tpipe = _pipes(True, "plain")
    xs = _requests(2, seed=1, n=2)
    masks = [np.zeros(S, bool), np.zeros(S, bool)]
    masks[0][3:11] = True
    masks[1][20:45] = True
    got, stats = tpipe.edit_latents_batch(
        [torch.from_numpy(x["lat0"]) for x in xs],
        [_tctx(tpipe, x) for x in xs], GRID, GRID,
        forced_masks=[torch.from_numpy(m) for m in masks])
    assert [st.edited_tokens for st in stats] == [8, 25]
    assert stats[0].capacity == 32
    _, single = _pipes(True, "plain", RE.replace(rags_capacity=32))
    for i, x in enumerate(xs):
        want, _ = single.edit_latents(
            torch.from_numpy(x["lat0"]), _tctx(single, x), GRID, GRID,
            forced_mask=torch.from_numpy(masks[i]))
        torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-5)


def test_differing_rope_tables_refuse_to_share_a_batch():
    _, tpipe = _pipes(False, "plain")
    xs = _requests(1, n=2)
    other = tpipe.build_rope(GRID, GRID, T_TXT, cond_grids=[(4, 16)])
    ctxs = [_tctx(tpipe, xs[0]), _tctx(tpipe, xs[1], rope=other)]
    with pytest.raises(ValueError, match="rope"):
        tpipe.edit_latents_batch([torch.from_numpy(x["lat0"]) for x in xs],
                                 ctxs, GRID, GRID)


def test_mesh_waits_for_the_sharding_port(tmp_path):
    """A mesh is accepted now that parallel/sharding is ported: on a
    one-rank (dp 1, tp 1) gloo mesh the group's edit equals the edit
    without one, bit for bit."""
    import torch.distributed as dist

    from regione_tpu_torch.parallel.sharding import make_mesh
    _, tpipe = _pipes(False, "plain")
    xs = _requests(1, n=2)
    lats = [torch.from_numpy(x["lat0"]) for x in xs]
    want, wstats = tpipe.edit_latents_batch(
        lats, [_tctx(tpipe, x) for x in xs], GRID, GRID)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device_type="cpu")
        got, stats = tpipe.edit_latents_batch(
            lats, [_tctx(tpipe, x) for x in xs], GRID, GRID, mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert stats == wstats
    for a, b in zip(got, want):
        assert torch.equal(a, b)
