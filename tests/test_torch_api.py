"""The port's `RegionEHelper` (`regione_tpu_torch.api`, its own copy of
`regione_tpu.api`) on the port's pipelines: the cases of tests/test_api.py;
the toggle's effect on `edit_latents`: `disable()` runs the dense path (the
latents of `edit_latents(dense_only=True)`, bit for bit, no stats) and
`enable()` the RegionE one, on the CPU in fp32; and the same calls of the
JAX helper and the port's leave a port pipeline in the same state."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from regione_tpu.api import RegionEHelper as JRegionEHelper
from regione_tpu.models.mmdit import init_mmdit
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu_torch.api import BACKEND_DEFAULTS, RegionEHelper
from regione_tpu_torch.core.config import RegionEParams
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.pipelines.base import EditInputs
from regione_tpu_torch.pipelines.flux_kontext import FluxKontextPipeline
from regione_tpu_torch.pipelines.qwen_image_edit import (
    QwenImageEditPipeline, QwenImageEditPlusPipeline)
from regione_tpu_torch.pipelines.step1x_edit import (
    Step1XEditPipeline, Step1XEditV1P2Pipeline)
from regione_tpu_torch.weights.from_jax import mmdit_from_jax
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GRID, T_TXT = 8, 4
S = GRID * GRID


@functools.lru_cache(maxsize=None)
def _params(preset):
    return jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(0),
                                               j_get_config(preset)))


def make_pipe(cls=Step1XEditPipeline, preset="tiny", re=None):
    model = mmdit_from_jax(_params(preset), get_config(preset),
                           device="cpu")
    return cls(model, re or RegionEParams())


def _edit_inputs(pipe, seed=1):
    cfg = pipe.cfg
    rng = np.random.default_rng(seed)
    b = 2 if pipe.do_cfg else 1
    rope_img, rope_txt = pipe.build_rope(GRID, GRID, T_TXT)
    ctx = EditInputs(
        txt=torch.from_numpy(rng.standard_normal(
            (b, T_TXT, cfg.txt_in_dim)).astype(np.float32)),
        cond_latent=torch.from_numpy((0.5 * rng.standard_normal(
            (1, S, cfg.in_channels))).astype(np.float32)),
        rope_img=rope_img, rope_txt=rope_txt,
        pooled=torch.from_numpy(rng.standard_normal(
            (b, cfg.pooled_dim)).astype(np.float32)))
    lat0 = torch.from_numpy(rng.standard_normal(
        (1, S, cfg.in_channels)).astype(np.float32))
    return lat0, ctx


def test_defaults_table_matches_reference():
    assert BACKEND_DEFAULTS["step1x-edit"]["threshold"] == 0.88
    assert BACKEND_DEFAULTS["step1x-edit"]["cache_threshold"] == 0.02
    assert BACKEND_DEFAULTS["flux-kontext"]["threshold"] == 0.93
    assert BACKEND_DEFAULTS["flux-kontext"]["cache_threshold"] == 0.04
    assert BACKEND_DEFAULTS["qwen-image-edit"]["threshold"] == 0.80
    assert BACKEND_DEFAULTS["qwen-image-edit"]["cache_threshold"] == 0.03
    for cfg in BACKEND_DEFAULTS.values():
        assert cfg["num_inference_steps"] == 28
        assert cfg["warmup_step"] == 6 and cfg["post_step"] == 2
        assert cfg["refresh_step"] == "16"
        assert cfg["erosion_dilation"] is True


@pytest.mark.parametrize("cls,preset,backend", [
    (Step1XEditPipeline, "tiny", "step1x-edit"),
    (Step1XEditV1P2Pipeline, "tiny", "step1x-edit-v1p2"),
    (FluxKontextPipeline, "tiny-flux", "flux-kontext"),
    (QwenImageEditPipeline, "tiny-qwen", "qwen-image-edit"),
    (QwenImageEditPlusPipeline, "tiny-qwen", "qwen-image-edit-plus"),
])
def test_helper_resolves_every_port_pipeline(cls, preset, backend):
    pipe = make_pipe(cls, preset)
    helper = RegionEHelper(pipe)
    assert helper.backend == backend
    helper.enable()
    assert pipe._regione_enabled is True
    assert pipe.re.threshold == BACKEND_DEFAULTS[backend]["threshold"]
    helper.disable()
    assert pipe._regione_enabled is False


def test_disable_runs_the_dense_path_and_enable_regione():
    re = RegionEParams(threshold=0.0, erosion_dilation=False,
                       cache_threshold=0.05, capacity_granularity=8)
    pipe = make_pipe(re=re)
    lat0, ctx = _edit_inputs(pipe)
    dense, none = pipe.edit_latents(lat0, ctx, GRID, GRID, dense_only=True)
    regione, stats = pipe.edit_latents(lat0, ctx, GRID, GRID)
    assert none is None and 0 < stats.edited_tokens < S
    assert not torch.equal(dense, regione)
    helper = RegionEHelper(pipe).set_params(
        threshold=0.0, erosion_dilation=False, cache_threshold=0.05,
        capacity_granularity=8)
    helper.disable()
    got, got_stats = pipe.edit_latents(lat0, ctx, GRID, GRID)
    assert got_stats is None and torch.equal(got, dense)
    helper.enable()
    got, got_stats = pipe.edit_latents(lat0, ctx, GRID, GRID)
    assert got_stats == stats and torch.equal(got, regione)


def test_helper_set_params_validation():
    pipe = make_pipe()
    pipe.sampler_for(GRID, GRID, T_TXT, 2)
    helper = RegionEHelper(pipe)
    helper.set_params(warmup_step=5, refresh_step="14", threshold=0.5)
    assert pipe.re.warmup_step == 5 and pipe.re.refresh_step == (14,)
    assert pipe._samplers == {}
    with pytest.raises(AssertionError):
        helper.set_params(num_inference_steps=30)
    with pytest.raises(AssertionError):
        helper.set_params(refresh_step="12,13")


def test_helper_rejects_unknown_pipeline():
    class Foo:
        pass
    with pytest.raises(ValueError):
        RegionEHelper(Foo())


@pytest.mark.parametrize("cls,preset", [
    (Step1XEditPipeline, "tiny"), (Step1XEditV1P2Pipeline, "tiny"),
    (FluxKontextPipeline, "tiny-flux"), (QwenImageEditPipeline, "tiny-qwen"),
    (QwenImageEditPlusPipeline, "tiny-qwen")])
def test_port_helper_drives_a_pipeline_as_the_jax_helper(cls, preset):
    """The same calls through either helper leave the pipeline with equal
    knobs, the same toggle and its samplers cleared."""
    states = []
    for helper_cls in (JRegionEHelper, RegionEHelper):
        pipe = make_pipe(cls, preset)
        pipe.sampler_for(GRID, GRID, T_TXT, 2)
        helper = helper_cls(pipe)
        seen = [helper.backend]
        for call in (helper.enable,
                     lambda: helper.set_params(warmup_step=5,
                                               refresh_step="14,20",
                                               threshold=0.5),
                     helper.disable):
            call()
            seen.append((dataclasses.asdict(pipe.re), pipe._regione_enabled,
                         len(pipe._samplers)))
        states.append(seen)
    assert states[1] == states[0]
