"""The port's `EditService`: the JAX package's serving cases
(tests/test_serve.py) on the port's pipelines, tiny presets on the CPU.

  * `run` gives each request its uint8 image, stats and stages, and equals
    `pipe(image, prompt, seed=...)` of the same request exactly (the same
    ops on the CPU; the preparation only ran on a worker thread);
  * `run_batched` groups by geometry, splits a group at `max_batch`,
    reports honest group latencies, and gives each request `run`'s
    edited-token count and image within one level (batched fp32 sums);
  * multi-reference requests (other condition lengths) and equal-length
    conditions with other rope tables land in groups of their own;
  * a request without both width and height comes back at its input
    geometry.
"""

import numpy as np
import pytest
import torch

from regione_tpu_torch.core.config import RegionEParams
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.models.text_encoders import MockTextEncoder
from regione_tpu_torch.models.vae import VAEConfig
from regione_tpu_torch.pipelines.qwen_image_edit import (
    QwenImageEditPlusPipeline)
from regione_tpu_torch.pipelines.serve import (EditRequest, EditService,
                                               _rope_digest)
from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
from regione_tpu_torch.weights.from_jax import init_params, init_vae_params
from tests.test_output_geometry import snapped_area_policy
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

RE = RegionEParams(threshold=0.0, erosion_dilation=False,
                   capacity_granularity=8)
VAE = VAEConfig(block_out_channels=(8, 16), latent_channels=2,
                norm_num_groups=4, layers_per_block=1)


def _pipe(cls=Step1XEditPipeline, preset="tiny", seed=0, pooled=True,
          **kw):
    cfg = get_config(preset)
    pipe = cls(init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu"), RE, **kw)
    pipe.attach_vae(init_vae_params(VAE, torch.Generator().manual_seed(
        seed + 1), device="cpu"))
    return pipe.attach_text_encoder(MockTextEncoder(
        cfg.txt_in_dim, cfg.pooled_dim if pooled else None, max_length=8))


def _images(seed, n, h=32, w=32):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(n)]


def test_edit_service_run_equals_the_pipeline_call():
    pipe = _pipe()
    svc = EditService(pipe, use_regione=True)
    reqs = [EditRequest(image=img, prompt=f"edit {i}", width=32, height=32,
                        seed=i) for i, img in enumerate(_images(0, 3))]
    results = svc.run(reqs)
    assert len(results) == 3
    for req, r in zip(reqs, results):
        assert r.image.dtype == np.uint8 and r.image.shape == (32, 32, 3)
        assert r.latency_s > 0 and r.prep_s >= 0
        assert 0 < r.stats.edited_tokens < r.stats.seq_len == 64
        assert set(r.stages) == {"prep", "denoise", "decode"}
        assert r.stages["prep"] == r.prep_s
        want, stats = pipe(req.image, req.prompt, width=32, height=32,
                           seed=req.seed, output_type="uint8")
        np.testing.assert_array_equal(r.image, want)
        assert r.stats == stats


def test_edit_service_batched_grouping():
    pipe = _pipe(seed=2)
    svc = EditService(pipe, use_regione=True)
    reqs = [EditRequest(image=img, prompt=f"edit {i}", width=32, height=32,
                        seed=i) for i, img in enumerate(_images(1, 3))]
    results = svc.run_batched(reqs, max_batch=2)  # 2 groups: [0, 1], [2]
    assert len(results) == 3
    for r in results:
        assert r.image.dtype == np.uint8 and np.isfinite(r.latency_s)
        # per-image stats and honest group latency accounting
        assert r.stats.edited_tokens >= 0
        assert r.group_latency_s == pytest.approx(r.latency_s * r.group_size)
        assert set(r.stages) == {"prep", "denoise", "decode"}
    assert [r.group_size for r in results] == [2, 2, 1]
    assert results[0].group_latency_s == results[1].group_latency_s
    # the batched denoise against one request at a time
    for r, s in zip(results, svc.run(reqs)):
        assert r.stats.edited_tokens == s.stats.edited_tokens
        assert np.abs(r.image.astype(int) - s.image).max() <= 1


def _plus_pipe(vae_image_area):
    pipe = _pipe(QwenImageEditPlusPipeline, "tiny-qwen", pooled=False,
                 true_cfg_scale=4.0)
    pipe.vae_image_area = vae_image_area
    pipe.condition_image_area = 32 * 32
    return pipe


def test_batched_grouping_splits_multiref_condition_lengths():
    """Requests whose condition sequences differ (multi-reference vs one
    image) land in separate groups: stacking them would fail on the
    condition latent's length."""
    svc = EditService(_plus_pipe(32 * 32))
    rng = np.random.default_rng(0)
    img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    ref = (rng.random((24, 40, 3)) * 255).astype(np.uint8)
    reqs = [EditRequest(image=[img, ref], prompt="a", width=32, height=32),
            EditRequest(image=[img, ref], prompt="b", width=32, height=32),
            EditRequest(image=img, prompt="c", width=32, height=32)]
    res = svc.run_batched(reqs, max_batch=4)
    assert [r.group_size for r in res] == [2, 2, 1]
    for r in res:
        assert r.image.shape == (32, 32, 3) and r.image.dtype == np.uint8


def test_batched_grouping_splits_equal_length_different_rope():
    """Equal-length condition sequences can decompose into different grids
    (transposed-aspect Plus references): the group key splits on the rope
    tables' content, and the batch entry point refuses a mixed group."""
    pipe = _plus_pipe(16 * 64)
    svc = EditService(pipe)
    rng = np.random.default_rng(0)
    img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    ref_wide = (rng.random((16, 64, 3)) * 255).astype(np.uint8)
    ref_tall = np.transpose(ref_wide, (1, 0, 2)).copy()
    reqs = [EditRequest(image=[img, ref_wide], prompt="a", width=32,
                        height=32),
            EditRequest(image=[img, ref_tall], prompt="b", width=32,
                        height=32)]
    pa, _ = svc._prepare(reqs[0])
    pb, _ = svc._prepare(reqs[1])
    assert pa.ctx.cond_latent.shape[-2] == pb.ctx.cond_latent.shape[-2]
    assert _rope_digest(pa.ctx) != _rope_digest(pb.ctx)
    res = svc.run_batched(reqs, max_batch=4)
    assert [r.group_size for r in res] == [1, 1]
    for r in res:
        assert r.image.shape == (32, 32, 3) and r.image.dtype == np.uint8
    with pytest.raises(ValueError, match="rope"):
        pipe.edit_latents_batch([pa.lat0, pb.lat0], [pa.ctx, pb.ctx],
                                pa.grid_h, pa.grid_w)


def test_edit_service_restores_input_geometry(monkeypatch):
    """As `pipe.__call__`: without an explicit width AND height the image
    comes back at the caller's size; an explicit size is kept."""
    pipe = _pipe(seed=4)
    monkeypatch.setattr(type(pipe), "target_resolution",
                        snapped_area_policy(32 * 32))
    svc = EditService(pipe, use_regione=True)
    img = _images(2, 1, h=40, w=24)[0]
    [r] = svc.run([EditRequest(image=img, prompt="edit", seed=0)])
    assert r.image.shape[:2] == (40, 24), r.image.shape
    [rb] = svc.run_batched([EditRequest(image=img, prompt="edit", seed=0)])
    assert rb.image.shape[:2] == (40, 24), rb.image.shape
    [re_] = svc.run([EditRequest(image=img, prompt="edit", width=32,
                                 height=32, seed=0)])
    assert re_.image.shape[:2] == (32, 32), re_.image.shape
    # a width alone is a hint, not an output geometry
    [rp] = svc.run([EditRequest(image=img, prompt="edit", width=32,
                                seed=0)])
    assert rp.image.shape[:2] == (40, 24), rp.image.shape
