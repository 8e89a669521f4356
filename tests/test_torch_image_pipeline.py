"""The port's image-level edit path against the JAX one.

`prepare_inputs` and `__call__` for every backend (Step1X v1.1 and v1.2 and
FLUX with the AutoencoderKL, Qwen and Plus with the Wan VAE) at the tiny
presets, the same params, images and prompt encoder in both frameworks,
fp32 on the CPU.  The JAX package draws its noise with `jax.random`; the
port's seam `initial_latents` is handed the same noise.  Bounds:
  * prompt tensors, bias, pooled, guidance and rope tables: 1e-6 (the same
    numpy values, cast);
  * the condition latent: 1e-4 of its largest magnitude (the VAE bound of
    tests/test_torch_vae.py, after a resize equal to 1e-5);
  * `__call__`'s image in [0, 1]: 1e-3 (28 fp32 Euler steps at 5e-4 as in
    tests/test_torch_pipeline.py, then the decoder); plan stats equal.
Then the JAX package's own image-level cases on the port: the output
geometry (tests/test_output_geometry.py), the prompt conditioning of both
CFG halves (tests/test_prompt_conditioning.py) and a Plus multi-reference
call (tests/test_multiref.py).
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regione_tpu.core.config import RegionEParams
from regione_tpu.models import vae as JV
from regione_tpu.models import vae_wan as JW
from regione_tpu.models.mmdit import init_mmdit
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.models.text_encoders import MockTextEncoder
from regione_tpu.pipelines import flux_kontext as jfk
from regione_tpu.pipelines import qwen_image_edit as jqie
from regione_tpu.pipelines import step1x_edit as jsx
from regione_tpu_torch.models import vae as V
from regione_tpu_torch.models import vae_wan as W
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.pipelines import flux_kontext as tfk
from regione_tpu_torch.pipelines import qwen_image_edit as tqie
from regione_tpu_torch.pipelines import step1x_edit as tsx
from regione_tpu_torch.weights.from_jax import mmdit_from_jax, vae_from_jax
from torch_cpu import jax_schedule  # noqa: F401 (fixture)
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

VAES = {
    "kl": (JV.VAEConfig(block_out_channels=(8, 16), latent_channels=2,
                        norm_num_groups=4, layers_per_block=1),
           V.VAEConfig(block_out_channels=(8, 16), latent_channels=2,
                       norm_num_groups=4, layers_per_block=1),
           JV.init_vae),
    "wan": (JW.WanVAEConfig(base_dim=8, dim_mult=(1, 2), num_res_blocks=1,
                            latent_channels=2, latents_mean=(-0.5, 0.3),
                            latents_std=(0.8, 1.5)),
            W.WanVAEConfig(base_dim=8, dim_mult=(1, 2), num_res_blocks=1,
                           latent_channels=2, latents_mean=(-0.5, 0.3),
                           latents_std=(0.8, 1.5)),
            JW.init_wan_vae),
}
# backend -> (class name, JAX module, port module, preset, VAE family)
BACKENDS = {
    "step1x-edit": ("Step1XEditPipeline", jsx, tsx, "tiny-step1x", "kl"),
    "step1x-edit-v1p2": ("Step1XEditV1P2Pipeline", jsx, tsx, "tiny-step1x",
                         "kl"),
    "flux-kontext": ("FluxKontextPipeline", jfk, tfk, "tiny-flux", "kl"),
    "qwen-image-edit": ("QwenImageEditPipeline", jqie, tqie, "tiny-qwen",
                        "wan"),
    "qwen-image-edit-plus": ("QwenImageEditPlusPipeline", jqie, tqie,
                             "tiny-qwen", "wan"),
}
RE = RegionEParams(threshold=0.0, erosion_dilation=False,
                   capacity_granularity=8)
IMG = (np.random.default_rng(3).random((48, 64, 3)) * 255).astype(np.uint8)
REF = (np.random.default_rng(4).random((40, 24, 3)) * 255).astype(np.uint8)


class PromptEncoder:
    """Stub prompt encoder: features from the prompt alone (so a one-level
    difference in a resized encoder image cannot change them), a length
    per prompt, a distinct pooled vector per prompt; records every call."""

    def __init__(self, dim, pooled_dim=None, t_for=None, default_t=6):
        self.dim, self.pooled_dim = dim, pooled_dim
        self.t_for, self.default_t = t_for or {}, default_t
        self.calls = []

    def encode(self, prompt, image=None):
        self.calls.append((prompt, image))
        t = self.t_for.get(prompt, self.default_t)
        seed = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:8],
                              "little")
        rng = np.random.default_rng(seed)
        emb = rng.standard_normal((1, t, self.dim)).astype(np.float32)
        pooled = (rng.standard_normal((1, self.pooled_dim)).astype(np.float32)
                  if self.pooled_dim else None)
        return emb, pooled, np.ones((1, t), bool)


@functools.lru_cache(maxsize=None)
def _weights(preset, family):
    params = jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(0),
                                                 j_get_config(preset)))
    jcfg, _, init = VAES[family]
    return params, jax.tree.map(np.asarray, init(jax.random.PRNGKey(1), jcfg))


def make_pair(backend, encoder=None, **kw):
    """(JAX pipeline, port pipeline) with the same weights and encoder."""
    cls, jmod, tmod, preset, family = BACKENDS[backend]
    params, vparams = _weights(preset, family)
    jvcfg, tvcfg, _ = VAES[family]
    jpipe = getattr(jmod, cls)(j_get_config(preset), params, RE, **kw)
    tpipe = getattr(tmod, cls)(mmdit_from_jax(params, get_config(preset),
                                              device="cpu"),
                               RE, **kw)
    jpipe.attach_vae(jvcfg, vparams)
    tpipe.attach_vae(vae_from_jax(vparams, tvcfg, device="cpu"))
    cfg = tpipe.cfg
    enc = encoder or PromptEncoder(cfg.txt_in_dim, cfg.pooled_dim or None)
    for p in (jpipe, tpipe):
        p.attach_text_encoder(enc)
        if backend == "qwen-image-edit-plus":
            p.vae_image_area = 32 * 32
    return jpipe, tpipe, enc


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _images(backend):
    return [IMG, REF] if backend == "qwen-image-edit-plus" else IMG


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_prepare_inputs_matches_jax(backend):
    jpipe, tpipe, _ = make_pair(backend)
    for p in (jpipe, tpipe):
        p.text_encoder.t_for = {"add a hat": 7, "blurry": 4}
    want, jgeo = jpipe.prepare_inputs(_images(backend), "add a hat",
                                      "blurry", width=32, height=32)
    got, tgeo = tpipe.prepare_inputs(_images(backend), "add a hat", "blurry",
                                     width=32, height=32)
    assert tgeo == jgeo
    for name in ("txt", "txt_bias", "pooled", "guidance"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            _close(g, w, 1e-6)
    for g_tab, w_tab in ((got.rope_img, want.rope_img),
                         (got.rope_txt, want.rope_txt)):
        for g, w in zip(g_tab, w_tab):
            _close(g, w, 1e-6)
    cond = np.asarray(want.cond_latent)
    _close(got.cond_latent, cond, 1e-4 * np.abs(cond).max())
    assert got.txt.shape[0] == (2 if tpipe.do_cfg else 1)
    if backend == "flux-kontext":
        assert got.guidance.dtype == torch.float32
        assert got.guidance.tolist() == [2.5]


@pytest.mark.usefixtures("jax_schedule")
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_call_matches_jax_given_the_same_noise(backend, monkeypatch):
    jpipe, tpipe, _ = make_pair(backend)

    def jax_noise(seed, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jnp.float32)))
    monkeypatch.setattr(tpipe, "initial_latents", jax_noise)
    want, jstats = jpipe(_images(backend), "make it night", width=32,
                         height=32, seed=5)
    got, tstats = tpipe(_images(backend), "make it night", width=32,
                        height=32, seed=5)
    assert got.shape == (32, 32, 3) and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0
    assert 0 < tstats.edited_tokens < tstats.seq_len
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    _close(got, want, 1e-3)


def test_initial_latents_seeded_on_the_device():
    _, tpipe, _ = make_pair("step1x-edit")
    a = tpipe.initial_latents(3, (1, 16, 8))
    assert a.dtype == torch.float32 and a.device == tpipe.device
    assert torch.equal(a, tpipe.initial_latents(3, (1, 16, 8)))
    assert not torch.equal(a, tpipe.initial_latents(4, (1, 16, 8)))


def test_call_needs_a_vae_and_an_encoder():
    _, tpipe, _ = make_pair("step1x-edit")
    tpipe.vae = None
    with pytest.raises(RuntimeError, match="attach_vae"):
        tpipe(IMG, "x", width=32, height=32)


def test_uint8_output_and_the_mock_encoder():
    """output_type="uint8" with the JAX package's MockTextEncoder (numpy
    only, reused by import)."""
    _, tpipe, _ = make_pair("flux-kontext",
                            encoder=MockTextEncoder(16, 8, max_length=8))
    out, stats = tpipe(IMG, "night", width=32, height=32, seed=1,
                       output_type="uint8")
    assert out.dtype == np.uint8 and out.shape == (32, 32, 3)
    assert stats is not None


# -- output geometry (tests/test_output_geometry.py) ------------------------

IN_H, IN_W = 52, 70
GEO_IMG = (np.random.default_rng(5).random((IN_H, IN_W, 3)) * 255
           ).astype(np.uint8)


def _area_policy(self, width, height):
    """Tiny-scale stand-in for the ~1024^2-area policy (64 x 64 area)."""
    ratio = width / height
    f = self.token_factor
    w = int(round((64 * 64 * ratio) ** 0.5 / f) * f)
    h = int(round((w / ratio) / f) * f)
    return max(f, w), max(f, h)


@pytest.fixture()
def geo_pipe(monkeypatch):
    _, tpipe, _ = make_pair("step1x-edit")
    monkeypatch.setattr(type(tpipe), "target_resolution", _area_policy)
    return tpipe


def test_default_restores_input_geometry(geo_pipe):
    out, _ = geo_pipe(GEO_IMG, "make it night", seed=0)
    assert out.shape == (IN_H, IN_W, 3)
    assert np.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0


def test_no_resize_keeps_processed_geometry(geo_pipe):
    out, _ = geo_pipe(GEO_IMG, "make it night", seed=0, resize_to_input=False)
    pw, ph = _area_policy(geo_pipe, IN_W, IN_H)
    assert out.shape == (ph, pw, 3) and out.shape[:2] != (IN_H, IN_W)


def test_explicit_size_wins_over_resize_back(geo_pipe):
    out, _ = geo_pipe(GEO_IMG, "make it night", seed=0, width=64, height=64)
    assert out.shape == (64, 64, 3)


def test_resize_back_matches_direct_resize_of_processed(geo_pipe):
    raw, _ = geo_pipe(GEO_IMG, "make it night", seed=0, resize_to_input=False)
    restored, _ = geo_pipe(GEO_IMG, "make it night", seed=0)
    expect = np.clip(geo_pipe._resize(raw, IN_W, IN_H), 0.0, 1.0)
    np.testing.assert_allclose(restored, expect, atol=1e-6)


# -- prompt conditioning (tests/test_prompt_conditioning.py) -----------------

@pytest.mark.parametrize("backend", ["step1x-edit", "step1x-edit-v1p2",
                                     "qwen-image-edit"])
def test_image_reaches_encoder_for_both_cfg_halves(backend):
    jpipe, tpipe, enc = make_pair(backend, true_cfg_scale=4.0)
    assert tpipe.do_cfg
    _, (w, h, _, _, _) = tpipe.prepare_inputs(IMG, "add a red hat",
                                              "low quality", width=32,
                                              height=32)
    assert [c[0] for c in enc.calls] == ["add a red hat", "low quality"]
    want = jpipe._resize_uint8(IMG, w, h)
    for _, image in enc.calls:
        (im,) = image
        assert im.shape == (h, w, 3) and im.dtype == np.uint8
        assert np.abs(im.astype(int) - want.astype(int)).max() <= 1


def test_flux_encoder_never_sees_the_image_and_uses_negative_pooled():
    _, tpipe, enc = make_pair("flux-kontext", true_cfg_scale=2.0)
    assert tpipe.do_cfg
    ctx, _ = tpipe.prepare_inputs(IMG, "make it night", "blurry", width=32,
                                  height=32)
    assert [c[0] for c in enc.calls] == ["make it night", "blurry"]
    assert all(image is None for _, image in enc.calls)
    pooled = ctx.pooled.numpy()
    assert pooled.shape[0] == 2 and ctx.guidance.tolist() == [2.5, 2.5]
    np.testing.assert_allclose(pooled[0], enc.encode("make it night")[1][0],
                               rtol=1e-6)
    np.testing.assert_allclose(pooled[1], enc.encode("blurry")[1][0],
                               rtol=1e-6)


def test_plus_condition_images_resized_to_384_area():
    jpipe, tpipe, enc = make_pair("qwen-image-edit-plus")
    tpipe.prepare_inputs([IMG, REF], "merge", "bad", width=32, height=32)
    assert len(enc.calls) == 2
    for _, image in enc.calls:
        assert isinstance(image, list) and len(image) == 2
        for im, src in zip(image, [IMG, REF]):
            want_w, want_h = tqie.calculate_dimensions(
                384 * 384, src.shape[1] / src.shape[0], 32)
            assert im.shape == (want_h, want_w, 3)
            ref = jpipe._resize_uint8(src, want_w, want_h)
            assert np.abs(im.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("backend,negative,want", [
    ("qwen-image-edit", None, " "),
    ("qwen-image-edit-plus", None, " "),
    ("step1x-edit", None, ""),
    ("qwen-image-edit", "blurry", "blurry"),
])
def test_default_negative_prompt_per_backend(backend, negative, want):
    _, tpipe, enc = make_pair(backend, true_cfg_scale=4.0)
    tpipe.prepare_inputs(IMG, "edit", negative_prompt=negative, width=32,
                         height=32)
    assert [c[0] for c in enc.calls] == ["edit", want]


def test_plus_ref_vae_size_uses_per_image_area_not_target():
    jpipe, tpipe, _ = make_pair("qwen-image-edit-plus")
    for p in (jpipe, tpipe):
        p.vae_image_area = 1024 * 1024
    w, h = tpipe.ref_vae_size(512, 2048, 32, 32)
    assert (w, h) == tqie.calculate_dimensions(1024 * 1024, 512 / 2048, 32)
    assert (w, h) == jpipe.ref_vae_size(512, 2048, 32, 32)
    # the default recipe: the reference's aspect at the target's area
    _, spipe, _ = make_pair("step1x-edit")
    assert spipe.ref_vae_size(24, 40, 32, 32) == \
        make_pair("step1x-edit")[0].ref_vae_size(24, 40, 32, 32)


def test_cfg_halves_with_different_lengths_pad_and_mask():
    _, tpipe, enc = make_pair("step1x-edit", true_cfg_scale=4.0)
    enc.t_for = {"long prompt": 10, "": 4}
    ctx, _ = tpipe.prepare_inputs(IMG, "long prompt", "", width=32,
                                  height=32)
    assert ctx.txt.shape == (2, 10, tpipe.cfg.txt_in_dim)
    bias = ctx.txt_bias.numpy()
    assert (bias[0, 0, 0, :10] == 0).all()
    assert (bias[1, 0, 0, :4] == 0).all()
    assert (bias[1, 0, 0, 4:10] < -1e8).all()
    assert (bias[:, 0, 0, 10:] == 0).all()


# -- multi-reference (tests/test_multiref.py) --------------------------------

def test_image_level_multiref_call():
    _, tpipe, _ = make_pair("qwen-image-edit-plus",
                            encoder=MockTextEncoder(16, None, max_length=8))
    tpipe.condition_image_area = 32 * 32
    rng = np.random.default_rng(1)
    target = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    ref2 = (rng.random((24, 40, 3)) * 255).astype(np.uint8)
    ctx, (_, _, gh, gw, _) = tpipe.prepare_inputs(
        [target, ref2], "put the object from the second image into the "
        "first", width=32, height=32)
    assert ctx.cond_latent.shape[1] > gh * gw
    out, stats = tpipe([target, ref2], "put the object from the second "
                       "image into the first", width=32, height=32, seed=5)
    assert out.shape == (32, 32, 3) and stats is not None
    assert np.isfinite(out).all()
