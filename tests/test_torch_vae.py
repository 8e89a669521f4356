"""The port's VAEs and image resizes against the JAX package's.

AutoencoderKL (`models/vae.py`) and the Wan 2.1 single-frame VAE
(`models/vae_wan.py`) at small configs, the same params (through
`vae_from_jax`) and numpy images in both frameworks, fp32 on the CPU:
`encode` and `decode` agree to 1e-4 of the output's largest magnitude
(fp32 convs summed in another order), the latent normalisations to 1e-6.
Token packing is held exactly; the pipeline's bilinear `_resize` agrees
with `jax.image.resize` to 1e-5 and `_resize_uint8` to one level (it
rounds after resizing, so a value at .5 may flip).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regione_tpu.models import vae as JV
from regione_tpu.models import vae_wan as JW
from regione_tpu.pipelines.base import EditPipelineBase as JEditPipelineBase
from regione_tpu_torch.models import vae as V
from regione_tpu_torch.models import vae_wan as W
from regione_tpu_torch.pipelines.base import EditPipelineBase
from regione_tpu_torch.weights.from_jax import init_vae_params, vae_from_jax
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REL_TOL = 1e-4

# (JAX config, port config, JAX init): three levels each, so a level both
# resamples and changes channels
CONFIGS = {
    "kl": (JV.VAEConfig(block_out_channels=(8, 16, 16), latent_channels=4,
                        norm_num_groups=4, layers_per_block=1),
           V.VAEConfig(block_out_channels=(8, 16, 16), latent_channels=4,
                       norm_num_groups=4, layers_per_block=1),
           JV.init_vae),
    "wan": (JW.WanVAEConfig(base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                            latent_channels=4,
                            latents_mean=tuple(np.linspace(-1, 1, 4)),
                            latents_std=tuple(np.linspace(0.5, 2, 4))),
            W.WanVAEConfig(base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                           latent_channels=4,
                           latents_mean=tuple(np.linspace(-1, 1, 4)),
                           latents_std=tuple(np.linspace(0.5, 2, 4))),
            JW.init_wan_vae),
}


@functools.lru_cache(maxsize=None)
def _pair(family):
    jcfg, tcfg, init = CONFIGS[family]
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), jcfg))
    return jcfg, params, vae_from_jax(params, tcfg, device="cpu")


def _jmod(family):
    return JW if family == "wan" else JV


def _assert_close(got_nchw, want_nhwc):
    want = np.asarray(want_nhwc).transpose(0, 3, 1, 2)
    assert got_nchw.shape == want.shape
    err = np.abs(got_nchw.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("family", ["kl", "wan"])
def test_encode_matches_jax(family):
    jcfg, params, vae = _pair(family)
    img = np.random.default_rng(0).uniform(-1, 1, (2, 24, 32, 3)).astype(
        np.float32)
    want = _jmod(family).encode(params["encoder"], jcfg, jnp.asarray(img))
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert got.shape == (2, 4, 6, 8)
    _assert_close(got, want)


@pytest.mark.parametrize("family", ["kl", "wan"])
def test_decode_matches_jax(family):
    jcfg, params, vae = _pair(family)
    z = np.random.default_rng(1).standard_normal((1, 5, 7, 4)).astype(
        np.float32)
    want = _jmod(family).decode(params["decoder"], jcfg, jnp.asarray(z))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    assert got.shape == (1, 3, 20, 28)
    _assert_close(got, want)


@pytest.mark.parametrize("family", ["kl", "wan"])
def test_latent_normalization_matches_jax(family):
    jcfg, _, vae = _pair(family)
    z = np.random.default_rng(2).standard_normal((1, 3, 5, 4)).astype(
        np.float32)
    jm = _jmod(family)
    zt = torch.from_numpy(z).permute(0, 3, 1, 2)
    for got, want in ((vae.normalize_latents(zt),
                       jm.normalize_latents(jcfg, jnp.asarray(z))),
                      (vae.denormalize_latents(zt),
                       jm.denormalize_latents(jcfg, jnp.asarray(z)))):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-6, atol=1e-6)
    back = vae.denormalize_latents(vae.normalize_latents(zt))
    np.testing.assert_allclose(back.numpy(), zt.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("family", ["kl", "wan"])
def test_posterior_sample_from_a_generator(family):
    """A generator samples mean + std * eps (same seed, same sample); no
    generator gives the mode."""
    _, _, vae = _pair(family)
    img = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (1, 3, 16, 16)).astype(np.float32))
    with torch.no_grad():
        mode = vae.encode(img)
        a = vae.encode(img, torch.Generator().manual_seed(7))
        b = vae.encode(img, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == mode.shape
    assert not torch.allclose(a, mode)


@pytest.mark.parametrize("family", ["kl", "wan"])
def test_vae_from_jax_is_strict(family):
    jcfg, params, vae = _pair(family)
    n_leaves = len(jax.tree.leaves(params))
    assert n_leaves == len(vae.state_dict())
    dropped = jax.tree.map(lambda x: x, params)
    dropped["decoder"]["up"][0]["resnets"][0].pop("conv1")
    with pytest.raises(RuntimeError, match="Missing key"):
        vae_from_jax(dropped, CONFIGS[family][1], device="cpu")


@pytest.mark.parametrize("family", ["kl", "wan"])
def test_init_vae_params_distributions(family):
    cfg = CONFIGS[family][1]
    vae = init_vae_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    for name, p in vae.named_parameters():
        if name.endswith("weight"):
            lim = 1.0 / np.sqrt(p[0].numel())
            assert p.abs().max() <= lim and p.std() > lim / 3, name
        elif name.endswith("bias"):
            assert not p.any(), name
        else:
            assert torch.equal(p, torch.ones_like(p)), name


def test_default_configs_match_jax():
    """Published sizes: the AutoencoderKL's 128/256/512/512 and the Wan
    VAE's level dims; both spatial factor 8."""
    for j, t in ((JV.VAEConfig(), V.VAEConfig()),
                 (JW.WanVAEConfig(), W.WanVAEConfig())):
        for f in ("latent_channels", "spatial_factor"):
            assert getattr(t, f) == getattr(j, f) == (
                16 if f == "latent_channels" else 8)
    assert V.VAEConfig().block_out_channels == \
        JV.VAEConfig().block_out_channels
    j, t = JW.WanVAEConfig(), W.WanVAEConfig()
    assert (t.encoder_dims, t.decoder_dims) == (j.encoder_dims, j.decoder_dims)
    assert (t.latents_mean, t.latents_std) == (j.latents_mean, j.latents_std)
    assert V.vae_module(t) is W.WanVAE
    assert V.vae_module(V.VAEConfig()) is V.AutoencoderKL


def test_pack_unpack_roundtrip_matches_jax():
    z = np.random.default_rng(2).standard_normal((2, 8, 12, 16)).astype(
        np.float32)
    zt = torch.from_numpy(z).permute(0, 3, 1, 2)
    tokens = V.pack_latents(zt)
    assert tokens.shape == (2, 4 * 6, 64)
    np.testing.assert_array_equal(tokens.numpy(),
                                  np.asarray(JV.pack_latents(jnp.asarray(z))))
    assert torch.equal(V.unpack_latents(tokens, 4, 6), zt)
    with pytest.raises(ValueError):
        V.unpack_latents(tokens, 4, 5)


def test_pack_spatial_order():
    """Token (i, j) holds the 2 x 2 patch at rows 2i:2i+2, cols 2j:2j+2,
    in (dy, dx) order."""
    z = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
    t = V.pack_latents(z)
    assert t[0, 0].tolist() == [0, 1, 4, 5]
    assert t[0, 1].tolist() == [2, 3, 6, 7]


RESIZES = [((300, 200), (128, 96)), ((37, 53), (32, 48)),
           ((16, 24), (40, 64)), ((52, 70), (64, 64))]


@pytest.fixture(scope="module")
def resizers():
    return EditPipelineBase.__new__(EditPipelineBase), \
        JEditPipelineBase.__new__(JEditPipelineBase)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_jax(resizers, src, dst):
    tpipe, jpipe = resizers
    arr = np.random.default_rng(5).random(src + (3,)).astype(np.float32)
    w, h = dst[1], dst[0]
    got = tpipe._resize(arr, w, h)
    want = jpipe._resize(arr, w, h)
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_uint8_within_one_level(resizers, src, dst):
    tpipe, jpipe = resizers
    img = (np.random.default_rng(6).random(src + (3,)) * 255).astype(
        np.uint8)
    got = tpipe._resize_uint8(img, dst[1], dst[0])
    want = jpipe._resize_uint8(img, dst[1], dst[0])
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
