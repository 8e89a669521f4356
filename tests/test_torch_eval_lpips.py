"""The port's LPIPS (`regione_tpu_torch.eval.lpips_torch`) and pixel probe
(`regione_tpu_torch.eval.pixelprobe`) against the JAX package's.

  * `lpips_forward` against `regione_tpu.eval.lpips_jax.lpips_forward` on
    the same seeded params at two sizes, fp32 on the CPU: relative error
    <= 1e-5 (the same convolutions summed in another order);
  * the `.npz` weights written by either package and read by the other,
    and the `$REGIONE_LPIPS_WEIGHTS` hook of `metrics.lpips_distance`
    (run_all_tasks' LPIPS column within 1e-4, the CSV's 4 decimals);
  * the pixel probe in fp32 for both decoder families at a 4 x 4 grid: the
    JAX decoder's params through `weights.from_jax.vae_from_jax`
    (`decoder_for_family` monkeypatched in both packages); decoded images
    within 1e-4 of their scale, `psnr_pixel_vs_dense` within its rounding
    (0.01 dB) and SSIM within 1e-4;
  * the production decoder of `decoder_for_family`: bf16, only the decoder
    on the device;
  * on the card (`cuda`): LPIPS card against CPU (TF32 off, 1e-4 of the
    distance) and the probe's decode card against CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regione_tpu.eval import lpips_jax as jl
from regione_tpu.eval import metrics as jmetrics
from regione_tpu.eval import pixelprobe as jprobe
from regione_tpu.models import vae as JV
from regione_tpu.models import vae_wan as JW
from regione_tpu_torch.eval import lpips_torch as tl
from regione_tpu_torch.eval import metrics as tmetrics
from regione_tpu_torch.eval import pixelprobe as tprobe
from regione_tpu_torch.models import vae as V
from regione_tpu_torch.models import vae_wan as W
from regione_tpu_torch.weights.from_jax import vae_from_jax
from test_lpips import _random_state_dicts
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's path of the metric")
    return torch.device("cuda")


def _images(hw, seed=1, n=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3, *hw)).astype(np.float32),
            rng.uniform(-1, 1, (n, 3, *hw)).astype(np.float32))


def test_architecture_constants_are_the_jax_package_s():
    assert tl._ALEX_STAGES == jl._ALEX_STAGES
    assert tl._POOL_AFTER == (0, 1) and tl._TV_IDX == jl._TV_IDX
    assert np.array_equal(tl._SHIFT, jl._SHIFT)
    assert np.array_equal(tl._SCALE, jl._SCALE)


@pytest.mark.parametrize("hw", [(64, 64), (96, 80)])
def test_lpips_forward_matches_jax(hw):
    params = jl.lpips_params_from_torch(*_random_state_dicts(0))
    tparams = tl.lpips_params_from_torch(*_random_state_dicts(0))
    assert params.keys() == tparams.keys()
    for k in params:
        assert np.array_equal(params[k], tparams[k])
    a, b = _images(hw)
    want = np.asarray(jl.lpips_forward(params, jnp.asarray(a),
                                       jnp.asarray(b)))
    got = tl.lpips_forward(tparams, torch.from_numpy(a),
                           torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # identical inputs: zero
    same = tl.lpips_forward(tparams, torch.from_numpy(a), torch.from_numpy(a))
    assert float(same.abs().max()) <= 1e-7


def _npz_pair(tmp_path):
    alex, lins = _random_state_dicts(4)
    ap, lp = tmp_path / "alex.pth", tmp_path / "lins.pth"
    torch.save(alex, ap)
    torch.save(lins, lp)
    jl.save_lpips_npz(str(ap), str(lp), str(tmp_path / "jax.npz"))
    tl.save_lpips_npz(str(ap), str(lp), str(tmp_path / "port.npz"))
    return tmp_path / "jax.npz", tmp_path / "port.npz"


def test_npz_weights_cross_the_packages(tmp_path):
    jnpz, tnpz = _npz_pair(tmp_path)
    with np.load(jnpz) as zj, np.load(tnpz) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert np.array_equal(zj[k], zt[k])
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    # each package on the other's file
    want = jl.lpips_pair_uint8(jl.load_lpips_npz(str(tnpz)), a, b)
    got = tl.lpips_pair_uint8(tl.load_lpips_npz(str(jnpz), device="cpu"),
                              a, b)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-5)
    params = tl.load_lpips_npz(str(jnpz), device="cpu")
    assert {v.device.type for v in params.values()} == {"cpu"}
    assert {v.dtype for v in params.values()} == {torch.float32}


def test_metrics_env_hook_and_run_all_tasks(tmp_path, monkeypatch):
    from PIL import Image
    jnpz, _ = _npz_pair(tmp_path)
    monkeypatch.setenv("REGIONE_LPIPS_WEIGHTS", str(jnpz))
    monkeypatch.setattr(jmetrics, "_LPIPS_JAX_PARAMS", None)
    monkeypatch.setattr(tmetrics, "_LPIPS_PARAMS", {})
    rng = np.random.default_rng(6)
    for root in ("vanilla", "regione"):
        (tmp_path / root / "TE" / "generation").mkdir(parents=True)
    for k in range(2):
        img = rng.integers(0, 256, (48, 48, 3)).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "vanilla" / "TE" /
                                  "generation" / f"k{k}.png")
        Image.fromarray(255 - img).save(tmp_path / "regione" / "TE" /
                                        "generation" / f"k{k}.png")
    want = jmetrics.run_all_tasks(str(tmp_path / "vanilla"),
                                  str(tmp_path / "regione"),
                                  str(tmp_path / "jax"))
    got = tmetrics.run_all_tasks(str(tmp_path / "vanilla"),
                                 str(tmp_path / "regione"),
                                 str(tmp_path / "port"), device="cpu")
    for w, g in zip(want["TE"], got["TE"]):
        assert g["psnr"] == w["psnr"] and g["ssim"] == w["ssim"]
        assert np.isfinite(g["lpips"])
        assert g["lpips"] == pytest.approx(w["lpips"], rel=1e-5)
    rows = [line.split(",") for line in
            (tmp_path / "port" / "TE" / "metric.csv").read_text().split()]
    jrows = [line.split(",") for line in
             (tmp_path / "jax" / "TE" / "metric.csv").read_text().split()]
    for r, j in zip(rows, jrows):
        assert r[:3] == j[:3]
        if r[0] != "Filename":
            assert abs(float(r[3]) - float(j[3])) <= 1e-4
    # a CUDA device with no card raises; it never measures on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tmetrics.lpips_distance(rng.integers(0, 256, (8, 8, 3), np.uint8),
                                rng.integers(0, 256, (8, 8, 3), np.uint8))
    # without weights: NaN, as in JAX
    monkeypatch.delenv("REGIONE_LPIPS_WEIGHTS")
    assert np.isnan(tmetrics.lpips_distance(np.zeros((8, 8, 3), np.uint8),
                                            np.zeros((8, 8, 3), np.uint8)))


def test_converter_rejects_bad_shapes():
    alex, lins = _random_state_dicts(6)
    lins["lin0.model.1.weight"] = torch.zeros(1, 65, 1, 1)
    with pytest.raises(ValueError, match="lin0"):
        tl.lpips_params_from_torch(alex, lins)
    alex, lins = _random_state_dicts(6)
    alex["features.3.weight"] = torch.zeros(192, 64, 3, 3)
    with pytest.raises(ValueError, match="conv1"):
        tl.lpips_params_from_torch(alex, lins)


# -- pixel probe ---------------------------------------------------------------

GRID = 4
PROBE_VAES = {
    # small fp32 decoders of each family, spatial factor 2 (a 4 x 4 token
    # grid -> 8 x 8 latents -> 16 x 16 px), 4 latent channels
    "flux": (JV.VAEConfig(block_out_channels=(8, 16), latent_channels=4,
                          norm_num_groups=4, layers_per_block=1),
             V.VAEConfig(block_out_channels=(8, 16), latent_channels=4,
                         norm_num_groups=4, layers_per_block=1),
             JV, JV.init_vae),
    "wan": (JW.WanVAEConfig(base_dim=8, dim_mult=(1, 2), num_res_blocks=1,
                            latent_channels=4,
                            latents_mean=(-0.5, 0.3, 0.1, 0.0),
                            latents_std=(0.8, 1.5, 1.0, 2.0)),
            W.WanVAEConfig(base_dim=8, dim_mult=(1, 2), num_res_blocks=1,
                           latent_channels=4,
                           latents_mean=(-0.5, 0.3, 0.1, 0.0),
                           latents_std=(0.8, 1.5, 1.0, 2.0)),
            JW, JW.init_wan_vae),
}


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, GRID * GRID, 16)).astype(np.float32)


@pytest.mark.parametrize("family", ["flux", "wan"])
def test_pixel_probe_matches_jax(family, monkeypatch):
    jcfg, tcfg, jmod, init = PROBE_VAES[family]
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(7), jcfg))
    monkeypatch.setattr(jprobe, "decoder_for_family", lambda fam, seed=0: (
        jcfg, jax.tree.map(jnp.asarray, params["decoder"]), jmod))
    vae = vae_from_jax(params, tcfg, device="cpu")
    monkeypatch.setattr(tprobe, "decoder_for_family",
                        lambda fam, seed=0, device="cuda": (tcfg, vae))
    t0, t1 = _tokens(0), _tokens(0) + 0.05 * _tokens(1)

    # the decoded images
    z = JV.unpack_latents(jnp.asarray(t1), GRID, GRID)
    want = np.asarray(jnp.clip(jmod.decode(
        params["decoder"], jcfg, jmod.denormalize_latents(jcfg, z))
        .astype(jnp.float32) * 0.5 + 0.5, 0.0, 1.0))
    got = tprobe.decode_tokens(vae, t1, GRID, GRID)
    assert got.shape == want.shape == (1, 16, 16, 3)
    assert float(np.abs(got - want).max()) <= 1e-4 * max(
        float(np.abs(want).max()), 1e-6)

    j = jprobe.pixel_psnr_vs_dense(t0, t1, GRID, GRID, family=family)
    t = tprobe.pixel_psnr_vs_dense(t0, t1, GRID, GRID, family=family)
    assert set(t) == set(j)
    assert np.isfinite(t["psnr_pixel_vs_dense"])
    assert abs(t["psnr_pixel_vs_dense"] - j["psnr_pixel_vs_dense"]) <= 0.01
    assert abs(t["ssim_pixel_vs_dense"] - j["ssim_pixel_vs_dense"]) <= 1e-4
    assert t["pixel_decoder"].endswith("16x16px")
    same = tprobe.pixel_psnr_vs_dense(t0, torch.from_numpy(t0), GRID, GRID,
                                      family=family)
    assert same["psnr_pixel_vs_dense"] == float("inf")
    assert same["ssim_pixel_vs_dense"] == 1.0


def test_probe_helpers_match_jax():
    a = np.random.default_rng(0).random((4, 4))
    assert tprobe._psnr01(a, a) == jprobe._psnr01(a, a) == float("inf")
    b = np.clip(a + 0.01, 0, 1)
    assert tprobe._psnr01(a, b) == jprobe._psnr01(a, b)
    x = np.random.default_rng(1).random((2, 9, 9, 3))
    y = np.clip(x + 0.02, 0, 1)
    assert tprobe._ssim01(x, y) == jprobe._ssim01(x, y)
    for preset in ("qwen-image-edit", "qwen-image-edit-plus", "step1x-edit",
                   "flux-kontext"):
        assert tprobe.family_for_preset(preset) == \
            jprobe.family_for_preset(preset)


@pytest.mark.parametrize("family", ["flux", "wan"])
def test_production_decoder_alone_reaches_the_device(family):
    """bf16 at the published topology, seeded: the decoder on the device
    asked for ("meta" here: the placement without the memory), the
    encoder on the host."""
    cfg, vae = tprobe.decoder_for_family(family, seed=0, device="meta")
    assert cfg == (W.WanVAEConfig(dtype=torch.bfloat16) if family == "wan"
                   else V.VAEConfig(dtype=torch.bfloat16))
    assert {p.device.type for p in vae.decoder.parameters()} == {"meta"}
    assert {p.device.type for p in vae.encoder.parameters()} == {"cpu"}
    assert {p.dtype for p in vae.parameters()} == {torch.bfloat16}
    _, again = tprobe.decoder_for_family(family, seed=0, device="meta")
    for p, q in zip(vae.encoder.parameters(), again.encoder.parameters()):
        assert torch.equal(p, q)


def test_probe_on_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tprobe.pixel_psnr_vs_dense(_tokens(0), _tokens(1), GRID, GRID)


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_lpips_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                           monkeypatch):
    """LPIPS on the card (cuDNN convs, TF32 off) within 1e-4 of the
    distance of the CPU's, directly and through metrics.lpips_distance."""
    jnpz, _ = _npz_pair(tmp_path)
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-30, 30, a.shape), 0, 255
                ).astype(np.uint8)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = tl.lpips_pair_uint8(tl.load_lpips_npz(str(jnpz), "cpu"), a, b)
        got = tl.lpips_pair_uint8(tl.load_lpips_npz(str(jnpz)), a, b)
        monkeypatch.setenv("REGIONE_LPIPS_WEIGHTS", str(jnpz))
        monkeypatch.setattr(tmetrics, "_LPIPS_PARAMS", {})
        via = tmetrics.lpips_distance(a, b)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert abs(got - want) <= 1e-4 * want and via == got


@pytest.mark.cuda
def test_pixel_probe_decodes_on_the_card(cuda_device):
    jcfg, tcfg, jmod, init = PROBE_VAES["wan"]
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(7), jcfg))
    vae = vae_from_jax(params, tcfg, device="cpu")
    want = tprobe.decode_tokens(vae, _tokens(2), GRID, GRID)
    vae.decoder.to(cuda_device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = tprobe.decode_tokens(vae, _tokens(2), GRID, GRID)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert float(np.abs(got - want).max()) <= 1e-4 * float(
        np.abs(want).max())
    # the production decoder on the card (16 latent channels: 64 a token)
    tokens = np.random.default_rng(3).standard_normal((1, 64, 64)).astype(
        np.float32)
    r = tprobe.pixel_psnr_vs_dense(tokens, tokens, 8, 8, "flux")
    assert r["psnr_pixel_vs_dense"] == float("inf")
    assert r["pixel_decoder"].endswith("bf16, 128x128px")
