"""The port's checkpoint loading (`weights.convert`, `weights.checkpoint`)
against the JAX package's converter, on the CPU in fp32.

Synthetic diffusers-layout state dicts (tests/test_convert.py's inverse
maps, tests/test_wan_vae.py's Wan state) are written as safetensors shards
and loaded through `load_converted`; the port's modules must hold exactly
what `mmdit_from_jax` / `vae_from_jax` give for the JAX converter's pytrees
of the same state.  Also: a tensor left unconsumed is refused; a bf16 file
reads as its fp32 twin rounded to bf16 (the JAX package's reader, numpy,
has no bfloat16); an edit on the loaded model matches the JAX pipeline's;
`checkpoint.save` / `load` round-trip quantized state dicts and agree with
the `safetensors` package; the offline converter writes files that load.
"""

import dataclasses
import json
import functools

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

import regione_tpu.weights.convert as jconvert
from regione_tpu.core.config import RegionEParams
from regione_tpu.models import vae as JV
from regione_tpu.models.mmdit import init_mmdit
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.pipelines.base import EditInputs as JEditInputs
from regione_tpu.pipelines.step1x_edit import (
    Step1XEditPipeline as JStep1XEditPipeline)
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.models.text_encoders import MockTextEncoder
from regione_tpu_torch.models.vae import VAEConfig
from regione_tpu_torch.models.vae_wan import WanVAE, WanVAEConfig
from regione_tpu_torch.ops.quant import quantize_params
from regione_tpu_torch.pipelines.base import EditInputs
from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
from regione_tpu_torch.weights import checkpoint
from regione_tpu_torch.weights import convert as tconvert
from regione_tpu_torch.weights.from_jax import mmdit_from_jax, vae_from_jax
from tests.test_convert import (synth_connector_state,
                                synth_state_from_params, synth_vae_state,
                                to_qwen_naming, to_step1x_naming)
from tests.test_wan_vae import TINY as J_WAN_TINY
from tests.test_wan_vae import synth_wan_state
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

KL_CFG = dict(block_out_channels=(8, 16), latent_channels=2,
              norm_num_groups=4, layers_per_block=1)


@functools.lru_cache(maxsize=None)
def _params(preset, seed=0):
    return jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(seed),
                                               j_get_config(preset)))


def _diffusers_state(preset, naming):
    params = _params(preset)
    cfg = j_get_config(preset)
    state = synth_state_from_params(params, cfg)
    if cfg.connector is not None:
        state.update(synth_connector_state(params["connector"],
                                           cfg.connector))
    return {"flux": lambda s: s, "step1x": to_step1x_naming,
            "qwen": to_qwen_naming}[naming](state)


def _jax_normalized(state):
    if any(k.startswith("img_in") or ".img_mod." in k for k in state):
        state = jconvert.normalize_qwen_keys(state)
    if jconvert.is_step1x_state(state):
        state = jconvert.normalize_step1x_keys(state)
    return state


def _write_shards(d, state, n_shards=2, dtype=np.float32):
    """A diffusers-style folder of `n_shards` safetensors files."""
    d.mkdir(parents=True, exist_ok=True)
    keys = sorted(state)
    for i in range(n_shards):
        np_save_file({k: np.ascontiguousarray(state[k], dtype)
                      for k in keys[i::n_shards]},
                     str(d / f"model-{i:05d}.safetensors"))


def _kl_vae(tmp, seed=1):
    jcfg = JV.VAEConfig(**KL_CFG)
    vstate = synth_vae_state(JV.init_vae(jax.random.PRNGKey(seed), jcfg))
    _write_shards(tmp / "vae", vstate, n_shards=1)
    (tmp / "vae" / "config.json").write_text(json.dumps(
        {"_class_name": "AutoencoderKL", "latent_channels": 2,
         "block_out_channels": [8, 16], "layers_per_block": 1,
         "norm_num_groups": 4, "scaling_factor": 0.3611,
         "shift_factor": 0.1159}))
    return jcfg, vstate


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k


@pytest.mark.parametrize("preset,naming", [
    ("tiny", "flux"), ("tiny-flux", "flux"), ("tiny-step1x", "step1x"),
    ("tiny-qwen", "qwen")])
def test_load_converted_equals_the_jax_converter(preset, naming, tmp_path):
    state = _diffusers_state(preset, naming)
    _write_shards(tmp_path / "transformer", state)
    jcfg, vstate = _kl_vae(tmp_path)
    model, vcfg, vae, enc = tconvert.load_converted(
        tmp_path, get_config(preset), backend=None, device="cpu")
    want = mmdit_from_jax(jconvert.convert_flux_transformer(
        _jax_normalized(state), j_get_config(preset)), get_config(preset),
        device="cpu")
    _assert_states_equal(model.state_dict(), want.state_dict())
    assert vcfg == VAEConfig(**KL_CFG)
    _assert_states_equal(vae.state_dict(), vae_from_jax(
        jconvert.convert_vae(vstate, jcfg), vcfg, device="cpu").state_dict())
    assert isinstance(enc, MockTextEncoder)
    assert enc.dim == get_config(preset).txt_in_dim


def test_wan_vae_equals_the_jax_converter(tmp_path):
    st = synth_wan_state(J_WAN_TINY)
    _write_shards(tmp_path / "vae", st)
    (tmp_path / "vae" / "config.json").write_text(json.dumps(
        {"_class_name": "AutoencoderKLWan", "z_dim": 4, "base_dim": 8,
         "dim_mult": [1, 2], "num_res_blocks": 1,
         "latents_mean": list(J_WAN_TINY.latents_mean),
         "latents_std": list(J_WAN_TINY.latents_std)}))
    _write_shards(tmp_path / "transformer", _diffusers_state("tiny-qwen",
                                                             "qwen"))
    _, vcfg, vae, _ = tconvert.load_converted(
        tmp_path, get_config("tiny-qwen"), device="cpu")
    assert isinstance(vae, WanVAE)
    assert vcfg == dataclasses.replace(
        WanVAEConfig(base_dim=8, dim_mult=(1, 2), num_res_blocks=1,
                     latent_channels=4),
        latents_mean=J_WAN_TINY.latents_mean,
        latents_std=J_WAN_TINY.latents_std)
    want = vae_from_jax(jconvert.convert_wan_vae(st, J_WAN_TINY), vcfg,
                        device="cpu")
    _assert_states_equal(vae.state_dict(), want.state_dict())
    # the causal kernels keep their last time tap
    np.testing.assert_array_equal(
        vae.state_dict()["encoder.conv_in.weight"].numpy(),
        st["encoder.conv_in.weight"][:, :, -1])


def test_unconsumed_or_missing_tensors_are_refused():
    state = _diffusers_state("tiny", "flux")
    state["transformer_blocks.0.attn.to_q_extra.weight"] = np.zeros(
        (4, 4), np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        tconvert.convert_flux_transformer(
            {k: torch.from_numpy(v.copy()) for k, v in state.items()},
            get_config("tiny"), device="cpu")
    # a connector preset with no connector tensors: a KeyError, never a
    # partial model
    plain = _diffusers_state("tiny", "flux")
    with pytest.raises(KeyError):
        tconvert.convert_flux_transformer(
            {k: torch.from_numpy(v.copy()) for k, v in plain.items()},
            get_config("tiny-step1x"), device="cpu")
    # quant / post_quant convs in an AutoencoderKL checkpoint: another
    # architecture
    vstate = synth_vae_state(JV.init_vae(jax.random.PRNGKey(0),
                                         JV.VAEConfig(**KL_CFG)))
    vstate["quant_conv.weight"] = np.zeros((4, 4, 1, 1), np.float32)
    with pytest.raises(ValueError, match="quant"):
        tconvert.convert_vae({k: torch.from_numpy(np.array(v))
                              for k, v in vstate.items()},
                             VAEConfig(**KL_CFG), device="cpu")


def test_bf16_checkpoint_reads_as_its_rounded_fp32_twin(tmp_path):
    """Published checkpoints are bf16.  The port reads a bf16 file to the
    values of the same fp32 tensors rounded to bf16, tensor by tensor and
    through `load_converted` (the JAX converter reads fp32 files only:
    numpy has no bfloat16)."""
    state = _diffusers_state("tiny-flux", "flux")
    st_save_file({k: torch.from_numpy(np.array(v)).bfloat16()
                  for k, v in state.items()},
                 str(tmp_path / "w.safetensors"))
    f = checkpoint.SafetensorsFile(tmp_path / "w.safetensors")
    for k, v in state.items():
        t = f.get(k)
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, torch.from_numpy(np.array(v)).bfloat16()), k
    (tmp_path / "ck" / "transformer").mkdir(parents=True)
    (tmp_path / "w.safetensors").rename(
        tmp_path / "ck" / "transformer" / "w.safetensors")
    _kl_vae(tmp_path / "ck")
    model, *_ = tconvert.load_converted(tmp_path / "ck",
                                        get_config("tiny-flux"),
                                        device="cpu")
    rounded = {k: np.asarray(torch.from_numpy(np.array(v)).bfloat16().float())
               for k, v in state.items()}
    want = mmdit_from_jax(jconvert.convert_flux_transformer(
        rounded, j_get_config("tiny-flux")), get_config("tiny-flux"),
        device="cpu")
    _assert_states_equal(model.state_dict(), want.state_dict())


def test_edit_on_the_loaded_model_matches_jax(tmp_path):
    state = _diffusers_state("tiny-step1x", "step1x")
    _write_shards(tmp_path / "transformer", state)
    _kl_vae(tmp_path)
    model, *_ = tconvert.load_converted(tmp_path, get_config("tiny-step1x"),
                                        device="cpu")
    jparams = jconvert.convert_flux_transformer(
        _jax_normalized(state), j_get_config("tiny-step1x"))
    re = RegionEParams(cache_threshold=0.05, capacity_granularity=8)
    jpipe = JStep1XEditPipeline(j_get_config("tiny-step1x"), jparams, re)
    tpipe = Step1XEditPipeline(model, re)
    rng = np.random.default_rng(3)
    grid, t_txt = 8, 4
    txt = rng.standard_normal((2, t_txt, 16)).astype(np.float32)
    cond = (0.5 * rng.standard_normal((1, 64, 8))).astype(np.float32)
    lat0 = rng.standard_normal((1, 64, 8)).astype(np.float32)
    forced = np.zeros((grid, grid), bool)
    forced[2:5, 1:6] = True
    jr = jpipe.build_rope(grid, grid, t_txt)
    want, jstats = jpipe.edit_latents(
        jax.numpy.asarray(lat0), JEditInputs(
            txt=jax.numpy.asarray(txt), cond_latent=jax.numpy.asarray(cond),
            rope_img=jr[0], rope_txt=jr[1]), grid, grid,
        forced_mask=jax.numpy.asarray(forced.reshape(-1)))
    tr = tpipe.build_rope(grid, grid, t_txt)
    got, tstats = tpipe.edit_latents(
        torch.from_numpy(lat0), EditInputs(
            txt=torch.from_numpy(txt), cond_latent=torch.from_numpy(cond),
            rope_img=tr[0], rope_txt=tr[1]), grid, grid,
        forced_mask=torch.from_numpy(forced.reshape(-1)))
    assert tstats.edited_tokens == 15 and tstats.rags_steps > 0
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    # tests/test_torch_pipeline.py's tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)


DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8,
          torch.uint8, torch.int32]


def test_safetensors_reader_and_writer_agree_with_the_package(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {f"t{i}": (torch.randn(3, 5, generator=g) * 50).to(dt)
             for i, dt in enumerate(DTYPES)}
    state.update(empty=torch.zeros(0, 4), scalar=torch.tensor(2.5),
                 odd=torch.arange(7, dtype=torch.int8))
    st_save_file(state, str(tmp_path / "lib.safetensors"),
                 metadata={"format": "pt"})
    _assert_states_equal(checkpoint.load(tmp_path / "lib.safetensors",
                                         "cpu"), state)
    checkpoint.save(tmp_path / "port.safetensors", state)
    _assert_states_equal(st_load_file(str(tmp_path / "port.safetensors")),
                         state)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_model_round_trips(bits, tmp_path, monkeypatch):
    import regione_tpu_torch.ops.quant as tquant
    monkeypatch.setattr(tquant, "_INT4_MIN_IN", 0)
    cfg = get_config("tiny-step1x")
    model = quantize_params(mmdit_from_jax(_params("tiny-step1x"), cfg,
                                           device="cpu"),
                            quantize_mods=True, bits=bits)
    checkpoint.save(tmp_path / "q.safetensors", model.state_dict())
    back = checkpoint.mmdit_from_checkpoint(tmp_path / "q.safetensors", cfg,
                                            device="cpu")
    _assert_states_equal(back.state_dict(), model.state_dict())
    assert {type(m).__name__ for m in back.modules()} == \
        {type(m).__name__ for m in model.modules()}


def test_offline_converter_writes_loadable_files(tmp_path, capsys):
    state = _diffusers_state("tiny-qwen", "qwen")
    _write_shards(tmp_path / "hf" / "transformer", state)
    _kl_vae(tmp_path / "hf")
    tconvert.main(["--model_path", str(tmp_path / "hf"), "--backend",
                   "tiny-qwen", "--out", str(tmp_path / "out"),
                   "--device", "cpu"])
    assert "converted tiny-qwen" in capsys.readouterr().out
    back = checkpoint.mmdit_from_checkpoint(
        tmp_path / "out" / "transformer.safetensors", get_config("tiny-qwen"),
        device="cpu")
    want = mmdit_from_jax(jconvert.convert_flux_transformer(
        _jax_normalized(state), j_get_config("tiny-qwen")),
        get_config("tiny-qwen"), device="cpu")
    _assert_states_equal(back.state_dict(), want.state_dict())
    vae = checkpoint.load(tmp_path / "out" / "vae.safetensors", "cpu")
    assert "encoder.conv_in.weight" in vae
