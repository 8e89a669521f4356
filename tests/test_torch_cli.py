"""The port's CLI (`regione_tpu_torch.cli.main`) on the CPU.

Demo and evaluation mode at the tiny presets with `--device cpu` and random
weights, beside the JAX package's CLI on the same inputs: the same output
files, image geometry and JSON schema (time_consuming.json, metadata.json).
`--model_path` (a synthetic diffusers-layout checkpoint) and the weight
formats (`--int8`, `--int4`, `--act_int8`, `--quantize_mods`,
`--int4_mods`) give the JAX CLI's image, and its two refusals; the
thinker flags run the v1.2 loop (`pipelines.thinker`); the reference
command-line forms (jsonl / dataset-root `--image_path`, the
28-step pin, warmup on the first item) behave as in tests/test_cli.py.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from regione_tpu.cli import main as jcli
from regione_tpu_torch.cli import main as tcli
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

FAST = ["--use_regione", "--threshold", "0.0", "--erosion_dilation", "False",
        "--size_level", "32", "--random_weights"]


def _png(path, seed=0, shape=(32, 32, 3)):
    img = (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)
    Image.fromarray(img).save(path)
    return path


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def test_demo_mode_matches_the_jax_cli(tmp_path):
    src = _png(tmp_path / "in.png", shape=(40, 56, 3))
    args = FAST + ["--preset", "tiny", "--image_path", str(src),
                   "--prompt", "test edit"]
    jcli.main(args + ["--output_dir", str(tmp_path / "jax")])
    tcli.main(args + ["--output_dir", str(tmp_path / "port"),
                      "--device", "cpu"])
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == \
        ["demo_0.png"]
    got = np.asarray(Image.open(tmp_path / "port" / "demo_0.png"))
    want = np.asarray(Image.open(tmp_path / "jax" / "demo_0.png"))
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.uint8


def _dataset(root, schema="ours"):
    task = root / "bench" / "TE"
    (task / "img").mkdir(parents=True)
    with open(task / "metadata.jsonl", "w") as fh:
        for k in range(2):
            _png(task / "img" / f"k{k}.png", seed=k)
            item = ({"key": f"k{k}", "image": f"k{k}.png",
                     "prompt": f"edit {k}"} if schema == "ours" else
                    {"key": f"k{k}", "instruction": f"edit {k}",
                     "instruction_language": "en"})
            fh.write(json.dumps(item) + "\n")
    return root / "bench"


@pytest.mark.parametrize("schema", ["ours", "reference"])
def test_evaluation_mode_matches_the_jax_cli(tmp_path, schema):
    bench = _dataset(tmp_path, schema)
    args = FAST + ["--preset", "tiny", "--evaluation", "--eval_dir",
                   str(bench)]
    jcli.main(args + ["--output_dir", str(tmp_path / "jax")])
    tcli.main(args + ["--output_dir", str(tmp_path / "port"),
                      "--device", "cpu"])
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == [
        "TE/generation/k0.png", "TE/generation/k1.png", "TE/metadata.json",
        "TE/time_consuming.json"]
    out = tmp_path / "port" / "TE"
    timing = json.load(open(out / "time_consuming.json"))
    want = json.load(open(tmp_path / "jax" / "TE" / "time_consuming.json"))
    assert sorted(timing) == sorted(want)
    assert timing["num_item"] == 2 and len(timing["time_consuming_list"]) == 2
    assert timing["ave_time_consuming"] == pytest.approx(
        np.mean(timing["time_consuming_list"]))
    assert json.load(open(out / "metadata.json")) == json.load(
        open(tmp_path / "jax" / "TE" / "metadata.json")) == {
            "k0": "edit 0", "k1": "edit 1"}


@pytest.mark.parametrize("backend,preset", [
    ("step1x-edit", "tiny-step1x"),
    ("step1x-edit-v1p2", "tiny-step1x"),
    ("flux-kontext", "tiny-flux"),
    ("qwen-image-edit", "tiny-qwen"),
    ("qwen-image-edit-plus", "tiny-qwen"),
])
def test_every_backend_demo(backend, preset, tmp_path):
    src = _png(tmp_path / "in.png", shape=(64, 64, 3))
    extra = (["--ref_image_path", str(_png(tmp_path / "ref.png", 1,
                                           (48, 80, 3)))]
             if backend == "qwen-image-edit-plus" else [])
    tcli.main(FAST + ["--backend", backend, "--preset", preset,
                      "--image_path", str(src), "--prompt", "edit",
                      "--output_dir", str(tmp_path / "out"),
                      "--device", "cpu"] + extra)
    arr = np.asarray(Image.open(tmp_path / "out" / "demo_0.png"))
    assert arr.shape == (32, 32, 3) and arr.dtype == np.uint8


def test_build_pipeline_geometry_and_flags():
    """The mock VAE has the production token factor 16 (a 64 x 64 grid at
    the default ~1024^2 target); --guidance_scale maps to FLUX's embedded
    guidance and to true CFG elsewhere; --use_regione sets the toggle."""
    parser = tcli.make_parser()
    args = parser.parse_args(["--backend", "flux-kontext", "--preset",
                              "tiny-flux", "--device", "cpu",
                              "--guidance_scale", "4.0"])
    pipe = tcli.build_pipeline(args)
    assert pipe.token_factor == 16 and pipe.guidance_scale == 4.0
    w, h = pipe.target_resolution(900, 900)
    assert (h // 16, w // 16) == (64, 64)
    assert pipe._regione_enabled is False and pipe.device.type == "cpu"
    args = parser.parse_args(["--backend", "qwen-image-edit", "--preset",
                              "tiny-qwen", "--device", "cpu",
                              "--guidance_scale", "3.0", "--use_regione"])
    pipe = tcli.build_pipeline(args)
    assert pipe.true_cfg_scale == 3.0 and pipe._regione_enabled is True
    assert parser.parse_args([]).device == "cuda"


@pytest.mark.parametrize("flags", [["--enable_thinking"],
                                   ["--enable_reflection"],
                                   ["--enable_thinking", "--enable_reflection",
                                    "--max_try_cnt", "2"]])
def test_thinker_flags_run_the_v1p2_loop(flags, tmp_path, monkeypatch):
    """--enable_thinking / --enable_reflection run demo mode through
    `edit_with_reflection` with the JAX CLI's EchoThinker: one try, and the
    PNG of the plain run."""
    from regione_tpu_torch.pipelines import thinker
    loops = []
    real = thinker.edit_with_reflection

    def recording(pipe, image, prompt, **kw):
        loops.append(kw)
        return real(pipe, image, prompt, **kw)

    monkeypatch.setattr(thinker, "edit_with_reflection", recording)
    src = _png(tmp_path / "in.png", shape=(40, 56, 3))
    args = FAST + ["--backend", "step1x-edit-v1p2", "--preset",
                   "tiny-step1x", "--image_path", str(src), "--prompt",
                   "add a hat", "--device", "cpu"]
    tcli.main(args + ["--output_dir", str(tmp_path / "plain")])
    assert loops == []
    tcli.main(args + flags + ["--output_dir", str(tmp_path / "think")])
    (kw,) = loops
    assert kw["enable_thinking"] == ("--enable_thinking" in flags)
    assert kw["enable_reflection"] == ("--enable_reflection" in flags)
    assert kw["max_try_cnt"] == (2 if "--max_try_cnt" in flags else 3)
    assert kw["seed"] == 110 and kw["width"] == kw["height"] == 32
    got = np.asarray(Image.open(tmp_path / "think" / "demo_0.png"))
    want = np.asarray(Image.open(tmp_path / "plain" / "demo_0.png"))
    assert got.shape == (32, 32, 3) and np.array_equal(got, want)


def test_reference_command_lines(tmp_path):
    """--image_path as a demo jsonl and as a dataset root, a free step count
    for the dense baseline, and the 28-step pin with --use_regione."""
    src = _png(tmp_path / "demo_in.png", shape=(64, 64, 3))
    with open(tmp_path / "data.jsonl", "w") as fh:
        fh.write(json.dumps({"key": str(tmp_path / "demo_in"),
                             "instruction": "demo edit"}) + "\n")
    base = ["--backend", "step1x-edit", "--preset", "tiny-step1x",
            "--device", "cpu", "--size_level", "32"]
    tcli.main(base + ["--num_inference_steps", "6", "--erosion_dilation",
                      "--image_path", str(tmp_path / "data.jsonl"),
                      "--output_dir", str(tmp_path / "out")])
    assert (tmp_path / "out" / "demo_0.png").exists()
    bench = _dataset(tmp_path / "ds", "reference")
    tcli.main(base + ["--evaluation", "--num_inference_steps", "6",
                      "--image_path", str(bench),
                      "--output_dir", str(tmp_path / "res")])
    assert (tmp_path / "res" / "TE" / "generation" / "k0.png").exists()
    with pytest.raises(SystemExit, match="28"):
        tcli.main(base + ["--use_regione", "--num_inference_steps", "12",
                          "--image_path", str(src), "--prompt", "x",
                          "--output_dir", str(tmp_path / "o2")])


def test_evaluation_fails_fast_without_a_dataset_root(tmp_path):
    with pytest.raises(SystemExit, match="dataset root"):
        tcli.main(["--evaluation", "--image_path",
                   str(tmp_path / "not_preprocessed"), "--output_dir",
                   str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="not a directory"):
        tcli.main(["--evaluation", "--eval_dir", str(tmp_path / "nope"),
                   "--output_dir", str(tmp_path / "o")])


def test_warmup_runs_on_the_first_item(monkeypatch, tmp_path):
    _png(tmp_path / "in.png", shape=(16, 16, 3))
    (tmp_path / "data.jsonl").write_text(json.dumps(
        {"key": str(tmp_path / "in"), "instruction": "demo edit"}) + "\n")
    calls = []

    class StubPipe:
        device = torch.device("cpu")

        def __call__(self, image, prompt, **kw):
            calls.append(prompt)
            return np.zeros((16, 16, 3), np.uint8), None

    monkeypatch.setattr(tcli, "build_pipeline", lambda args: StubPipe())
    tcli.main(["--num_warmup_runs", "2", "--image_path",
               str(tmp_path / "data.jsonl"), "--output_dir",
               str(tmp_path / "out")])
    assert calls == ["demo edit"] * 3


def test_print_plan(tmp_path, capsys):
    tcli.main(FAST + ["--preset", "tiny", "--device", "cpu", "--print_plan",
                      "--image_path", str(_png(tmp_path / "in.png")),
                      "--prompt", "x", "--output_dir", str(tmp_path / "o")])
    assert "partition" in capsys.readouterr().out.lower()


def _checkpoint(root, preset="tiny"):
    """A diffusers-layout directory (transformer/, vae/) of fp32 tensors
    whose values are bf16 numbers, so the JAX loader's bf16 cast keeps them
    and both CLIs run the same weights."""
    import jax
    from regione_tpu.models import vae as JV
    from regione_tpu.models.mmdit import init_mmdit
    from regione_tpu.models.presets import get_config
    from tests.test_convert import synth_state_from_params, synth_vae_state
    from tests.test_torch_convert import _write_shards

    def bf16_values(state):
        return {k: torch.from_numpy(np.array(v, np.float32)).bfloat16()
                .float().numpy() for k, v in state.items()}

    cfg = get_config(preset)
    _write_shards(root / "transformer", bf16_values(synth_state_from_params(
        init_mmdit(jax.random.PRNGKey(3), cfg), cfg)))
    vcfg = JV.VAEConfig(block_out_channels=(8, 16, 32, 64), norm_num_groups=8,
                        layers_per_block=1, latent_channels=2)
    _write_shards(root / "vae", synth_vae_state(
        JV.init_vae(jax.random.PRNGKey(4), vcfg)), n_shards=1)
    (root / "vae" / "config.json").write_text(json.dumps(
        {"latent_channels": 2, "block_out_channels": [8, 16, 32, 64],
         "layers_per_block": 1, "norm_num_groups": 8}))
    return root


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("flags,psnr_min", [
    ([], 50.0),
    (["--int8"], 50.0),
    (["--int4"], 50.0),
    (["--int8", "--act_int8"], 40.0),
    (["--int8", "--quantize_mods", "true"], 50.0),
    (["--int4", "--int4_mods", "false"], 50.0),
])
def test_ported_flags_match_the_jax_cli(flags, psnr_min, tmp_path,
                                        monkeypatch):
    """`--model_path` on a synthetic checkpoint, with each weight format:
    the port's demo image against the JAX CLI's, the JAX noise handed to the
    port.  Pixel PSNR >= 50 dB (fp32
    both sides; the uint8 rounding of a summation-order difference), >= 40
    dB under W8A8 (an activation code a summation-order difference moves
    across a rounding boundary).  int4 takes the tiny preset's narrow
    linears (_INT4_MIN_IN 0 in both packages)."""
    import jax
    import regione_tpu.ops.quant as jquant
    import regione_tpu_torch.ops.quant as tquant
    from regione_tpu_torch.pipelines.base import EditPipelineBase
    monkeypatch.setattr(jquant, "_INT4_MIN_IN", 0)
    monkeypatch.setattr(tquant, "_INT4_MIN_IN", 0)
    # the JAX package's noise (jax.random) through the port's seam
    monkeypatch.setattr(
        EditPipelineBase, "initial_latents",
        lambda self, seed, shape: torch.from_numpy(np.array(
            jax.random.normal(jax.random.PRNGKey(seed), shape))))
    ckpt = _checkpoint(tmp_path / "ckpt")
    # the input at the target size: the mock encoder hashes the resized
    # image, and the two host resizes may round a pixel apart
    src = _png(tmp_path / "in.png", shape=(64, 64, 3))
    args = ["--use_regione", "--size_level", "64", "--preset", "tiny",
            "--model_path", str(ckpt), "--image_path", str(src),
            "--prompt", "test edit"] + flags
    jcli.main(args + ["--output_dir", str(tmp_path / "jax")])
    tcli.main(args + ["--output_dir", str(tmp_path / "port"),
                      "--device", "cpu"])
    got = np.asarray(Image.open(tmp_path / "port" / "demo_0.png"))
    want = np.asarray(Image.open(tmp_path / "jax" / "demo_0.png"))
    assert got.shape == want.shape == (64, 64, 3)
    assert _psnr(want, got) >= psnr_min


def test_quantized_build_replaces_the_linears(tmp_path):
    from regione_tpu_torch.models.layers import Int4Linear, Int8Linear
    args = tcli.make_parser().parse_args(
        ["--preset", "tiny", "--device", "cpu", "--model_path",
         str(_checkpoint(tmp_path / "ckpt")), "--int8", "--act_int8"])
    pipe = tcli.build_pipeline(args)
    kinds = {type(m) for m in pipe.model.modules()}
    assert Int8Linear in kinds and Int4Linear not in kinds
    assert pipe.model.cfg.act_int8 and pipe.cfg.act_int8
    # W8A8 takes the modulations (quantize_mods defaults to true), never
    # final_mod
    assert isinstance(pipe.model.double_blocks[0].img_mod, Int8Linear)
    assert type(pipe.model.final_mod) is torch.nn.Linear


@pytest.mark.parametrize("flags,match", [
    (["--act_int8"], "requires --int8"),
    (["--int8", "--int4", "--act_int8"], "mutually exclusive"),
])
def test_invalid_weight_flags_exit_like_the_jax_cli(flags, match, tmp_path):
    common = ["--preset", "tiny", "--random_weights", "--image_path",
              str(_png(tmp_path / "in.png")), "--prompt", "x"] + flags
    with pytest.raises(SystemExit, match=match):
        jcli.main(common + ["--output_dir", str(tmp_path / "jax")])
    with pytest.raises(SystemExit, match=match):
        tcli.main(common + ["--output_dir", str(tmp_path / "port"),
                            "--device", "cpu"])
    assert not (tmp_path / "port").exists()
