"""The port's CLI (`regione_tpu_torch.cli.main`) on the CPU.

Demo and evaluation mode at the tiny presets with `--device cpu` and random
weights, beside the JAX package's CLI on the same inputs: the same output
files, image geometry and JSON schema (time_consuming.json, metadata.json).
Flags whose modules are not ported stop the run with their ROADMAP item;
the reference command-line forms (jsonl / dataset-root `--image_path`, the
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


@pytest.mark.parametrize("flag", [["--int8"], ["--int4"], ["--act_int8"],
                                  ["--quantize_mods", "true"],
                                  ["--int4_mods", "false"],
                                  ["--model_path", "ckpt"],
                                  ["--enable_thinking"],
                                  ["--enable_reflection"]])
def test_unported_flags_exit_with_their_roadmap_item(flag, tmp_path):
    with pytest.raises(SystemExit, match="not ported.*ROADMAP queue 1"):
        tcli.main(flag + ["--preset", "tiny", "--device", "cpu",
                          "--image_path", str(_png(tmp_path / "in.png")),
                          "--prompt", "x", "--output_dir",
                          str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


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
