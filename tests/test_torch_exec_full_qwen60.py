"""The port's `bench.exec_full_qwen60` against the JAX package's
`scripts/exec_full_qwen60.py`, on the same numpy params and draws:

  * on the CPU (fp32): the JAX script's `main()` run on `tiny-qwen-tp` with
    60 double blocks (the script asserts 60), grid 8, t_txt 8; its
    `init_quantized` params carried across (`weights.from_jax.
    convert_params`) to the port, alone (tp 1) and on two gloo CPU ranks
    (tp 2): the row's plan statistics and parameter count equal, its keys
    the script's first, the latents within 5e-4 (the tolerance of
    tests/test_torch_bench.py: 28 Euler steps at CFG 4 over 60 blocks in
    fp32, summation order only);
  * `cuda`: the published Qwen width cut to 4 blocks at grid 16, the x0
    probe's condition at threshold 0.8, on one card and over every card
    this process sees (at most 4, one NCCL rank each; skipped with fewer
    than 2): equal plan statistics, latent PSNR >= 40 dB (PERF.md section
    2's sharded-against-unsharded limit).
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from regione_tpu.models import presets as jpresets
from regione_tpu.ops import quant as jquant
from regione_tpu.pipelines import qwen_image_edit as jqwen
from regione_tpu_torch.bench import exec_full_qwen60
from regione_tpu_torch.weights.from_jax import convert_params
from torch_cpu import jax_schedule  # noqa: F401 (fixture)
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=5e-4, atol=5e-4)
PLAN_KEYS = ("dense_steps", "rags_steps", "reuse_steps", "edited_tokens",
             "seq_len", "capacity")


@pytest.fixture(scope="module")
def exec60_jax(tmp_path_factory):
    """The JAX script on the 60-block tiny Qwen: (row, latents, the port
    state dict of its params, saved)."""
    mp = pytest.MonkeyPatch()
    cfg60 = dataclasses.replace(jpresets.get_config("tiny-qwen-tp"),
                                depth_double=60)
    mp.setattr(jpresets, "get_config", lambda name: cfg60)
    seen = {}
    init = jquant.init_quantized

    def keep_params(*a, **kw):
        seen["params"] = init(*a, **kw)
        return seen["params"]

    edit = jqwen.QwenImageEditPipeline.edit_latents

    def keep_latents(self, *a, **kw):
        out = edit(self, *a, **kw)
        seen["lat"] = np.asarray(out[0])
        return out

    mp.setattr(jquant, "init_quantized", keep_params)
    mp.setattr(jqwen.QwenImageEditPipeline, "edit_latents", keep_latents)
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    mp.setattr(sys, "argv", ["exec_full_qwen60.py", "--grid", "8",
                             "--t-txt", "8"])
    try:
        with redirect_stdout(buf):
            runpy.run_path(str(REPO / "scripts" / "exec_full_qwen60.py"),
                           run_name="__main__")
    finally:
        mp.undo()
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    state, _ = convert_params(jax.tree.map(np.asarray, seen["params"]),
                              "cpu")
    path = tmp_path_factory.mktemp("exec60") / "params.pt"
    torch.save(state, path)
    return row, seen["lat"], path


def _port_argv(params, *extra):
    return ["--preset", "tiny-qwen-tp", "--blocks", "60", "--grid", "8",
            "--t-txt", "8", "--params", str(params), "--runs", "1",
            "--device", "cpu", *extra]


@pytest.mark.usefixtures("jax_schedule")
@pytest.mark.parametrize("tp", [1, 2])
def test_exec_full_qwen60_matches_the_jax_script(exec60_jax, tp, tmp_path,
                                                 capsys):
    want, want_lat, params = exec60_jax
    assert 0 < want["edited_tokens"] < want["seq_len"] == 64
    lat_path = tmp_path / "lat.npy"
    got = exec_full_qwen60.main(_port_argv(
        params, "--tp", str(tp), "--save-latents", str(lat_path)))
    for key in PLAN_KEYS:
        assert got[key] == want[key], key
    jkeys = list(want)
    assert list(got)[:len(jkeys)] == jkeys
    assert got["blocks"] == want["blocks"] == 60
    assert got["params"] == want["params"]
    assert got["mesh"] == (None if tp == 1 else {"dp": 1, "tp": 2})
    assert len(got["ranks"]) == tp
    np.testing.assert_allclose(np.load(lat_path), want_lat, **TOL)
    assert json.loads(capsys.readouterr().out.strip()) == got


@pytest.mark.cuda
def test_exec_full_qwen60_across_cards(tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs: one NCCL rank per card")
    n = min(torch.cuda.device_count(), 4)
    # the x0 probe at the Qwen threshold: a gap in the cosines at the
    # threshold, so the ranks' other bf16 sums move no token across it
    argv = ["--grid", "16", "--t-txt", "32", "--blocks", "4", "--probe",
            "--threshold", "0.8", "--runs", "1"]
    one = exec_full_qwen60.main(argv + ["--save-latents",
                                        str(tmp_path / "one.npy")])
    many = exec_full_qwen60.main(argv + ["--tp", str(n), "--compare-to",
                                         str(tmp_path / "one.npy")])
    for key in PLAN_KEYS:
        assert many[key] == one[key], key
    assert many["mesh"] == {"dp": 1, "tp": n} and len(many["ranks"]) == n
    assert many["psnr_vs"] >= 40.0
