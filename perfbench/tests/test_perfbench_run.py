"""Whole runs of the harness on the CPU at the tiny presets.

  * a run of each tiny cell is correct, its result line has the keys the
    contract names (the checks last), and the plain reference agrees with
    the port to fp32 rounding;
  * the control (the reference in the precision below the configuration's,
    bf16 for these fp32 presets) comes out not correct;
  * the timed path broken underneath comes out not correct, once for each
    fault the cells can have: a RAGS step that returns its rows unchanged,
    half of the CFG batch left out (Step1X), a token altered where the
    edit produces it;
  * the check for JAX and the JAX package compares top-level names whole;
  * on a card (marked `cuda`): a 10 s window of `step1x-edit.local-512`
    through the command itself.

    python -m pytest perfbench/tests -q
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import guard, harness  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
PATHS = harness.Paths(bench=DATA / "BENCHMARK.json", root=DATA,
                      mixes=DATA / "mixes", limits=DATA / "limits")
FLUX, STEP = "tiny-flux-kontext.tiny-local", "tiny-step1x-edit.tiny-local"
# a connector that widens its input (in 16, hidden 24), as Step1X-Edit's
WIDE = "tiny-step1x-wide.tiny-local"
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, system="program", seed=SEED):
    return harness.run_once(workload, seed, 0.0, False, time.perf_counter(),
                            paths=PATHS, device="cpu", system=system)


@pytest.mark.parametrize("workload", [FLUX, STEP, WIDE])
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    # no device peak off the card, so no peak_mem_gib
    assert set(r["metrics"]) == {"edit_s", "setup_s"}
    checks = r["checks"]
    assert checks["plan_diff"] == [0.0, 0]
    # the port's plain path and the reference, both fp32
    assert checks["latent_err"][0] < 1e-4
    assert checks["token_err"][0] < 1e-3
    edited = r["_info"]["edited"]
    assert sorted(edited) == [36, 49]      # the blocks' 6^2 and 7^2 cells


def test_result_line_keys(capsys):
    r = run(FLUX)
    harness.emit(r)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    last = err.strip().splitlines()[-3:]
    assert [ln.split()[2] for ln in last] == ["plan_diff", "latent_err",
                                              "token_err"]
    assert all(" limit " in ln for ln in last)


@pytest.mark.parametrize("workload", [FLUX, STEP])
def test_control_is_not_correct(workload):
    r = run(workload, system="control")
    assert not r["correct"]
    assert r["checks"]["latent_err"][0] > r["checks"]["latent_err"][1]


def _unchanged_rags_step(prog):
    """Every RAGS run returns the edited rows as it got them."""
    orig = prog.pipe.sampler_for

    def sampler_for(*a, **k):
        s = orig(*a, **k)
        s._rags_runs = lambda lat_act, avd_act, cache, *rest: (cache,
                                                               lat_act)
        return s
    prog.pipe.sampler_for = sampler_for


def _half_batch(prog):
    """Classifier-free guidance over one half: the uncond rows dropped,
    the cond half taken for both."""
    def combine(v, sigma):
        v = v.float()
        pos, _ = v.chunk(2, dim=0)
        return pos
    prog.pipe._combine = combine


def _altered_token(prog):
    orig = prog.pipe.edit_latents

    def edit_latents(*a, **k):
        out, st = orig(*a, **k)
        out = out.clone()
        out[:, 0] = out[:, 1]
        return out, st
    prog.pipe.edit_latents = edit_latents


@pytest.mark.parametrize("workload,fault", [
    (FLUX, _unchanged_rags_step), (STEP, _unchanged_rags_step),
    (STEP, _half_batch), (FLUX, _altered_token), (STEP, _altered_token)])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    class Broken(harness.Program):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            fault(self)
    monkeypatch.setattr(harness, "Program", Broken)
    r = run(workload)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("names,banned", [
    (["regione_tpu_torch", "regione_tpu_torch.ops", "torch"], []),
    (["regione_tpu.core.sampler", "torch"], ["regione_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "regione_tpu_x"], [])])
def test_guard_compares_top_level_names(names, banned):
    assert guard.banned_modules(names) == banned


def test_run_refuses_a_banned_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "regione_tpu.core", object())
    with pytest.raises(guard.Banned):
        run(FLUX)


@pytest.mark.cuda
def test_card_window_of_step1x_512():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "step1x-edit.local-512", "--seed", "2147483999", "--seconds", "10",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], res.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"edit_s", "peak_mem_gib",
                                    "setup_s"}
