"""Qwen-Image-Edit in the benchmark, on the CPU: its configuration, its
plain reference (`reference/qwen_image.py`) and `pipeline.cache_write_ms`.

  * the tiny cell (the `tiny-qwen` widths, an int8 cache) is correct
    against the reference, and not correct with the program changed in
    each way the reference holds it to: FLUX.1's schedule, FLUX.1's rotary
    ids, no text RMSNorm, the plain CFG combine;
  * the reference's int8 round trip of the stored K / V reads closer to
    the program than a store without it;
  * the reference's sigmas, plan and rotary ids are the port's Qwen
    pipeline's, written independently;
  * the published configuration: the port's MMDiT from its file at full
    width (on the meta device), its parameter count, and each published
    value of the source's two config files in the group that runs it;
  * `pipeline.cache_write_ms` reads None with no spans and the sum over
    the edits on a recorder filled by hand.

    python -m pytest perfbench/tests -q
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, inputs  # noqa: E402
from perfbench.reference import plan as P  # noqa: E402
from perfbench.reference import qwen_image  # noqa: E402
from regione_tpu_torch.core.schedule import FLUX_SHIFT  # noqa: E402
from regione_tpu_torch.models import mmdit  # noqa: E402
from regione_tpu_torch.pipelines.base import EditPipelineBase  # noqa: E402
from regione_tpu_torch.pipelines.qwen_image_edit import (  # noqa: E402
    QwenImageEditPipeline)
from regione_tpu_torch.utils import telemetry  # noqa: E402

PB = ROOT / "perfbench"
DATA = Path(__file__).resolve().parent / "data"
CONF = "tiny-qwen-image-edit"
CELL = f"{CONF}.tiny-local"
SEED = 2**31 + 91
QWEN = json.loads((PB / "configs" / "qwen-image-edit.json").read_text())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The tests' benchmark with the tiny Qwen configuration and cell
    added (the file under data/ is left as it is)."""
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONF, "source": "tiny",
                             "file": f"configs/{CONF}.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": CONF,
                               "traffic": "tiny-local", "chips": 1,
                               "why": "CPU tests"})
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return harness.Paths(bench=path, root=DATA, mixes=DATA / "mixes",
                         limits=DATA / "limits")


def run(paths, system="program"):
    return harness.run_once(CELL, SEED, 0.0, False, time.perf_counter(),
                            paths=paths, device="cpu", system=system)


def test_the_tiny_cell_is_correct(paths):
    r = run(paths)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert r["checks"]["plan_diff"] == [0.0, 0]
    assert r["checks"]["latent_err"][0] < 1e-6


def test_the_control_is_not_correct(paths):
    assert not run(paths, "control")["correct"]


# a change of the program, and what it changes
FAULTS = {
    "flux_schedule": (QwenImageEditPipeline, "flow_shift", FLUX_SHIFT),
    "flux_rotary_ids": (QwenImageEditPipeline, "rope_position_ids",
                        EditPipelineBase.rope_position_ids),
    "no_txt_norm": (mmdit, "rmsnorm", lambda x, scale: x),
    "plain_cfg_combine": (QwenImageEditPipeline, "combine_cfg",
                          EditPipelineBase.combine_cfg),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_changed_program_is_not_correct(paths, fault, monkeypatch):
    monkeypatch.setattr(*FAULTS[fault])
    r = run(paths)
    assert not r["correct"] and r["failed"] >= 1


def test_the_int8_round_trip_reads_closer_to_the_program(paths,
                                                         monkeypatch):
    """The program's K2q reads the int8 cache: the reference that stores
    through the same round trip is nearer, by every reading, than one that
    keeps its K / V in the model dtype."""
    with_trip = run(paths)["checks"]
    monkeypatch.setattr(qwen_image, "int8_round_trip", lambda x: x)
    without = run(paths)["checks"]
    for name in ("latent_err", "token_err"):
        assert 10 * with_trip[name][0] < without[name][0], name
    assert not without["latent_err"][0] <= without["latent_err"][1]


def test_the_round_trip_is_the_ports_cache():
    """Codes and scales of `ops.quant.quantize_kv_heads`, dequantized."""
    from regione_tpu_torch.ops import quant
    x = torch.randn(2, 3, 40, 16, generator=torch.Generator().manual_seed(5))
    x[0, 0, 3] = 0.0
    rows, scales = quant.quantize_kv_heads(x)
    want = quant.dequantize_kv_heads(rows, scales, torch.float32)
    assert torch.equal(qwen_image.int8_round_trip(x), want)


@pytest.mark.parametrize("grid", [16, 32, 48, 64, 96])
def test_the_reference_plan_is_the_ports(grid):
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.core.schedule import build_stage_plan
    sig = qwen_image.sigmas(28, grid * grid, QWEN["schedule"])
    port = QwenImageEditPipeline.flow_shift.sigmas(28, grid * grid)
    assert np.array_equal(sig, port)
    mine = P.build_plan(P.Knobs.of(QWEN["regione"]), sig, QWEN["gamma"])
    theirs = build_stage_plan(RegionEParams(**QWEN["regione"]), port,
                              np.asarray(QWEN["gamma"], np.float16))
    assert [(s.sigma, s.dense, s.role, s.dt, s.dt_jump, s.dt_final, s.reuse,
             s.ratio) for s in mine] == \
        [(s.sigma, s.dense, s.sched_role, s.dt, s.dt_jump, s.dt_final,
          s.reuse, s.ratio) for s in theirs]


@pytest.mark.parametrize("grid,t_txt", [(8, 4), (9, 3), (64, 1392)])
def test_the_reference_rotary_ids_are_the_ports(grid, t_txt):
    img, txt = qwen_image.rotary_ids(grid, t_txt, "cpu")
    pipe = QwenImageEditPipeline.__new__(QwenImageEditPipeline)
    want_img, want_txt = pipe.rope_position_ids(grid, grid, t_txt)
    assert np.array_equal(img.numpy(), want_img)
    assert np.array_equal(txt.numpy(), want_txt)
    assert img[:, 1].min() < 0 and txt[0, 0] == grid // 2


def test_the_configuration_builds_the_port_at_full_width():
    from regione_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    m = dict(QWEN["model"])
    assert m.pop("connector") is None
    m["axes_dims"] = tuple(m["axes_dims"])
    model = MMDiT(MMDiTConfig(**m), "meta")
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    lay = qwen_image.layout(QWEN)
    assert {n: tuple(s) for n, s, _, _ in lay} == want
    assert sum(int(np.prod(s)) for _, s, _, _ in lay) == \
        QWEN["parameters"] == 20_430_401_088
    # the default layout lacks the text RMSNorm's scale
    assert len(inputs.layout(QWEN)) == len(lay) - 1


# each published key (the source's own names) and where the file runs it
PUBLISHED = {
    "num_layers": "model.depth_double", "attention_head_dim":
    "model.head_dim", "num_attention_heads": "model.heads",
    "in_channels": "model.in_channels", "joint_attention_dim":
    "model.txt_in_dim", "guidance_embeds": "model.guidance_embed",
    "axes_dims_rope": "model.axes_dims", "base_image_seq_len":
    "schedule.base_image_seq_len", "max_image_seq_len":
    "schedule.max_image_seq_len", "base_shift": "schedule.base_shift",
    "max_shift": "schedule.max_shift", "shift_terminal":
    "schedule.shift_terminal"}


def test_the_configuration_runs_the_published_values():
    m = QWEN["model"]
    pub = QWEN["published"]
    for key, where in PUBLISHED.items():
        got = QWEN
        for part in where.split("."):
            got = got[part]
        assert got == pub[key], key
    # packed 2 x 2 patches: 16 latent channels out, 64 in and out per token
    assert pub["patch_size"] ** 2 * pub["out_channels"] == \
        m["out_channels"] == m["in_channels"]
    assert m["hidden"] == m["heads"] * m["head_dim"]
    assert (pub["use_dynamic_shifting"], pub["time_shift_type"]) == \
        (True, "exponential")
    assert m["depth_single"] == m["pooled_dim"] == 0 and m["txt_norm"]
    assert QWEN["reduced"] == [] and QWEN["reference"] == "qwen_image"
    assert QWEN["pipeline_args"]["true_cfg_scale"] == \
        QWEN["guidance"]["true_cfg_scale"] == 4.0
    from regione_tpu_torch.core.gamma import gamma_for
    assert np.array_equal(np.asarray(QWEN["gamma"], np.float16),
                          gamma_for("qwen-image-edit"))


def test_the_published_schedule():
    """mu 0.6935 at 4096 noise tokens (FLUX.1's would be 1.15), the last
    sigma before the terminal 0 stretched to 0.02."""
    sig = qwen_image.sigmas(28, 4096, QWEN["schedule"])
    mu = P.calculate_shift(4096, 256, 8192, 0.5, 0.9)
    assert mu == pytest.approx(0.69355, abs=1e-5)
    assert sig[0] == 1.0 and sig[-2] == np.float32(0.02) and sig[-1] == 0.0
    assert not np.array_equal(sig, P.sigmas(28, 4096))


# -- pipeline.cache_write_ms -------------------------------------------------

class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _read(n_edits):
    run = harness.RunRecord(config=QWEN, mix={}, grid=64,
                            edits=[{"request": i} for i in range(n_edits)],
                            window_s=1.0, setup_s=1.0, peak_window_bytes=0,
                            spans=[], trace=None, groups=[])
    return harness.load_reader(
        PB / "metrics" / "pipeline.cache_write_ms.py")(run)


def _fill(edits):
    """One `pipeline.edit` span per entry of `edits`, each a list of the
    device ms of its `model.cache_write` spans, set by hand."""
    with telemetry.recording():
        for writes in edits:
            with telemetry.span("pipeline.edit", edit=True):
                for i, ms in enumerate(writes):
                    with telemetry.span("model.double_block", index=i):
                        with telemetry.span("model.cache_write", index=i,
                                            key="dk") as s:
                            pass
                    s._events = (_Event(0.0), _Event(ms), None)


@pytest.fixture
def empty_recorder():
    telemetry.clear()
    yield
    telemetry.clear()


def test_cache_write_ms_finds_nothing_and_returns_none(empty_recorder):
    assert _read(2) is None                      # an empty recorder
    _fill([[]])
    assert _read(1) is None                      # an edit with no write
    telemetry.clear()
    _fill([[0.5]])
    assert _read(0) is None                      # no edits
    assert _read(2) is None                      # 1 edit span, 2 edits
    with telemetry.recording():                  # a write with no events
        with telemetry.span("model.cache_write"):
            pass
    assert _read(1) is None


def test_cache_write_ms_on_a_recorder_filled_by_hand(empty_recorder):
    _fill([[0.25, 0.5, 1.0], [0.75] * 4])
    assert _read(2) == pytest.approx((0.25 + 0.5 + 1.0 + 4 * 0.75) / 2)
