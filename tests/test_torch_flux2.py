"""FLUX.2 [dev] in the port (backend `flux2-dev`), on the CPU, against the
benchmark's plain reference of it (`perfbench/reference/flux2.py`), which
is written from the model's description and imports nothing of the port.

  * the tiny edit (`perfbench/tests/data/configs/tiny-flux2-dev.json`, fp32,
    a 16 x 16 grid, two requests) through `PIPELINES["flux2-dev"]` and the
    port's `MMDiT` agrees with the reference's edit: the plan statistics
    exactly, the latents within the tiny cell's limits (fp32 on both sides:
    the fused chains' plain versions and the reference's expressions sum
    in other orders; about 5e-8 is read); the reference in bf16 (the
    control) does not;
  * one forward against the reference's, in dense, write (the cache rows
    too) and RAGS mode;
  * the port changed in each way the reference holds it to is not correct:
    GELU in place of the SwiGLU gate, FLUX.1's rotary ids (three axes
    padded, the reference at t = 1, text at 0), the reference at t = 1,
    text ids without the l axis, FLUX.1's mu;
  * the published preset counts 32,223,281,152 parameters on the meta
    device, its state-dict keys and shapes are the reference's `layout`
    (a bias in any linear, or a modulation linear in a block, breaks
    that), and FLUX.1's block at its widths (`flux2_block` off) changes
    them;
  * the schedule (mu 2.1514 at 4096 noise tokens and 28 steps), the
    rotary ids and the knobs against the reference's and the file's.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from regione_tpu_torch.core.config import DEFAULT_PARAMS
from regione_tpu_torch.core.gamma import gamma_for
from regione_tpu_torch.core.schedule import FLUX2_SHIFT, FLUX_SHIFT
from regione_tpu_torch.models import kv_cache
from regione_tpu_torch.models import mmdit
from regione_tpu_torch.models.layers import gather_rope, rope_table
from regione_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.ops import fused
from regione_tpu_torch.pipelines import PIPELINES
from regione_tpu_torch.pipelines import flux2 as port_flux2
from regione_tpu_torch.pipelines.base import EditPipelineBase
from regione_tpu_torch.pipelines.flux2 import Flux2Pipeline
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import harness, inputs  # noqa: E402
from perfbench.reference import flux2  # noqa: E402
from perfbench.reference import model as M  # noqa: E402
from perfbench.reference import plan as P  # noqa: E402

DATA = ROOT / "perfbench" / "tests" / "data"
TINY = json.loads((DATA / "configs" / "tiny-flux2-dev.json").read_text())
MIX = json.loads((DATA / "mixes" / "tiny-local.json").read_text())
LIMITS = json.loads((DATA / "limits" / "tiny-flux2-dev.tiny-local.json")
                    .read_text())
FULL = json.loads((ROOT / "perfbench" / "configs" / "flux2-dev.json")
                  .read_text())
SEED = 2**31 + 2026


def edit_checks(control: bool = False, seed: int = SEED):
    """The tiny cell as a benchmark run computes it, with no window: the
    weights and requests from the seed, the condition latents by the
    probe, each request edited by the port (`harness.Program`) or by the
    control, then judged against the reference's edit over the weights
    drawn again.  Returns (checks, failed edits, correct)."""
    grid = MIX["grid"]
    lay = flux2.layout(TINY)
    gen = harness.generator("cpu", seed)
    weights = inputs.make_weights(TINY, gen, "cpu", lay)
    reqs = inputs.make_requests(TINY, MIX, seed, gen, "cpu")
    probe = flux2.Reference(TINY, weights, grid, "cpu")
    for r in reqs:
        inputs.probe(probe, r, MIX["probe_iters"])
    sut = harness.Control(TINY, weights, grid, "cpu", flux2) if control \
        else harness.Program(TINY, weights, grid, "cpu")
    outs, edits = [], []
    with torch.inference_mode():
        for r in reqs:
            out, stats = sut.edit(r)
            outs.append(out)
            edits.append({"request": r.index, "stats": stats})
    readings, _ = harness.reference_readings(flux2, lay, TINY, grid, "cpu",
                                             seed, reqs, outs, edits)
    return harness.judge(readings, LIMITS)


def test_the_tiny_edit_agrees_with_the_reference():
    checks, failed, ok = edit_checks()
    assert ok and failed == 0
    assert checks["plan_diff"] == [0.0, 0]
    assert checks["latent_err"][0] < 1e-6
    assert checks["token_err"][0] < 1e-5


def test_the_control_is_not_correct():
    assert not edit_checks(control=True)[2]


def _gelu_gate(attn, h):
    """GELU of the first half in place of silu(a) * b."""
    return fused.gelu_pack(attn, h[..., :h.shape[-1] // 2])


def _flux1_ids(self, grid_h, grid_w, t_txt, cond_grids=None):
    img, txt = EditPipelineBase.rope_position_ids(self, grid_h, grid_w,
                                                  t_txt, cond_grids)
    pad = lambda a: np.concatenate([a, np.zeros((len(a), 1), a.dtype)], 1)
    return pad(img), pad(txt)


_FLUX2_IDS = Flux2Pipeline.rope_position_ids


def _text_at_zero(self, *args, **kw):
    img, txt = _FLUX2_IDS(self, *args, **kw)
    return img, np.zeros_like(txt)


# a change of the program, and what it changes
FAULTS = {
    "gelu_for_swiglu": (mmdit, "swiglu_pack", _gelu_gate),
    "flux1_rotary_ids": (Flux2Pipeline, "rope_position_ids", _flux1_ids),
    "reference_at_t1": (port_flux2, "REF_T0", 1.0),
    "text_ids_without_l": (Flux2Pipeline, "rope_position_ids",
                           _text_at_zero),
    "flux1_mu": (Flux2Pipeline, "flow_shift", FLUX_SHIFT),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_changed_program_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(*FAULTS[fault])
    checks, failed, ok = edit_checks()
    assert not ok and failed >= 1


# -- one forward --------------------------------------------------------------

GRID, T_TXT = 4, 5


def _forward_inputs():
    m = TINY["model"]
    gen = torch.Generator().manual_seed(3)
    lay = flux2.layout(TINY)
    weights = inputs.make_weights(TINY, gen, "cpu", lay)
    s_kv = 2 * GRID * GRID
    img = torch.randn((1, s_kv, m["in_channels"]), generator=gen)
    txt = torch.randn((1, T_TXT, m["txt_in_dim"]), generator=gen)
    cfg = dict(m, axes_dims=tuple(m["axes_dims"]))
    cfg.pop("connector")
    model = MMDiT(MMDiTConfig(**cfg, dtype=torch.float32), "meta")
    model.load_state_dict(weights, strict=True, assign=True)
    ids_img, ids_txt = flux2.rotary_ids(GRID, T_TXT, "cpu")
    axes, theta = m["axes_dims"], m["rope_theta"]
    return (weights, model, img, txt, rope_table(ids_img, axes, theta),
            rope_table(ids_txt, axes, theta))


@pytest.mark.parametrize("mode", ["dense", "write", "rags"])
def test_one_forward_is_the_references(mode):
    """The port's forward and the reference's on the same fp32 weights:
    the velocity (RAGS: of the edited rows, one pad slot besides, against
    the stored K / V the write forward left) and the written cache."""
    weights, model, img, txt, rope_img, rope_txt = _forward_inputs()
    m, lin = TINY["model"], M.Linear(weights)
    t = torch.tensor([0.63])
    g = torch.tensor([4.0])
    s_kv = img.shape[1]
    store = {}
    with torch.no_grad():
        want = flux2.forward(lin, m, img, txt, t, rope_img, rope_txt, g,
                             mode="write" if mode == "rags" else mode,
                             store=store)
        got, cache = model(img, txt, t, rope_img, rope_txt, guidance=g,
                           mode="write" if mode == "rags" else mode)
        if mode == "rags":
            edited = torch.tensor([1, 6, 7, 12])
            stale = torch.zeros(s_kv, dtype=torch.bool)
            stale[edited] = True
            keep = torch.nonzero(~stale).reshape(-1)
            rows = img[:, edited] + 0.5
            want = flux2.forward(lin, m, rows, txt, t,
                                 tuple(x[edited] for x in rope_img),
                                 rope_txt, g, mode="rags", store=store,
                                 keep=keep)
            ids = torch.cat([edited, torch.tensor([s_kv])])
            got, _ = model(torch.cat([rows, torch.zeros_like(rows[:, :1])],
                                     1), txt, t, gather_rope(rope_img, ids),
                           rope_txt, guidance=g, mode="rags", cache=cache,
                           sel_img_ids=ids)
            got = got[:, :len(edited)]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if mode != "write":
        return
    assert kv_cache.cache_format(model.cfg) == "int8"

    def values(codes, scales):
        return codes.float() * scales.reshape(*codes.shape[:-1], 1)
    for kind, depth, keys in (("double", m["depth_double"], ("dk", "dv")),
                              ("single", m["depth_single"], ("sk", "sv"))):
        for i in range(depth):
            for j, key in enumerate(keys):
                torch.testing.assert_close(
                    values(*kv_cache.layer_kv(cache, key, i)),
                    values(*store[f"{kind}_blocks.{i}."][j]), rtol=0,
                    atol=1e-5)


def test_the_reference_cache_is_the_ports_int8_cache():
    """Codes and scales of `ops.quant.quantize_kv_heads`, and the values of
    the Qwen reference's round trip."""
    from perfbench.reference import qwen_image
    from regione_tpu_torch.ops import quant
    x = torch.randn(1, 3, 40, 16, generator=torch.Generator().manual_seed(7))
    x[0, 1, 5] = 0.0
    codes, scales = flux2.int8_codes(x)
    rows, want_scales = quant.quantize_kv_heads(x)
    assert codes.dtype == torch.int8 and torch.equal(codes, rows)
    assert torch.equal(scales[..., 0], want_scales)
    assert torch.equal(codes.float() * scales, qwen_image.int8_round_trip(x))


def test_the_forward_computes_the_modulation_once(monkeypatch):
    """Three modulation products a forward, in the `model.modulation` span
    inside `model.embed`; the blocks hold no modulation linear."""
    from regione_tpu_torch.utils import telemetry
    _, model, img, txt, rope_img, rope_txt = _forward_inputs()
    assert not any(n.endswith("mod") for n, _ in
                   model.double_blocks.named_modules())
    assert not any(n.endswith("mod") for n, _ in
                   model.single_blocks.named_modules())
    calls = []
    chunk = mmdit._modulation
    monkeypatch.setattr(mmdit, "_modulation", lambda lin, x, n: calls.append(
        n) or chunk(lin, x, n))
    telemetry.clear()
    with telemetry.recording(), torch.no_grad():
        model(img, txt, torch.tensor([0.5]), rope_img, rope_txt,
              guidance=torch.tensor([4.0]))
    assert calls == [6, 6, 3, 2]          # img, txt, single; the final layer
    spans = {s.name: s for s in telemetry.spans()}
    assert spans["model.modulation"].parent == spans["model.embed"].id
    telemetry.clear()


# -- the published configuration ----------------------------------------------

def test_the_published_preset_counts_its_parameters_and_keys():
    cfg = get_config("flux2-dev")
    model = MMDiT(cfg, "meta")
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    lay = flux2.layout(FULL)
    assert {n: tuple(s) for n, s, _, _ in lay} == want
    assert sum(int(np.prod(s)) for _, s, _, _ in lay) == \
        sum(int(np.prod(s)) for s in want.values()) == FULL["parameters"] \
        == 32_223_281_152
    m = dict(FULL["model"], axes_dims=tuple(FULL["model"]["axes_dims"]))
    assert m.pop("connector") is None
    # the file runs the preset with the int8 cache (not part of a preset)
    assert MMDiTConfig(**m) == kv_cache.with_cache_format(cfg, "int8")


def test_the_flux1_block_changes_the_layout():
    """FLUX.1's block (GELU MLP, modulation a block, biases) at FLUX.2's
    widths: the published weights no longer load (strict), so it cannot
    pass as FLUX.2."""
    cfg = dataclasses.replace(get_config("tiny-flux2"), flux2_block=False)
    got = {n: tuple(p.shape) for n, p in MMDiT(cfg, "meta").named_parameters()}
    lay = {n: tuple(s) for n, s, _, _ in flux2.layout(TINY)}
    assert got != lay


def test_the_file_runs_the_published_values():
    pub, m = FULL["published"], FULL["model"]
    assert (m["depth_double"], m["depth_single"], m["heads"], m["head_dim"],
            m["in_channels"], m["txt_in_dim"], m["axes_dims"],
            m["rope_theta"], m["mlp_ratio"], m["time_embed_dim"]) == (
        pub["num_layers"], pub["num_single_layers"],
        pub["num_attention_heads"], pub["attention_head_dim"],
        pub["in_channels"], pub["joint_attention_dim"],
        pub["axes_dims_rope"], pub["rope_theta"], pub["mlp_ratio"],
        pub["timestep_guidance_channels"])
    assert m["hidden"] == m["heads"] * m["head_dim"] == 6144
    assert m["flux2_block"] is True
    assert FULL["reduced"] == [] and FULL["reference"] == "flux2"
    assert FULL["guidance"]["distilled_scale"] == \
        FULL["pipeline_args"]["guidance_scale"] == 4.0
    re = DEFAULT_PARAMS["flux2-dev"]
    assert re == DEFAULT_PARAMS["flux-kontext"]
    assert P.Knobs.of(FULL["regione"]) == P.Knobs.of(
        {k: getattr(re, k) for k in FULL["regione"]})
    assert np.array_equal(np.asarray(FULL["gamma"], np.float16),
                          gamma_for("flux2-dev"))
    assert np.array_equal(gamma_for("flux2-dev"), gamma_for("flux-kontext"))
    assert PIPELINES["flux2-dev"] is Flux2Pipeline


@pytest.mark.parametrize("grid", [16, 32, 64, 66, 96])
def test_the_schedule_is_the_references(grid):
    sched = FULL["schedule"]
    sig = flux2.sigmas(28, grid * grid, sched)
    assert np.array_equal(sig, FLUX2_SHIFT.sigmas(28, grid * grid))
    assert FLUX2_SHIFT.mu(28, grid * grid) == pytest.approx(
        flux2.empirical_mu(28, grid * grid, sched), rel=1e-12)
    assert not np.array_equal(sig, FLUX_SHIFT.sigmas(28, grid * grid))


def test_the_published_mu():
    """2.1514 at 4096 noise tokens and 28 steps; past 4300 tokens the
    200-step line alone."""
    assert FLUX2_SHIFT.mu(28, 4096) == pytest.approx(2.15144, abs=1e-5)
    assert FLUX2_SHIFT.mu(28, 4356) == pytest.approx(
        0.00016927 * 4356 + 0.45666666)
    sig = FLUX2_SHIFT.sigmas(28, 4096)
    assert sig[0] == 1.0 and sig[-1] == 0.0 and len(sig) == 29


@pytest.mark.parametrize("grid,t_txt", [(4, 5), (9, 3), (64, 512)])
def test_the_rotary_ids_are_the_references(grid, t_txt):
    img, txt = flux2.rotary_ids(grid, t_txt, "cpu")
    pipe = Flux2Pipeline.__new__(Flux2Pipeline)
    want_img, want_txt = pipe.rope_position_ids(grid, grid, t_txt)
    assert np.array_equal(img.numpy(), want_img)
    assert np.array_equal(txt.numpy(), want_txt)
    s = grid * grid
    assert set(want_img[s:, 0]) == {10.0} and set(want_img[:s, 0]) == {0.0}
    assert (want_img[:, 3] == 0).all() and (want_txt[:, :3] == 0).all()
    assert list(want_txt[:, 3]) == list(range(t_txt))


def test_a_second_reference_takes_t_20():
    pipe = Flux2Pipeline.__new__(Flux2Pipeline)
    img, _ = pipe.rope_position_ids(2, 3, 1, cond_grids=[(2, 3), (1, 2)])
    assert list(img[:, 0]) == [0.0] * 6 + [10.0] * 6 + [20.0] * 2


def test_the_image_path_names_what_is_missing():
    model = MMDiT(get_config("tiny-flux2"), "cpu")
    pipe = Flux2Pipeline(model, DEFAULT_PARAMS["flux2-dev"])
    with pytest.raises(NotImplementedError, match="VAE.*Mistral"):
        pipe(np.zeros((32, 32, 3), np.uint8), "x")
