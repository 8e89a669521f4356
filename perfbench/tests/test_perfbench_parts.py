"""The harness's parts on the CPU: discovery by file name, the seeded
inputs, the weight layout against the port's parameters, the operation and
byte counts, and the device-trace reduction.

    python -m pytest perfbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import devtrace, harness, inputs, work  # noqa: E402

PB = ROOT / "perfbench"
DATA = Path(__file__).resolve().parent / "data"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(name="tiny-flux-kontext"):
    return json.loads((DATA / "configs" / f"{name}.json").read_text())


# -- discovery ---------------------------------------------------------------

def test_every_name_in_the_benchmark_has_its_file():
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"].startswith(c["source"])
    for w in BENCH["workloads"]:
        assert w["config"] in names
        assert (PB / "mixes" / f"{w['traffic']}.json").is_file()
        limits = json.loads((PB / "limits" / f"{w['name']}.json").read_text())
        assert set(limits) == {"plan_diff", "latent_err", "token_err"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert (PB / "end_to_end" / f"{m['name']}.py").is_file()
    for cell in cells:       # setup_s, one more, a per-layer metric each
        assert cell in e2e["setup_s"]
        assert sum(cell in ws for ws in e2e.values()) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        # every cell it is read in reports the metric it moves
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]])


def test_a_new_cell_metric_and_kernel_group_are_files(tmp_path):
    """A configuration, a mix, a limits file, a per-layer metric and a
    kernel group added as new files are found by name, no file edited."""
    pb = tmp_path / "perfbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns("tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = tiny()
    conf["name"] = "tiny-new"
    (pb / "configs" / "tiny-new.json").write_text(json.dumps(conf))
    mix = json.loads((DATA / "mixes" / "tiny-local.json").read_text())
    (pb / "mixes" / "tiny-new-mix.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny-new.tiny-new-mix.json").write_text(json.dumps(
        {"plan_diff": 0, "latent_err": 1e-4, "token_err": 1e-3}))
    (pb / "metrics" / "sampler.edits_seen.py").write_text(
        "def read(run):\n    return float(len(run.edits))\n")
    (pb / "kernel_groups" / "newkernel.json").write_text(json.dumps(
        {"group": "attention", "priority": 5, "patterns": ["my_new_attn"]}))
    bench["configs"].append({"name": "tiny-new", "source": "tiny",
                             "file": "perfbench/configs/tiny-new.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-new.tiny-new-mix",
                               "config": "tiny-new",
                               "traffic": "tiny-new-mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "sampler.edits_seen", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "sampler", "moves": "edit_s",
                               "workloads": ["tiny-new.tiny-new-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    paths = harness.Paths(bench=tmp_path / "BENCHMARK.json", root=tmp_path,
                          mixes=pb / "mixes", limits=pb / "limits",
                          metrics=pb / "metrics",
                          end_to_end=pb / "end_to_end",
                          groups=pb / "kernel_groups")
    cell = harness.load_cell(paths, "tiny-new.tiny-new-mix")
    assert cell["config"]["name"] == "tiny-new"
    assert [m["name"] for k, m in cell["metrics"] if k == "per_layer"] == \
        ["sampler.edits_seen"]
    read = harness.load_reader(pb / "metrics" / "sampler.edits_seen.py")
    assert read(type("R", (), {"edits": [1, 2]})()) == 2.0
    groups = devtrace.load_groups(pb / "kernel_groups")
    assert devtrace.group_of("my_new_attn_kernel<4>", groups) == "attention"
    assert devtrace.group_of("nvjet_tst_128x256", groups) == "gemm"


# -- inputs ----------------------------------------------------------------

def _requests(seed, name="tiny-step1x-edit"):
    conf = tiny(name)
    mix = json.loads((DATA / "mixes" / "tiny-local.json").read_text())
    gen = harness.generator("cpu", seed)
    w = inputs.make_weights(conf, gen, "cpu")
    return w, inputs.make_requests(conf, mix, seed, gen, "cpu")


def test_requests_repeat_for_a_seed_and_differ_across_seeds():
    seed = 2**31 + 5
    w1, r1 = _requests(seed)
    w2, r2 = _requests(seed)
    _, r3 = _requests(seed + 1)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    for a, b in zip(r1, r2):
        assert a.index == b.index and (a.block == b.block).all()
        for f in ("noise", "txt", "cond0", "fill"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(r1[0].noise, r3[0].noise) or \
        not torch.equal(r1[0].txt, r3[0].txt)
    assert sorted(r.side for r in r1) == sorted(r.side for r in r3)


@pytest.mark.parametrize("preset,name", [
    ("tiny-flux", "tiny-flux-kontext"), ("tiny-step1x", "tiny-step1x-edit")])
def test_weight_layout_is_the_ports_parameters(preset, name):
    """The tiny configs' layout against the port's tiny presets (so the
    tiny configs are those presets), on the CPU."""
    from regione_tpu_torch.models.mmdit import MMDiT
    from regione_tpu_torch.models.presets import get_config
    model = MMDiT(get_config(preset), "meta")
    got = [(n, tuple(s)) for n, s, _, _ in inputs.layout(tiny(name))]
    want = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("name", ["flux-kontext", "step1x-edit"])
def test_published_configs_build_the_port_at_full_width(name):
    """The published configs' layout against the port's MMDiT built from
    the same file on the meta device (no memory), and the parameter count
    the file states."""
    from regione_tpu_torch.models.connector import ConnectorConfig
    from regione_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    conf = json.loads((PB / "configs" / f"{name}.json").read_text())
    m = dict(conf["model"])
    c = m.pop("connector")
    m["axes_dims"] = tuple(m["axes_dims"])
    model = MMDiT(MMDiTConfig(**m, connector=c and ConnectorConfig(**c)),
                  "meta")
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = {n: tuple(s) for n, s, _, _ in inputs.layout(conf)}
    assert got == want
    assert inputs.param_count(conf) == conf["parameters"]


# each key of a configuration's `published` block (the source's own names)
# and where the file's `model` group holds it
PUBLISHED_KEYS = {
    "attention_head_dim": "head_dim", "head_dim": "head_dim",
    "num_attention_heads": "heads", "num_heads": "heads",
    "hidden_size": "hidden", "num_layers": "depth_double",
    "depth": "depth_double", "num_single_layers": "depth_single",
    "depth_single_blocks": "depth_single", "in_channels": "in_channels",
    "joint_attention_dim": "txt_in_dim", "context_in_dim": "txt_in_dim",
    "pooled_projection_dim": "pooled_dim", "vec_in_dim": "pooled_dim",
    "guidance_embeds": "guidance_embed", "axes_dims_rope": "axes_dims",
    "axes_dim": "axes_dims", "patch_size": None,
    "connector_in_dim": "connector.in_dim",
    "connector_hidden": "connector.hidden",
    "connector_heads": "connector.heads",
    "connector_depth": "connector.depth"}


@pytest.mark.parametrize("name", ["flux-kontext", "step1x-edit"])
def test_configs_run_the_sources_published_widths(name):
    """Every width and depth that the source publishes (the file's
    `published` block, in the source's names) is the one the file runs:
    the model group against the source, not against the port."""
    conf = json.loads((PB / "configs" / f"{name}.json").read_text())
    m = conf["model"]
    assert m["hidden"] == m["heads"] * m["head_dim"]
    for key, want in conf["published"].items():
        assert key in PUBLISHED_KEYS, key
        where = PUBLISHED_KEYS[key]
        if where is None:                   # FLUX's patch size 1
            assert want == 1
            continue
        got = m
        for part in where.split("."):
            got = got[part]
        assert got == want, (key, got, want)
    assert conf["reduced"] == []


# -- operations and bytes --------------------------------------------------

def test_gemm_and_attention_counts_by_hand():
    assert work.gemm_work(4, 6, 8) == (2 * 4 * 6 * 8,
                                       2 * (4 * 8 + 8 * 6 + 4 * 6 + 6))
    # q [2, 3, 5, 128] over 7 keys: QK^T and PV
    assert work.attention_work(2, 3, 5, 7, 128) == (
        2 * (2 * 3 * 5 * 7 * 128) * 2,
        2 * (2 * 2 * 3 * 5 * 128 + 2 * 2 * 3 * 7 * 128))
    assert work.bound_s(989e12, 0.0) == 1.0
    assert work.bound_s(0.0, 3.35e12) == 1.0


def test_forward_items_of_one_small_shape_by_hand():
    """tiny-flux (hidden 32, 2 heads of 16, 2 + 2 blocks, mlp 64, text 8):
    a dense forward over 10 image rows and a RAGS forward over 3 edited
    rows with 10 stored, batch 1."""
    conf = tiny()
    dense = work.forward_items(conf, 10, 10, 1, False)
    rags = work.forward_items(conf, 3, 10, 1, True)
    attn = [it for it in dense if it[0] == "attn"]
    assert attn == [("attn", 1, 2, 18, 18, 16)] * 4
    assert [it for it in rags if it[0] == "attn"] == \
        [("attn", 1, 2, 11, 18, 16)] * 4
    # double block, image stream: q, k, v, out, mlp in, mlp out
    img = [it for it in dense if it[0] == "gemm" and it[1] == 10]
    assert ("gemm", 10, 32, 32) in img and ("gemm", 10, 64, 32) in img
    flops, _ = work.totals(dense, "gemm")
    by_hand = 0
    h, t, r, mlp = 32, 8, 10, 64
    by_hand += 2 * r * h * 8 + 2 * h * 32 + 2 * h * h  # x_embed, time_in
    by_hand += 2 * (h * 8 + h * h)                     # vector_in
    by_hand += 2 * (h * 32 + h * h)                    # guidance_in
    by_hand += 2 * t * h * 16                          # txt_in
    for _ in range(2):                                 # double blocks
        by_hand += 2 * 2 * (6 * h * h)
        for n in (r, t):
            by_hand += 2 * n * (4 * h * h + 2 * h * mlp)
    for _ in range(2):                                 # single blocks
        by_hand += 2 * (3 * h * h) + 2 * (t + r) * h * (3 * h + mlp) + \
            2 * (t + r) * (h + mlp) * h
    by_hand += 2 * 2 * h * h + 2 * r * h * 8           # final
    assert flops == by_hand


# -- the device trace --------------------------------------------------------

def _trace(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return devtrace.read_chrome_trace(p)


def test_trace_groups_busy_union_and_gaps(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "attention_tma_kernel<0>",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "nvjet_tst_gemm", "ts": 50.0,
         "dur": 100.0},                      # overlaps: counted once
        {"ph": "X", "cat": "kernel", "name": "fused_adaln_kernel",
         "ts": 400.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 140.0, "dur": 200.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 1.0}]
    raw = _trace(tmp_path, ev)
    groups = devtrace.load_groups()
    s = devtrace.summarize(raw, groups, window_s=1e-3)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["span_s"] == pytest.approx(500e-6)     # 0 to 500 us
    assert s["by_group"] == pytest.approx(
        {"attention": 1e-4, "gemm": 1e-4, "fused": 1e-4})
    assert s["gaps"] == pytest.approx(
        {"cudaStreamSynchronize before fused": 250e-6})


def _record(trace=None, spans=(), edits=()):
    conf = json.loads((PB / "configs" / "flux-kontext.json").read_text())
    return harness.RunRecord(config=conf, mix={}, grid=64, edits=list(edits),
                             window_s=3.0, setup_s=1.0, peak_window_bytes=0,
                             spans=list(spans), trace=trace, groups=[])


def test_readers_find_nothing_and_return_nothing():
    for name in ("kernels.attention_roofline", "kernels.gemm_roofline",
                 "device.idle_share", "device.edit_mfu",
                 "pipeline.dense_forward_ms", "pipeline.rags_forward_ms",
                 "sampler.self_ms", "sampler.rags_row_use"):
        read = harness.load_reader(PB / "metrics" / f"{name}.py")
        assert read(_record()) is None, name


def test_readers_on_a_record():
    stats = {"edited_tokens": 900, "capacity": 1024, "dense_steps": 9,
             "rags_steps": 19, "reuse_steps": 13}
    spans = [{"edit_ms": 3000.0, "forwards": [("dense", 280.0)] * 9
              + [("rags", 60.0)] * 6}]
    trace = {"by_group": {"attention": 1.0, "gemm": 1.5}, "busy_s": 2.9,
             "span_s": 2.95, "window_s": 3.0}
    r = _record(trace, spans, [{"request": 0, "stats": stats,
                                "wall_s": 3.0}])
    get = {n: harness.load_reader(PB / "metrics" / f"{n}.py")(r) for n in (
        "pipeline.dense_forward_ms", "pipeline.rags_forward_ms",
        "sampler.self_ms", "sampler.rags_row_use", "device.idle_share",
        "kernels.attention_roofline", "device.edit_mfu")}
    assert get["pipeline.dense_forward_ms"] == 280.0
    assert get["pipeline.rags_forward_ms"] == 60.0
    assert get["sampler.self_ms"] == pytest.approx(3000 - 9 * 280 - 6 * 60)
    assert get["sampler.rags_row_use"] == pytest.approx(100 * 900 / 1024)
    assert get["device.idle_share"] == pytest.approx(100 * 0.1 / 3.0)
    items = work.edit_items(r.config, 64, stats)
    assert get["kernels.attention_roofline"] == pytest.approx(
        100 * work.totals(items, "attn")[1])
    assert get["device.edit_mfu"] == pytest.approx(
        100 * work.totals(items)[0] / (2.95 * work.PEAK_BF16))


@pytest.mark.parametrize("name", ["flux-kontext", "step1x-edit"])
@pytest.mark.parametrize("grid", [16, 32, 48, 64, 96])
def test_reference_plan_is_the_ports(name, grid):
    """The frozen plan against the port's `build_stage_plan` over the
    configuration's knobs and float16 gamma table: every step alike."""
    import numpy as np
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.core.schedule import (build_sigmas,
                                                 build_stage_plan,
                                                 calculate_shift)
    from perfbench.reference import plan as P
    conf = json.loads((PB / "configs" / f"{name}.json").read_text())
    mine = P.build_plan(P.Knobs.of(conf["regione"]),
                        P.sigmas(28, grid * grid), conf["gamma"])
    theirs = build_stage_plan(
        RegionEParams(**conf["regione"]),
        build_sigmas(28, mu=calculate_shift(grid * grid)),
        np.asarray(conf["gamma"], np.float16))
    assert [(s.sigma, s.dense, s.role, s.dt, s.dt_jump, s.dt_final, s.reuse,
             s.ratio) for s in mine] == \
        [(s.sigma, s.dense, s.sched_role, s.dt, s.dt_jump, s.dt_final,
          s.reuse, s.ratio) for s in theirs]
