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

from perfbench import devtrace, harness, inputs, reference, work  # noqa: E402

PB = ROOT / "perfbench"
DATA = Path(__file__).resolve().parent / "data"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(name="tiny-flux-kontext"):
    return json.loads((DATA / "configs" / f"{name}.json").read_text())


@pytest.fixture
def reference_dirs(monkeypatch):
    """`add(folder, ...)`: `reference.load` also finds modules in these
    folders for the test; the modules it imported are forgotten after."""
    before = set(sys.modules)

    def add(*folders):
        monkeypatch.setattr(reference, "__path__",
                            [*reference.__path__, *map(str, folders)])

    yield add
    for name in set(sys.modules) - before:
        if name.startswith(reference.__name__ + "."):
            del sys.modules[name]


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


def test_a_new_cell_metric_and_kernel_group_are_files(tmp_path,
                                                      reference_dirs,
                                                      monkeypatch):
    """A configuration with a reference module that counts its own
    forwards, a mix, a limits file, per-layer metrics and kernel groups
    added as new files are found by name and counted, no file edited."""
    pb = tmp_path / "perfbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns("tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = tiny()
    conf["name"] = "tiny-new"
    conf["reference"] = "tiny_new_count"
    (pb / "reference" / "tiny_new_count.py").write_text(
        "from perfbench import work\n"
        "from perfbench.reference.sampler import Reference  # noqa: F401\n"
        "def forward_items(config, rows, s_kv, batch, rags):\n"
        "    return work.forward_items(config, rows, s_kv, batch, rags) \\\n"
        "        + [('op', 'tinyop', 1000.0 * batch * rows)]\n")
    (pb / "kernel_groups" / "tinyop.json").write_text(json.dumps(
        {"group": "tinyop", "priority": 6, "patterns": ["my_tiny_op"]}))
    (pb / "metrics" / "kernels.tinyop_roofline.py").write_text(
        "from perfbench import work\n"
        "def read(run):\n"
        "    dev = run.trace['by_group'].get('tinyop', 0.0)\n"
        "    least = sum(work.totals(work.edit_items(\n"
        "        run.config, run.grid, e['stats']), 'tinyop')[1]\n"
        "        for e in run.edits)\n"
        "    return 100.0 * least / dev if dev > 0.0 else None\n")
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
    bench["per_layer"].append({"name": "kernels.tinyop_roofline",
                               "unit": "%", "better": "higher",
                               "source": "device_trace",
                               "layer": "kernels", "moves": "edit_s",
                               "workloads": ["tiny-new.tiny-new-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    paths = harness.Paths(bench=tmp_path / "BENCHMARK.json", root=tmp_path,
                          mixes=pb / "mixes", limits=pb / "limits",
                          metrics=pb / "metrics",
                          end_to_end=pb / "end_to_end",
                          groups=pb / "kernel_groups")
    reference_dirs(pb / "reference")
    # the copy's kernel groups stand in for the repo's
    monkeypatch.setattr(work, "GROUPS_DIR", pb / "kernel_groups")
    cell = harness.load_cell(paths, "tiny-new.tiny-new-mix")
    assert cell["config"]["name"] == "tiny-new"
    assert cell["reference"].__file__ == str(pb / "reference"
                                             / "tiny_new_count.py")
    assert [m["name"] for k, m in cell["metrics"] if k == "per_layer"] == \
        ["sampler.edits_seen", "kernels.tinyop_roofline"]
    read = harness.load_reader(pb / "metrics" / "sampler.edits_seen.py")
    assert read(type("R", (), {"edits": [1, 2]})()) == 2.0
    groups = devtrace.load_groups(pb / "kernel_groups")
    assert devtrace.group_of("my_new_attn_kernel<4>", groups) == "attention"
    assert devtrace.group_of("nvjet_tst_128x256", groups) == "gemm"
    assert devtrace.group_of("my_tiny_op_kernel<2>", groups) == "tinyop"
    # the module's op is counted under its group, and nowhere else
    stats = {"edited_tokens": 5, "capacity": 8, "dense_steps": 9,
             "rags_steps": 19, "reuse_steps": 13}
    items = work.edit_items(cell["config"], 4, stats)
    default = work.forward_items(cell["config"], 32, 32, 1, False)
    assert items[:len(default)] == default
    least = (9 * 1000.0 * 32 + 6 * 1000.0 * 5) / work.HBM_BYTES_PER_S
    assert work.totals(items, "tinyop") == (0.0, pytest.approx(least))
    record = harness.RunRecord(
        config=cell["config"], mix=cell["mix"], grid=4,
        edits=[{"stats": stats}] * 2, window_s=1.0, setup_s=1.0,
        peak_window_bytes=0, spans=[], groups=groups,
        trace={"by_group": {"tinyop": 4 * least}})
    read = harness.load_reader(pb / "metrics" / "kernels.tinyop_roofline.py")
    assert read(record) == pytest.approx(50.0)


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


def test_op_items_are_bytes_under_their_group():
    """("op", group, nbytes): its least time is its bytes at the HBM
    rate, filed under its group's name; it adds no FLOPs to a total."""
    op = ("op", "fused", 6.7e12)
    assert work.work(op) == (0.0, 6.7e12)
    gemm = ("gemm", 64, 64, 64)
    items = [gemm, op, ("op", "fused", 3.35e9), ("op", "partition", 3.35e6)]
    assert work.totals(items, "fused") == (0.0, pytest.approx(2.001))
    assert work.totals(items, "partition") == (0.0, pytest.approx(1e-6))
    assert work.totals(items, "gemm") == work.totals([gemm])
    assert work.totals(items)[0] == work.gemm_work(64, 64, 64)[0]
    assert work.totals(items)[1] == pytest.approx(
        work.totals([gemm])[1] + 2.001 + 1e-6)


def test_op_items_reach_the_roofline_of_their_group():
    """An op of the "attention" or "gemm" group is counted with the
    attentions or the linears, under the group's name or the item kind's:
    the readers ask for "attn" and "gemm"."""
    attn, gemm = ("attn", 1, 2, 64, 64, 32), ("gemm", 64, 64, 64)
    items = [attn, gemm, ("op", "attention", 3.35e9), ("op", "gemm", 6.7e9)]
    for kind in ("attn", "attention"):
        assert work.totals(items, kind) == (
            work.totals([attn])[0],
            pytest.approx(work.totals([attn])[1] + 1e-3))
    assert work.totals(items, "gemm") == (
        work.totals([gemm])[0], pytest.approx(work.totals([gemm])[1] + 2e-3))
    assert [work.group(it) for it in items] == \
        ["attention", "gemm", "attention", "gemm"]


@pytest.mark.parametrize("kind", ["attention", "norm", "Gemm"])
def test_an_item_of_unknown_kind_raises(kind):
    """An item of a kind `work` does not know is an error, in every total:
    it was once counted as an attention."""
    items = [("gemm", 4, 4, 4), (kind, 1, 2, 3, 4, 5)]
    with pytest.raises(ValueError, match="unknown kind"):
        work.work(items[1])
    for group in (None, "gemm", "attn", "fused"):
        with pytest.raises(ValueError, match="unknown kind"):
            work.totals(items, group)


# (len, and (FLOPs, least seconds) of `work.totals` over all items, "gemm"
# and "attn") of `work.edit_items` a cell at STATS[grid], as the work.py of
# commit 3faa3aa, whose count was the same for every configuration, gives
# them; from the root of a clone:
#   git show 3faa3aa:perfbench/work.py > build/work_parent.py
#   PYTHONPATH=build:perfbench/tests python3 -c "import work_parent as w, \
#       test_perfbench_parts as t; print(t.cell_totals(w))"
STATS = {64: {"edited_tokens": 1142, "capacity": 1280, "dense_steps": 9,
              "rags_steps": 19, "reuse_steps": 13},
         32: {"edited_tokens": 308, "capacity": 384, "dense_steps": 9,
              "rags_steps": 19, "reuse_steps": 13}}
PARENT_TOTALS = {
    "flux-kontext.local-1024": (6705, [
        (1677867684986880.0, 1.726053640595702),
        (1139797579530240.0, 1.181998933359446),
        (538070105456640.0, 0.5440547072362428)]),
    "step1x-edit.local-512": (7005, [
        (644430291271680.0, 0.6878028007287084),
        (576743913553920.0, 0.6193047551143487),
        (67686377717760.0, 0.06849804561435323)]),
    "step1x-edit.local-1024": (7005, [
        (3095340114247680.0, 3.1663281757060546),
        (2133792923320320.0, 2.1940274878171095),
        (961547190927360.0, 0.9723006878889842)]),
    "qwen-image-edit.local-1024": (13590, [
        (4192897487339520.0, 4.300772972993711),
        (2759046196101120.0, 2.850973891862236),
        (1433851291238400.0, 1.4497990811308072)])}


def cell_totals(w=work) -> dict:
    """What PARENT_TOTALS pins, by the `work` module `w`."""
    out = {}
    for cell in (c for c in BENCH["workloads"] if c["name"] in PARENT_TOTALS):
        conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
        grid = json.loads((PB / "mixes" / f"{cell['traffic']}.json")
                          .read_text())["grid"]
        items = w.edit_items(json.loads((ROOT / conf["file"]).read_text()),
                             grid, STATS[grid])
        out[cell["name"]] = (len(items), [w.totals(items, k)
                                          for k in (None, "gemm", "attn")])
    return out


def test_the_benchmarks_cells_count_as_before():
    """The four cells that were there before a configuration could bring
    its own count bring none: each cell's edit counts the parent's items
    to the last bit.  A cell added later is not this test's."""
    for cell in (c for c in BENCH["workloads"] if c["name"] in PARENT_TOTALS):
        conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
        mod = reference.load(json.loads((ROOT / conf["file"]).read_text()))
        assert not hasattr(mod, "forward_items"), cell["name"]
    assert cell_totals() == PARENT_TOTALS


def _counting_configs():
    """Every configuration, of the benchmark or of the tests' data, whose
    reference module gives `forward_items`, with a grid to count it at."""
    grids = {c["config"]: json.loads((PB / "mixes" / f"{c['traffic']}.json")
                                     .read_text())["grid"]
             for c in BENCH["workloads"]}
    confs = [(json.loads((ROOT / c["file"]).read_text()), grids[c["name"]])
             for c in BENCH["configs"]]
    confs += [(json.loads(f.read_text()), 64)
              for f in sorted((DATA / "configs").glob("*.json"))]
    return [(conf, g if g in STATS else 64) for conf, g in confs
            if hasattr(reference.load(conf), "forward_items")]


def test_every_op_a_configuration_counts_is_a_kernel_group(reference_dirs):
    """An op filed under a group that no `kernel_groups/*.json` names would
    be held against no device time: each module's ops name known groups."""
    reference_dirs(DATA / "reference")
    known = {g for g, _ in devtrace.load_groups(PB / "kernel_groups")}
    confs = _counting_configs()
    assert "flux2-dev-shaped" in [c["name"] for c, _ in confs]
    for conf, grid in confs:
        items = work.edit_items(conf, grid, STATS[grid])
        assert {work.group(it) for it in items} <= known, conf["name"]


def test_an_op_of_no_kernel_group_raises(tmp_path, reference_dirs):
    """A misspelled group stops the count instead of being counted
    nowhere."""
    (tmp_path / "misspelled_count.py").write_text(
        "from perfbench import work\n"
        "def forward_items(config, rows, s_kv, batch, rags):\n"
        "    return work.forward_items(config, rows, s_kv, batch, rags) \\\n"
        "        + [('op', 'fusd', 64.0 * rows)]\n")
    reference_dirs(tmp_path)
    conf = tiny()
    conf["reference"] = "misspelled_count"
    with pytest.raises(ValueError, match="fusd"):
        work.edit_items(conf, 4, STATS[64])


def _block_gemm_flops(conf, items, batch):
    """FLOPs of the linears over token rows inside the blocks: not the
    image and text embedders (their K) and not the output projection
    (its N)."""
    m = conf["model"]
    return sum(work.gemm_work(*it[1:])[0] for it in items
               if it[0] == "gemm" and it[1] > batch
               and it[3] not in (m["in_channels"], m["txt_in_dim"])
               and it[2] != m["out_channels"])


def test_a_configurations_own_count_replaces_the_default(reference_dirs):
    """FLUX.2 [dev]'s shape (SwiGLU ratio 3, shared modulation, 8 + 48
    blocks of hidden 6144) through its module's `forward_items`: a dense
    1024^2 forward (8192 image rows, 512 text) counts 13 hidden^2 products
    a block and token, where the default count gives 10."""
    reference_dirs(DATA / "reference")
    conf = tiny("flux2-dev-shaped")
    mod = reference.load(conf)
    h, rows, tokens, blocks = 6144, 8192, 8704, 56
    dense = mod.forward_items(conf, rows, rows, 1, False)
    default = work.forward_items(conf, rows, rows, 1, False)
    assert _block_gemm_flops(conf, dense, 1) == 2 * 13 * h * h * blocks * tokens
    assert _block_gemm_flops(conf, dense, 1) == pytest.approx(4.7839e14,
                                                              rel=1e-4)
    assert _block_gemm_flops(conf, default, 1) == \
        2 * 10 * h * h * blocks * tokens
    assert _block_gemm_flops(conf, default, 1) == pytest.approx(3.6799e14,
                                                                rel=1e-4)
    # the attention is the same call in both counts
    assert [it for it in dense if it[0] == "attn"] == \
        [it for it in default if it[0] == "attn"]
    assert work.totals(dense, "attn")[0] == pytest.approx(1.043e14, rel=1e-3)
    # modulation once a forward, not once a block
    assert sum(it[0] == "gemm" and it[1] == 1 for it in dense) == 8
    assert sum(it[0] == "gemm" and it[1] == 1 for it in default) == \
        4 + 2 * 8 + 48 + 1
    # `edit_items` takes the module's count, dense and RAGS forwards alike
    stats = STATS[64]
    items = work.edit_items(conf, 64, stats)
    rags = mod.forward_items(conf, stats["edited_tokens"], rows, 1, True)
    assert items == dense * 9 + rags * 6
    gate = sum(it[2] for it in items if it[0] == "op")
    assert work.totals(items, "fused") == (
        0.0, pytest.approx(gate / work.HBM_BYTES_PER_S))


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
