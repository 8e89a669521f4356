"""A configuration's plain reference and weight layout, found by name, on
the CPU.

  * a configuration that names a reference module added as a new file
    (with a `layout` of its own) is found, and that module's layout and
    `Reference` are the ones a run uses; no file that is there is edited;
  * end to end at a tiny size: a model with the text RMSNorm before
    `txt_in` (`txt_norm`), which the default reference does not compute,
    added with new files only, comes out correct, and the same module
    without the norm does not;
  * an unknown reference stops `load_cell` and names the missing file;
  * every module under `reference/` stays plain: it imports nothing of
    the program and nothing of JAX.

    python -m pytest perfbench/tests -q
"""

import ast
import importlib
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, inputs, reference  # noqa: E402
from perfbench.reference import sampler  # noqa: E402

PB = ROOT / "perfbench"
DATA = Path(__file__).resolve().parent / "data"
SEED = 2**31 + 91
CELL = "tiny-txt-norm.tiny-local"

# the text RMSNorm of Qwen-Image's `txt_norm`, as a new reference module
# over the default one: its scale in the layout, the norm before txt_in
WITH_NORM = '''
from perfbench import inputs
from perfbench.reference import model as M
from perfbench.reference import sampler


def layout(config):
    return inputs.layout(config) + [
        ("txt_norm.scale", (config["model"]["txt_in_dim"],), inputs.NORM,
         0)]


class Reference(sampler.Reference):
    def velocity(self, rows, sigma, req, *args, **kw):
        txt = M.rmsnorm(req["txt"], self.lin.w["txt_norm.scale"])
        return super().velocity(rows, sigma, dict(req, txt=txt), *args,
                                **kw)
'''
# the same layout, the norm left out
WITHOUT_NORM = '''
from perfbench import inputs
from perfbench.reference import sampler


def layout(config):
    return inputs.layout(config) + [
        ("txt_norm.scale", (config["model"]["txt_in_dim"],), inputs.NORM,
         0)]


Reference = sampler.Reference
'''


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_references(monkeypatch):
    """Reference modules that a test adds from its copy are forgotten
    after it, so that a name can stand for another file in the next."""
    monkeypatch.setattr(reference, "__path__", list(reference.__path__))
    known = set(sys.modules)
    yield
    here = Path(reference.__file__).parent
    for name in set(sys.modules) - known:
        mod = sys.modules[name]
        if name.startswith(reference.__name__ + ".") \
                and Path(mod.__file__).parent != here:
            del sys.modules[name]


def _files(folder: Path) -> dict:
    return {p.relative_to(folder): p.read_bytes()
            for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def tmp_bench(tmp_path, module_src: str | None, ref_name="tiny_txt_norm"):
    """A copy of the benchmark with one new configuration (tiny FLUX with
    `txt_norm`, naming `ref_name`), its cell at the tiny mix, its limits,
    and (`module_src`) its reference module, all as new files.  The copy's
    `reference/` is put on the package's path, where the module is found
    by its name.  Returns the paths of the copy."""
    pb = tmp_path / "perfbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns("tests",
                                                          "__pycache__"))
    before = _files(pb)
    conf = json.loads((DATA / "configs" / "tiny-flux-kontext.json")
                      .read_text())
    conf["name"] = "tiny-txt-norm"
    conf["reference"] = ref_name
    conf["model"]["txt_norm"] = True
    (pb / "configs" / "tiny-txt-norm.json").write_text(json.dumps(conf))
    if module_src is not None:
        (pb / "reference" / f"{ref_name}.py").write_text(module_src)
    shutil.copy(DATA / "mixes" / "tiny-local.json", pb / "mixes")
    shutil.copy(DATA / "limits" / "tiny-flux-kontext.tiny-local.json",
                pb / "limits" / f"{CELL}.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-txt-norm", "source": "tiny",
                             "file": "perfbench/configs/tiny-txt-norm.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-txt-norm",
                               "traffic": "tiny-local", "chips": 1,
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _files(pb)
    # every file that was there is as it was; the rest is new
    assert {k: after[k] for k in before} == before
    reference.__path__.append(str(pb / "reference"))
    importlib.invalidate_caches()
    return harness.Paths(bench=tmp_path / "BENCHMARK.json", root=tmp_path,
                         mixes=pb / "mixes", limits=pb / "limits",
                         metrics=pb / "metrics",
                         end_to_end=pb / "end_to_end",
                         groups=pb / "kernel_groups")


def run(paths, system="program"):
    return harness.run_once(CELL, SEED, 0.0, False, time.perf_counter(),
                            paths=paths, device="cpu", system=system)


def test_a_reference_module_added_as_a_file_is_the_one_used(tmp_path):
    paths = tmp_bench(tmp_path, WITH_NORM)
    cell = harness.load_cell(paths, CELL)
    mod = cell["reference"]
    assert mod.Reference.__module__ == "perfbench.reference.tiny_txt_norm"
    assert Path(mod.__file__).parent == tmp_path / "perfbench" / "reference"
    conf, lay = cell["config"], cell["layout"]
    assert [e[0] for e in lay] == [e[0] for e in inputs.layout(conf)] + [
        "txt_norm.scale"]
    weights = inputs.make_weights(conf, harness.generator("cpu", SEED),
                                  "cpu", lay)
    assert weights["txt_norm.scale"].shape == (16,)
    # the port's MMDiT holds the same parameters
    from regione_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    m = dict(conf["model"])
    m.pop("connector")
    m["axes_dims"] = tuple(m["axes_dims"])
    model = MMDiT(MMDiTConfig(**m), "meta")
    assert sorted(n for n, _ in model.named_parameters()) == sorted(weights)


def test_a_model_the_default_reference_does_not_compute(tmp_path):
    """Tiny FLUX with `txt_norm`: the reference module that adds the norm
    is correct to fp32 rounding; without it, not correct."""
    good = run(tmp_bench(tmp_path / "with", WITH_NORM, "with_norm"))
    assert good["correct"] and good["failed"] == 0
    assert good["checks"]["plan_diff"] == [0.0, 0]
    assert good["checks"]["latent_err"][0] < 1e-4
    bad = run(tmp_bench(tmp_path / "without", WITHOUT_NORM,
                        "without_norm"))
    assert not bad["correct"] and bad["failed"] >= 1
    assert bad["checks"]["latent_err"][0] > bad["checks"]["latent_err"][1]


def test_the_default_reference_cannot_load_txt_norm_weights(tmp_path):
    """Without a layout of its own the weights lack `txt_norm.scale`, and
    the port refuses them: the reason a configuration brings one."""
    paths = tmp_bench(tmp_path, None, ref_name="sampler")
    with pytest.raises(RuntimeError, match="txt_norm.scale"):
        run(paths)


def test_an_unknown_reference_stops_load_cell(tmp_path):
    paths = tmp_bench(tmp_path, None, ref_name="no_such_reference")
    with pytest.raises(SystemExit, match="reference/no_such_reference.py"):
        harness.load_cell(paths, CELL)


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_every_reference_module_stays_plain(path):
    """No module under reference/ imports the program or JAX, by the
    top-level name of each import, compared whole."""
    banned = {"regione_tpu_torch", "regione_tpu", "jax", "jaxlib", "flax"}
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            found.add(node.module.split(".")[0])
    assert not found & banned, (path.name, sorted(found & banned))


@pytest.mark.parametrize("conf", [c["file"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]])
def test_each_configuration_finds_its_reference(conf):
    """A file that names no reference gets `sampler` and the layout of
    `inputs`; whatever it names gives a `Reference`."""
    conf = json.loads((ROOT / conf).read_text())
    mod = reference.load(conf)
    assert hasattr(mod, "Reference")
    if "reference" not in conf:
        assert mod is sampler and not hasattr(mod, "layout")
