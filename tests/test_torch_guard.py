"""Guards of the PyTorch port: no JAX, no build at import, no fallback.

  * importing `regione_tpu_torch`, every module in it (the VAEs, the FLUX
    pipeline, the CLI, `eval.*` and the thinker included) and `chip_smoke.py` leaves `jax` and the
    JAX package `regione_tpu` out of `sys.modules` (in a subprocess: this
    test process has imported jax already through tests/conftest.py);
  * no source file of the port and not `chip_smoke.py` names
    `regione_tpu` (other than `regione_tpu_torch`) in an import statement,
    lazy imports inside functions included (the measuring entry points of
    `bench/` are named in the import check); no shell script of the port
    (`scripts/torch_*.sh`, `scripts/torch_demo/*.sh`) runs a module of the
    JAX package or its console script;
  * the CLI with no CUDA card stops unless `--device cpu` is given;
  * the kernel modules import with no triton and no nvcc;
  * CPU tensors take the plain path (no launch is counted), and a device
    with no kernel raises instead of falling back, for every wrapper (the
    quantized-cache ones, the fused block kernels and the cache's
    quantizer K10 included); a call on the kernel path with no library to
    load raises too;
  * the kernels' library is named by a hash of the sources, so an edit
    rebuilds; each source compiles in its own nvcc process, then one link
    (a fake nvcc records the commands); the C signatures the loader binds
    are exactly the `extern "C"` entries of the sources;
  * the public builders of models and VAEs, the eval entry points (the
    local judges, the thinker's VLM, LPIPS, the pixel probe, the eval
    CLIs' `--device`) default to the card, and with no card they raise;
    `parallel.sharding.make_mesh` names the card by default;
  * `make_mesh` keeps the caller's backend for its subgroups (no switch
    to another one).
"""

import argparse
import ast
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from regione_tpu_torch.ops import _build
from regione_tpu_torch.ops import flash_attention as fa
from regione_tpu_torch.ops import partition_kernel as pk
from regione_tpu_torch.ops.quant import (quantize_kv_heads, quantize_kv_heads4,
                                         store_quantized)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import regione_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    regione_tpu_torch.__path__, "regione_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in ("jax", "jaxlib", "triton", "regione_tpu")
       if m in sys.modules]
new = {"regione_tpu_torch.models.vae", "regione_tpu_torch.models.vae_wan",
       "regione_tpu_torch.pipelines.flux_kontext",
       "regione_tpu_torch.cli.main", "regione_tpu_torch.pipelines.serve",
       "regione_tpu_torch.utils.telemetry", "regione_tpu_torch.utils.memplan",
       "regione_tpu_torch.pipelines.thinker",
       "regione_tpu_torch.parallel", "regione_tpu_torch.parallel.sharding"} | {
       "regione_tpu_torch.bench." + m for m in (
           "common", "headline", "profile_steps", "serve_batch", "fullsize",
           "exec_full_qwen60", "profile_rags", "fidelity_int8",
           "encoder_placement")} | {
       "regione_tpu_torch.eval." + m for m in (
           "metrics", "merge", "run_metrics", "preprocess", "lpips_torch",
           "pixelprobe", "viescore", "run_viescore")}
print(len(names), sorted(new - set(names)) + bad)
"""


def test_port_imports_no_jax_and_builds_nothing(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(maxsplit=1)
    assert int(n) >= 30
    assert bad.strip() == "[]"


def _jax_package_imports(path):
    """(line, module) of every import of `regione_tpu[.x]` in a file."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "regione_tpu" or n.startswith("regione_tpu.")]
    return found


_PORT_FILES = sorted((REPO / "regione_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_never_imports_the_jax_package(path):
    assert _jax_package_imports(path) == []


_PORT_SHELL = sorted((REPO / "scripts").glob("torch_*.sh")) + sorted(
    (REPO / "scripts" / "torch_demo").glob("*.sh"))


@pytest.mark.parametrize("path", _PORT_SHELL,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_shell_scripts_never_call_the_jax_package(path):
    """A port script runs `regione_tpu_torch` modules and the port's
    console script only: no `regione_tpu.` module, no `regione-tpu `."""
    text = path.read_text()
    assert re.findall(r"\bregione_tpu\.", text) == []
    assert re.findall(r"\bregione-tpu\s", text) == []
    assert "regione_tpu_torch." in text or "regione-tpu-torch" in text


def test_the_import_scan_sees_every_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import regione_tpu\nimport regione_tpu_torch\n"
                   "from regione_tpu.core import config\n"
                   "def f():\n    import regione_tpu.api as a\n"
                   "    from regione_tpu_torch.core import config\n")
    assert _jax_package_imports(src) == [
        (1, "regione_tpu"), (3, "regione_tpu.core"), (5, "regione_tpu.api")]


def test_cli_without_a_card_stops_instead_of_using_the_cpu(monkeypatch,
                                                           tmp_path):
    from regione_tpu_torch.cli import main as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--preset", "tiny", "--random_weights", "--prompt", "x",
            "--image_path", str(tmp_path / "in.png"),
            "--output_dir", str(tmp_path / "o")]
    for extra in ([], ["--device", "cuda:0"]):
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            cli.main(argv + extra)
    assert not (tmp_path / "o").exists()
    assert cli.resolve_device("cpu") == torch.device("cpu")


def _launch_counts():
    return (fa.attention.launches, fa.attention.long_launches,
            fa.attention_rows2.launches, fa.attention_rows2_quant.launches,
            fa.attention_quant.launches, pk.fused_partition.launches,
            store_quantized.launches)


def test_cpu_tensors_take_the_plain_path():
    fa.reset_launches()
    pk.fused_partition.launches = 0
    store_quantized.launches = 0
    q = torch.randn(1, 2, 5, 128)
    k = torch.randn(1, 2, 8, 128)
    torch.testing.assert_close(fa.attention(q, k, k),
                               fa.attention_reference(q, k, k))
    torch.testing.assert_close(fa.attention_rows2(q, k, k, k, k),
                               fa.attention_rows2_reference(q, k, k, k, k))
    for quant in (quantize_kv_heads, quantize_kv_heads4):
        rows, sc = quant(k)
        torch.testing.assert_close(
            fa.attention(q, rows, rows, k_scale=sc, v_scale=sc),
            fa.attention_quant_reference(q, rows, rows, sc, sc))
        torch.testing.assert_close(
            fa.attention_rows2(q, k, k, rows, rows, k_scale=sc, v_scale=sc),
            fa.attention_rows2_quant_reference(q, k, k, rows, rows, sc, sc))
    x = torch.randn(16, 8)
    assert torch.equal(pk.fused_partition(x, -x, 0.0, 4, 4),
                       pk.partition_reference(x, -x, 0.0, 4, 4))
    xb = torch.randn(3, 16, 8)
    assert torch.equal(pk.fused_partition(xb, -xb, 0.0, 4, 4),
                       pk.partition_reference(xb, -xb, 0.0, 4, 4))
    for bits, quant_heads in ((8, quantize_kv_heads), (4, quantize_kv_heads4)):
        rows, sc = (torch.zeros_like(t) for t in quant_heads(k))
        store_quantized(k, rows, sc, bits)
        want = quant_heads(k)
        assert torch.equal(rows, want[0]) and torch.equal(sc, want[1])
    assert _launch_counts() == (0,) * 7


def test_no_fallback_on_a_device_without_kernels():
    q = torch.empty(1, 2, 5, 128, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        fa.attention(q, q, q)
    with pytest.raises(ValueError, match="no attention kernel"):
        fa.attention_rows2(q, q, q, q, q)
    rows = torch.empty(1, 2, 4, 128, dtype=torch.int8, device="meta")
    sc = torch.empty(1, 2, 8, device="meta")
    for call in (lambda: fa.attention(q, rows, rows, k_scale=sc, v_scale=sc),
                 lambda: fa.attention_quant(q, rows, rows, sc, sc),
                 lambda: fa.attention_rows2(q, q, q, rows, rows, k_scale=sc,
                                            v_scale=sc),
                 lambda: fa.attention_rows2_quant(q, q, q, rows, rows, sc,
                                                  sc)):
        with pytest.raises(ValueError, match="no attention kernel"):
            call()
    for shape in ((16, 8), (3, 16, 8)):
        x = torch.empty(shape, device="meta")
        with pytest.raises(ValueError, match="no partition kernel"):
            pk.fused_partition(x, x, 0.0, 4, 4)
    for bits in (8, 4):
        with pytest.raises(ValueError, match="no kv_quant_store kernel"):
            store_quantized(q[:, :, :4], rows, sc, bits)


# the twelve kernel wrappers: K1/K5, K2, K2q, K6, K3, K7 (three modes), K8,
# K9, K10, K11
KERNEL_WRAPPERS = ("attention", "attention_rows2", "attention_rows2_quant",
                   "attention_quant", "fused_partition", "adaln",
                   "residual_adaln", "gated_residual", "qk_norm_rope",
                   "gelu_pack", "store_quantized", "swiglu_pack")


def _wrapper_call(name, device="cpu", wrong_dtype=False):
    """One call of kernel wrapper `name` on valid shapes; `wrong_dtype`:
    its activations in a dtype its kernel does not take (fp32 for the bf16
    kernels, bf16 for K3's fp32)."""
    from regione_tpu_torch.ops import fused
    bf16, fp32 = ((torch.float32, torch.bfloat16) if wrong_dtype
                  else (torch.bfloat16, torch.float32))
    x = torch.zeros(1, 3, 256, dtype=bf16, device=device)
    m = torch.zeros(1, 1, 256, dtype=bf16, device=device)
    q = torch.zeros(1, 2, 4, 128, dtype=bf16, device=device)
    rows = torch.zeros(1, 2, 4, 128, dtype=torch.int8, device=device)
    sc = torch.ones(1, 2, 4, device=device)
    img = torch.zeros(16, 8, dtype=fp32, device=device)
    calls = {
        "attention": lambda: fa.attention(q, q, q),
        "attention_rows2": lambda: fa.attention_rows2(q, q, q, q, q),
        "attention_rows2_quant": lambda: fa.attention_rows2_quant(
            q, q, q, rows, rows, sc, sc),
        "attention_quant": lambda: fa.attention_quant(q, rows, rows, sc, sc),
        "fused_partition": lambda: pk.fused_partition(img, img, 0.0, 4, 4),
        "adaln": lambda: fused.adaln(x, m, m),
        "residual_adaln": lambda: fused.residual_adaln(x, m, x, m, m),
        "gated_residual": lambda: fused.gated_residual(x, m, x),
        "qk_norm_rope": lambda: fused.qk_norm_rope(
            x, 2, torch.ones(128, dtype=bf16, device=device)),
        "gelu_pack": lambda: fused.gelu_pack(x, x),
        "swiglu_pack": lambda: fused.swiglu_pack(x, x),
        "store_quantized": lambda: store_quantized(q, rows, sc, 8),
    }
    return calls[name]()


@pytest.mark.parametrize("name", KERNEL_WRAPPERS)
def test_fused_kernels_never_fall_back(monkeypatch, tmp_path, name):
    """Each kernel wrapper: a device with no kernel raises; on the kernel
    path (a CUDA tensor, stood in for by patching `ops.launch.on_card`) a
    wrong dtype raises before any build, and with no nvcc to build the
    library the call raises instead of computing the plain version.  No
    launch is counted."""
    from regione_tpu_torch.ops import launch
    from regione_tpu_torch.utils import telemetry
    telemetry.reset_counters()
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        _wrapper_call(name, device="meta")
    monkeypatch.setattr(launch, "on_card", lambda x, what: True)
    with pytest.raises(TypeError, match="the kernel takes"):
        _wrapper_call(name, wrong_dtype=True)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _wrapper_call(name)
    assert telemetry.counter_totals()[0] == 0


def test_fused_entries_are_bound():
    """The fused kernels' four C entries are bound by the loader and
    defined in csrc/fused_block.cu."""
    src = (_build.CSRC / "fused_block.cu").read_text()
    for name in ("regione_adaln_fwd", "regione_qk_norm_rope_fwd",
                 "regione_gelu_pack_fwd", "regione_swiglu_pack_fwd"):
        assert name in _build._SIGNATURES
        assert f'extern "C" int {name}(' in src


def test_missing_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    src.write_text("// v2\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR
    assert {p.name for p in _build.sources()} == {"k.cu"}


_FAKE_NVCC = """#!{python}
import json, sys
with open({log!r}, "a") as fh:
    fh.write(json.dumps(sys.argv[1:]) + "\\n")
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "w").write("built")
print("ptxas info    : Used 1 registers")
"""


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    import json
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    path, out = _build.build()
    cmds = [json.loads(line) for line in log.read_text().splitlines()]
    compiles, link = cmds[:-1], cmds[-1]
    assert sorted(c[-1] for c in compiles) == [str(csrc / "a.cu"),
                                               str(csrc / "b.cu")]
    assert all("-c" in c and "sm_90a" in " ".join(c) for c in compiles)
    assert "-shared" in link and "-c" not in link
    assert sorted(Path(x).suffix for x in link if x.endswith(".o")) == [
        ".o", ".o"]
    assert path == _build.library_path() and path.read_text() == "built"
    assert out.count("Used 1 registers") == 3
    assert sorted(p.name for p in build.iterdir()) == [path.name]
    assert _build.build() == (path, "")          # built: nothing to do


def test_signatures_name_exactly_the_c_entries():
    """No entry bound by the loader is missing from csrc/*.cu, and none of
    the sources' `extern "C"` entries goes unbound."""
    found = set()
    for src in _build.sources():
        found |= set(re.findall(r'extern "C" \w+\s+(\w+)\(',
                                src.read_text()))
    assert found == set(_build._SIGNATURES)
    assert "regione_attention_tma_fwd" in found


def test_public_builders_default_to_the_card():
    from regione_tpu_torch.eval import (lpips_torch, metrics, pixelprobe,
                                        run_metrics, run_viescore, viescore)
    from regione_tpu_torch.models.vae import AutoencoderKL
    from regione_tpu_torch.models.vae_wan import WanVAE
    from regione_tpu_torch.parallel import sharding
    from regione_tpu_torch.pipelines import thinker
    from regione_tpu_torch.weights import from_jax
    for fn in (from_jax.convert_params, from_jax.mmdit_from_jax,
               from_jax.vae_from_jax, from_jax.init_vae_params,
               from_jax.init_params, AutoencoderKL.__init__, WanVAE.__init__,
               viescore.LocalVLMBackbone.__init__,
               viescore.MiniCPMVBackbone.__init__, viescore.make_backbone,
               thinker.local_vlm_thinker, metrics.lpips_distance,
               metrics.calculate_image_metrics, metrics.run_all_tasks,
               lpips_torch.load_lpips_npz, pixelprobe.decoder_for_family,
               pixelprobe.pixel_psnr_vs_dense):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__
    assert inspect.signature(sharding.make_mesh).parameters[
        "device_type"].default == "cuda"
    # the eval CLIs' --device
    for cli, argv in ((run_metrics, ["--folder1", "a", "--folder2", "b"]),
                      (run_viescore, ["--data_dir", "d"])):
        seen = []
        parse = argparse.ArgumentParser.parse_args

        def spy(self, args=None, namespace=None):
            ns = parse(self, args, namespace)
            seen.append(ns.device)
            raise SystemExit(0)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(argparse.ArgumentParser, "parse_args", spy)
            with pytest.raises(SystemExit):
                cli.main(argv)
        assert seen == ["cuda"], cli.__name__


def test_eval_on_a_missing_card_raises(monkeypatch, tmp_path):
    """The eval entry points with their default device and no card raise;
    none of them measures on the CPU instead."""
    import numpy as np

    from regione_tpu_torch.eval import lpips_torch, pixelprobe, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.savez(tmp_path / "w.npz", conv0_w=np.zeros((1,), np.float32))
    for call in (lambda: resolve_device("cuda:0"),
                 lambda: lpips_torch.load_lpips_npz(str(tmp_path / "w.npz")),
                 lambda: pixelprobe.decoder_for_family("flux")):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_mesh_keeps_the_callers_backend(tmp_path):
    """The mesh's dp and tp groups run on the default group's backend
    (gloo here), whatever device type the mesh names."""
    import torch.distributed as dist

    from regione_tpu_torch.parallel import sharding
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(device_type="cpu")
        for dim in ("dp", "tp"):
            assert dist.get_backend(mesh.get_group(dim)) == "gloo"
    finally:
        dist.destroy_process_group()
