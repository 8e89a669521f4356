"""Guards of the PyTorch port: no JAX, no build at import, no fallback.

  * importing `regione_tpu_torch`, every module in it (the VAEs, the FLUX
    pipeline and the CLI included) and `chip_smoke.py` leaves `jax` out of
    `sys.modules` (in a subprocess: this test process has imported jax
    already through tests/conftest.py);
  * the CLI with no CUDA card stops unless `--device cpu` is given;
  * the kernel modules import with no triton and no nvcc;
  * CPU tensors take the plain path (no launch is counted), and a device
    with no kernel raises instead of falling back, for every wrapper (the
    quantized-cache ones included);
  * the kernels' library is named by a hash of the sources, so an edit
    rebuilds.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from regione_tpu_torch.ops import _build
from regione_tpu_torch.ops import flash_attention as fa
from regione_tpu_torch.ops import partition_kernel as pk
from regione_tpu_torch.ops.quant import quantize_kv_heads, quantize_kv_heads4

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import regione_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    regione_tpu_torch.__path__, "regione_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in ("jax", "jaxlib", "triton") if m in sys.modules]
new = {"regione_tpu_torch.models.vae", "regione_tpu_torch.models.vae_wan",
       "regione_tpu_torch.pipelines.flux_kontext",
       "regione_tpu_torch.cli.main"}
print(len(names), sorted(new - set(names)) + bad)
"""


def test_port_imports_no_jax_and_builds_nothing(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(maxsplit=1)
    assert int(n) >= 20
    assert bad.strip() == "[]"


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
            fa.attention_quant.launches, pk.fused_partition.launches)


def test_cpu_tensors_take_the_plain_path():
    fa.reset_launches()
    pk.fused_partition.launches = 0
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
    assert _launch_counts() == (0,) * 6


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
    x = torch.empty(16, 8, device="meta")
    with pytest.raises(ValueError, match="no partition kernel"):
        pk.fused_partition(x, x, 0.0, 4, 4)


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
