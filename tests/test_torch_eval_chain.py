"""The whole evaluation stack chained on the port (mirrors
tests/test_eval_chain.py and the reference's script/Evaluation.sh): the
port's CLI generation (vanilla + RegionE, `--device cpu`) -> pixel metrics
(LPIPS on the CPU over seeded weights) -> merge -> VIEScore (dry-run
judge) -> statistics."""

import csv
import json

import numpy as np
import pytest
from PIL import Image

from regione_tpu_torch.cli import main as tcli
from regione_tpu_torch.eval import lpips_torch, merge, metrics, run_metrics
from regione_tpu_torch.eval import run_viescore
from regione_tpu_torch.eval.viescore import analyze_scores
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def _seeded_lpips_npz(path):
    rng = np.random.default_rng(0)
    params, cin = {}, 3
    for i, (oc, k, _, _) in enumerate(lpips_torch._ALEX_STAGES):
        params[f"conv{i}_w"] = (0.1 * rng.standard_normal(
            (oc, cin, k, k))).astype(np.float32)
        params[f"conv{i}_b"] = (0.1 * rng.standard_normal(oc)).astype(
            np.float32)
        params[f"lin{i}"] = np.abs(rng.standard_normal(oc)).astype(np.float32)
        cin = oc
    np.savez(path, **params)
    return path


def test_full_eval_chain_on_the_port(tmp_path, monkeypatch):
    task = tmp_path / "bench" / "TE"
    (task / "img").mkdir(parents=True)
    with open(task / "metadata.jsonl", "w") as fh:
        for k in range(2):
            img = (np.random.default_rng(k).random((32, 32, 3)) * 255
                   ).astype(np.uint8)
            Image.fromarray(img).save(task / "img" / f"k{k}.png")
            fh.write(json.dumps({"key": f"k{k}", "image": f"k{k}.png",
                                 "prompt": f"edit {k}"}) + "\n")

    common = ["--preset", "tiny", "--random_weights", "--device", "cpu",
              "--threshold", "0.0", "--erosion_dilation", "False",
              "--evaluation", "--eval_dir", str(tmp_path / "bench"),
              "--size_level", "32"]
    tcli.main(common + ["--output_dir", str(tmp_path / "vanilla")])
    tcli.main(common + ["--use_regione",
                        "--output_dir", str(tmp_path / "regione")])

    # pixel metrics (LPIPS over seeded weights, on the CPU) + merge
    monkeypatch.setattr(metrics, "_LPIPS_PARAMS", {})
    res = run_metrics.main([
        "--folder1", str(tmp_path / "vanilla"), "--folder2",
        str(tmp_path / "regione"), "--device", "cpu", "--lpips_weights",
        str(_seeded_lpips_npz(tmp_path / "lpips.npz"))])
    assert len(res["TE"]) == 2
    for row in res["TE"]:
        a = np.asarray(Image.open(tmp_path / "vanilla" / "TE" /
                                  "generation" / row["file"]))
        b = np.asarray(Image.open(tmp_path / "regione" / "TE" /
                                  "generation" / row["file"]))
        assert row["psnr"] == metrics.psnr(a, b)
        assert np.isfinite(row["lpips"]) and row["lpips"] >= 0
    text = merge.merge_direction(str(tmp_path / "regione"))
    lat = json.load(open(tmp_path / "regione" / "TE" /
                         "time_consuming.json"))["time_consuming_list"]
    assert "PSNR:" in text and "Prompts: 2" in text
    assert f"Latency: {np.mean(lat):.4f}" in text

    # VIEScore dry-run sweep + stats (reference run_gedit_score)
    stats = run_viescore.main(["--data_dir", str(tmp_path / "bench"),
                               "--gen_root", str(tmp_path / "regione"),
                               "--backbone", "dryrun", "--device", "cpu"])
    csvp = tmp_path / "regione" / "TE" / "dryrun_vie_score.csv"
    assert csvp.exists()
    assert analyze_scores([str(csvp)]) == stats
    assert stats["n"] == 2 and 0 <= stats["overall"]["o"] <= 10
    rows = list(csv.DictReader(open(csvp)))
    assert [r["key"] for r in rows] == ["k0", "k1"]
    assert stats["overall"]["o"] == pytest.approx(
        np.mean([float(r["o"]) for r in rows]))
