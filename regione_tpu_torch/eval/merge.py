"""Aggregate per-task metric.csv + time_consuming.json into merged_metric.txt.

The port's copy of `regione_tpu/eval/merge.py` (the reference's
evaluation/metric_merge.py:6-123): item-weighted averaging of
PSNR/SSIM/LPIPS across tasks plus mean latency; "Pretrain" (vanilla)
result dirs get identity metrics (PSNR=inf, SSIM=1, LPIPS=0).
Works for both GEdit-Bench (11 tasks) and Kontext-Bench (5 tasks) layouts.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np


def _read_metric_csv(path: Path) -> dict | None:
    """Read a metric.csv in EITHER schema: the reference's
    (`Filename,PSNR,SSIM,LPIPS`, metric_all_task.py:145-178 — also what
    our writer emits) or this repo's pre-r4 lowercase header.  A file in
    neither schema is an ERROR, never silently skipped."""
    if not path.exists():
        return None
    rows = list(csv.DictReader(open(path)))
    if not rows:
        return None

    def col(r, *names):
        for n in names:
            if n in r:
                return r[n]
        raise ValueError(f"{path}: no {'/'.join(names)} column "
                         f"(found {sorted(rows[0])})")

    data = [r for r in rows if col(r, "Filename", "file") != "AVERAGE"]
    if not data:
        return None
    return {
        "n": len(data),
        "psnr": float(np.mean([float(col(r, "PSNR", "psnr"))
                               for r in data])),
        "ssim": float(np.mean([float(col(r, "SSIM", "ssim"))
                               for r in data])),
        "lpips": float(np.nanmean([float(col(r, "LPIPS", "lpips"))
                                   for r in data])),
    }


def _read_times(path: Path) -> dict | None:
    """Read a time_consuming.json in EITHER schema: the reference's
    (ave_time_consuming/time_consuming_list, src/Step1X-Edit/main.py:125)
    or this repo's short aliases (ave/list).  A file in neither schema is
    an ERROR, never a silent latency of 0.0."""
    if not path.exists():
        return None
    d = json.load(open(path))
    lst = d.get("time_consuming_list", d.get("list"))
    ave = d.get("ave_time_consuming", d.get("ave"))
    if ave is None and lst:
        ave = float(np.mean(lst))
    if ave is None:
        raise ValueError(
            f"{path}: no ave_time_consuming/ave or time_consuming_list/list "
            f"key (found {sorted(d)}); refusing to fabricate latency 0.0")
    n = d.get("num_item", len(lst) if lst is not None else None)
    if n is None:
        raise ValueError(f"{path}: no num_item or timing list to count")
    return {"n": n, "ave": float(ave)}


def merge_direction(direction: str, is_pretrain: bool = False) -> str:
    """Merge all task dirs under `direction`; writes merged_metric.txt there
    and returns its contents (reference metric_merge.py:6-123)."""
    root = Path(direction)
    total_n = 0
    acc = {"psnr": 0.0, "ssim": 0.0, "lpips": 0.0}
    lat_n, lat_acc = 0, 0.0
    for task in sorted(p for p in root.iterdir() if p.is_dir()):
        m = _read_metric_csv(task / "metric.csv")
        t = _read_times(task / "time_consuming.json")
        if is_pretrain and m is None and t is not None:
            m = {"n": t["n"], "psnr": float("inf"), "ssim": 1.0, "lpips": 0.0}
        if m:
            total_n += m["n"]
            for k in acc:
                acc[k] += m[k] * m["n"]
        if t:
            lat_n += t["n"]
            lat_acc += t["ave"] * t["n"]
    lines = []
    if total_n:
        lines += [f"PSNR: {acc['psnr'] / total_n:.4f}",
                  f"SSIM: {acc['ssim'] / total_n:.4f}",
                  f"LPIPS: {acc['lpips'] / total_n:.4f}",
                  f"Prompts: {total_n}"]
    if lat_n:
        lines.append(f"Latency: {lat_acc / lat_n:.4f}")
    text = "\n".join(lines) + "\n"
    (root / "merged_metric.txt").write_text(text)
    return text


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--direction", required=True)
    ap.add_argument("--pretrain", action="store_true")
    args = ap.parse_args(argv)
    print(merge_direction(args.direction, args.pretrain))


if __name__ == "__main__":
    main()
