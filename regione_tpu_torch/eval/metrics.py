"""Pixel metrics: PSNR / SSIM / LPIPS between paired output folders.

The port's copy of `regione_tpu/eval/metrics.py` (the reference's
evaluation/metric_all_task.py:12-202): compares same-named files in a
vanilla folder vs. a RegionE folder, resizing on mismatch, and writes
per-task metric.csv with an AVERAGE row.

PSNR/SSIM are numpy (dtype-faithful to skimage.metrics defaults for uint8
inputs: data_range 255, SSIM with gaussian_weights=False, 7x7 uniform
window, K1=0.01, K2=0.03).  LPIPS (AlexNet) resolves in order: the `lpips`
package if installed; else the port's own implementation
(eval/lpips_torch.py) with the weights `$REGIONE_LPIPS_WEIGHTS` points to,
on `device` (default the card; a CUDA device with no card raises); else
NaN.
"""

from __future__ import annotations

import csv
import math
import os
from pathlib import Path

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(data_range ** 2 / mse)


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable uniform filter with edge padding (scipy-free); borders are
    cropped by the caller so the padding mode does not affect results."""
    pad = size // 2
    for axis in (0, 1):
        xp = np.take(x, np.clip(np.arange(-pad, x.shape[axis] + pad),
                                0, x.shape[axis] - 1), axis=axis)
        c = np.cumsum(xp, axis=axis, dtype=np.float64)
        zeros_shape = list(c.shape)
        zeros_shape[axis] = 1
        c = np.concatenate([np.zeros(zeros_shape), c], axis=axis)
        hi = np.take(c, np.arange(size, c.shape[axis]), axis=axis)
        lo = np.take(c, np.arange(0, c.shape[axis] - size), axis=axis)
        x = (hi - lo) / size
    return x


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0,
         win: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM, channel-averaged, uniform 7x7 window (skimage defaults
    for multichannel uint8 images as used by the reference,
    evaluation/metric_all_task.py)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    vals = []
    # cov normalization as skimage: unbiased (N/(N-1)) with N = win^2
    np_ = win * win
    cov_norm = np_ / (np_ - 1)
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        ux = _uniform_filter(x, win)
        uy = _uniform_filter(y, win)
        uxx = _uniform_filter(x * x, win)
        uyy = _uniform_filter(y * y, win)
        uxy = _uniform_filter(x * y, win)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
            (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
        pad = (win - 1) // 2
        s = s[pad:s.shape[0] - pad, pad:s.shape[1] - pad]
        vals.append(s.mean())
    return float(np.mean(vals))


_LPIPS_MODEL = None
_LPIPS_PARAMS = {}      # (weights path, device) -> params on that device


def lpips_distance(a: np.ndarray, b: np.ndarray, device="cuda") -> float:
    """LPIPS(alex): lpips package -> the port's LPIPS on `device`
    ($REGIONE_LPIPS_WEIGHTS .npz from eval.lpips_torch.save_lpips_npz or
    the JAX package's save_lpips_npz) -> NaN.  A CUDA device with no card
    raises instead of measuring on the CPU."""
    global _LPIPS_MODEL
    import torch
    try:
        import lpips  # type: ignore
        if _LPIPS_MODEL is None:
            _LPIPS_MODEL = lpips.LPIPS(net="alex")
        ta = torch.from_numpy(np.asarray(a, np.float32) / 127.5 - 1.0
                              ).permute(2, 0, 1)[None]
        tb = torch.from_numpy(np.asarray(b, np.float32) / 127.5 - 1.0
                              ).permute(2, 0, 1)[None]
        with torch.no_grad():
            return float(_LPIPS_MODEL(ta, tb).item())
    except Exception:
        pass
    weights = os.environ.get("REGIONE_LPIPS_WEIGHTS")
    if weights and os.path.exists(weights):
        from . import resolve_device
        from .lpips_torch import load_lpips_npz, lpips_pair_uint8
        dev = resolve_device(device)    # raises with no card: never the CPU
        try:
            key = (weights, str(dev))
            if key not in _LPIPS_PARAMS:
                _LPIPS_PARAMS[key] = load_lpips_npz(weights, device=dev)
            return lpips_pair_uint8(_LPIPS_PARAMS[key], a, b)
        except Exception:
            return float("nan")
    return float("nan")


def _load(path: Path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _resize_like(img: np.ndarray, ref: np.ndarray) -> np.ndarray:
    if img.shape == ref.shape:
        return img
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize(
        (ref.shape[1], ref.shape[0])))


def calculate_image_metrics(folder1: str, folder2: str,
                            with_lpips: bool = True,
                            device="cuda") -> list[dict]:
    """Pairwise metrics over same-named files (reference
    metric_all_task.py:12-143); LPIPS on `device`."""
    f1, f2 = Path(folder1), Path(folder2)
    names = sorted(set(os.listdir(f1)) & set(os.listdir(f2)))
    rows = []
    for name in names:
        if not name.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
            continue
        a = _load(f1 / name)
        b = _resize_like(_load(f2 / name), a)
        rows.append({
            "file": name,
            "psnr": psnr(a, b),
            "ssim": ssim(a, b),
            "lpips": (lpips_distance(a, b, device) if with_lpips
                      else float("nan")),
        })
    return rows


def save_results_to_csv(rows: list[dict], out_csv: str):
    """Per-file rows + AVERAGE row, in the REFERENCE's column schema
    (`Filename,PSNR,SSIM,LPIPS`, metric_all_task.py:145-178) so the
    reference's metric_merge.py — which indexes those exact column names
    on the tail row (metric_merge.py:40-41) — runs unchanged on our
    outputs."""
    Path(out_csv).parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["Filename", "PSNR", "SSIM", "LPIPS"])
        for r in rows:
            w.writerow([r["file"], f"{r['psnr']:.4f}", f"{r['ssim']:.4f}",
                        f"{r['lpips']:.4f}"])
        if rows:
            w.writerow([
                "AVERAGE",
                f"{np.mean([r['psnr'] for r in rows]):.4f}",
                f"{np.mean([r['ssim'] for r in rows]):.4f}",
                f"{np.nanmean([r['lpips'] for r in rows]):.4f}",
            ])


def run_all_tasks(folder1: str, folder2: str, out_dir: str | None = None,
                  with_lpips: bool = True, device="cuda"):
    """Walk matching task subdirs of two roots (reference
    metric_all_task.py:182-202): <root>/<task>/generation/*.png."""
    root1, root2 = Path(folder1), Path(folder2)
    out_root = Path(out_dir or folder2)
    results = {}
    for task in sorted(p.name for p in root1.iterdir() if p.is_dir()):
        g1, g2 = root1 / task / "generation", root2 / task / "generation"
        if not (g1.is_dir() and g2.is_dir()):
            continue
        rows = calculate_image_metrics(str(g1), str(g2), with_lpips, device)
        save_results_to_csv(rows, str(out_root / task / "metric.csv"))
        results[task] = rows
    return results
