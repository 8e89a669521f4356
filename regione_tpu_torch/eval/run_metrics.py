"""CLI for the per-task pixel metrics (reference metric_all_task.py:182-202).

    python -m regione_tpu_torch.eval.run_metrics --folder1 <vanilla root> \\
        --folder2 <RegionE root> [--lpips_weights w.npz] [--device cpu]

LPIPS runs on `--device` (default cuda; with no card the run stops: pass
`--device cpu` to compute it on the CPU)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from regione_tpu_torch.eval.metrics import run_all_tasks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--folder1", required=True, help="vanilla results root")
    ap.add_argument("--folder2", required=True, help="RegionE results root")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--no_lpips", action="store_true")
    ap.add_argument("--lpips_weights", default=None,
                    help=".npz from eval.lpips_torch.save_lpips_npz (same "
                         "as $REGIONE_LPIPS_WEIGHTS); enables the port's "
                         "LPIPS when the lpips package is absent")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the LPIPS network (default cuda)")
    args = ap.parse_args(argv)
    if args.lpips_weights:
        os.environ["REGIONE_LPIPS_WEIGHTS"] = args.lpips_weights
    res = run_all_tasks(args.folder1, args.folder2, args.out_dir,
                        with_lpips=not args.no_lpips, device=args.device)
    for task, rows in res.items():
        if rows:
            print(f"{task}: n={len(rows)} "
                  f"psnr={np.mean([r['psnr'] for r in rows]):.3f} "
                  f"ssim={np.mean([r['ssim'] for r in rows]):.4f}")
    return res


if __name__ == "__main__":
    main()
