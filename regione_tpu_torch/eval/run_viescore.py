"""CLI for the VIEScore sweep (reference run_gedit_score.py:68-166).

    python -m regione_tpu_torch.eval.run_viescore --data_dir <bench root> \\
        --gen_root <results root> --backbone dryrun

Walks every task dir under --data_dir (each with metadata.jsonl + a
generation/ folder of edited images), scores SC/PQ/O per item with the
selected backbone, resumes per-task if the CSV already exists, and prints
the aggregated statistics.  The local judges run on `--device` (default
cuda; with no card the run stops: pass `--device cpu`)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from regione_tpu_torch.eval.viescore import (VIEScore, make_backbone,
                                             run_task, write_score_artifacts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True,
                    help="processed benchmark root (tasks with metadata.jsonl)")
    ap.add_argument("--gen_root", default=None,
                    help="results root holding <task>/generation; defaults "
                         "to --data_dir")
    ap.add_argument("--backbone", default="gpt4o",
                    choices=["gpt4o", "gpt4v", "gemini", "idefics2", "mantis",
                             "minicpmv", "qwen25vl", "dryrun"])
    ap.add_argument("--model_name", default=None,
                    help="API model id override (gpt4o/gpt4v/gemini)")
    ap.add_argument("--key_path", default=None)
    ap.add_argument("--vlm_path", default=None,
                    help="local VLM checkpoint dir (idefics2/mantis/"
                         "minicpmv/qwen25vl backbones)")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--language", default="en",
                    help="instruction language the statistics keep "
                         "(reference calculate_statistics.py:34 filters "
                         "to the run's language; pass 'all' to keep "
                         "every row, e.g. for a cn GEdit sweep scored "
                         "together with en)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of a local judge (default cuda)")
    ap.add_argument("--max_new_tokens", type=int, default=400,
                    help="generation budget of a local judge's reply")
    args = ap.parse_args(argv)

    backbone = make_backbone(args.backbone, key_path=args.key_path,
                             model_name=args.model_name,
                             vlm_path=args.vlm_path, device=args.device,
                             max_new_tokens=args.max_new_tokens)
    scorer = VIEScore(backbone)

    root = Path(args.data_dir)
    gen_root = Path(args.gen_root or args.data_dir)
    csvs = []
    for task in sorted(p for p in root.iterdir() if p.is_dir()):
        if not (task / "metadata.jsonl").exists():
            continue
        gen = gen_root / task.name / "generation"
        if not gen.is_dir():
            continue
        out_csv = gen_root / task.name / f"{args.backbone}_vie_score.csv"
        rows = run_task(scorer, str(task), str(gen), str(out_csv),
                        workers=args.workers)
        csvs.append(str(out_csv))
        print(f"{task.name}: {len(rows)} scored")
    stats = write_score_artifacts(
        csvs, str(gen_root), args.backbone,
        language=None if args.language == "all" else args.language)
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
