"""The readings that the limits of `correct` are set from: a cell's
program and its control over many seeds in one process (the process start,
the kernels' build and the card's warm-up paid once).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13
        [--control] [--seconds 1] [--out build/perfbench/cal.jsonl]

Each seed is a whole run (`harness.run_once`: weights, requests, probe,
warm-up, a short window, the reference), with the program in the timed
path, or with `--control` the reference in the precision below the
configuration's (`config["control"]`).  Prints one JSON line per seed:
the checks' readings, the partition's margin (the smallest distance of a
token's cosine from the threshold, in the reference) and the edited
counts; then the largest reading of each check over the seeds.  Not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    system = "control" if args.control else "program"
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run_once(args.workload, seed, args.seconds, False, t,
                             system=system)
        row = {"workload": args.workload, "system": system, "seed": seed,
               "correct": r["correct"],
               **{k: v[0] for k, v in r["checks"].items()},
               "margin": r["_info"]["margin"],
               "edited": r["_info"]["edited"],
               "ref_s": r["_info"]["ref_s"],
               "setup_s": r["metrics"]["setup_s"]["value"],
               "edit_s": r["metrics"]["edit_s"]["value"],
               "run_s": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del r
        gc.collect()
        torch.cuda.empty_cache()
    worst = {k: max(r[k] for r in rows)
             for k in ("plan_diff", "latent_err", "token_err")}
    least = {k: min(r[k] for r in rows) for k in ("latent_err", "token_err")}
    print(json.dumps({"workload": args.workload, "system": system,
                      "seeds": len(rows), "max": worst, "min": least,
                      "min_margin": min(r["margin"] for r in rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
