"""One benchmark cell's traced cycle on the card, counted: what the RAGS
graphs change in the device trace, the memory and the set-up.

    python3 <this file> --workload step1x-edit.local-512 --seed <n>

Run it from the root of the checkout to measure (it imports that
checkout's port and `perfbench/`), so that one copy of it measures two
checkouts in turn.  It builds the cell as `perfbench/run.py` does (the
weights and requests from the seed, the probe, the program, one warm-up
edit of each request, each timed: the change captures its graphs there),
then runs one cycle of the pool under `torch.profiler` with CUDA activity
alone, as the benchmark's `--trace 1` does, and prints one JSON line: the
card and its power limit, the traced cycle's kernel launches (in all and
by kernel group of `perfbench/kernel_groups`) with their seconds, its
copies and fills, the warm-up edits' seconds, `torch.cuda`'s reserved
bytes after the warm-up and after the cycle with the peak of each, and the
program's `pipeline.rags_graph` counts over the cycle where it has them.
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import devtrace, harness, inputs  # noqa: E402
from regione_tpu_torch.utils import telemetry  # noqa: E402


def power_limit() -> str:
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    return "unknown"


def rags_graph_counts():
    """The recorded edits' `pipeline.rags_graph.<count>` attrs, summed over
    their `pipeline.edit` spans, or None where the program stores none (a
    parent)."""
    edits = [s for s in telemetry.spans() if s.name == "pipeline.edit"]
    prefix = "pipeline.rags_graph."
    keys = [k for k in (edits[0].attrs if edits else ()) if
            k.startswith(prefix)]
    if not keys:
        return None
    return {k[len(prefix):]: sum(s.attrs[k] for s in edits) for k in keys}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    dev = "cuda"
    c = harness.load_cell(harness.Paths(), args.workload)
    config, mix, ref_mod = c["config"], c["mix"], c["reference"]
    gen = harness.generator(dev, args.seed)
    weights = inputs.make_weights(config, gen, dev, c["layout"])
    reqs = inputs.make_requests(config, mix, args.seed, gen, dev)
    probe_ref = ref_mod.Reference(config, weights, mix["grid"], dev)
    for r in reqs:
        inputs.probe(probe_ref, r, mix["probe_iters"])
    del probe_ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sut = harness.Program(config, weights, mix["grid"], dev)
    out = {"workload": args.workload, "seed": args.seed,
           "card": power_limit(), "root": ROOT.name}
    warm = []
    with torch.inference_mode():
        for r in reqs:
            t = time.perf_counter()
            sut.edit(r)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t)
    out["warmup_edit_s"] = warm
    out["after_warmup"] = {
        "reserved": torch.cuda.memory_reserved(),
        "max_reserved": torch.cuda.max_memory_reserved(),
        "max_allocated": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    telemetry.clear()
    from torch.profiler import ProfilerActivity, profile
    trace_path = ROOT / "build" / "rags_graph_check" / "trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            torch.inference_mode():
        t = time.perf_counter()
        for r in reqs:
            sut.edit(r)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t
    prof.export_chrome_trace(str(trace_path))
    out["cycle"] = {
        "reserved": torch.cuda.memory_reserved(),
        "max_reserved": torch.cuda.max_memory_reserved(),
        "max_allocated": torch.cuda.max_memory_allocated(),
        "rags_graph": rags_graph_counts()}
    raw = devtrace.read_chrome_trace(trace_path)
    trace_path.unlink()
    groups = devtrace.load_groups()
    counts: dict = {}
    for name, cat, _, _ in raw["device"]:
        g = devtrace.group_of(name, groups) if cat == "kernel" else cat
        counts[g] = counts.get(g, 0) + 1
    summary = devtrace.summarize(raw, groups, window_s)
    out["trace"] = {
        "kernels": sum(n for g, n in counts.items()
                       if g not in devtrace.DEVICE_CATS),
        "count_by_group": counts, "s_by_group": summary["by_group"],
        "busy_s": summary["busy_s"], "window_s": window_s,
        "idle_gaps": devtrace.top(summary["gaps"], 6)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
