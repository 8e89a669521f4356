"""The device trace of a `--trace 1` run: `torch.profiler`'s CUDA activity
over the traced edits, read from its chrome trace.

Kernel groups are data: every `kernel_groups/*.json` holds
{"group": name, "priority": n, "patterns": [regex, ...]}; a kernel belongs
to the group of the first file, by (priority, file name), with a pattern
found in its name (case ignored), else to "other".  A kernel added by a
later change gets a pattern file of its own.  (The grouping and the idle
share were `chip_smoke.py`'s `_kernel_group` and `profile_run`.)

The device is busy where any kernel, copy or fill runs: the union of their
intervals, so overlapping streams count once.  An idle gap is named by the
runtime call the host was in when the device ran dry (a synchronize, a
copy), else "host", and by the kernel group that ended it.
"""

from __future__ import annotations

import bisect
import json
import re
from pathlib import Path

GROUPS_DIR = Path(__file__).resolve().parent / "kernel_groups"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def load_groups(root: Path = GROUPS_DIR) -> list[tuple[str, list]]:
    """[(group, [compiled patterns])] in matching order."""
    files = []
    for f in sorted(root.glob("*.json")):
        spec = json.loads(f.read_text())
        files.append((spec.get("priority", 100), f.name, spec["group"],
                      [re.compile(p, re.IGNORECASE)
                       for p in spec["patterns"]]))
    return [(g, pats) for _, _, g, pats in sorted(files)]


def group_of(name: str, groups) -> str:
    for g, pats in groups:
        if any(p.search(name) for p in pats):
            return g
    return "other"


def read_chrome_trace(path) -> dict:
    """{"device": [(name, cat, start_us, dur_us)], "runtime": [(name,
    start_us, dur_us)]} of a chrome trace, each sorted by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, rt = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((ev["name"], cat, float(ev["ts"]),
                        float(ev.get("dur", 0.0))))
        elif cat in RUNTIME_CATS:
            rt.append((ev["name"], float(ev["ts"]), float(ev.get("dur", 0.0))))
    dev.sort(key=lambda e: e[2])
    rt.sort(key=lambda e: e[1])
    return {"device": dev, "runtime": rt}


def busy_intervals(device) -> list[tuple[float, float]]:
    """The union of the device events' intervals, in us."""
    out: list = []
    for _, _, ts, dur in device:
        end = ts + dur
        if out and ts <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((ts, end))
    return out


def summarize(raw: dict, groups, window_s: float) -> dict:
    """Kernel seconds by group and by name, busy seconds, the device's
    span (first device event's start to last one's end, idle gaps
    inside it included) and the idle gaps by what the host was doing."""
    by_group: dict = {}
    by_name: dict = {}
    kernels = []
    for name, cat, ts, dur in raw["device"]:
        g = group_of(name, groups) if cat == "kernel" else cat
        by_group[g] = by_group.get(g, 0.0) + dur / 1e6
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        kernels.append((name, g, ts, dur))
    busy = busy_intervals(raw["device"])
    busy_s = sum(b - a for a, b in busy) / 1e6
    span_s = (busy[-1][1] - busy[0][0]) / 1e6 if busy else 0.0
    gaps: dict = {}
    rt = raw["runtime"]
    j = 0
    starts = [k[2] for k in kernels]
    for (a0, a1), (b0, _) in zip(busy, busy[1:]):
        while j < len(rt) and rt[j][1] + rt[j][2] < a1:
            j += 1
        host = "host"
        for name, ts, dur in rt[j:j + 64]:
            if ts > a1:
                break
            if ts + dur >= a1 and "Launch" not in name:
                host = name
                break
        nxt = _first_at(kernels, starts, b0)
        label = f"{host} before {nxt}"
        gaps[label] = gaps.get(label, 0.0) + (b0 - a1) / 1e6
    return {"by_group": by_group, "by_name": by_name, "busy_s": busy_s,
            "span_s": span_s, "window_s": window_s, "gaps": gaps}


def _first_at(kernels, starts, t: float) -> str:
    i = bisect.bisect_left(starts, t)
    return kernels[i][1] if i < len(kernels) else "end"


def top(d: dict, n: int = 10, width: int = 120) -> list:
    return [[k[:width], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
