"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, the metrics, the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything a cell is made of is found by name: the cell in
`BENCHMARK.json` names its configuration (the file its entry gives) and
its traffic (`mixes/<traffic>.json`); the configuration names its plain
reference (`reference/<name>.py`, `sampler` where it names none; see
`reference/__init__.py`); its limits are `limits/<cell>.json`; each
metric is read by `end_to_end/<name>.py` or `metrics/<name>.py` (a
`read(run)` returning a number or None), each kernel group is
`kernel_groups/*.json`.

Set-up: the weights and the requests from the seed (`inputs`), each
request's condition latent by the probe over the reference's plain
forward, the program built over those weights, one warm-up edit of every
request (every shape the window uses).  The window: the pool's requests
back to back, one at a time, each ended by `torch.cuda.synchronize()`
(the client has its latents), whole cycles of the pool until `--seconds`
have passed.  With `--trace 1` the window is one cycle under
`torch.profiler`, with CUDA-event spans around every edit and every
forward hook of the pipeline.

Then the program is freed, the weights are drawn again from the seed, and
the reference edits every request of the pool: each edit of the window is
compared with its request's reference edit (see `compare`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import devtrace, guard, inputs, reference

PB = Path(__file__).resolve().parent
ROOT = PB.parent
STAT_KEYS = ("edited_tokens", "capacity", "dense_steps", "rags_steps",
             "reuse_steps")
TRACE_DIR = ROOT / "build" / "perfbench"


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Paths:
    """Where a run finds its cells and the files they name."""
    bench: Path = ROOT / "BENCHMARK.json"
    root: Path = ROOT
    mixes: Path = PB / "mixes"
    limits: Path = PB / "limits"
    metrics: Path = PB / "metrics"
    end_to_end: Path = PB / "end_to_end"
    groups: Path = PB / "kernel_groups"


def load_cell(paths: Paths, workload: str) -> dict:
    spec = json.loads(paths.bench.read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in {paths.bench.name}")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    metrics = []
    for k in ("end_to_end", "per_layer"):
        for mt in spec[k]:
            if cell["name"] in mt.get("workloads", [cell["name"]]):
                metrics.append((k, mt))
    config = json.loads((paths.root / conf["file"]).read_text())
    ref_mod = reference.load(config)
    mix = json.loads((paths.mixes / f"{cell['traffic']}.json").read_text())
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise SystemExit(f"mix {cell['traffic']!r}: the window drives one "
                         "client in a closed loop")
    return {"cell": cell,
            "config": config,
            "reference": ref_mod,
            "layout": getattr(ref_mod, "layout", inputs.layout)(config),
            "mix": mix,
            "limits": json.loads((paths.limits / f"{workload}.json")
                                 .read_text()),
            "metrics": metrics}


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the systems a window can drive
# ---------------------------------------------------------------------------

class Program:
    """The port: `PIPELINES[backend]` over its `MMDiT`, the weights handed
    in as views (no copy), the RegionE knobs and the gamma table from the
    configuration file.  `spans`: a list to which every dense / RAGS hook
    call appends (kind, start event, end event)."""

    def __init__(self, config: dict, weights: dict, grid: int, device,
                 spans: list | None = None):
        from regione_tpu_torch.core.config import RegionEParams
        from regione_tpu_torch.models.connector import ConnectorConfig
        from regione_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
        from regione_tpu_torch.pipelines import PIPELINES
        from regione_tpu_torch.pipelines.base import EditInputs
        self._inputs = EditInputs
        dt = getattr(torch, config["dtype"])
        m = dict(config["model"])
        conn = m.pop("connector", None)
        m["axes_dims"] = tuple(m["axes_dims"])
        cfg = MMDiTConfig(**m, dtype=dt, connector=None if conn is None
                          else ConnectorConfig(**conn, dtype=dt))
        model = MMDiT(cfg, "meta")
        model.load_state_dict(weights, strict=True, assign=True)
        model.eval()
        re = RegionEParams(**config["regione"])
        self.pipe = PIPELINES[config["backend"]](
            model, re, gamma=np.asarray(config["gamma"], np.float16),
            **config["pipeline_args"])
        self.grid = grid
        self.rope = self.pipe.build_rope(grid, grid,
                                         config["text"]["t_txt"])
        if spans is not None:
            for kind in ("dense", "rags"):
                hook = getattr(self.pipe, f"{kind}_forward")
                setattr(self.pipe, f"{kind}_forward",
                        _spanned(hook, kind, spans))

    def edit(self, req):
        ctx = self._inputs(txt=req.txt, cond_latent=req.cond,
                           rope_img=self.rope[0], rope_txt=self.rope[1],
                           pooled=req.pooled, guidance=req.guidance)
        out, st = self.pipe.edit_latents(req.noise, ctx, self.grid,
                                         self.grid)
        return out, {k: int(getattr(st, k)) for k in STAT_KEYS}


def _spanned(hook, kind: str, spans: list):
    def call(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = hook(*args, **kw)
        e1.record()
        spans.append((kind, e0, e1))
        return out
    return call


class Control:
    """The reference in the program's place, its linears computed in the
    precision below the configuration's (`config["control"]`).
    `ref_mod`: the configuration's reference module."""

    def __init__(self, config: dict, weights: dict, grid: int, device,
                 ref_mod):
        lower = getattr(torch, config["control"])
        self.ref = ref_mod.Reference(config, weights, grid, device,
                                     lower=lower)

    def edit(self, req):
        out, info = self.ref.edit(req.noise, req.as_dict())
        return out, {k: info[k] for k in STAT_KEYS}


# ---------------------------------------------------------------------------
# the comparison that decides `correct`
# ---------------------------------------------------------------------------

def compare(out, ref, stats: dict, ref_info: dict) -> dict:
    """The numbers an edit is judged by:
      plan_diff:  |program's plan statistics - the reference's|, summed
                  (edited tokens, capacity bucket, dense / RAGS / reuse
                  steps); exact;
      latent_err: ||out - ref|| / ||ref|| over the final latents;
      token_err:  the largest token's ||out_t - ref_t|| over the rms token
                  norm of ref (a token altered where it is produced)."""
    o, r = out.double().reshape(-1, out.shape[-1]), \
        ref.double().reshape(-1, ref.shape[-1])
    d = (o - r).norm(dim=-1)
    rms = r.norm(dim=-1).pow(2).mean().sqrt()
    return {"plan_diff": float(sum(abs(stats[k] - ref_info[k])
                                   for k in STAT_KEYS)),
            "latent_err": float((o - r).norm() / r.norm()),
            "token_err": float(d.max() / rms)}


def judge(readings: list[dict], limits: dict) -> tuple[dict, int, bool]:
    """(checks {name: [worst reading, limit]}, failed edits, correct)."""
    checks = {}
    for name, limit in limits.items():
        vals = [r[name] for r in readings]
        worst = max(vals, key=lambda v: math.inf if math.isnan(v) else v)
        checks[name] = [worst, limit]
    failed = sum(any(not r[n] <= limits[n] for n in limits)
                 for r in readings)
    ok = bool(readings) and failed == 0
    return checks, failed, ok


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2**63)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_once(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, *, paths: Paths = Paths(), device="cuda",
             system: str = "program") -> dict:
    """Set-up, window, comparison; returns the result line's dict, with
    "_info" (numbers for the log).  `system`: "program", or "control" (the
    reference in the precision below the configuration's)."""
    c = load_cell(paths, workload)
    config, mix, ref_mod, lay = (c["config"], c["mix"], c["reference"],
                                 c["layout"])
    grid = mix["grid"]
    on_card = torch.device(device).type == "cuda"
    traced = trace and on_card

    t = time.perf_counter()
    gen = generator(device, seed)
    weights = inputs.make_weights(config, gen, device, lay)
    reqs = inputs.make_requests(config, mix, seed, gen, device)
    sync(device)
    setup = {"weights_s": time.perf_counter() - t}
    t = time.perf_counter()
    probe_ref = ref_mod.Reference(config, weights, grid, device)
    for r in reqs:
        inputs.probe(probe_ref, r, mix["probe_iters"])
    del probe_ref
    sync(device)
    setup["probe_s"] = time.perf_counter() - t
    if on_card:      # the program's peak, not the probe's
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    spans: list | None = [] if traced else None
    if system == "program":
        sut = Program(config, weights, grid, device, spans)
    else:
        sut = Control(config, weights, grid, device, ref_mod)
    setup["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if system == "program":       # the control builds and compiles nothing
        with torch.inference_mode():
            for r in reqs:
                sut.edit(r)
    sync(device)
    setup["warmup_s"] = time.perf_counter() - t
    if spans is not None:
        spans.clear()
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    edits, outs, edit_spans = [], [], []
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
    else:
        prof = contextlib.nullcontext()
    # what set-up made stays out of the collector's scans: a full
    # collection over the weights' and modules' objects would land in
    # whichever edit triggers it
    gc.collect()
    gc.freeze()
    with prof, torch.inference_mode():
        sync(device)
        t0 = time.perf_counter()
        while True:
            for r in reqs:
                if traced:
                    n0 = len(spans)
                    e0, e1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    e0.record()
                te = time.perf_counter()
                out, stats = sut.edit(r)
                if traced:
                    e1.record()
                sync(device)
                edits.append({"request": r.index, "stats": stats,
                              "wall_s": time.perf_counter() - te})
                outs.append(out)
                if traced:
                    edit_spans.append((e0, e1, spans[n0:]))
            if trace or time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    gc.unfreeze()
    setup_s = t0 - t_start
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    raw = None
    if traced:
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / "trace.json"
        prof.export_chrome_trace(str(path))
        raw = devtrace.read_chrome_trace(path)
        path.unlink()
    span_ms = [{"edit_ms": e0.elapsed_time(e1),
                "forwards": [(k, a.elapsed_time(b)) for k, a, b in fw]}
               for e0, e1, fw in edit_spans]
    banned = guard.banned_modules()
    if banned:
        raise guard.Banned(banned)

    # free the program, draw the weights again, run the reference
    del sut, weights, spans, edit_spans, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    readings, ref_info = reference_readings(ref_mod, lay, config, grid,
                                            device, seed, reqs, outs, edits)
    ref_s = time.perf_counter() - t
    checks, failed, ok = judge(readings, c["limits"])

    run = RunRecord(config=config, mix=mix, grid=grid, edits=edits,
                    window_s=window_s, setup_s=setup_s,
                    peak_window_bytes=peak_window, spans=span_ms,
                    trace=None, groups=devtrace.load_groups(paths.groups))
    result = {"correct": ok, "attempted": len(edits), "failed": failed,
              "metrics": {}, "device": device_info(
                  device, max(peak_setup, peak_window))}
    if raw is not None:
        run.trace = devtrace.summarize(raw, run.groups, window_s)
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = window_s
        result["breakdown"] = {
            "device_ops": devtrace.top(run.trace["by_name"]),
            "idle_gaps": devtrace.top(run.trace["gaps"])}
    want = "per_layer" if trace else "end_to_end"
    for kind, mt in c["metrics"]:
        if kind != want:
            continue
        folder = paths.metrics if kind == "per_layer" else paths.end_to_end
        val = load_reader(folder / f"{mt['name']}.py")(run)
        if val is not None:
            result["metrics"][mt["name"]] = {"value": val,
                                             "unit": mt["unit"]}
    result["checks"] = checks
    result["_info"] = {
        **setup, "ref_s": ref_s, **ref_info,
        "edit_wall_s": [e["wall_s"] for e in edits],
        "kernel_s_by_group": run.trace and run.trace["by_group"]}
    return result


def reference_readings(ref_mod, lay, config, grid, device, seed, reqs,
                       outs, edits):
    """The reference edit (`ref_mod.Reference`) of every request of the
    pool, over the weights drawn again from the seed in the layout `lay`,
    and each window edit's readings against its request's.  Returns
    (readings, {"margin", "edited"})."""
    ref = ref_mod.Reference(config, inputs.make_weights(
        config, generator(device, seed), device, lay), grid, device)
    refs, margin = {}, math.inf
    with torch.inference_mode():
        for r in reqs:
            lat, info = ref.edit(r.noise, r.as_dict())
            refs[r.index] = (lat, info)
            margin = min(margin, float(
                (info["cos"] - ref.knobs.threshold).abs().min()))
    readings = []
    for o, e in zip(outs, edits):
        lat, info = refs[e["request"]]
        readings.append(compare(o, lat, e["stats"], info))
    sync(device)
    return readings, {"margin": margin,
                      "edited": [refs[r.index][1]["edited_tokens"]
                                 for r in reqs]}


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader gets.  `edits`: one dict per edit of the
    window (request, stats, wall_s); `spans` (--trace 1): per edit
    {"edit_ms", "forwards": [(kind, ms)]} from CUDA events; `trace`
    (--trace 1): `devtrace.summarize` of the device trace."""
    config: dict
    mix: dict
    grid: int
    edits: list
    window_s: float
    setup_s: float
    peak_window_bytes: int
    spans: list
    trace: dict | None
    groups: list


def device_info(device, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result
    line as the last line of standard output (checks its last key)."""
    info = result.pop("_info", {})
    log("info " + json.dumps(info))
    for name, (val, lim) in result["checks"].items():
        log(f"check {name} {val!r} limit {lim!r}")
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    paths = Paths()
    cell = load_cell(paths, args.workload)["cell"]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = run_once(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start, paths=paths)
        banned = guard.banned_modules()
        if banned:
            raise guard.Banned(banned)
    except guard.Banned as exc:
        log(str(exc))
        return 3
    emit(result)
    return 0
