"""What the port's spans cost, and where the device idles, in one cell of
the benchmark (`BENCHMARK.json`), on the card.

    python3 scripts/torch_span_cost.py --workload step1x-edit.local-512 \
        --seed 2147500001 [--pairs 6] [--window 10] [--out PATH]

Sets the cell up as `perfbench/run.py` does (weights and requests from the
seed, each request's condition latent by the probe, the program over the
weights, a warm-up edit of each request), then measures:

  * the on-cost: `edit_s` (a window of whole cycles of the pool over the
    edits in it, each edit ended by a synchronize) with spans recording
    (`telemetry.recording()`; no profiler, so no `record_function`) and
    off, in turns (on-off, off-on, ...), `--pairs` pairs of `--window`
    seconds each;
  * the idle by span: one cycle under `torch.profiler` with CUDA activity
    only, as the benchmark's traced run; its idle gaps
    (`telemetry.idle_by_span`) split by the forward or sampler segment
    they fall in and, within it, by the innermost span; each forward
    kind's mean host and device ms; the wrappers' host time per launch
    up to the launch call (`kernels.wrapper_host_us`) and of the launch
    call itself;
  * with `--variants N`, the recording's cost as the benchmark's traced
    run sees it: one cycle under a profile of CUDA activity alone with
    everything recording, without the spans' CUDA events, without the
    `model.*` block spans, without the wrappers' counters, and with
    nothing recording, in turns, N rounds: each cycle's wall time and
    device idle share;
  * the host cost of one `span()` call: off, on, on with CUDA events,
    under the profiler, and annotated inside `telemetry.trace`; the host
    time a launch of K7-K9, up to and of its launch call, with the launch
    queue kept short.

Prints one JSON line (also written to `--out`, default
`build/span_cost_<workload>.json`).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import harness, inputs  # noqa: E402
from perfbench.reference.sampler import Reference  # noqa: E402
from regione_tpu_torch.utils import telemetry  # noqa: E402

FORWARDS = ("pipeline.dense_forward", "pipeline.rags_forward")


def setup(workload: str, seed: int, device, paths=harness.Paths()):
    """(program, requests, config) of the cell, warmed up."""
    c = harness.load_cell(paths, workload)
    config, mix = c["config"], c["mix"]
    gen = harness.generator(device, seed)
    weights = inputs.make_weights(config, gen, device)
    reqs = inputs.make_requests(config, mix, seed, gen, device)
    probe_ref = Reference(config, weights, mix["grid"], device)
    for r in reqs:
        inputs.probe(probe_ref, r, mix["probe_iters"])
    del probe_ref
    prog = harness.Program(config, weights, mix["grid"], device)
    with torch.inference_mode():
        for r in reqs:
            prog.edit(r)
    harness.sync(device)
    return prog, reqs


def window(prog, reqs, seconds: float, device) -> float:
    """`edit_s` of one window of whole cycles of the pool."""
    n = 0
    with torch.inference_mode():
        harness.sync(device)
        t0 = time.perf_counter()
        while True:
            for r in reqs:
                prog.edit(r)
                harness.sync(device)
                n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return (time.perf_counter() - t0) / n


def quartiles(vals: list) -> dict:
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    return {"median": q2, "q1": q1, "q3": q3, "spread": (q3 - q1) / q2,
            "runs": vals}


def on_cost(prog, reqs, pairs: int, seconds: float, device) -> dict | None:
    if pairs == 0:
        return None
    on, off = [], []
    for i in range(pairs):
        for rec in ((True, False) if i % 2 == 0 else (False, True)):
            telemetry.clear()
            if rec:
                with telemetry.recording():
                    on.append(window(prog, reqs, seconds, device))
            else:
                off.append(window(prog, reqs, seconds, device))
    telemetry.clear()
    return {"on": quartiles(on), "off": quartiles(off),
            "on_over_off": [a / b for a, b in zip(on, off)]}


def _segment(s, by_id) -> str:
    """The forward or sampler segment a span lies in ("" for none)."""
    while s is not None:
        if s.name in FORWARDS or s.name.startswith("sampler."):
            return s.name
        s = by_id.get(s.parent)
    return ""


def idle_table(prog, reqs, device, trace_path: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            torch.inference_mode():
        for r in reqs:
            prog.edit(r)
            harness.sync(device)
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    trace = json.loads(trace_path.read_text())
    trace_path.unlink()
    spans = telemetry.spans()
    by_id = {s.id: s for s in spans}

    def key(s):
        return (_segment(s, by_id) or "no segment", s.name,
                s.attrs.get("index"))
    idle = telemetry.idle_by_span(trace, spans, key=key)
    busy = telemetry.busy_intervals(trace)
    groups: dict = {}
    for label, sec in idle.items():
        seg, name, index = (label if label != "no span" else
                            ("no span", "no span", None))
        g = groups.setdefault(seg, {"idle_s": 0.0, "by_name": {},
                                    "by_span": {}})
        g["idle_s"] += sec
        g["by_name"][name] = g["by_name"].get(name, 0.0) + sec
        g["by_span"][name if index is None else f"{name}[{index}]"] = sec
    for g in groups.values():
        for k in ("by_name", "by_span"):
            g[k] = sorted(g[k].items(), key=lambda kv: -kv[1])[:6]
    forwards = {}
    for name in FORWARDS + ("sampler.warm", "sampler.partition",
                            "sampler.sync", "sampler.rest", "sampler.sms",
                            "pipeline.edit"):
        mine = [s for s in spans if s.name == name]
        if mine:
            dev = [s.device_ms() for s in mine if s.device_ms() is not None]
            forwards[name] = {
                "n": len(mine),
                "host_ms": statistics.mean(s.host_ms for s in mine),
                "device_ms": statistics.mean(dev) if dev else None}
    edits = [s for s in spans if s.name == "pipeline.edit"]
    launches = sum(s.attrs["launches"] for s in edits)
    host_ns = sum(s.attrs["host_ns"] for s in edits)
    launch_ns = sum(s.attrs["launch_ns"] for s in edits)
    telemetry.clear()
    return {"idle_s": sum(idle.values()),
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "span_s": (busy[-1][1] - busy[0][0]) / 1e6 if busy else 0.0,
            "by_segment": dict(sorted(groups.items(),
                                      key=lambda kv: -kv[1]["idle_s"])),
            "spans": forwards, "launches_per_edit": launches / len(edits),
            "wrapper_host_us": host_ns / launches / 1e3 if launches else None,
            "wrapper_launch_us": (launch_ns / launches / 1e3 if launches
                                  else None)}


@contextlib.contextmanager
def _variant(name: str):
    """Record as `name` says (see `traced_variants`) inside the block."""
    span, clock = telemetry.span, telemetry.clock
    if name == "no_events":
        telemetry.span = lambda n, events_on=None, edit=False, **a: span(
            n, None, edit, **a)
    elif name == "no_blocks":
        telemetry.span = lambda n, *a, **k: (
            telemetry.NOOP if n.startswith("model.") else span(n, *a, **k))
    elif name == "none":
        telemetry.span = lambda *a, **k: telemetry.NOOP
    if name in ("no_counters", "none"):
        telemetry.clock = lambda: 0
    try:
        yield
    finally:
        telemetry.span, telemetry.clock = span, clock


VARIANTS = ("all", "no_events", "no_blocks", "no_counters", "none")


def traced_variants(prog, reqs, device, rounds: int, trace_path: Path):
    """{variant: {"wall_s": [...], "idle_share": [...]}}: one cycle of the
    pool under a profile of CUDA activity alone (as the benchmark traces)
    for each of `VARIANTS` in turns, `rounds` times."""
    from torch.profiler import ProfilerActivity, profile
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    out = {v: {"wall_s": [], "idle_share": []} for v in VARIANTS}
    for r in range(rounds + 1):             # round 0 warms the profiler
        for v in (VARIANTS if r % 2 else VARIANTS[::-1]):
            telemetry.clear()
            with _variant(v), profile(activities=[ProfilerActivity.CUDA]) \
                    as prof, torch.inference_mode():
                harness.sync(device)
                t = time.perf_counter()
                for q in reqs:
                    prog.edit(q)
                harness.sync(device)
                wall = time.perf_counter() - t
            prof.export_chrome_trace(str(trace_path))
            busy = telemetry.busy_intervals(json.loads(
                trace_path.read_text()))
            trace_path.unlink()
            if r:
                span = busy[-1][1] - busy[0][0]
                out[v]["wall_s"].append(wall)
                out[v]["idle_share"].append(
                    1 - sum(b - a for a, b in busy) / span)
    telemetry.clear()
    return out


def span_call_ns(device, n: int = 100_000) -> dict:
    """Host ns of one `with span(name, index=i): pass`: off, on
    (`recording()`), on with CUDA events, under a profile of CUDA activity
    alone, and inside `telemetry.trace` (annotated)."""
    def loop(k, **kw):
        t = time.perf_counter_ns()
        for i in range(k):
            with telemetry.span("x", index=i, **kw):
                pass
        return (time.perf_counter_ns() - t) / k
    out = {"off": loop(n)}
    with telemetry.recording():
        out["on"] = loop(n)
        telemetry.clear()
        if torch.device(device).type == "cuda":
            x = torch.zeros(1, device=device)
            out["on_events"] = loop(n // 10, events_on=x)
            torch.cuda.synchronize()
    telemetry.clear()
    if torch.device(device).type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            out["cuda_profile"] = loop(n // 10)
        with telemetry.trace(str(ROOT / "build" / "span_cost")):
            out["trace"] = loop(n // 10)
        telemetry.clear()
    return out


def wrapper_host_us(device, hidden: int, rows: int = 1152,
                    calls: int = 400) -> dict:
    """Host us a launch of K7 (`adaln`), K8 (`qk_norm_rope`) and K9
    (`gelu_pack`) at `rows` x `hidden` bf16, the launch queue kept short
    (a synchronize every 8 calls), so with no wait for room in the queue:
    {name: (up to the launch call, the launch call)}."""
    from regione_tpu_torch.ops import fused
    gen = torch.Generator(device=device).manual_seed(0)

    def t(*shape):
        return torch.randn(shape, device=device, generator=gen,
                           dtype=torch.bfloat16)
    x, h = t(2, rows, hidden), t(2, rows, 4 * hidden)
    shift, scale = t(2, 1, hidden), t(2, 1, hidden)
    norm = torch.ones(128, device=device, dtype=torch.bfloat16)
    calls_of = {"adaln": lambda: fused.adaln(x, shift, scale),
                "qk_norm_rope": lambda: fused.qk_norm_rope(
                    x, hidden // 128, norm),
                "gelu_pack": lambda: fused.gelu_pack(x, h)}
    out = {}
    with telemetry.recording():
        for name, call in calls_of.items():
            fn = getattr(fused, name)
            call()
            torch.cuda.synchronize()
            n0, ns0, lns0 = fn.launches, fn.host_ns, fn.launch_ns
            for i in range(calls):
                call()
                if i % 8 == 7:
                    torch.cuda.synchronize()
            n = fn.launches - n0
            out[name] = ((fn.host_ns - ns0) / n / 1e3,
                         (fn.launch_ns - lns0) / n / 1e3)
    telemetry.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6,
                    help="on / off pairs of the on-cost (0: none)")
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--variants", type=int, default=0,
                    help="rounds of the traced variants (0: none)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = "cuda"
    t = time.perf_counter()
    prog, reqs = setup(args.workload, args.seed, device)
    setup_s = time.perf_counter() - t
    gc.collect()
    gc.freeze()
    row = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), "setup_s": setup_s,
           "span_call_ns": span_call_ns(device),
           "wrapper_host_us": wrapper_host_us(
               device, prog.pipe.cfg.hidden),
           "on_cost": on_cost(prog, reqs, args.pairs, args.window, device),
           "idle": idle_table(prog, reqs, device, ROOT / "build" /
                              "span_cost" / f"{args.workload}.json")}
    if args.variants:
        row["traced_variants"] = traced_variants(
            prog, reqs, device, args.variants,
            ROOT / "build" / "span_cost" / f"{args.workload}_v.json")
    out = Path(args.out or ROOT / "build" /
               f"span_cost_{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(row, indent=1))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
