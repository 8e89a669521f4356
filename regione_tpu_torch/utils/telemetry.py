"""Observability: stage timing, structured per-image stats, profiler traces.

Counterpart of `regione_tpu/utils/telemetry.py`:

  * `device_sync(x)`: a completion barrier for what produced x;
  * `StageTimer`: named wall-clock segments, each ended by a barrier;
  * `trace(dir)`: a `torch.profiler` context that writes a Chrome trace
    (chrome://tracing, Perfetto) of the CPU and, on a card, CUDA activity;
  * `log_stats`: one JSON line per record appended to a stats file
    (edited-token counts, capacities, per-stage latencies), tensors and
    dataclasses included.

The JAX module's `enable_compile_cache` configures XLA's persistent compile
cache; eager PyTorch compiles nothing, so it has no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import torch


def device_sync(x) -> None:
    """Wait for the work that produces x (a tensor, or a tuple / list /
    dict whose first leaf is one).  On a card it waits for the current
    stream of x's device, not the whole device: work queued on other
    streams (`EditService.run` prepares the next request on one of its
    own) goes on."""
    while isinstance(x, (tuple, list, dict)):
        x = next(iter(x.values() if isinstance(x, dict) else x))
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


class StageTimer:
    """Accumulates named wall-clock segments (ended by `device_sync`)."""

    def __init__(self):
        self.segments: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                device_sync(sync_on)
            self.segments[name] = self.segments.get(name, 0.0) + (
                time.perf_counter() - t0)

    def as_dict(self) -> dict[str, float]:
        return dict(self.segments)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block, written to
    `<log_dir>/trace.json` (Chrome trace format); CUDA activity is traced
    when a card is present."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def log_stats(path: str | Path, record: dict) -> None:
    """Append one JSON line; creates parent dirs."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    record = {"ts": time.time(), **record}
    with open(p, "a") as fh:
        fh.write(json.dumps(_jsonable(record)) + "\n")


def _jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.item() if obj.numel() == 1 else obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "size", 2) == 1:
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
