"""Observability: spans and counters inside the program, stage timing,
profiler traces.

Counterpart of `regione_tpu/utils/telemetry.py`:

  * `device_sync(x)`: a completion barrier for what produced x;
  * `StageTimer`: named wall-clock segments, each ended by a barrier, each
    also a span `serve.<name>`;
  * `trace(dir)`: a `torch.profiler` context that writes a Chrome trace
    (chrome://tracing, Perfetto) of the CPU and, on a card, CUDA activity;
    the program's spans appear in it as user annotations.

Spans.  `span(name, events_on=None, edit=False, **attrs)` is a context
manager for one layer boundary of the program.  Each record holds its name,
its id, its parent's id (a stack per thread), the id of the edit it belongs
to, its attrs and its host start and end, `t0_ns` / `t1_ns`, as read by
`perf_counter_ns()`.  `trace_ns(t)` places such a time on the clock of
`torch.profiler`'s chrome trace (`ts` us + `baseTimeNanoseconds`, which
reads as Unix time) by one offset to `time_ns()`, taken when a recording
session starts: at import, at `clear()`, and where `recording()` or
`trace()` turns recording on.  With `events_on` a CUDA tensor, the span
also records a CUDA event on that device's current stream at its start and
its end; `device_ms()` reads them once the caller has synchronized (a span
adds no sync).  `edit=True` marks a span as an edit: the spans inside it
take its id as their edit id, and its attrs gain what its edit added to
the kernel wrappers' counters.  Inside `trace()` a span also enters
`record_function(name)`, so it lies on the kernels' timeline of that
CPU + CUDA trace as a user annotation.  Under another profiler session it
does not: with CUDA activity alone (as the benchmark traces) the profiler
pays for every kernel launched inside an annotation (about 13 us a launch
on an H100's host, against 3 us for the span itself), and `trace_ns`
places the spans on that trace anyway.

Spans record while a `torch.profiler` session is active, or inside a
`recording()` block (of any thread).  Otherwise `span()` returns the shared
no-op `NOOP`: it creates nothing, reads no clock and records no event.
`spans()` returns the records, `clear()` drops them; nothing is written to
disk.  The recorder keeps the newest `MAX_SPANS` records (about 140 edits);
`trace()` clears it as it starts, and whoever profiles with a bare
`torch.profiler` session calls `clear()` when done with the spans.
`idle_by_span(trace, spans)` puts each idle gap of a device trace down to
the innermost span open on the host when the gap began.

Counters.  Every kernel wrapper of `ops` is registered once, with
`register_counters`, and has `.launches` (each launch) and, while
recording only, `.host_ns` (the host ns from the wrapper's entry to its
launch call: its own checks, allocations and arguments) and `.launch_ns`
(the launch call itself: the C entry's host work and the CUDA launch,
with any wait for room in the launch queue where the device is behind).
`counter_totals()` sums the three over the registered wrappers,
`reset_counters()` zeroes them.

The JAX module's `enable_compile_cache` configures XLA's persistent compile
cache; eager PyTorch compiles nothing, so it has no counterpart here.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import itertools
import json
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

_forced = 0                 # open `recording()` blocks, over all threads
_annotate = 0               # open `trace()` blocks
_lock = threading.Lock()
MAX_SPANS = 1 << 17
_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans
_offset_ns = time.time_ns() - time.perf_counter_ns()   # see `trace_ns`
_counted: list = []         # the kernel wrappers with counters
COUNTERS = ("launches", "host_ns", "launch_ns")


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


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, profiler or not."""
    global _forced
    with _lock:
        if not _recording():
            _renew_offset()
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


class _NoSpan:
    """What `span()` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _NoSpan()


def _recording() -> bool:
    return bool(_forced or _profiler._is_profiler_enabled)


def _renew_offset() -> None:
    """Start a recording session's one offset of `trace_ns`."""
    global _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()


def trace_ns(t_ns: int) -> int:
    """A span's `perf_counter_ns()` time on the chrome trace's clock (ns
    since the Unix epoch), by the offset of the current session."""
    return t_ns + _offset_ns


class Span:
    """One recorded span (see the module docstring); made by `span()`."""
    __slots__ = ("name", "id", "parent", "edit", "attrs", "thread", "t0_ns",
                 "t1_ns", "_events_on", "_events", "_is_edit", "_counts",
                 "_annotation")

    def __init__(self, name: str, events_on, is_edit: bool, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._events_on = events_on
        self._is_edit = is_edit
        self.t0_ns = self.t1_ns = None
        self._events = self._counts = self._annotation = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        self.edit = self.id if self._is_edit else (
            top.edit if top is not None else None)
        self.thread = threading.get_ident()
        if self._is_edit:
            self._counts = counter_totals()
        stack.append(self)
        _records.append(self)
        if _annotate:
            self._annotation = _profiler.record_function(self.name)
            self._annotation.__enter__()
        self.t0_ns = time.perf_counter_ns()
        x = self._events_on
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            stream = torch.cuda.current_stream(x.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            self._events[0].record(stream)
        self._events_on = None
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._events[2])
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        self.t1_ns = time.perf_counter_ns()
        if self._counts is not None:
            for name, a, b in zip(COUNTERS, self._counts, counter_totals()):
                self.attrs[name] = b - a
        _local.stack.pop()
        return False

    def set(self, **attrs) -> None:
        """Add attrs known only inside the span (a count read at a sync)."""
        self.attrs.update(attrs)

    @property
    def host_ms(self) -> float | None:
        if self.t1_ns is None:
            return None
        return (self.t1_ns - self.t0_ns) / 1e6

    def device_ms(self) -> float | None:
        """The device time between the span's CUDA events (after the
        caller's sync); None for a span without events."""
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1])

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"edit={self.edit}, attrs={self.attrs})")


def span(name: str, events_on=None, edit: bool = False, **attrs):
    """A span of `name` while recording (module docstring), else `NOOP`."""
    if not (_forced or _profiler._is_profiler_enabled):
        return NOOP
    return Span(name, events_on, edit, attrs)


def spans() -> list:
    """The recorded spans in the order they started."""
    return list(_records)


def clear() -> None:
    """Drop every recorded span, and start a new session's offset."""
    _records.clear()
    _renew_offset()


# ---------------------------------------------------------------------------
# the kernel wrappers' counters
# ---------------------------------------------------------------------------

def register_counters(*wrappers) -> None:
    """Register kernel wrappers, each given its `COUNTERS` at 0: the one
    list of the wrappers that `counter_totals` and `reset_counters`
    read."""
    for w in wrappers:
        if w not in _counted:
            _counted.append(w)
            for name in COUNTERS:
                setattr(w, name, 0)


def counter_totals() -> tuple[int, ...]:
    """(launches, host ns, launch ns) over every registered wrapper."""
    return tuple(sum(getattr(w, name) for w in _counted)
                 for name in COUNTERS)


def reset_counters(module: str | None = None) -> None:
    """Zero the `COUNTERS` of every registered wrapper, or of those
    defined in `module` (a module's `__name__`)."""
    for w in _counted:
        if module is None or w.__module__ == module:
            for name in COUNTERS:
                setattr(w, name, 0)


def clock() -> int:
    """At a wrapper's entry: `perf_counter_ns()` while recording, else 0."""
    if _forced or _profiler._is_profiler_enabled:
        return time.perf_counter_ns()
    return 0


def lap(wrapper, t0: int, counter: str = "host_ns") -> int:
    """Add the ns since `t0` (`clock()` or an earlier `lap`) to
    `wrapper.<counter>` and return the time read; nothing, and 0, for
    t0 = 0 (not recording).  A wrapper laps `host_ns` just before its
    launch call and `launch_ns` just after it."""
    if not t0:
        return 0
    t = time.perf_counter_ns()
    setattr(wrapper, counter, getattr(wrapper, counter) + t - t0)
    return t


# ---------------------------------------------------------------------------
# idle device time by span
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_intervals(trace: dict) -> list[tuple[float, float]]:
    """The union of a chrome trace's kernels, copies and fills, in the
    trace's us, sorted."""
    events = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur",
                                                                     0.0)))
                    for ev in trace["traceEvents"]
                    if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS)
    out: list = []
    for a, b in events:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_by_span(chrome_trace, spans_, key=None) -> dict[str, float]:
    """Idle device seconds by span: every gap between two busy intervals
    of `chrome_trace` (a path or a loaded trace; CUDA only or CPU + CUDA)
    goes to the innermost of `spans_` open on the host when the gap began
    (the latest started of those open), labelled `key(span)` (default its
    name), or to "no span".  The spans' times are placed on the trace's
    clock by `trace_ns`, so the trace is one taken in the spans' session."""
    if not isinstance(chrome_trace, dict):
        with open(chrome_trace) as f:
            chrome_trace = json.load(f)
    base = int(chrome_trace.get("baseTimeNanoseconds", 0))
    key = key or (lambda s: s.name)
    busy = busy_intervals(chrome_trace)
    order = sorted((s for s in spans_ if s.t1_ns is not None),
                   key=lambda s: s.t0_ns)
    heap: list = []
    out: dict = {}
    j = 0
    for (_, gap0), (gap1, _) in zip(busy, busy[1:]):
        t = base + int(gap0 * 1000) - trace_ns(0)
        while j < len(order) and order[j].t0_ns <= t:
            heapq.heappush(heap, (-order[j].t0_ns, j, order[j]))
            j += 1
        while heap and heap[0][2].t1_ns <= t:
            heapq.heappop(heap)
        label = key(heap[0][2]) if heap else "no span"
        out[label] = out.get(label, 0.0) + (gap1 - gap0) / 1e6
    return out


# ---------------------------------------------------------------------------
# stages and traces
# ---------------------------------------------------------------------------

class StageTimer:
    """Accumulates named wall-clock segments (ended by `device_sync`); each
    stage is also a span `serve.<name>` with the timer's attrs."""

    def __init__(self, **attrs):
        self.segments: dict[str, float] = {}
        self.attrs = attrs

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        with span(f"serve.{name}", **self.attrs):
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
    when a card is present.  The recorder is cleared as the block starts;
    the spans of the block are recorded and annotated in it."""
    global _annotate
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    clear()
    with profile(activities=acts) as prof:
        with _lock:
            _annotate += 1
        try:
            yield prof
        finally:
            with _lock:
                _annotate -= 1
    prof.export_chrome_trace(str(out / "trace.json"))
