"""The port's spans and counters (`regione_tpu_torch.utils.telemetry`).

  * off (no profiler, no `recording()`): an edit records nothing and
    `span()` hands back the one no-op object;
  * one offset to the trace's clock a recording session; the recorder
    keeps the newest `MAX_SPANS`, and `trace()` starts it empty;
  * on: one `pipeline.edit` per edit call, over the sampler's segments and
    its host sync; one forward span per dense and computed RAGS step of
    the plan; `depth` block spans per forward; every child inside its
    parent's host interval; the edit's launch and host-time attrs and
    its `pipeline.rags_graph` counts;
  * recording leaves the latents bit-identical;
  * each write forward's blocks hold a `model.cache_write` span for K and
    one for V, with their attrs (model-dtype and int8 caches);
  * in a CPU + CUDA trace (`telemetry.trace`) each span starts where its
    own user annotation does on the trace's clock; under a profile of CUDA
    activity alone the spans record with no annotation;
  * `idle_by_span` puts each gap of a hand-built device trace under the
    span open when it began;
  * `EditService.run` gives each request its `serve.*` stages, the
    preparation on the worker thread;
  * every kernel wrapper in the one registry, which the resets read;
  * on a card (marked `cuda`): the wrappers' `.host_ns` and `.launch_ns`
    grow only while recording, their `.launches` are the same either way, and the spans'
    CUDA events and host clock sit on the profiler's trace.
"""

import collections
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from regione_tpu_torch.core.config import RegionEParams
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.models.text_encoders import MockTextEncoder
from regione_tpu_torch.models.vae import VAEConfig
from regione_tpu_torch.pipelines.base import EditInputs
from regione_tpu_torch.pipelines.qwen_image_edit import QwenImageEditPipeline
from regione_tpu_torch.pipelines.serve import EditRequest, EditService
from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
from regione_tpu_torch.utils import telemetry
from regione_tpu_torch.weights.from_jax import init_params, init_vae_params
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GRID, T_TXT = 8, 4
RE = RegionEParams(threshold=0.0, erosion_dilation=False,
                   capacity_granularity=8)
SAMPLER = ("sampler.warm", "sampler.partition", "sampler.sync",
           "sampler.rest", "sampler.sms")


@pytest.fixture(autouse=True)
def empty_recorder():
    telemetry.clear()
    yield
    telemetry.clear()


def _pipe(seed=0):
    cfg = get_config("tiny")
    return Step1XEditPipeline(init_params(cfg, torch.Generator().manual_seed(
        seed), device="cpu"), RE, true_cfg_scale=6.0)


def _inputs(pipe, seed=1):
    cfg = pipe.cfg
    gen = torch.Generator().manual_seed(seed)
    rope = pipe.build_rope(GRID, GRID, T_TXT)
    ctx = EditInputs(
        txt=torch.randn(2, T_TXT, cfg.txt_in_dim, generator=gen),
        cond_latent=torch.randn(1, GRID * GRID, cfg.in_channels,
                                generator=gen),
        rope_img=rope[0], rope_txt=rope[1],
        pooled=torch.randn(2, cfg.pooled_dim, generator=gen))
    lat0 = torch.randn(1, GRID * GRID, cfg.in_channels, generator=gen)
    return lat0, ctx


@pytest.fixture(scope="module")
def edit():
    """(pipe, lat0, ctx, latents and stats of the edit with nothing
    recording)."""
    pipe = _pipe()
    lat0, ctx = _inputs(pipe)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, stats = pipe.edit_latents(lat0, ctx, GRID, GRID)
    finally:
        torch.set_num_threads(n)
    return pipe, lat0, ctx, out, stats


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


# -- off ---------------------------------------------------------------------

def test_off_an_edit_records_nothing_and_span_is_the_noop(edit):
    pipe, lat0, ctx, _, _ = edit
    pipe.edit_latents(lat0, ctx, GRID, GRID)
    assert telemetry.spans() == []
    a = telemetry.span("x", events_on=lat0, edit=True, k=1)
    assert a is telemetry.span("y") is telemetry.NOOP
    with a as s:
        s.set(n=2)
    assert telemetry.spans() == [] and telemetry.clock() == 0


def test_recording_turns_on_and_nests():
    assert telemetry.clock() == 0
    with telemetry.recording():
        with telemetry.recording():
            assert telemetry.clock() > 0
        assert telemetry.clock() > 0
        with telemetry.span("outer", k=1) as o:
            with telemetry.span("inner") as i:
                i.set(n=3)
    assert telemetry.clock() == 0
    assert telemetry.spans() == [o, i]
    assert i.host_ms == (i.t1_ns - i.t0_ns) / 1e6
    assert (o.parent, i.parent, o.attrs, i.attrs) == (None, o.id, {"k": 1},
                                                      {"n": 3})
    assert o.edit is None and i.device_ms() is None      # no events on CPU
    assert o.t0_ns <= i.t0_ns <= i.t1_ns <= o.t1_ns
    telemetry.clear()
    assert telemetry.spans() == []


def test_one_clock_offset_a_session():
    """The offset to the trace's clock is taken as recording starts and
    holds while it lasts, whatever other threads' spans or blocks open."""
    with telemetry.recording():
        offset = telemetry.trace_ns(0)

        def worker():
            with telemetry.recording():
                with telemetry.span("serve.prep"):
                    pass
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with telemetry.span("outer"):
            pass
        assert telemetry.trace_ns(0) == offset
    assert len(telemetry.spans()) == 2


def test_the_recorder_keeps_the_newest_spans_and_trace_clears_it(
        tmp_path, monkeypatch):
    monkeypatch.setattr(telemetry, "_records", collections.deque(maxlen=3))
    with telemetry.recording():
        for i in range(5):
            with telemetry.span("x", i=i):
                pass
    assert [s.attrs["i"] for s in telemetry.spans()] == [2, 3, 4]
    with telemetry.trace(str(tmp_path)):
        assert telemetry.spans() == []
        with telemetry.span("y"):
            pass
    assert [s.name for s in telemetry.spans()] == ["y"]
    assert telemetry.MAX_SPANS >= 100 * 1000


# -- on ----------------------------------------------------------------------

def test_on_an_edit_gives_one_root_over_the_segments(edit):
    pipe, lat0, ctx, _, stats = edit
    with telemetry.recording():
        pipe.edit_latents(lat0, ctx, GRID, GRID)
    spans = telemetry.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["pipeline.edit"]
    root = roots[0]
    # the CPU runs every computed RAGS forward eagerly
    computed = stats.rags_steps - stats.reuse_steps
    assert root.attrs == {"grid": (GRID, GRID), "batch": 1,
                          "backend": "step1x-edit", "launches": 0,
                          "host_ns": 0, "launch_ns": 0,
                          "pipeline.rags_graph.replays": 0,
                          "pipeline.rags_graph.captures": 0,
                          "pipeline.rags_graph.eager": computed}
    assert all(s.edit == root.id for s in spans)
    assert [s.name for s in _children(spans, root)] == list(SAMPLER)
    seg = {s.name: s for s in _children(spans, root)}
    assert seg["sampler.sync"].attrs == {"edited": stats.edited_tokens}
    assert seg["sampler.warm"].attrs == {"steps": RE.warmup_step - 1}
    n = collections.Counter(s.name for s in spans)
    assert n["pipeline.dense_forward"] == stats.dense_steps
    assert n["pipeline.rags_forward"] == \
        stats.rags_steps - stats.reuse_steps > 0


def test_on_every_forward_holds_its_blocks(edit):
    pipe, lat0, ctx, _, _ = edit
    cfg = pipe.cfg
    with telemetry.recording():
        pipe.edit_latents(lat0, ctx, GRID, GRID)
    spans = telemetry.spans()
    forwards = [s for s in spans if s.name.startswith("pipeline.") and
                s.name.endswith("_forward")]
    for fw in forwards:
        kids = _children(spans, fw)
        assert [k.name for k in kids] == ["model.embed"] + [
            "model.double_block"] * cfg.depth_double + [
            "model.single_block"] * cfg.depth_single + ["model.final"]
        assert [k.attrs["index"] for k in kids[1:-1]] == \
            list(range(cfg.depth_double)) + list(range(cfg.depth_single))
    rows = {s.name: s.attrs["rows"] for s in forwards}
    assert rows["pipeline.dense_forward"] == GRID * GRID


def test_on_every_child_lies_inside_its_parent(edit):
    pipe, lat0, ctx, _, _ = edit
    with telemetry.recording():
        pipe.edit_latents(lat0, ctx, GRID, GRID)
    spans = telemetry.spans()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans) > 100
    for s in spans:
        assert s.t0_ns <= s.t1_ns and s.host_ms >= 0
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (p, s)


def test_on_a_batch_edit_gives_one_root_per_call(edit):
    pipe, lat0, ctx, _, _ = edit
    lat1, ctx1 = _inputs(pipe, seed=2)
    with telemetry.recording():
        pipe.edit_latents_batch([lat0, lat1], [ctx, ctx1], GRID, GRID)
        pipe.edit_latents_batch([lat1], [ctx1], GRID, GRID)
    spans = telemetry.spans()
    roots = [s for s in spans if s.parent is None]
    assert [(r.name, r.attrs["batch"]) for r in roots] == [
        ("pipeline.edit", 2), ("pipeline.edit", 1)]
    for r in roots:
        assert [s.name for s in _children(spans, r)] == list(SAMPLER)
    sync = [s for s in spans if s.name == "sampler.sync"][0]
    assert len(sync.attrs["edited"]) == 2


def test_recording_leaves_the_latents_bit_identical(edit):
    pipe, lat0, ctx, out, stats = edit
    with telemetry.recording():
        got, got_stats = pipe.edit_latents(lat0, ctx, GRID, GRID)
    assert telemetry.spans()
    assert torch.equal(got, out) and got_stats == stats


# -- the cache writes --------------------------------------------------------

def _qwen_int8():
    """A tiny Qwen-Image-Edit pipeline with an int8 K/V cache, true CFG 4,
    and its inputs (pipe, lat0, ctx)."""
    cfg = dataclasses.replace(get_config("tiny-qwen"), cache_int8=True)
    pipe = QwenImageEditPipeline(init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), RE)
    gen = torch.Generator().manual_seed(1)
    rope = pipe.build_rope(GRID, GRID, T_TXT)
    ctx = EditInputs(
        txt=torch.randn(2, T_TXT, cfg.txt_in_dim, generator=gen),
        cond_latent=torch.randn(1, GRID * GRID, cfg.in_channels,
                                generator=gen),
        rope_img=rope[0], rope_txt=rope[1])
    lat0 = torch.randn(1, GRID * GRID, cfg.in_channels, generator=gen)
    return pipe, lat0, ctx


@pytest.mark.parametrize("which", ["step1x-fp32", "qwen-int8"])
def test_each_write_forward_stores_k_and_v_of_every_block(edit, which):
    """Two `model.cache_write` spans (K, then V) in each block span of a
    write forward, none elsewhere; their attrs: the block's index, the
    cache key, the rows, the bytes written and the format.  None while
    nothing records."""
    if which == "qwen-int8":
        pipe, lat0, ctx = _qwen_int8()
    else:
        pipe, lat0, ctx = edit[:3]
    cfg = pipe.cfg
    pipe.edit_latents(lat0, ctx, GRID, GRID)
    assert telemetry.spans() == []
    with telemetry.recording():
        pipe.edit_latents(lat0, ctx, GRID, GRID)
    spans = telemetry.spans()
    forwards = [s for s in spans if s.name.startswith("pipeline.") and
                s.name.endswith("_forward")]
    n_write = sum(f.attrs.get("write", False) for f in forwards)
    writes = [s for s in spans if s.name == "model.cache_write"]
    assert n_write >= 2            # the partition step and the refresh
    assert len(writes) == 2 * n_write * (cfg.depth_double + cfg.depth_single)
    for fw in forwards:
        for blk in _children(spans, fw)[1:-1]:
            got = [(k.name, k.attrs["key"], k.attrs["index"])
                   for k in _children(spans, blk)]
            if not fw.attrs.get("write"):
                assert got == []
                continue
            tag = "d" if blk.name == "model.double_block" else "s"
            assert got == [("model.cache_write", tag + key,
                             blk.attrs["index"]) for key in "kv"]
    s_kv = 2 * GRID * GRID
    values = 2 * cfg.heads * s_kv * cfg.head_dim     # a CFG batch of two
    want = ({"format": "int8", "bytes": values + 4 * values // cfg.head_dim}
            if which == "qwen-int8" else
            {"format": "float32", "bytes": 4 * values})
    for w in writes:
        assert w.attrs["rows"] == s_kv
        assert {k: w.attrs[k] for k in want} == want


# -- the profiler's clock ----------------------------------------------------

def _annotations(trace: dict) -> dict:
    """{name: [start ns on the trace's clock]} of the user annotations."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    out = collections.defaultdict(list)
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            out[ev["name"]].append(base + float(ev["ts"]) * 1e3)
    return {k: sorted(v) for k, v in out.items()}


def _offsets_on_the_trace(run, tmp_path, tries=3):
    """|span start - its own user annotation's start| in ns on the trace's
    clock, span by span, the least over `tries` runs of `run()` under
    `telemetry.trace`: a preemption between the annotation and the span's
    clock read (up to milliseconds with the test workers sharing the
    cores) is no error of the clock, and seldom hits one span twice.  A
    first traced `run()` pays the process's one-time profiler set-up,
    which delays the first annotation's return by about a millisecond."""
    with telemetry.trace(str(tmp_path / "first")):
        run()
    best = None
    for k in range(tries):
        telemetry.clear()
        with telemetry.trace(str(tmp_path / str(k))):
            run()
        notes = _annotations(json.loads(
            (tmp_path / str(k) / "trace.json").read_text()))
        spans = telemetry.spans()
        assert spans
        offsets = []
        for name in sorted({s.name for s in spans}):
            mine = [s for s in spans if s.name == name]
            assert len(notes.get(name, ())) == len(mine), name
            offsets += [abs(telemetry.trace_ns(s.t0_ns) - t)
                        for s, t in zip(mine, notes[name])]
        best = offsets if best is None else list(map(min, best, offsets))
    return best


def test_spans_sit_on_the_profiler_clock(edit, tmp_path):
    pipe, lat0, ctx, _, _ = edit
    offsets = _offsets_on_the_trace(
        lambda: pipe.edit_latents(lat0, ctx, GRID, GRID), tmp_path)
    assert len(offsets) > 100 and max(offsets) <= 1e5, max(offsets)  # 0.1 ms


def test_a_profile_of_its_own_records_spans_without_annotations(edit,
                                                                 tmp_path):
    pipe, lat0, ctx, _, _ = edit
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.edit_latents(lat0, ctx, GRID, GRID)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    assert sum(s.name == "pipeline.edit" for s in telemetry.spans()) == 1
    assert "pipeline.edit" not in _annotations(trace)


# -- idle by span ------------------------------------------------------------

def _trace(kernels, base=10**18):
    return {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}
        for cat, ts, dur in kernels] + [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 999},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "a", "ts": 0,
         "dur": 999}]}


def _span(name, t0_us, t1_us, base=10**18):
    """A span from t0 to t1 us after `base` on the trace's clock."""
    s = telemetry.Span(name, None, False, {})
    perf = base - telemetry.trace_ns(0)
    s.t0_ns, s.t1_ns = perf + t0_us * 1000, perf + t1_us * 1000
    return s


def test_idle_by_span_puts_each_gap_under_the_open_span(tmp_path):
    # busy [0, 10] [12, 20] (a copy inside) [25, 30] [31, 40] [100, 110]
    trace = _trace([("kernel", 0, 10), ("kernel", 12, 8),
                    ("gpu_memcpy", 14, 2), ("gpu_memset", 25, 5),
                    ("kernel", 31, 9), ("kernel", 100, 10)])
    fwd = _span("pipeline.dense_forward", 5, 35)
    blk = _span("model.double_block", 8, 18)
    sync = _span("sampler.sync", 39, 60)
    spans = [sync, blk, fwd]
    idle = telemetry.idle_by_span(trace, spans)
    assert idle == pytest.approx({"model.double_block": 2e-6,     # at 10
                                  "pipeline.dense_forward": 6e-6,  # 20, 30
                                  "sampler.sync": 60e-6})          # at 40
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    assert telemetry.idle_by_span(str(path), spans) == idle
    # a gap outside every span, and a key of the caller's
    late = _trace([("kernel", 0, 10), ("kernel", 65, 1), ("kernel", 80, 1)])
    by_forward = telemetry.idle_by_span(late, spans, key=lambda s: "in")
    assert by_forward == pytest.approx({"in": 55e-6, "no span": 14e-6})
    assert telemetry.idle_by_span(_trace([("kernel", 0, 1)]), spans) == {}


# -- serving -----------------------------------------------------------------

def test_service_run_records_each_request_s_stages():
    cfg = get_config("tiny")
    pipe = Step1XEditPipeline(init_params(cfg, torch.Generator().manual_seed(
        0), device="cpu"), RE)
    pipe.attach_vae(init_vae_params(VAEConfig(
        block_out_channels=(8, 16), latent_channels=2, norm_num_groups=4,
        layers_per_block=1), torch.Generator().manual_seed(1), device="cpu"))
    pipe.attach_text_encoder(MockTextEncoder(cfg.txt_in_dim, cfg.pooled_dim,
                                             max_length=8))
    rng = np.random.default_rng(0)
    reqs = [EditRequest(image=(rng.random((32, 32, 3)) * 255).astype(
        np.uint8), prompt=f"edit {i}", width=32, height=32, seed=i)
        for i in range(2)]
    with telemetry.recording():
        results = EditService(pipe).run(reqs)
    spans = telemetry.spans()
    by_id = {s.id: s for s in spans}
    main = threading.get_ident()
    for i, r in enumerate(results):
        mine = {s.name: s for s in spans if s.name.startswith("serve.")
                and s.attrs == {"request": i}}
        assert set(mine) == {"serve.prep", "serve.denoise", "serve.decode"}
        prep = mine["serve.prep"]
        assert prep.thread != main and prep.parent is None
        assert mine["serve.denoise"].thread == main
        assert set(r.stages) == {"prep", "denoise", "decode"}
        edits = [s for s in spans if s.name == "pipeline.edit"
                 and s.parent == mine["serve.denoise"].id]
        assert len(edits) == 1 and edits[0].thread == main
    assert sum(s.name == "pipeline.edit" for s in spans) == 2
    assert all(s.parent is None or s.parent in by_id for s in spans)


def test_stage_timer_opens_a_span_per_stage():
    timer = telemetry.StageTimer(request=7)
    with timer.stage("prep"):
        pass
    assert telemetry.spans() == [] and set(timer.as_dict()) == {"prep"}
    with telemetry.recording():
        with timer.stage("prep", sync_on=torch.zeros(1)):
            pass
    (s,) = telemetry.spans()
    assert (s.name, s.attrs) == ("serve.prep", {"request": 7})


# -- counters ----------------------------------------------------------------

def test_every_wrapper_is_counted_and_reset():
    from regione_tpu_torch.bench import common
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import fused
    from regione_tpu_torch.ops import partition_kernel as pk
    from regione_tpu_torch.ops import quant
    wrappers = [fa.attention, fa.attention_rows2, fa.attention_rows2_quant,
                fa.attention_quant, pk.fused_partition, fused.adaln,
                fused.residual_adaln, fused.gated_residual,
                fused.qk_norm_rope, fused.gelu_pack, quant.store_quantized,
                fused.swiglu_pack]
    assert sorted(map(id, telemetry._counted)) == sorted(map(id, wrappers))
    saved = [(w.launches, w.host_ns, w.launch_ns) for w in wrappers]
    try:
        for k, w in enumerate(wrappers):
            w.launches, w.host_ns, w.launch_ns = k, 10 * k, 100 * k
        fa.attention.long_launches = 3
        assert telemetry.counter_totals() == (66, 660, 6600)
        fa.reset_launches()
        fused.reset_launches()
        assert fa.attention.long_launches == 0
        assert telemetry.counter_totals() == (14, 140, 1400)  # K3's, K10's
        for k, w in enumerate(wrappers):
            w.launches, w.host_ns, w.launch_ns = k, 10 * k, 100 * k
        fa.attention.long_launches = 3
        common.reset_counts()
        assert telemetry.counter_totals() == (0, 0, 0)
        assert fa.attention.long_launches == 0
        assert set(common.read_counts().values()) == {0}
    finally:
        for w, (n, ns, lns) in zip(wrappers, saved):
            w.launches, w.host_ns, w.launch_ns = n, ns, lns


def test_lap_adds_only_while_recording():
    class W:
        host_ns = launch_ns = 0
    assert telemetry.lap(W, telemetry.clock()) == 0
    assert W.host_ns == 0
    with telemetry.recording():
        t0 = telemetry.clock()
        t1 = telemetry.lap(W, t0)
        t2 = telemetry.lap(W, t1, "launch_ns")
    assert W.host_ns == t1 - t0 > 0 and W.launch_ns == t2 - t1 > 0


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wrapper_host_time_counts_only_while_recording(cuda_device):
    from regione_tpu_torch.ops import fused
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(1, 64, 512, device=cuda_device, generator=gen,
                    dtype=torch.bfloat16)
    shift, scale = torch.randn(2, 1, 1, 512, device=cuda_device,
                               generator=gen, dtype=torch.bfloat16)
    fused.adaln(x, shift, scale)                       # builds the kernels
    torch.cuda.synchronize()
    w = fused.adaln
    n0, ns0, lns0 = w.launches, w.host_ns, w.launch_ns
    off = fused.adaln(x, shift, scale)
    assert (w.launches, w.host_ns, w.launch_ns) == (n0 + 1, ns0, lns0)
    with telemetry.recording():
        on = fused.adaln(x, shift, scale)
    assert w.launches == n0 + 2 and w.host_ns > ns0 and w.launch_ns > lns0
    torch.cuda.synchronize()
    assert torch.equal(on, off)


@pytest.mark.cuda
def test_spans_on_the_card_time_the_device_and_sit_on_the_trace(
        cuda_device, tmp_path):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(2048, 2048, device=cuda_device, generator=gen)

    def run():
        with telemetry.span("outer", events_on=a):
            for _ in range(4):
                with telemetry.span("inner", events_on=a):
                    a @ a
    offsets = _offsets_on_the_trace(run, tmp_path)
    torch.cuda.synchronize()
    assert len(offsets) == 5 and max(offsets) <= 1e5, offsets
    spans = telemetry.spans()
    outer = spans[0]
    assert outer.device_ms() >= sum(s.device_ms() for s in spans[1:]) > 0
