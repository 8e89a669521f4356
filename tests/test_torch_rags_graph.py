"""The computed RAGS forward replayed from CUDA graphs
(`pipelines.base.RagsGraphs`), the pipeline's one K / V cache
(`_kv_cache`) and the `pipeline.rags_graph` counts.

  * the static-buffer runner over CPU tensors (its eager mode): two
    consecutive edits with different requests and capacities give latents
    bit-equal to edits each made on a fresh pipeline (a fresh cache, the
    eager `_rags`), in a group of two too; so does the default CPU path
    with its kept cache;
  * the runner's key: the capacity, the batch rows, the ids' rank and the
    text length each make a new entry; a repeat makes none;
  * the pipeline keeps one cache, refilled as `init_cache` fills a new
    one, and a cache of another shape replaces it and drops the graphs
    and their pool; an offloaded prompt encoder encodes with neither on
    the card, in `__call__` and in a service;
  * the CPU and sharded fallbacks: `.eager` counts every computed RAGS
    step, and a sharded model never replays;
  * each `pipeline.edit` span's attrs hold its own edit's counts, which
    `perfbench/metrics/pipeline.rags_graph_share.py` reads (None where
    they are absent);
  * on a card (marked `cuda`): a replayed forward bit-equal to the eager
    `_rags` at FLUX's batch 1, Step1X's CFG batch 2 and a Qwen-style int8
    cache under a served group's [B, K] ids, at small widths; and
    `EditService.run` (the next request prepared on a worker thread while
    this one captures and replays) and `run_batched` with group sizes
    that alternate (each a new cache, graphs and pool) bit-equal to the
    same service run eagerly.
"""

import contextlib
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from regione_tpu_torch.core.config import RegionEParams
from regione_tpu_torch.models.connector import ConnectorConfig
from regione_tpu_torch.models.kv_cache import init_cache
from regione_tpu_torch.models.mmdit import MMDiTConfig
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.models.text_encoders import MockTextEncoder
from regione_tpu_torch.models.vae import VAEConfig
from regione_tpu_torch.parallel import sharding
from regione_tpu_torch.pipelines.base import EditInputs
from regione_tpu_torch.pipelines.flux_kontext import FluxKontextPipeline
from regione_tpu_torch.pipelines.qwen_image_edit import QwenImageEditPipeline
from regione_tpu_torch.pipelines.serve import EditRequest, EditService
from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
from regione_tpu_torch.utils import telemetry
from regione_tpu_torch.weights.from_jax import init_params, init_vae_params
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GRID, T_TXT = 8, 4
RE = RegionEParams(threshold=0.0, erosion_dilation=False,
                   capacity_granularity=8)
SHARE = (Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
         / "pipeline.rags_graph_share.py")


@pytest.fixture(autouse=True)
def fresh_spans():
    telemetry.clear()
    yield
    telemetry.clear()


def _pipe(preset="tiny", cls=Step1XEditPipeline, seed=0, device="cpu",
          **kw):
    cfg = preset if isinstance(preset, MMDiTConfig) else get_config(preset)
    model = init_params(cfg, torch.Generator(device).manual_seed(seed),
                        device=device)
    return cls(model, RE, **kw)


def _request(pipe, seed, n_edit, t_txt=T_TXT, device="cpu"):
    """(lat0, ctx, forced mask of `n_edit` tokens) drawn from `seed`."""
    cfg = pipe.cfg
    gen = torch.Generator(device).manual_seed(seed)
    rows = 2 if pipe.do_cfg else 1
    rope = pipe.build_rope(GRID, GRID, t_txt)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    txt_dim = cfg.connector.in_dim if cfg.connector else cfg.txt_in_dim
    ctx = EditInputs(
        txt=randn(rows, t_txt, txt_dim).to(cfg.dtype),
        cond_latent=randn(1, GRID * GRID, cfg.in_channels),
        rope_img=rope[0], rope_txt=rope[1],
        pooled=(randn(rows, cfg.pooled_dim).to(cfg.dtype)
                if cfg.pooled_dim else None),
        guidance=(torch.full((rows,), 2.5, device=device)
                  if cfg.guidance_embed else None))
    mask = torch.zeros(GRID * GRID, dtype=torch.bool, device=device)
    mask[torch.randperm(GRID * GRID, generator=gen,
                        device=device)[:n_edit]] = True
    return randn(1, GRID * GRID, cfg.in_channels), ctx, mask


def _through_the_runner(pipe):
    """Route the pipeline's RAGS forwards through its runner on the CPU."""
    pipe._graphable = lambda x: True
    return pipe


# -- the static-buffer runner, eager over CPU tensors ------------------------

@pytest.mark.parametrize("preset,cls", [
    ("tiny", Step1XEditPipeline), ("tiny-flux", FluxKontextPipeline),
    ("tiny-qwen", QwenImageEditPipeline)])
def test_consecutive_edits_through_the_runner_equal_fresh_eager_edits(
        preset, cls):
    reqs = [_request(_pipe(preset, cls), seed, n)
            for seed, n in ((1, 5), (2, 20), (3, 5))]
    want = [_pipe(preset, cls).edit_latents(lat0, ctx, GRID, GRID,
                                            forced_mask=m)
            for lat0, ctx, m in reqs]
    caps = [st.capacity for _, st in want]
    assert caps[0] != caps[1]
    runner, kept = _through_the_runner(_pipe(preset, cls)), _pipe(preset,
                                                                  cls)
    for pipe in (runner, kept):
        for (lat0, ctx, m), (w, w_st) in zip(reqs, want):
            got, st = pipe.edit_latents(lat0, ctx, GRID, GRID,
                                        forced_mask=m)
            assert st == w_st
            assert torch.equal(got, w)
    # one entry a capacity; the kept-cache path makes none
    assert len(runner._rags_graphs._entries) == len(set(caps))
    assert not kept._rags_graphs._entries
    for pipe in (runner, kept):
        assert pipe._rags_graphs.replays == pipe._rags_graphs.captures == 0


def test_a_group_through_the_runner_equals_fresh_eager_groups():
    pipe0 = _pipe()
    reqs = [_request(pipe0, seed, n) for seed, n in ((1, 5), (2, 20))]
    lats, ctxs, masks = zip(*reqs)
    want, want_st = _pipe().edit_latents_batch(list(lats), list(ctxs), GRID,
                                               GRID, forced_masks=masks)
    single, _ = _pipe().edit_latents_batch([lats[0]], [ctxs[0]], GRID, GRID,
                                           forced_masks=masks[:1])
    pipe = _through_the_runner(_pipe())
    for _ in range(2):
        got, st = pipe.edit_latents_batch(list(lats), list(ctxs), GRID,
                                          GRID, forced_masks=masks)
        assert st == want_st
        assert all(map(torch.equal, got, want))
    got, _ = pipe.edit_latents_batch([lats[0]], [ctxs[0]], GRID, GRID,
                                     forced_masks=masks[:1])
    assert torch.equal(got[0], single[0])


def test_the_key_grows_with_each_shape_it_sees():
    pipe = _pipe()
    lat0, ctx, _ = _request(pipe, 1, 5)
    ctx = dataclasses.replace(ctx, s_noise=GRID * GRID)
    runner = pipe._rags_graphs
    cache = pipe._kv_cache(2, 2 * GRID * GRID)

    def call(cap=8, b=1, ids_rank=1, c=ctx, kv=cache):
        ids = torch.arange(cap, dtype=torch.int32)
        if ids_rank == 2:
            ids = ids.expand(b, -1).contiguous()
        lat = torch.randn(b, cap, pipe.cfg.in_channels)
        # a batch of b takes b rows of each CFG half
        if c.txt.shape[0] != pipe._cfg_rows(b):
            c = dataclasses.replace(
                c, txt=c.txt.repeat_interleave(b, 0),
                pooled=c.pooled.repeat_interleave(b, 0))
        v = runner(lat, 0.5, kv, ids, c)
        assert v.shape == (pipe._cfg_rows(b), cap, pipe.cfg.out_channels)
        return len(runner._entries)

    cache4 = init_cache(pipe.cfg, 4, 2 * GRID * GRID, "cpu")
    assert call() == 1
    assert call() == 1                                  # a repeat
    assert call(cap=16) == 2                            # the capacity
    assert call(b=2, kv=cache4) == 3                    # the batch rows
    assert call(b=2, ids_rank=2, kv=cache4) == 4        # the ids' rank
    _, ctx6, _ = _request(pipe, 2, 5, t_txt=6)
    assert call(c=dataclasses.replace(ctx6, s_noise=GRID * GRID)) == 5
    other = init_cache(pipe.cfg, 2, 2 * GRID * GRID, "cpu")
    assert call(kv=other) == 6                          # another cache
    assert runner.eager == 7 and runner.replays == 0


def test_the_pipeline_keeps_one_cache_refilled_as_new():
    pipe = _pipe("tiny-qwen", QwenImageEditPipeline)
    pipe.cfg = pipe.model.cfg = dataclasses.replace(pipe.cfg,
                                                    cache_int8=True)
    a = pipe._kv_cache(2, 16)
    for v in a.values():
        v.fill_(3)
    runner = pipe._rags_graphs
    runner._entries["stale"], runner._pool = None, "pool"
    b = pipe._kv_cache(2, 16)
    assert b is a and runner._entries == {"stale": None}
    new = init_cache(pipe.cfg, 2, 16, "cpu")
    assert b.keys() == new.keys()
    assert all(torch.equal(b[k], new[k]) for k in new)
    c = pipe._kv_cache(4, 16)              # another shape: a new cache
    assert c is not a and c["dk"].shape[1] == 4 and runner._entries == {}
    assert runner._pool is None            # the next capture takes a new one


VAE = VAEConfig(block_out_channels=(8, 16), latent_channels=2,
                norm_num_groups=4, layers_per_block=1)


class _OffloadedMock(MockTextEncoder):
    """A mock prompt encoder placed "offload": notes, at each encode,
    whether its pipeline holds a K / V cache or RAGS graphs."""
    placement = "offload"

    def __init__(self, pipe, *a, **kw):
        super().__init__(*a, **kw)
        self.pipe, self.seen = pipe, []

    @contextlib.contextmanager
    def on_device(self):
        self.seen.append((self.pipe._kv, dict(self.pipe._rags_graphs._entries)))
        yield


def _images(seed, n, side=32):
    rng = np.random.default_rng(seed)
    return [(rng.random((side, side, 3)) * 255).astype(np.uint8)
            for _ in range(n)]


def test_an_offloaded_encoder_encodes_without_the_cache():
    pipe = _through_the_runner(_pipe())
    pipe.attach_vae(init_vae_params(VAE, torch.Generator().manual_seed(1),
                                    device="cpu"))
    cfg = pipe.cfg
    enc = _OffloadedMock(pipe, cfg.txt_in_dim, cfg.pooled_dim, max_length=8)
    pipe.attach_text_encoder(enc)
    imgs = _images(0, 4)
    for i in range(2):
        pipe(imgs[i], f"edit {i}", width=32, height=32, seed=i)
        assert pipe._kv is not None and pipe._rags_graphs._entries
    EditService(pipe).run([EditRequest(image=img, prompt=f"edit {i}",
                                       width=32, height=32, seed=i)
                           for i, img in enumerate(imgs[2:])])
    assert len(enc.seen) == 4
    assert all(kv is None and not entries for kv, entries in enc.seen)


# -- the fallbacks and the counter -------------------------------------------

def test_the_cpu_path_counts_every_computed_rags_step_as_eager():
    pipe = _pipe()
    lat0, ctx, m = _request(pipe, 1, 5)
    with telemetry.recording():
        _, st = pipe.edit_latents(lat0, ctx, GRID, GRID, forced_mask=m)
    computed = st.rags_steps - st.reuse_steps
    assert computed > 0
    assert pipe._rags_graphs.counts() == (0, 0, computed)
    (edit,) = [s for s in telemetry.spans() if s.name == "pipeline.edit"]
    assert {k: v for k, v in edit.attrs.items()
            if k.startswith("pipeline.rags_graph.")} == {
        "pipeline.rags_graph.replays": 0,
        "pipeline.rags_graph.captures": 0,
        "pipeline.rags_graph.eager": computed}


def test_a_sharded_model_stays_eager(tmp_path):
    pipe = _pipe("tiny-tp")
    assert pipe._graphable(types.SimpleNamespace(is_cuda=True))
    assert not pipe._graphable(torch.zeros(1))
    lat0, ctx, m = _request(pipe, 1, 5)
    want, _ = _pipe("tiny-tp").edit_latents(lat0, ctx, GRID, GRID,
                                            forced_mask=m)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        sharding.shard_params(pipe.model,
                              sharding.make_mesh(device_type="cpu"))
        assert not pipe._graphable(types.SimpleNamespace(is_cuda=True))
        got, st = pipe.edit_latents(lat0, ctx, GRID, GRID, forced_mask=m)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    assert pipe._rags_graphs.counts() == (0, 0,
                                          st.rags_steps - st.reuse_steps)


def _share(n_edits):
    spec = importlib.util.spec_from_file_location("rags_graph_share", SHARE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(types.SimpleNamespace(edits=[{}] * n_edits))


def test_rags_graph_share_reads_the_edits_counts():
    assert _share(1) is None                           # an empty recorder
    with telemetry.recording():
        for replays, eager in ((6, 0), (3, 3)):
            with telemetry.span("pipeline.edit", edit=True) as e:
                e.set(**{"pipeline.rags_graph.replays": replays,
                         "pipeline.rags_graph.captures": 1,
                         "pipeline.rags_graph.eager": eager})
    assert _share(0) is None                           # no edits
    assert _share(3) is None                           # 2 edit spans, 3 edits
    assert _share(2) == pytest.approx(100 * 9 / 12)
    telemetry.clear()
    with telemetry.recording():                        # no RAGS forward
        with telemetry.span("pipeline.edit", edit=True) as e:
            e.set(**{"pipeline.rags_graph.replays": 0,
                     "pipeline.rags_graph.eager": 0})
    assert _share(1) is None
    telemetry.clear()
    with telemetry.recording():                        # no counts: a parent
        with telemetry.span("pipeline.edit", edit=True):
            pass
    assert _share(1) is None


def test_each_edit_span_holds_its_own_edits_counts():
    pipe = _through_the_runner(_pipe())
    reqs = [_request(pipe, seed, n) for seed, n in ((1, 5), (2, 20))]
    with telemetry.recording():
        stats = [pipe.edit_latents(lat0, ctx, GRID, GRID, forced_mask=m)[1]
                 for lat0, ctx, m in reqs]
        _, group = pipe.edit_latents_batch(
            [r[0] for r in reqs], [r[1] for r in reqs], GRID, GRID,
            forced_masks=[r[2] for r in reqs])
    edits = [s for s in telemetry.spans() if s.name == "pipeline.edit"]
    # the group computes its forwards once, at the larger capacity
    computed = [st.rags_steps - st.reuse_steps for st in (*stats, group[0])]
    assert [s.attrs["pipeline.rags_graph.eager"] for s in edits] == computed
    assert all(s.attrs["pipeline.rags_graph.replays"] ==
               s.attrs["pipeline.rags_graph.captures"] == 0 for s in edits)
    assert pipe._rags_graphs.counts() == (0, 0, sum(computed))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


# head_dim 128 in bf16, as the kernels take
SMALL = dict(hidden=256, heads=2, head_dim=128, txt_in_dim=64,
             axes_dims=(16, 56, 56), time_embed_dim=256, mlp_ratio=2.0,
             in_channels=64, out_channels=64, dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,cls,group,kw", [
    (MMDiTConfig(**SMALL, depth_double=2, depth_single=2, pooled_dim=64,
                 guidance_embed=True), FluxKontextPipeline, 1, {}),
    (MMDiTConfig(**{**SMALL, "txt_in_dim": 256}, depth_double=2,
                 depth_single=2, pooled_dim=64,
                 connector=ConnectorConfig(in_dim=64, hidden=256, heads=2,
                                           pooled_dim=64, mlp_ratio=2.0)),
     Step1XEditPipeline, 1, {}),
    (MMDiTConfig(**SMALL, depth_double=3, depth_single=0, pooled_dim=0,
                 txt_norm=True, cache_int8=True), QwenImageEditPipeline, 2,
     {}),
], ids=["flux-b1", "step1x-cfg-b2", "qwen-int8-group"])
def test_a_replayed_forward_equals_the_eager_one(cuda_device, cfg, cls,
                                                 group, kw):
    pipe = _pipe(cfg, cls, device=cuda_device, **kw)
    reqs = [_request(pipe, s, 12, t_txt=16, device=cuda_device)
            for s in range(group)]
    ctx = reqs[0][1]
    if group > 1:
        ctx = dataclasses.replace(ctx, **{
            f: torch.cat([getattr(c, f)[k:k + 1] for k in range(
                getattr(ctx, f).shape[0]) for _, c, _ in reqs])
            for f in ("txt", "pooled", "guidance")
            if getattr(ctx, f) is not None})
    ctx = dataclasses.replace(ctx, s_noise=GRID * GRID)
    rows = pipe._cfg_rows(group)
    with torch.inference_mode():
        cache = pipe._kv_cache(rows, 2 * GRID * GRID)
        lat_full = torch.cat([lat for lat, _, _ in reqs])
        pipe.dense_forward(lat_full, 0.9, cache, dataclasses.replace(
            ctx, cond_latent=torch.cat([c.cond_latent for _, c, _ in reqs])),
            True)
        for cap, sigma in ((16, 0.7), (16, 0.6), (24, 0.5), (16, 0.4),
                           (24, 0.3), (24, 0.2)):
            ids = torch.stack([torch.randperm(GRID * GRID, device=cuda_device)
                               [:cap] for _ in range(group)]).int()
            ids[:, -3:] = GRID * GRID           # sentinel pads
            if group == 1:
                ids = ids[0]
            lat = torch.randn(group, cap, cfg.in_channels,
                              device=cuda_device)
            want, _ = pipe._rags(lat, sigma, cache, ids, ctx)
            got, _ = pipe.rags_forward(lat.clone(), sigma, cache, ids.clone(),
                                       ctx)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (cap, sigma)
    # per capacity: one eager call, one capture, then replays
    assert pipe._rags_graphs.counts() == (4, 2, 2)


def _recorded(pipe, name, out):
    """Note the latents of each call of the pipeline's method `name`."""
    method = getattr(pipe, name)

    def call(*a, **kw):
        lat, stats = method(*a, **kw)
        out.append([x.clone() for x in lat] if isinstance(lat, list)
                   else lat.clone())
        return lat, stats
    setattr(pipe, name, call)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["run", "run_batched"])
def test_a_service_replays_bit_equal_to_its_eager_run(cuda_device, batched):
    cfg = MMDiTConfig(**{**SMALL, "txt_in_dim": 256}, depth_double=2,
                      depth_single=2, pooled_dim=64,
                      connector=ConnectorConfig(in_dim=64, hidden=256,
                                                heads=2, pooled_dim=64,
                                                mlp_ratio=2.0))
    pipe = _pipe(cfg, Step1XEditPipeline, device=cuda_device)
    # 16 latent channels packed 2 x 2 into the backbone's 64
    pipe.attach_vae(init_vae_params(
        dataclasses.replace(VAE, latent_channels=16),
        torch.Generator(cuda_device).manual_seed(1), device=cuda_device))
    pipe.attach_text_encoder(MockTextEncoder(64, 64, max_length=16))
    reqs = [EditRequest(image=img, prompt=f"edit {i}", width=32, height=32,
                        seed=i) for i, img in enumerate(_images(3, 5))]
    name = "edit_latents_batch" if batched else "edit_latents"

    def serve(graphs: bool):
        if graphs:
            del pipe._graphable
        else:
            pipe._graphable = lambda x: False
        lats = []
        _recorded(pipe, name, lats)
        svc = EditService(pipe)
        if batched:
            # groups of 2, 2, 1, then 2, 1: each change of size a new
            # cache, new graphs and a new pool
            res = svc.run_batched(reqs, max_batch=2) + svc.run_batched(
                reqs[:3], max_batch=2)
        else:
            res = svc.run(reqs[:3]) + svc.run(reqs[3:])
        del pipe.__dict__[name]
        torch.cuda.synchronize()
        return res, lats

    want, want_lats = serve(graphs=False)
    eager = pipe._rags_graphs.counts()
    assert eager[:2] == (0, 0) and eager[2] > 0
    got, got_lats = serve(graphs=True)
    replays, captures, _ = pipe._rags_graphs.counts()
    assert replays > captures > 0
    assert len(got_lats) == len(want_lats) == 5
    for g, w in zip(got_lats, want_lats):
        for a, b in zip(g if batched else [g], w if batched else [w]):
            assert torch.equal(a, b)
    for g, w in zip(got, want):
        assert g.stats == w.stats
        np.testing.assert_array_equal(g.image, w.image)
