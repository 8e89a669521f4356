"""The port's measuring entry points (`regione_tpu_torch.bench`) against the
JAX package's `bench.py` and `scripts/{profile_steps,bench_serve_batch,
bench_fullsize}.py`.

  * the headline at `tiny`, grid 16: the structured condition latent and
    its mask equal those of a JAX probe built from `bench.py`'s own calls
    (`bench.py:198-236`) on the same params (the JAX init through
    `weights.from_jax`) and numpy draws; then the dense, the adaptive and
    the forced-mask edits: equal plan statistics, latents within 5e-4 (the
    tolerance of tests/test_torch_pipeline.py, fp32 on the CPU: 28 Euler
    steps at CFG scale 6 amplify summation-order differences); the row's
    keys are `bench.py`'s;
  * `params` of `step1x-edit:dev`, counted on the meta device, equals the
    JAX package's count in `BENCH_r04.json` (1,259,147,328);
  * `profile_steps`' plan counts equal the JAX plan's, for each backend;
  * `serve_batch` in both modes at `tiny` with two requests, and its OOM
    row;
  * `fullsize`: its memplan bytes equal the JAX script's `plan()` call,
    and it writes its artifact only where `--out` says (by default under
    build/bench/ of the checkout, never the repo root);
  * a reference on the card (`cuda`; JAX is installed on the card's
    machine): the headline flow on a small Step1X topology with head_dim
    128 (hidden 256, 2 double + 2 single blocks; the card's attention
    kernels take head_dim 128 only) at grid 32, the JAX package on the CPU
    in fp32 and the port on the card in bf16, the same numpy params and
    noise: equal plan statistics, latent PSNR >= 30 dB (PERF.md section 2);
  * the port's sampler against tests/oracle.py::oracle_edit (the
    reference-style loop with dynamic shapes and host control flow) on the
    CPU, as tests/test_sampler_tiny.py holds the JAX sampler: 5e-4.

Helpers are imported by module name (`torch_cpu`, `oracle`): the card's
machine has a package named `tests` of its own.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regione_tpu.core.config import RegionEParams as JRegionEParams
from regione_tpu.core.gamma import gamma_for as j_gamma_for
from regione_tpu.core.partition import select_edited_mask as j_select
from regione_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig
from regione_tpu.models.mmdit import init_mmdit, param_count as j_param_count
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.pipelines.base import EditInputs as JEditInputs
from regione_tpu.pipelines.flux_kontext import (
    FluxKontextPipeline as JFluxKontextPipeline)
from regione_tpu.pipelines.qwen_image_edit import (
    QwenImageEditPipeline as JQwenImageEditPipeline)
from regione_tpu.pipelines.step1x_edit import (
    Step1XEditPipeline as JStep1XEditPipeline)
from regione_tpu.utils.memplan import plan as j_plan
from regione_tpu_torch.bench import common, fullsize, headline, profile_steps
from regione_tpu_torch.bench import serve_batch
from regione_tpu_torch.models import presets
from regione_tpu_torch.core.config import RegionEParams
from regione_tpu_torch.core.gamma import gamma_for
from regione_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from regione_tpu_torch.pipelines.base import EditInputs, EditPipelineBase
from regione_tpu_torch.weights.from_jax import mmdit_from_jax
from oracle import oracle_edit
from torch_cpu import jax_schedule  # noqa: F401 (fixture)
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=5e-4, atol=5e-4)
GRID, T_TXT = 16, 8


def _row_keys(script, index=-1):
    """The string keys of a JSON row the JAX script writes: its dict
    literals whose first key is "metric" or "preset", in source order (the
    `**` spreads are not keys)."""
    tree = ast.parse((REPO / script).read_text())
    rows = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Dict)
                   and n.keys and isinstance(n.keys[0], ast.Constant)
                   and n.keys[0].value in ("metric", "preset")),
                  key=lambda n: n.lineno)
    return [k.value for k in rows[index].keys if k is not None]


def _jax_bench_probe(cfg, params, grid, t_txt, seed):
    """`bench.py:158-236` at another preset and grid: the same JAX calls."""
    re = JRegionEParams().replace(threshold=0.88, cache_threshold=0.02)
    pipe = JStep1XEditPipeline(cfg, params, re)
    rng = np.random.default_rng(seed)
    s = grid * grid
    rope_img, rope_txt = pipe.build_rope(grid, grid, t_txt)
    lat0 = jnp.asarray(rng.standard_normal((1, s, cfg.in_channels)),
                       jnp.float32)
    txt = jnp.asarray(rng.standard_normal((2, t_txt, cfg.txt_in_dim)),
                      cfg.dtype)
    pooled = jnp.asarray(rng.standard_normal((2, cfg.pooled_dim)), cfg.dtype)

    def make_ctx(cond):
        return JEditInputs(txt=txt, cond_latent=jnp.asarray(cond, jnp.float32),
                           rope_img=rope_img, rope_txt=rope_txt, pooled=pooled)

    b0, b1 = grid // 16, grid // 2
    block = np.zeros((grid, grid), bool)
    block[b0:b1, b0:b1] = True
    target = block.reshape(-1)
    sampler = pipe.sampler_for(grid, grid, t_txt, batch_cache=2)
    warm = sampler.plan[: re.warmup_step - 1]
    part = sampler.plan[re.warmup_step - 1]

    @jax.jit
    def x0_probe(lat, ctx):
        lat = lat.astype(jnp.float32)
        sig = jnp.array([sp.sigma for sp in warm], jnp.float32)
        dts = jnp.array([sp.dt for sp in warm], jnp.float32)

        def body(l, xs):
            sg, dt = xs
            v, _ = pipe.dense_forward(l, sg, None, ctx, False)
            return l + dt * v.astype(jnp.float32), None

        lat, _ = jax.lax.scan(body, lat, (sig, dts))
        v, _ = pipe.dense_forward(lat, jnp.float32(part.sigma), None, ctx,
                                  False)
        return lat + part.dt_final * v.astype(jnp.float32)

    def ctx_extra(ctx):
        return dataclasses.replace(ctx, extra={"params": params,
                                               "s_noise": s})

    noise_block = rng.standard_normal((int(target.sum()), cfg.in_channels))
    cond = rng.standard_normal((1, s, cfg.in_channels))
    for it in range(3):
        x0 = np.asarray(x0_probe(lat0, ctx_extra(make_ctx(cond))))
        cond = x0.copy()
        cond[0, target] = noise_block
        mask = np.asarray(j_select(
            jnp.asarray(x0), jnp.asarray(cond, jnp.float32), re.threshold,
            grid_h=grid, grid_w=grid, erosion_dilation=re.erosion_dilation))
        frac = float(mask.mean())
        if 0.18 <= frac <= 0.35 and it >= 1:
            break
    return pipe, lat0, make_ctx(cond), cond, mask


def _bench_r04():
    """The JAX package's headline row of its fourth round."""
    return json.loads((REPO / "BENCH_r04.json").read_text())["parsed"]


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(0),
                                               j_get_config("tiny")))


def test_headline_matches_bench_py(monkeypatch, tiny_params):
    cfg = j_get_config("tiny")
    jpipe, jlat0, jctx, jcond, jmask = _jax_bench_probe(
        cfg, tiny_params, GRID, T_TXT, 110)
    jdense, _ = jpipe.edit_latents(jlat0, jctx, GRID, GRID, dense_only=True)
    jout, jstats = jpipe.edit_latents(jlat0, jctx, GRID, GRID)
    fmask = np.zeros((GRID, GRID), bool)
    fmask[:GRID // 2, :GRID // 2] = True
    _, jfstats = jpipe.edit_latents(jlat0, jctx, GRID, GRID,
                                    forced_mask=jnp.asarray(fmask.reshape(-1)))

    def model():
        return mmdit_from_jax(tiny_params, presets.get_config("tiny"), "cpu")

    # the probe as `headline.prepare` runs it, its mask kept
    w = headline.prepare("tiny", GRID, T_TXT, 110, "cpu", model())
    np.testing.assert_allclose(w.ctx.cond_latent.numpy(), jcond, **TOL)
    pipe = w.pipe
    rng, lat0, txt, pooled = common.seeded_inputs(pipe, GRID, T_TXT, 110)
    cond, mask = common.structured_condition(
        pipe, pipe.sampler_for(GRID, GRID, T_TXT, 2),
        common.make_ctx(pipe, GRID, txt, pooled), lat0, rng)
    np.testing.assert_array_equal(lat0.numpy(), np.asarray(jlat0))
    np.testing.assert_array_equal(mask, jmask)
    assert 0 < mask.sum() < GRID * GRID
    np.testing.assert_allclose(cond, jcond, **TOL)

    # the row, with the decoder stubbed (the pixel probe has its own tests)
    from regione_tpu_torch.eval import pixelprobe
    pix = {"psnr_pixel_vs_dense": 40.0, "ssim_pixel_vs_dense": 0.99,
           "pixel_decoder": "stub"}
    monkeypatch.setattr(pixelprobe, "pixel_psnr_vs_dense",
                        lambda *a, **k: pix)
    row, stats, launches = headline.run("tiny", GRID, T_TXT, 110, runs=1,
                                        device="cpu", model=model())
    assert list(row) == (_row_keys("bench.py")[:7] + list(pix)
                         + _row_keys("bench.py")[7:])
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert 0 < stats.edited_tokens < GRID * GRID and stats.rags_steps > 0
    assert (row["edited_tokens"], row["capacity"], row["reuse_steps"],
            row["seq_len"]) == (jstats.edited_tokens, jstats.capacity,
                                jstats.reuse_steps, jstats.seq_len)
    assert row["forced_edited_tokens"] == jfstats.edited_tokens
    assert row["params"] == j_param_count(tiny_params)
    assert row["device"] == "cpu" and row["model"] == "tiny"
    assert len(launches) == 2 and all(v == 0 for d in launches
                                      for v in d.values())
    # the latents: the port's edits of the probed request against JAX's
    got_dense, _ = pipe.edit_latents(lat0, w.ctx, GRID, GRID,
                                     dense_only=True)
    got, got_stats = pipe.edit_latents(lat0, w.ctx, GRID, GRID)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(jstats)
    np.testing.assert_allclose(got_dense.numpy(), np.asarray(jdense), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), **TOL)
    want_psnr = common.psnr(np.asarray(jdense), np.asarray(jout))
    assert abs(row["psnr_latent_vs_dense"] - want_psnr) < 0.1


def test_headline_params_at_dev_equal_the_jax_count():
    model = MMDiT(presets.get_config("step1x-edit:dev"), torch.device("meta"))
    # BENCH_r04.json, the JAX package's count of the same preset
    assert common.param_count(model) == 1_259_147_328
    assert _bench_r04()["params"] == 1_259_147_328


@pytest.mark.usefixtures("jax_schedule")
@pytest.mark.parametrize("preset,backend,jpipe", [
    ("tiny", "step1x-edit", JStep1XEditPipeline),
    ("tiny-qwen", "qwen-image-edit", JQwenImageEditPipeline),
    ("tiny-flux", "flux-kontext", JFluxKontextPipeline)])
def test_profile_steps_plan_counts_match_jax(preset, backend, jpipe):
    row = profile_steps.run(preset, 8, 4, runs=1, device="cpu",
                            backend=backend)
    assert list(row) == _row_keys("scripts/profile_steps.py")
    jplan = jpipe(j_get_config(preset), None, JRegionEParams().replace(
        **_knobs(backend))).sampler_for(8, 8, 4, batch_cache=2).plan
    want = {"dense": sum(1 for sp in jplan
                         if sp.dense and sp.kv_phase != "cache_write"),
            "write": sum(1 for sp in jplan if sp.kv_phase == "cache_write"),
            "rags": sum(1 for sp in jplan if sp.is_rags and not sp.reuse),
            "reuse": sum(1 for sp in jplan if sp.reuse)}
    assert row["plan_counts"] == want
    assert row["dense_ms"] > 0 and row["est_ratio"] > 1
    # bench.py's grid: the plan alone (its 14 reuse steps)
    pipe = common.build(preset, "cpu", backend=backend)
    got = profile_steps.plan_counts(pipe.sampler_for(64, 64, 128, 2).plan)
    jplan = jpipe(j_get_config(preset), None, JRegionEParams().replace(
        **_knobs(backend))).sampler_for(64, 64, 128, batch_cache=2).plan
    assert got["reuse"] == sum(1 for sp in jplan if sp.reuse)
    if backend == "step1x-edit":
        assert got["reuse"] == _bench_r04()["reuse_steps"]


def _knobs(backend):
    from regione_tpu.core.config import DEFAULT_PARAMS
    re = DEFAULT_PARAMS[backend]
    return dict(threshold=re.threshold, cache_threshold=re.cache_threshold)


def test_serve_batch_both_modes_at_tiny(monkeypatch):
    row, detail = serve_batch.run(batch=2, grid=8, t_txt=4, preset="tiny",
                                  runs=1, device="cpu")
    assert list(row) == _row_keys("scripts/bench_serve_batch.py", 1)
    assert row["batch"] == 2 and row["max_abs_err_vs_single"] < 1e-4
    np.testing.assert_allclose(detail["batched"], detail["single"], **TOL)
    # scripts/bench_serve_batch.py:171-175
    from regione_tpu.models.mmdit import init_cache as j_init_cache
    jcfg = dataclasses.replace(j_get_config("tiny"), cache_int8=True)
    want = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree.leaves(jax.eval_shape(
                   lambda: j_init_cache(jcfg, 2, 2 * 64, 4)))) * 2 / 2**30
    assert row["cache_sets_gib"] == round(want, 3) and row["device"] == "cpu"
    svc = serve_batch.service_e2e("tiny", requests=2, device="cpu", size=64)
    assert list(svc) == _row_keys("scripts/bench_serve_batch.py")
    assert svc["requests"] == 2 and svc["wall_s"] > 0

    # a group that does not fit: the OOM row, and nothing but that error
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 512.00 MiB.")

    from regione_tpu_torch.pipelines.base import EditPipelineBase
    monkeypatch.setattr(EditPipelineBase, "edit_latents_batch", oom)
    row, detail = serve_batch.run(batch=2, grid=8, t_txt=4, preset="tiny",
                                  runs=1, device="cpu")
    assert list(row) == _row_keys("scripts/bench_serve_batch.py", 0)
    assert detail is None and row["oom"] is True
    assert row["hbm_needed_gib"] == 0.5 and row["hbm_capacity_gib"] is None

    def other(*a, **k):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(EditPipelineBase, "edit_latents_batch", other)
    with pytest.raises(RuntimeError, match="not a memory error"):
        serve_batch.run(batch=2, grid=8, t_txt=4, preset="tiny", runs=1,
                        device="cpu")


@pytest.mark.parametrize("preset,flags", [
    ("step1x-edit", []), ("step1x-edit", ["--int4"]),
    ("flux-kontext", ["--act-int8"]), ("qwen-image-edit", ["--cache-int4"]),
    ("qwen-image-edit", ["--int4"])])
def test_fullsize_memplan_matches_the_jax_script(preset, flags):
    args = fullsize.parse_args(["--preset", preset, *flags])
    got = fullsize.memory_plan(args)
    # scripts/bench_fullsize.py:203-215
    cfg = dataclasses.replace(j_get_config(preset),
                              cache_int8=not args.cache_int4,
                              cache_int4=args.cache_int4,
                              act_int8=args.act_int8)
    if args.blocks is not None:
        cfg = dataclasses.replace(cfg, depth_double=args.blocks)
    want = j_plan(cfg, grid=args.grid, t_txt=args.t_txt, tp=1, int8=True,
                  batch_cfg=1 if preset == "flux-kontext" else 2,
                  quantize_mods=True, cache_dtype=jnp.int8,
                  bits=4 if args.int4 else 8, int4_mods=args.int4,
                  cache_bits=4 if args.cache_int4 else 8)
    assert got.param_bytes == want.param_bytes_per_device
    assert got.cache_bytes == want.cache_bytes_per_device
    assert got.total_bytes == want.total_bytes_per_device
    assert got.params_total == want.params_total


def test_fullsize_writes_only_under_out(monkeypatch, tmp_path):
    default = fullsize.parse_args([])
    assert Path(default.out) == REPO / "build" / "bench" / "FULLSIZE.json"
    assert (default.grid, default.t_txt) == (44, 128)
    assert Path(fullsize.parse_args(["--preset", "qwen-image-edit",
                                     "--int4"]).out).name == \
        "FULLSIZE_QWEN60.json"
    # a small Step1X-topology backbone in place of the published one
    monkeypatch.setitem(presets.PRESETS, "step1x-edit",
                        presets.PRESETS["tiny-step1x"])
    out = tmp_path / "out" / "row.json"
    before = sorted(p.name for p in REPO.iterdir())
    args = fullsize.parse_args(["--grid", "16", "--t-txt", "8", "--runs",
                                "1", "--device", "cpu", "--adaptive",
                                "--skip-pixel-psnr", "--out", str(out)])
    row = fullsize.run(args)
    assert sorted(p.name for p in REPO.iterdir()) == before
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == [
        "row.json"]
    assert json.loads(out.read_text()) == row
    assert row["partition"] == "adaptive"
    assert 0 < row["edited_tokens"] < 256 and row["weight_bits"] == 8
    assert "forced_mask_s" in row and row["device"] == "cpu"


# the card reference's topology: Step1X (double + single blocks, pooled
# vector, no connector) at head_dim 128
SMALL = dict(hidden=256, heads=2, head_dim=128, depth_double=2,
             depth_single=2, time_embed_dim=64, mlp_ratio=2.0, in_channels=16,
             out_channels=16, txt_in_dim=64, pooled_dim=32)
PSNR_MIN = 30.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_headline_on_the_card_matches_jax_on_the_cpu(monkeypatch,
                                                      cuda_device):
    grid, t_txt = 32, 16
    jcfg = JMMDiTConfig(**SMALL, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(0), jcfg))
    jpipe, jlat0, jctx, _, _ = _jax_bench_probe(jcfg, params, grid, t_txt,
                                                110)
    jdense, _ = jpipe.edit_latents(jlat0, jctx, grid, grid, dense_only=True)
    jout, jstats = jpipe.edit_latents(jlat0, jctx, grid, grid)
    assert 0 < jstats.edited_tokens < grid * grid

    cfg = MMDiTConfig(**SMALL, dtype=torch.bfloat16)
    monkeypatch.setitem(presets.PRESETS, "step1x-small-128", cfg)
    w = headline.prepare("step1x-small-128", grid, t_txt, 110, cuda_device,
                         mmdit_from_jax(params, cfg, cuda_device))
    dense, _ = w.pipe.edit_latents(w.lat0, w.ctx, grid, grid,
                                   dense_only=True)
    common.reset_counts()
    out, stats = w.pipe.edit_latents(w.lat0, w.ctx, grid, grid)
    launches = common.read_counts()
    assert (stats.edited_tokens, stats.capacity, stats.dense_steps,
            stats.rags_steps, stats.reuse_steps) == (
        jstats.edited_tokens, jstats.capacity, jstats.dense_steps,
        jstats.rags_steps, jstats.reuse_steps)
    assert common.psnr(np.asarray(jdense), dense) >= PSNR_MIN
    assert common.psnr(np.asarray(jout), out) >= PSNR_MIN
    assert launches["fused_partition"] == 1
    assert launches["attention"] > 0 and launches["attention_rows2"] > 0


@pytest.mark.parametrize("erosion_dilation,threshold",
                         [(False, 0.0), (True, 0.2)])
def test_sampler_matches_the_reference_oracle(erosion_dilation, threshold,
                                              tiny_params):
    """tests/test_sampler_tiny.py's inputs and knobs, the port's sampler."""
    grid, t_txt = 8, 4
    s = grid * grid
    kw = dict(threshold=threshold, cache_threshold=0.05,
              erosion_dilation=erosion_dilation, refresh_step=(16,),
              capacity_granularity=8)
    cfg = presets.get_config("tiny")
    pipe = EditPipelineBase(mmdit_from_jax(tiny_params, cfg, "cpu"),
                            RegionEParams(**kw),
                            gamma=gamma_for("step1x-edit"))
    rng = np.random.default_rng(1)
    txt = rng.standard_normal((1, t_txt, cfg.txt_in_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32)
    cond = rng.standard_normal((1, s, cfg.in_channels)).astype(
        np.float32) * 0.5
    lat0 = rng.standard_normal((1, s, cfg.in_channels)).astype(np.float32)
    rope_img, rope_txt = pipe.build_rope(grid, grid, t_txt)
    ctx = EditInputs(txt=torch.from_numpy(txt),
                     cond_latent=torch.from_numpy(cond), rope_img=rope_img,
                     rope_txt=rope_txt, pooled=torch.from_numpy(pooled))
    got, stats = pipe.edit_latents(torch.from_numpy(lat0), ctx, grid, grid)
    want, edited = oracle_edit(
        tiny_params, j_get_config("tiny"), JRegionEParams(**kw),
        j_gamma_for("step1x-edit"), lat0, cond, txt, grid, grid,
        pooled=pooled)
    assert 0 < stats.edited_tokens < s and stats.reuse_steps > 0
    assert stats.edited_tokens == len(edited)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    import inspect

    from regione_tpu_torch import graft_entry
    for fn in (headline.prepare, headline.run, profile_steps.run,
               serve_batch.run, serve_batch.service_e2e, graft_entry.entry,
               graft_entry._build, graft_entry.dryrun_multichip):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__
    assert fullsize.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: headline.main([]),
                 lambda: profile_steps.main(["--preset", "tiny"]),
                 lambda: serve_batch.main(["--preset", "tiny"]),
                 lambda: fullsize.main(["--skip-pixel-psnr"]),
                 lambda: graft_entry.entry("tiny", 8, 4),
                 lambda: graft_entry.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            call()
