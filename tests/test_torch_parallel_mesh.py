"""The port's tensor and data parallelism on a (dp 2, tp 4) gloo mesh of 8
CPU processes, against the JAX package on its 8-virtual-device mesh.

Mirrors tests/test_parallel.py case for case, on the `tiny-tp` and
`tiny-qwen-tp` presets (8 heads, every feature dim divisible by 4): the
sharded dense forward; the full four-segment RegionE loop (warm steps,
partition, RAGS against a tp-sharded cache, refresh, reuse runs, SMS) for
the Step1X and the Qwen topologies with the unquantized and the int8
cache; the batch sampling over dp (each dp rank denoises its own request);
each rank holding only its slices (weights, cache).  And the port's own:
row-parallel W8A8 linears bit-equal to the whole layer, int4 ones with each
rank's dequantized weight bit-equal to its slice of the whole; a quantized
model sharded against the same model whole, its bytes per rank against
memplan's; a rank's shard read from a checkpoint file.

One process group runs every case (`tests/torch_parallel_worker.py`), in 8
processes spawned once for this module, with a hard limit of 60 s after
which they are killed: a hung collective fails the tests instead of
running the suite into its time limit.  The JAX side runs meanwhile in this
process.  The same params (the JAX init, through `weights.from_jax`) and
numpy inputs go to both.  Tolerances are the JAX tests': 2e-4 in fp32,
2e-3 with the int8 cache; edited_tokens equal.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from regione_tpu.core.config import RegionEParams as JRegionEParams
from regione_tpu.core.gamma import gamma_for
from regione_tpu.models.mmdit import init_mmdit
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.parallel import sharding as jsharding
from regione_tpu.pipelines.base import EditInputs as JEditInputs
from regione_tpu.pipelines.base import EditPipelineBase as JEditPipelineBase
from regione_tpu.pipelines.step1x_edit import (
    Step1XEditPipeline as JStep1XEditPipeline)
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.ops.quant import quantize_params
from regione_tpu_torch.weights import checkpoint
from regione_tpu_torch.weights.from_jax import convert_params, mmdit_from_jax
from tests.test_parallel import (_full_loop_inputs, _full_loop_run,
                                 _full_qwen_loop_run)

REPO = Path(__file__).resolve().parents[1]
WORLD, DP = 8, 2
LIMIT_S = 60.0
LOOP_RE = dict(threshold=0.3, cache_threshold=0.05, capacity_granularity=8)
BATCH_RE = dict(threshold=0.0, erosion_dilation=False, cache_threshold=0.05,
                capacity_granularity=8)
# (preset, pipeline, cache flags, JAX key seed, input seed, tolerance)
LOOPS = {
    "step1x": ("tiny-tp", "step1x", {}, 9, 11, 2e-4),
    "step1x_int8": ("tiny-tp", "step1x", {"cache_int8": True}, 9, 11, 2e-3),
    "qwen": ("tiny-qwen-tp", "qwen", {}, 13, 13, 2e-4),
    "qwen_int8": ("tiny-qwen-tp", "qwen", {"cache_int8": True}, 13, 13,
                  2e-3),
}


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(_np(x)))


def _state(params):
    return convert_params(jax.tree.map(np.asarray, params), "cpu")[0]


def _dense_inputs(cfg, grid=4, t_txt=8):
    rng = np.random.default_rng(0)
    s = grid * grid
    f = np.float32
    return dict(txt=rng.standard_normal((2, t_txt, cfg.txt_in_dim)).astype(f),
                cond=rng.standard_normal((1, s, cfg.in_channels)).astype(f),
                pooled=rng.standard_normal((2, cfg.pooled_dim)).astype(f),
                lat=rng.standard_normal((1, s, cfg.in_channels)).astype(f))


def _batch_inputs(cfg, grid=8, t_txt=4, b=2):
    rng = np.random.default_rng(5)
    s = grid * grid
    xs = []
    for _ in range(b):
        x = dict(txt=rng.standard_normal((1, t_txt, cfg.txt_in_dim)),
                 cond=rng.standard_normal((1, s, cfg.in_channels)),
                 pooled=rng.standard_normal((1, cfg.pooled_dim)))
        x["lat0"] = rng.standard_normal((1, s, cfg.in_channels))
        xs.append({k: v.astype(np.float32) for k, v in x.items()})
    return xs


def _torch_x(x):
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


def _cases(work):
    """The children's cases, and what the JAX side needs for each."""
    cases, jax_side = {}, {}
    cfg = j_get_config("tiny-tp")
    params = init_mmdit(jax.random.PRNGKey(0), cfg)
    dense = _dense_inputs(cfg)
    cases["dense"] = dict(kind="dense", preset="tiny-tp",
                          state=_state(params), x=_torch_x(dense), grid=4)
    jax_side["dense"] = (params, dense)
    for name, (preset, pipe, flags, key, seed, _) in LOOPS.items():
        jcfg = dataclasses.replace(j_get_config(preset), **flags)
        jparams = init_mmdit(jax.random.PRNGKey(key), jcfg)
        lat0, txt, cond, pooled = _full_loop_inputs(jcfg, 8, 8, seed=seed)
        x = dict(lat0=_t(lat0), txt=_t(txt), cond=_t(cond))
        if pipe == "step1x":
            x["pooled"] = _t(pooled)
        cases[name] = dict(kind="loop", preset=preset, pipe=pipe,
                           flags=flags, re=LOOP_RE, state=_state(jparams),
                           x=x, grid=8)
        jax_side[name] = (jcfg, jparams, (lat0, txt, cond, pooled))
    xs = _batch_inputs(cfg)
    cases["batch"] = dict(kind="batch", preset="tiny-tp", re=BATCH_RE,
                          state=_state(params),
                          xs=[_torch_x(x) for x in xs], grid=8)
    jax_side["batch"] = (params, xs)
    cases["batch3"] = dict(kind="batch", preset="tiny-tp", re=BATCH_RE,
                           state=_state(params), whole=True, grid=8,
                           xs=[_torch_x(x) for x in _batch_inputs(cfg, b=3)])
    cases["layers"] = dict(kind="layers", seed=3)
    for bits in (8, 4):
        cases[f"quantized_{bits}"] = dict(
            kind="quantized", preset="tiny-tp", bits=bits,
            state=_state(params), x=_torch_x(dense), grid=4)
    tcfg = get_config("tiny-tp")
    model = quantize_params(mmdit_from_jax(params, tcfg, "cpu"),
                            quantize_mods=True)
    path = work / "tiny_tp_int8.safetensors"
    checkpoint.save(path, model.state_dict())
    cases["checkpoint"] = dict(kind="checkpoint", preset="tiny-tp",
                               path=str(path), x=_torch_x(dense), grid=4)
    return cases, jax_side


def _jax_dense(params, x, mesh=None):
    cfg = j_get_config("tiny-tp")
    pipe = JStep1XEditPipeline(cfg, params, JRegionEParams(),
                               true_cfg_scale=4.0)
    rope_img, rope_txt = pipe.build_rope(4, 4, 8)
    ctx = JEditInputs(txt=jnp.asarray(x["txt"]),
                      cond_latent=jnp.asarray(x["cond"]), rope_img=rope_img,
                      rope_txt=rope_txt, pooled=jnp.asarray(x["pooled"]))
    if mesh is not None:
        ctx = dataclasses.replace(
            ctx, txt=jax.device_put(ctx.txt, NamedSharding(mesh, P("dp"))),
            extra={"params": jsharding.shard_params(params, mesh)})
    v, _ = jax.jit(lambda l, c: pipe.dense_forward(l, 0.9, None, c, False))(
        jnp.asarray(x["lat"]), ctx)
    return _np(v)


def _jax_results(jax_side):
    """Each case's JAX results: unsharded, and on the (dp 2, tp 4) mesh."""
    out = {}
    mesh = jsharding.make_mesh(8, dp=2)
    params, x = jax_side["dense"]
    out["dense"] = {"single": _jax_dense(params, x)}
    with mesh:
        out["dense"]["mesh"] = _jax_dense(params, x, mesh)
    re = JRegionEParams(**LOOP_RE)
    for name, (preset, pipe, *_rest) in LOOPS.items():
        jcfg, jparams, (lat0, txt, cond, pooled) = jax_side[name]
        if pipe == "step1x":
            def run(p):
                return _full_loop_run(jcfg, re, p, 8, 8, lat0, txt, cond,
                                      pooled)
        else:
            def run(p):
                return _full_qwen_loop_run(jcfg, re, p, 8, 8, lat0, txt,
                                           cond)
        single, stats = run(jparams)
        with mesh:
            sharded, mstats = run(jsharding.shard_params(jparams, mesh))
        out[name] = {"single": single, "stats": stats, "mesh": sharded,
                     "mesh_stats": mstats}
    params, xs = jax_side["batch"]
    cfg = j_get_config("tiny-tp")
    pipe = JEditPipelineBase(cfg, params, JRegionEParams(**BATCH_RE),
                             gamma=gamma_for("step1x-edit"))
    rope_img, rope_txt = pipe.build_rope(8, 8, 4)
    ctxs = [JEditInputs(txt=jnp.asarray(x["txt"]),
                        cond_latent=jnp.asarray(x["cond"]),
                        rope_img=rope_img, rope_txt=rope_txt,
                        pooled=jnp.asarray(x["pooled"])) for x in xs]
    outs, stats = pipe.edit_latents_batch(
        [jnp.asarray(x["lat0"]) for x in xs], ctxs, 8, 8)
    out["batch"] = {"outs": [_np(o) for o in outs], "stats": stats}
    return out


def _launch(work):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_worker", str(work),
         str(r), str(WORLD), str(DP)], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]


def _wait(procs, deadline):
    """Wait for every child until `deadline`; kill them all at the deadline
    or as soon as one fails.  Returns an error string or None."""
    error = None
    while any(p.poll() is None for p in procs):
        if any(p.returncode not in (None, 0) for p in procs):
            error = "a rank failed"
            break
        if time.monotonic() > deadline:
            error = f"the group ran past its {LIMIT_S:.0f} s limit"
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    if error is None and any(p.returncode for p in procs):
        error = "a rank failed"
    if error:
        errs = [p.stderr.read()[-3000:] for p in procs if p.returncode]
        error += "\n" + "\n".join(e for e in errs if e)
    for p in procs:
        p.stderr.close()
    return error


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    cases, jax_side = _cases(work)
    torch.save(cases, work / "inputs.pt")
    start = time.monotonic()
    procs = _launch(work)
    try:
        jax_out = _jax_results(jax_side)
    finally:
        error = _wait(procs, start + LIMIT_S)
    if error:
        pytest.fail(f"the 8-rank group: {error}")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out


def _same_on_every_rank(ranks, get):
    first = get(ranks[0])
    for r in ranks[1:]:
        assert torch.equal(get(r), first)
    return first.numpy()


def test_sharded_forward_matches_single_device(run):
    ranks, jax_out = run
    v = _same_on_every_rank(ranks, lambda r: r["dense"]["v"])
    for want in jax_out["dense"].values():
        np.testing.assert_allclose(v, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(LOOPS))
def test_full_regione_loop_under_tp_matches_jax(run, name):
    """Step1X / Qwen topology, unquantized / int8 cache, on (dp 2, tp 4):
    equal edited_tokens and plan, latents within the JAX tolerance of
    JAX's unsharded and sharded loops."""
    ranks, jax_out = run
    tol = LOOPS[name][-1]
    got = _same_on_every_rank(ranks, lambda r: r[name]["out"])
    want = jax_out[name]
    st = ranks[0][name]["stats"]
    assert 0 < st["edited_tokens"] < 64 and st["rags_steps"] > 0
    for key in ("edited_tokens", "capacity", "rags_steps", "reuse_steps",
                "dense_steps"):
        assert st[key] == getattr(want["stats"], key) == \
            getattr(want["mesh_stats"], key), key
    for ref in (want["single"], want["mesh"]):
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_batch_sampling_dp_sharded(run):
    """Two requests on dp 2: each dp rank denoises its own on its tp group
    of 4; every rank returns both, equal to JAX's unsharded batch."""
    ranks, jax_out = run
    want = jax_out["batch"]
    for i, ref in enumerate(want["outs"]):
        got = _same_on_every_rank(ranks, lambda r: r["batch"]["outs"][i])
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    for r in ranks:
        assert r["batch"]["stats"] == [dataclasses.asdict(s)
                                       for s in want["stats"]]


def test_each_rank_holds_only_its_slice(run):
    """tiny-tp at tp 4: a quarter of each split leaf (linear1 and linear2
    per part) and of the cache's heads; in the dp batch one request's cache
    set per rank."""
    ranks, _ = run
    cfg = get_config("tiny-tp")
    h, inner, mh, s_kv = cfg.hidden, cfg.inner, cfg.mlp_hidden, 2 * 64
    for r in ranks:
        loop = r["step1x"]["shapes"]
        assert loop["double_blocks.0.img_attn.q.weight"] == (inner // 4, h)
        assert loop["double_blocks.0.img_attn.out.weight"] == (h, inner // 4)
        assert loop["double_blocks.0.img_mod.weight"] == (6 * h // 4, h)
        assert loop["single_blocks.0.linear1.weight"] == (
            (3 * inner + mh) // 4, h)
        assert loop["single_blocks.0.linear2.weight"] == (h, (inner + mh)
                                                          // 4)
        # the CFG pair's rows, 2 of 8 heads
        assert loop["cache"]["dk"] == (2, 2, 2, s_kv, 16)
        assert r["step1x_int8"]["shapes"]["cache"]["sk_s"] == (2, 2, 2, s_kv)
        # one request (no CFG) of the two on each dp rank
        assert r["batch"]["shapes"]["cache"]["dk"] == (2, 1, 2, s_kv, 16)


@pytest.mark.parametrize("key", ["int8_256", "int8_64"])
def test_row_parallel_w8a8_is_bit_equal(run, key):
    """The row amax all-reduced (MAX), the exact int32 products summed:
    the whole layer's output bit for bit."""
    ranks, _ = run
    for r in ranks:
        assert torch.equal(r["layers"][key]["got"], r["layers"][key]["want"])


@pytest.mark.parametrize("key", ["int4_384", "int4_1024"])
def test_row_parallel_int4_matches_the_whole_layer(run, key):
    """Each rank's repacked codes with its scale groups dequantize to its
    slice of the whole weight bit for bit; the summed output agrees."""
    ranks, _ = run
    for r in ranks:
        res = r["layers"][key]
        assert res["deq_equal"]
        torch.testing.assert_close(res["got"], res["want"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_model_sharded_matches_whole(run, bits):
    """tiny-tp with W8A8 / int4 weights: the sharded dense forward against
    the same model whole; each rank's weight bytes equal memplan's per
    card."""
    ranks, _ = run
    for r in ranks:
        res = r[f"quantized_{bits}"]
        torch.testing.assert_close(res["sharded"], res["whole"], rtol=2e-4,
                                   atol=2e-4)
        assert res["weight_bytes"] == res["plan_bytes"]


def test_sharded_checkpoint_load(run):
    """A rank's shard read from an int8 checkpoint: the bytes cut out of
    the file are its slices' (less than the whole), and its forward
    matches the whole model's."""
    ranks, _ = run
    for r in ranks:
        res = r["checkpoint"]
        assert res["loaded_bytes"] == res["want_bytes"] < res["whole_bytes"]
        torch.testing.assert_close(res["sharded"], res["whole"], rtol=2e-4,
                                   atol=2e-4)


def test_batch_dp_cannot_divide_runs_whole_on_each_dp_rank(run):
    """Three requests on dp 2: every dp rank denoises the whole group on
    its tp group (the JAX package's `device_put` on P("dp") refuses a
    batch dp does not divide); the result is the unsharded group's."""
    ranks, _ = run
    for r in ranks:
        res = r["batch3"]
        assert len(res["outs"]) == 3 and res["stats"] == res["whole_stats"]
        assert res["shapes"]["cache"]["dk"][1] == 3
        for got, want in zip(res["outs"], res["whole"]):
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
