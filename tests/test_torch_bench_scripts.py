"""The port's `bench.profile_rags` and `bench.fidelity_int8` against the JAX
package's `scripts/profile_rags.py` and `scripts/fidelity_int8.py`, on the
same numpy params and draws (fp32 on the CPU):

  * `profile_rags`: the dense (cache write) and the RAGS forwards it times,
    on the script's state at `tiny` width, grid 8, t_txt 8, cap 16, with
    the bf16 and the int8 cache, against JAX's `dense_forward` /
    `rags_forward` on the zeroed cache (2e-4, the dense forward tests'
    tolerance); the row's keys, with and without `--scan-only`, are the
    script's;
  * `fidelity_int8`: both at hidden 512 (4 heads of 128, so int4 takes the
    linears it takes at full width), 2 + 2 blocks, grid 8, t_txt 16, 3
    steps, from the same fp32 master: each format's forward and trajectory
    SNR within 0.5 dB of the script's (the codes and scales are bit-equal,
    tests/test_torch_quant_weights.py; what differs is the order of the
    sums, and bf16's rounding of it).
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from regione_tpu.models import presets as jpresets
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _run_jax_script(path, argv, monkeypatch, capsys):
    """`main()` of a JAX script with `argv`; returns its last stdout line
    as JSON."""
    monkeypatch.setattr(sys, "argv", [str(path)] + argv)
    runpy.run_path(str(path), run_name="__main__")
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# profile_rags
# ---------------------------------------------------------------------------

def _res_keys(script):
    """The keys the JAX script assigns into `res`, in source order, after
    the literal it starts from."""
    import ast
    tree = ast.parse((REPO / script).read_text())
    start = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and isinstance(n.targets[0], ast.Name)
                 and n.targets[0].id == "res" and isinstance(n.value,
                                                             ast.Dict))
    keys = [k.value for k in start.value.keys]
    subs = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Subscript)
                   and isinstance(n.value, ast.Name) and n.value.id == "res"
                   and isinstance(n.ctx, ast.Store)),
                  key=lambda n: n.lineno)
    return keys + [n.slice.value for n in subs]


@pytest.mark.parametrize("cache_int8", [False, True])
def test_profile_rags_forwards_match_jax(cache_int8):
    """The script's setup at `tiny`, grid 8, t_txt 8, cap 16: its dense
    (cache write) forward and its RAGS forward on the zeroed cache equal
    JAX's; the row's keys are the script's."""
    import jax.numpy as jnp

    from regione_tpu.core.config import RegionEParams as JRegionEParams
    from regione_tpu.models.mmdit import init_cache as j_init_cache
    from regione_tpu.models.mmdit import init_mmdit_jit
    from regione_tpu.pipelines.base import EditInputs as JEditInputs
    from regione_tpu.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.bench import profile_rags
    from regione_tpu_torch.weights.from_jax import mmdit_from_jax

    grid, t_txt, cap = 8, 8, 16
    s = grid * grid
    jcfg = dataclasses.replace(jpresets.get_config("tiny"),
                               cache_int8=cache_int8)
    params = jax.tree.map(np.asarray, init_mmdit_jit(jax.random.PRNGKey(0),
                                                     jcfg))
    jpipe = Step1XEditPipeline(jcfg, params, JRegionEParams())
    rng = np.random.default_rng(0)
    rope_img, rope_txt = jpipe.build_rope(grid, grid, t_txt)
    jctx = JEditInputs(
        txt=jnp.asarray(rng.standard_normal((2, t_txt, jcfg.txt_in_dim)),
                        jcfg.dtype),
        cond_latent=jnp.asarray(rng.standard_normal((1, s,
                                                     jcfg.in_channels)),
                                jnp.float32),
        rope_img=rope_img, rope_txt=rope_txt,
        pooled=jnp.asarray(rng.standard_normal((2, jcfg.pooled_dim)),
                           jcfg.dtype),
        extra={"params": params, "s_noise": s})
    lat = jnp.asarray(rng.standard_normal((1, s, jcfg.in_channels)),
                      jnp.float32)
    lat_act = jnp.asarray(rng.standard_normal((1, cap, jcfg.in_channels)),
                          jnp.float32)
    ids = jnp.asarray(np.arange(cap, dtype=np.int32))
    cache = j_init_cache(jcfg, 2, 2 * s, t_txt)
    want_dense, _ = jpipe.dense_forward(lat, jnp.float32(0.7), cache, jctx,
                                        True)
    want_rags, _ = jpipe.rags_forward(lat_act, jnp.float32(0.5), cache, ids,
                                      jctx)

    argv = ["--preset", "tiny", "--grid", str(grid), "--t-txt", str(t_txt),
            "--cap", str(cap), "--device", "cpu", "--runs", "1"] + (
        ["--cache-int8"] if cache_int8 else [])
    args = profile_rags.parse_args(argv)
    model = mmdit_from_jax(params, dataclasses.replace(
        profile_rags.common.config("tiny"), cache_int8=cache_int8), "cpu")
    st = profile_rags.prepare(args, model)
    with torch.inference_mode():
        got_rags = profile_rags.rags_fwd(st)      # on the zeroed cache
        got_dense = profile_rags.dense_fwd(st)
    np.testing.assert_allclose(got_dense.numpy(), np.asarray(want_dense),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_rags.numpy(), np.asarray(want_rags),
                               rtol=2e-4, atol=2e-4)

    want_keys = _res_keys("scripts/profile_rags.py")
    row = profile_rags.run(args, model)
    assert list(row) == want_keys
    scan = profile_rags.run(profile_rags.parse_args(argv + ["--scan-only"]),
                            model)
    assert list(scan) == ["cap", "cache_int8", "flash", "dense_scan8_ms",
                          "rags_scan8_ms"]
    assert all(row[k] > 0 for k in want_keys if k.endswith("_ms")
               or k.endswith(("_x24", "_x48")))


# ---------------------------------------------------------------------------
# fidelity_int8
# ---------------------------------------------------------------------------

def _narrow(get_config):
    """Step1X-Edit's topology at hidden 512 (4 heads of 128: int4 takes
    every linear of 512 inputs or more, as at full width)."""
    return dataclasses.replace(get_config("step1x-edit"), hidden=512,
                               heads=4, txt_in_dim=64, pooled_dim=32)


def test_fidelity_int8_matches_the_jax_script(monkeypatch, capsys):
    from regione_tpu.models import mmdit as jmmdit
    from regione_tpu_torch.bench import fidelity_int8
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.weights.from_jax import mmdit_from_jax

    jcfg = _narrow(jpresets.get_config)
    monkeypatch.setattr(jpresets, "get_config", lambda name: jcfg)
    seen = {}
    init = jmmdit.init_mmdit

    def keep_master(key, cfg):
        seen["master"] = init(key, cfg)
        return seen["master"]

    monkeypatch.setattr(jmmdit, "init_mmdit", keep_master)
    argv = ["--grid", "8", "--t-txt", "16", "--steps", "3",
            "--depth-double", "2", "--depth-single", "2"]
    want = _run_jax_script(REPO / "scripts" / "fidelity_int8.py", argv,
                           monkeypatch, capsys)
    args = fidelity_int8.parse_args(argv + ["--device", "cpu"])
    base = _narrow(get_config)
    cfg32 = dataclasses.replace(base, depth_double=2, depth_single=2,
                                connector=None, dtype=torch.float32)
    master = mmdit_from_jax(jax.tree.map(np.asarray, seen["master"]), cfg32,
                            "cpu")
    got = fidelity_int8.run(args, base=base, master=master)
    assert list(got)[:len(want)] == list(want)
    for key, value in want.items():
        if isinstance(value, dict):
            for fmt, snr in value.items():
                assert abs(got[key][fmt] - snr) <= 0.5, (key, fmt)
        elif "snr" in key:
            assert abs(got[key] - value) <= 0.5, key
        else:
            assert got[key] == value, key
