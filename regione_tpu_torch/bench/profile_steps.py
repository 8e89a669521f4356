"""Per-step-kind times of the RegionE path: the port of the JAX package's
`scripts/profile_steps.py`.

Times each step kind alone (the dense forward, the dense forward with the
cache write, the RAGS forward at a capacity) so the end-to-end ratio can be
held against a per-step budget: ratio ~= 28 t_dense / (n_dense t_dense +
n_write t_write + n_rags t_rags).  The step counts come from the preset's
own stage plan (its backend's gamma table and knobs decide how many steps
reuse a velocity).  The cache is written in place (no donation to arrange).

  python -m regione_tpu_torch.bench.profile_steps --preset step1x-edit:dev --grid 64
  python -m regione_tpu_torch.bench.profile_steps --preset step1x-edit --grid 44 --int8 --cache-int8
  python -m regione_tpu_torch.bench.profile_steps --preset qwen-image-edit --grid 48 \\
      --t-txt 512 --int4 --cache-int8 --cap 640

Prints one JSON line; add `--device cpu` to run on the CPU.  Times are the
fastest of `--runs` calls after a warm-up, host wall time ended by
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from regione_tpu_torch.bench import common
from regione_tpu_torch.models.mmdit import init_cache


def plan_counts(plan) -> dict:
    """The plan's step kinds: dense (no cache), write (dense + cache
    write), rags (computed on the edited rows), reuse (AVD, no forward)."""
    n_write = sum(1 for sp in plan if sp.kv_phase == "cache_write")
    n_reuse = sum(1 for sp in plan if sp.reuse)
    n_rags = sum(1 for sp in plan if sp.is_rags and not sp.reuse)
    n_dense = sum(1 for sp in plan
                  if sp.dense and sp.kv_phase != "cache_write")
    if n_dense + n_write + n_rags + n_reuse != len(plan):
        raise AssertionError((n_dense, n_write, n_rags, n_reuse, len(plan)))
    return {"dense": n_dense, "write": n_write, "rags": n_rags,
            "reuse": n_reuse}


def run(preset: str = "step1x-edit:dev", grid: int = 64, t_txt: int = 128,
        cap: int | None = None, int8: bool = False, int4: bool = False,
        cache_int8: bool = False, cache_int4: bool = False,
        act_int8: bool = False, blocks: int | None = None, runs: int = 5,
        device="cuda", backend: str | None = None) -> dict:
    """The JSON row.  `backend`: the pipeline, default the preset's name
    before ":" (a tiny-* preset needs one)."""
    if act_int8 and not int8:
        raise SystemExit("--act-int8 requires --int8 weights")
    fmt = "int4" if cache_int4 else "int8" if cache_int8 else "bf16"
    pipe = common.build(preset, device, backend=backend, int8=int8,
                        int4=int4, act_int8=act_int8, cache=fmt,
                        blocks=blocks)
    cfg, dev = pipe.cfg, pipe.device

    rng = np.random.default_rng(0)
    s = grid * grid
    cap = cap or max(64, (s // 4 + 127) // 128 * 128)
    bc = 2 if pipe.do_cfg else 1

    lat = common.draw(rng, (1, s, cfg.in_channels), dev)
    txt = common.draw(rng, (bc, t_txt, cfg.txt_in_dim), dev, cfg.dtype)
    cond = common.draw(rng, (1, s, cfg.in_channels), dev)
    pooled = common.draw(rng, (bc, cfg.pooled_dim), dev, cfg.dtype)
    guidance = (torch.full((bc,), 2.5, device=dev) if cfg.guidance_embed
                else None)
    ctx = dataclasses.replace(
        common.make_ctx(pipe, grid, txt, pooled, guidance)(cond), s_noise=s)
    cache = init_cache(cfg, bc, 2 * s, dev)
    ids = torch.arange(cap, dtype=torch.int32, device=dev)
    lat_act = common.draw(rng, (1, cap, cfg.in_channels), dev)
    sigma = 0.7

    common.log(f"{preset} grid={grid} cap={cap} int8={int8} int4={int4} "
               f"cache={fmt} act_int8={act_int8} on "
               f"{common.device_name(dev)}", "profile")
    with torch.inference_mode():
        t_dense, _ = common.best_of(
            lambda: pipe.dense_forward(lat, sigma, None, ctx, False), runs)
        common.log(f"dense forward          {t_dense * 1e3:9.1f} ms",
                   "profile")
        t_write, _ = common.best_of(
            lambda: pipe.dense_forward(lat, sigma, cache, ctx, True), 2)
        common.log(f"dense + cache write    {t_write * 1e3:9.1f} ms",
                   "profile")
        t_rags, _ = common.best_of(
            lambda: pipe.rags_forward(lat_act, sigma, cache, ids, ctx), runs)
        common.log(f"rags forward (cap={cap}) {t_rags * 1e3:7.1f} ms",
                   "profile")

    plan = pipe.sampler_for(grid, grid, t_txt, batch_cache=bc).plan
    counts = plan_counts(plan)
    est = (counts["dense"] * t_dense + counts["write"] * t_write
           + counts["rags"] * t_rags)
    full = len(plan) * t_dense
    return {
        "preset": preset,
        "dense_ms": round(t_dense * 1e3, 1),
        "write_ms": round(t_write * 1e3, 1),
        "rags_ms": round(t_rags * 1e3, 1),
        "rags_over_dense": round(t_rags / t_dense, 3),
        "plan_counts": counts,
        "est_regione_s": round(est, 3),
        "est_dense_s": round(full, 3),
        "est_ratio": round(full / est, 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="step1x-edit:dev")
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--t-txt", type=int, default=128)
    ap.add_argument("--cap", type=int, default=None,
                    help="RAGS capacity (default: quarter of grid^2)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int4", action="store_true",
                    help="nibble-packed int4 weights (+int4 mods)")
    ap.add_argument("--cache-int8", action="store_true")
    ap.add_argument("--cache-int4", action="store_true",
                    help="nibble-packed int4 KV cache (S-halves packing)")
    ap.add_argument("--act-int8", action="store_true",
                    help="W8A8: dynamic activation quant (torch._int_mm)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="override depth_double (e.g. the 36-block Qwen)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card cuda stops")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.preset, a.grid, a.t_txt, a.cap, a.int8, a.int4,
                         a.cache_int8, a.cache_int4, a.act_int8, a.blocks,
                         a.runs, a.device)))


if __name__ == "__main__":
    main()
