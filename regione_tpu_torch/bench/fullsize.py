"""A published-width backbone with quantized weights and KV cache on one
card, RegionE against dense: the port of the JAX package's
`scripts/bench_fullsize.py`.

    python -m regione_tpu_torch.bench.fullsize [--preset step1x-edit]
        [--grid 44] [--t-txt 128] [--blocks N] [--act-int8 | --int4]
        [--cache-int4] [--adaptive] [--runs 2] [--out PATH] [--device cpu]

The weights are drawn quantized from seed 0 (`ops.quant.init_quantized`:
int8 codes, or int4 with `--int4`, modulations quantized too), never as
bf16 first; the cache is int8 (`--cache-int4`: int4).  Without
`--adaptive` the RegionE edit runs the pinned quarter mask; with it, the
adaptive partition on a structured condition latent (`common.
structured_condition`, the edited fraction held in 0.15-0.40) and the
forced mask as the ablation.  Before the weights, `utils.memplan` prints
the plan and whether it fits an H100.  After the timing the weights leave
the card and both latents are decoded through the family's decoder for the
pixel PSNR (`--skip-pixel-psnr`: not).

Defaults by preset (grid, t_txt, depth_double, artifact): the JAX
script's, so a row compares with its `FULLSIZE*.json`; the artifact is
written under `build/bench/` of the checkout unless `--out` names a path.
Times are host wall time ended by `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import argparse
import gc
import json
from pathlib import Path

import numpy as np
import torch

from regione_tpu_torch.bench import common
from regione_tpu_torch.models.kv_cache import format_of
from regione_tpu_torch.utils import telemetry

# preset -> (grid, t_txt, depth_double, artifact): the reference's text
# lengths (FLUX T5 512, Qwen chat-template prompts ~512, Step1X 128)
DEFAULTS = {
    "step1x-edit": (44, 128, None, "FULLSIZE.json"),
    "step1x-edit-v1p2": (44, 128, None, "FULLSIZE_V1P2.json"),
    "flux-kontext": (64, 512, None, "FULLSIZE_FLUX.json"),
    "qwen-image-edit": (48, 512, 36, "FULLSIZE_QWEN.json"),
    "qwen-image-edit-plus": (48, 512, 36, "FULLSIZE_PLUS.json"),
}
# the reference's headline speedup of each family (no v1.2 / Plus rows)
REF_HEADLINE = {"step1x-edit": 2.572, "step1x-edit-v1p2": 2.572,
                "flux-kontext": 2.409, "qwen-image-edit": 2.059,
                "qwen-image-edit-plus": 2.059}
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "bench"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="step1x-edit", choices=list(DEFAULTS))
    ap.add_argument("--grid", type=int, default=None)
    ap.add_argument("--t-txt", type=int, default=None)
    ap.add_argument("--blocks", type=int, default=None,
                    help="override depth_double (Qwen: 36 by default)")
    ap.add_argument("--act-int8", action="store_true",
                    help="W8A8: dynamic per-row activation quant "
                         "(torch._int_mm)")
    ap.add_argument("--int4", action="store_true",
                    help="nibble-packed int4 weights incl. modulations "
                         "(bf16 compute); moves the Qwen default to the 60 "
                         "blocks at grid 44 and Step1X to grid 64")
    ap.add_argument("--cache-int4", action="store_true",
                    help="nibble-packed int4 KV cache instead of int8")
    ap.add_argument("--adaptive", action="store_true",
                    help="the adaptive partition on a structured condition "
                         "latent (the headline's path) instead of the pinned "
                         "quarter mask, which becomes the ablation")
    ap.add_argument("--cap-granularity", type=int, default=None,
                    help="override RegionEParams.capacity_granularity")
    ap.add_argument("--cache-threshold", type=float, default=None,
                    help="override RegionEParams.cache_threshold")
    ap.add_argument("--threshold", type=float, default=None,
                    help="override RegionEParams.threshold")
    ap.add_argument("--skip-pixel-psnr", action="store_true",
                    help="skip the decode of both latents after the timing")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="the artifact's path (default build/bench/<the "
                         "preset's artifact>)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card cuda stops")
    args = ap.parse_args(argv)
    if args.int4 and args.act_int8:
        ap.error("--int4 and --act-int8 are mutually exclusive (int4 runs "
                 "the bf16 product; W8A8 needs int8 weights)")
    dg, dt, db, dout = DEFAULTS[args.preset]
    if args.int4:
        if args.preset.startswith("qwen"):
            dg, db = 44, 60
            dout = dout.replace("QWEN", "QWEN60").replace("PLUS", "PLUS60")
        elif args.preset.startswith("step1x"):
            dg = 64
            dout = dout.replace(".json", "_1024.json")
        else:
            dout = dout.replace(".json", "_INT4.json")
    if args.act_int8:
        dout = dout.replace(".json", "_W8A8.json")
    args.grid = dg if args.grid is None else args.grid
    args.t_txt = dt if args.t_txt is None else args.t_txt
    args.blocks = db if args.blocks is None else args.blocks
    args.out = args.out or str(OUT_DIR / dout)
    return args


def memory_plan(args):
    """`utils.memplan.plan` of the run `args` asks for: quantized weights
    and modulations, the KV cache's format, a CFG batch of 2 (FLUX: 1)."""
    from regione_tpu_torch.utils.memplan import plan
    cache = format_of(int8=True, int4=args.cache_int4)
    cfg = common.config(args.preset, cache, args.act_int8, args.blocks)
    return plan(cfg, grid=args.grid, t_txt=args.t_txt,
                batch_cfg=1 if args.preset == "flux-kontext" else 2,
                cache=cache, int8=True, quantize_mods=True,
                bits=4 if args.int4 else 8, int4_mods=args.int4)


def warm_partition_seconds(edit) -> float:
    """The warm steps + partition segment of one `edit()`: the device
    time of its `sampler.warm` and `sampler.partition` spans (their CUDA
    events; on the CPU, their host time)."""
    telemetry.clear()
    with telemetry.recording():
        edit()
    common.sync()
    ms = 0.0
    for sp in telemetry.spans():
        if sp.name in ("sampler.warm", "sampler.partition"):
            dev_ms = sp.device_ms()
            ms += sp.host_ms if dev_ms is None else dev_ms
    telemetry.clear()
    return ms / 1e3


def run(args) -> dict:
    """The row of `parse_args`' arguments (written to `args.out`)."""
    from regione_tpu_torch.eval.pixelprobe import (family_for_preset,
                                                   pixel_psnr_vs_dense)

    grid, t_txt, preset = args.grid, args.t_txt, args.preset
    is_flux = preset == "flux-kontext"
    bits = 4 if args.int4 else 8
    cache = format_of(int8=True, int4=args.cache_int4)
    batch_cfg = 1 if is_flux else 2   # FLUX: guidance embedded, one forward
    dev = common.resolve_device(args.device)
    mp = memory_plan(args)
    common.log(f"memplan: params {mp.param_bytes / 2**30:.2f} GiB, cache "
               f"{mp.cache_bytes / 2**30:.2f} GiB, total "
               f"{mp.total_bytes / 2**30:.2f} GiB, fits h100: "
               f"{mp.fits('h100')}", "fullsize")
    pipe = common.build(preset, dev, int8=not args.int4, int4=args.int4,
                        act_int8=args.act_int8, cache=cache,
                        blocks=args.blocks,
                        re=_knobs(args, preset),
                        **({"guidance_scale": 2.5} if is_flux else {}))
    cfg = pipe.cfg
    n_params = common.param_count(pipe.model)
    common.log(f"{preset}: {n_params / 1e9:.2f} B int{bits} parameters on "
               f"{common.device_name(dev)}", "fullsize")

    # the JAX script's draws from default_rng(110): lat0, txt, cond, pooled
    rng = np.random.default_rng(110)
    s = grid * grid
    lat0 = common.draw(rng, (1, s, cfg.in_channels), dev)
    txt = common.draw(rng, (batch_cfg, t_txt, cfg.txt_in_dim), dev, cfg.dtype)
    cond = common.draw(rng, (1, s, cfg.in_channels), dev)
    pooled = common.draw(rng, (batch_cfg, cfg.pooled_dim), dev, cfg.dtype)
    guidance = (torch.full((batch_cfg,), 2.5, device=dev)
                if cfg.guidance_embed else None)
    ctx_of = common.make_ctx(pipe, grid, txt, pooled, guidance)
    ctx = ctx_of(cond)
    forced_mask = common.quarter_mask(grid, dev)
    if args.adaptive:
        sampler = pipe.sampler_for(grid, grid, t_txt, batch_cache=batch_cfg)
        common.log("probing x0 for a structured condition latent...",
                   "fullsize")
        cond, _ = common.structured_condition(
            pipe, sampler, ctx_of, lat0, rng, band=(0.15, 0.40),
            cond=cond.cpu().numpy(), log=lambda m: common.log(m, "fullsize"))
        ctx = ctx_of(cond)

    t_dense, (out_dense, _) = common.best_of(
        lambda: pipe.edit_latents(lat0, ctx, grid, grid, dense_only=True),
        args.runs)
    common.log(f"dense {t_dense:.3f}s", "fullsize")
    headline_mask = None if args.adaptive else forced_mask
    t_re, (out_re, stats) = common.best_of(
        lambda: pipe.edit_latents(lat0, ctx, grid, grid,
                                  forced_mask=headline_mask), args.runs)
    warm_partition_s = warm_partition_seconds(
        lambda: pipe.edit_latents(lat0, ctx, grid, grid,
                                  forced_mask=headline_mask))
    common.log(f"regione {t_re:.3f}s (edited {stats.edited_tokens}, cap "
               f"{stats.capacity})", "fullsize")
    forced_row = {}
    if args.adaptive:
        t_f, (_, fstats) = common.best_of(
            lambda: pipe.edit_latents(lat0, ctx, grid, grid,
                                      forced_mask=forced_mask), args.runs)
        forced_row = {"forced_mask_s": round(t_f, 4),
                      "forced_mask_speedup": round(t_dense / t_f, 4),
                      "forced_edited_tokens": fstats.edited_tokens}
    out_dense, out_re = out_dense.cpu().numpy(), out_re.cpu().numpy()
    speedup = t_dense / t_re
    pix = {}
    if not args.skip_pixel_psnr:
        # the decoder alone on the card: the backbone and its inputs leave
        pipe = ctx = ctx_of = lat0 = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        try:     # the timing row survives a decode failure
            pix = pixel_psnr_vs_dense(out_dense, out_re, grid, grid,
                                      family_for_preset(preset), device=dev)
        except Exception as e:  # noqa: BLE001 (reported in the row)
            pix = {"pixel_decode_error": repr(e)[:200]}
    row = {
        "metric": f"{_label(args, cfg, n_params)} single-chip edit speedup "
                  f"(int{bits} weights + {cache} KV "
                  f"cache{' + W8A8 activations' if args.act_int8 else ''})",
        "value": round(speedup, 4),
        "unit": "x",
        "vs_baseline": round(speedup / REF_HEADLINE[preset], 4),
        "dense_s": round(t_dense, 4),
        "regione_s": round(t_re, 4),
        "psnr_latent_vs_dense": round(common.psnr(out_dense, out_re), 2),
        **pix,
        "partition": "adaptive" if args.adaptive else "forced",
        "edited_tokens": stats.edited_tokens,
        "edited_frac": round(stats.edited_tokens / s, 4),
        # the warm steps + partition segment of one edit after the timed
        # ones (the adaptive path's x0 estimate lives here)
        "warm_partition_s": round(warm_partition_s, 4),
        **forced_row,
        "capacity": stats.capacity,
        "seq_len": stats.seq_len,
        "reuse_steps": stats.reuse_steps,
        **({"cache_threshold": args.cache_threshold}
           if args.cache_threshold is not None else {}),
        **({"threshold": args.threshold} if args.threshold is not None
           else {}),
        "params": n_params,
        "weight_bits": bits,
        "grid": grid,
        "resolution_px": grid * 16,
        "memplan_total_gib": round(mp.total_bytes / 2**30, 3),
        "model": preset,
        "device": common.device_name(dev),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(row, indent=2))
    return row


def _knobs(args, preset):
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    re = DEFAULT_PARAMS[preset]
    if args.cap_granularity:
        re = re.replace(capacity_granularity=args.cap_granularity)
    if args.cache_threshold is not None:
        re = re.replace(cache_threshold=args.cache_threshold)
    if args.threshold is not None:
        re = re.replace(threshold=args.threshold)
    return re


def _label(args, cfg, n_params) -> str:
    preset = args.preset
    qwen = (f"production-width Qwen ({cfg.depth_double}/60 blocks, "
            f"{n_params / 1e9:.1f}B)")
    if args.int4 and preset.startswith("qwen") and cfg.depth_double == 60:
        qwen = f"FULL 20B Qwen (60/60 blocks, {n_params / 1e9:.1f}B)"
    return {"step1x-edit": "full-size 12B Step1X",
            "step1x-edit-v1p2": "full-size 12B Step1X v1.2 (own gamma)",
            "flux-kontext": "full-size 12B FLUX.1-Kontext",
            "qwen-image-edit": qwen,
            "qwen-image-edit-plus": qwen + " [Plus gamma]"}[preset]


def main(argv=None):
    print(json.dumps(run(parse_args(argv))))


if __name__ == "__main__":
    main()
