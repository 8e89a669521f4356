"""Each weight format against an fp32 master at production width (hidden
3072, 24 heads): the port of the JAX package's `scripts/fidelity_int8.py`.

A Step1X-topology slice at the published width with few blocks (2 double +
4 single by default) is drawn once in fp32 (seed 0) and cast or quantized
from that master the way the loading path does it (bf16, then
`ops.quant.quantize_params`):

    fp32 master  ->  bf16          (the production format)
                 ->  int8 weights  (weight-only, modulations int8)
                 ->  W8A8          (the int8 weights, activations quantized
                                    per row, `torch._int_mm`)
                 ->  int4 weights  (nibble-packed, group-128 scales, int4
                                    modulations)

Each format runs one dense forward on [noise || condition] rows (grid 24:
576 + 576) and a short dense Euler trajectory (8 steps); the row holds the
SNR in dB, 10 log10(sum ref^2 / sum err^2), of each against the master.
The formats run on `--device` (the card by default: the attention kernels
and the quantized linears); the master is an explicit reference run on the
CPU in fp32 with the plain PyTorch path, as the JAX script runs it (the
card's kernels take bf16 only).  The inputs come from `default_rng(110)` in
the script's order.

    python -m regione_tpu_torch.bench.fidelity_int8 [--steps 8] [--grid 24]

Prints one JSON line (the JAX script's keys, then `master` and `device`).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from regione_tpu_torch.bench import common

FORMATS = ("bf16", "int8_weight_only", "w8a8", "int4_weight_only")
MASTER = "fp32 on the CPU, plain PyTorch (the reference run)"


def snr_db(ref, x) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(x, np.float64) - ref
    denom = float((err * err).sum())
    if denom == 0.0:
        return float("inf")
    return 10.0 * float(np.log10((ref * ref).sum() / denom))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=24,
                    help="token grid (24 -> 576 noise + 576 cond rows)")
    ap.add_argument("--t-txt", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8,
                    help="dense Euler steps for the trajectory-drift row "
                         "(0 = single forward only)")
    ap.add_argument("--depth-double", type=int, default=2)
    ap.add_argument("--depth-single", type=int, default=4)
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where the formats run: cuda (default) or cpu")
    return ap.parse_args(argv)


def formats(master, dev) -> dict:
    """{format: (model on `dev`, W8A8)}, each cast or quantized from a copy
    of the fp32 master; W8A8 runs the int8 weights."""
    from regione_tpu_torch.ops.quant import quantize_params

    def bf16():
        m = copy.deepcopy(master).to(dev, torch.bfloat16)
        m.cfg = dataclasses.replace(master.cfg, dtype=torch.bfloat16)
        return m

    int8 = quantize_params(bf16(), quantize_mods=True)
    return {"bf16": (bf16(), False), "int8_weight_only": (int8, False),
            "w8a8": (int8, True),
            "int4_weight_only": (quantize_params(
                bf16(), quantize_mods=True, bits=4, int4_mods=True), False)}


def run(args, base=None, master=None) -> dict:
    """The JSON row.  `base`: the config whose width is kept (default the
    published `step1x-edit`); `master`: the fp32 `MMDiT` to use instead of
    the seed-0 draw (its config is `base` cut to the depths)."""
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.core.gamma import gamma_for
    from regione_tpu_torch.core.schedule import build_sigmas, calculate_shift
    from regione_tpu_torch.models.mmdit import MODE_DENSE
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.pipelines.base import EditPipelineBase
    from regione_tpu_torch.weights.from_jax import init_params

    dev = common.resolve_device(args.device)
    cpu = torch.device("cpu")
    cfg32 = dataclasses.replace(
        base or get_config("step1x-edit"), depth_double=args.depth_double,
        depth_single=args.depth_single, connector=None, dtype=torch.float32)
    grid, t_txt = args.grid, args.t_txt
    s = grid * grid
    rng = np.random.default_rng(110)
    if master is None:
        master = init_params(cfg32, torch.Generator(cpu).manual_seed(0), cpu)
    master.cfg = cfg32
    img = common.draw(rng, (1, 2 * s, cfg32.in_channels), cpu)
    txt = common.draw(rng, (1, t_txt, cfg32.txt_in_dim), cpu)
    pooled = common.draw(rng, (1, cfg32.pooled_dim), cpu)
    rope = EditPipelineBase(master, RegionEParams(),
                            gamma=gamma_for("step1x-edit")).build_rope(
        grid, grid, t_txt)
    models = {"fp32": (master, False), **formats(master, dev)}

    @torch.inference_mode()
    def fwd(model_w8a8, img_in):
        model, w8a8 = model_w8a8
        model.cfg = dataclasses.replace(model.cfg, act_int8=w8a8)
        d, dt = next(model.parameters()).device, model.cfg.dtype
        # sigma 0.7 in fp32 for every format, as the script passes it
        v, _ = model(img_in.to(d), txt.to(d, dt),
                     torch.full((1,), 0.7, device=d),
                     tuple(r.to(d) for r in rope[0]),
                     tuple(r.to(d) for r in rope[1]),
                     pooled=None if pooled is None else pooled.to(d, dt),
                     mode=MODE_DENSE)
        return v.float().cpu()

    common.log(f"forward x4 formats at hidden={cfg32.hidden}, "
               f"{args.depth_double}+{args.depth_single} blocks, {2 * s} img "
               f"rows on {common.device_name(dev)}; the fp32 master on the "
               "CPU", "fidelity")
    v = {name: fwd(m, img) for name, m in models.items()}
    out = {
        "width": cfg32.hidden, "heads": cfg32.heads,
        "depth": [args.depth_double, args.depth_single],
        "img_rows": 2 * s, "t_txt": t_txt,
        "forward_snr_db_vs_fp32": {
            f: round(snr_db(v["fp32"], v[f]), 1) for f in FORMATS},
        "forward_snr_db_int8_vs_bf16": round(
            snr_db(v["bf16"], v["int8_weight_only"]), 1),
        "forward_snr_db_w8a8_vs_int8": round(
            snr_db(v["int8_weight_only"], v["w8a8"]), 1),
        "forward_snr_db_int4_vs_bf16": round(
            snr_db(v["bf16"], v["int4_weight_only"]), 1),
    }
    if args.steps:
        sigmas = build_sigmas(args.steps, mu=calculate_shift(s))
        lat_init = common.draw(rng, (1, s, cfg32.in_channels), cpu)

        def run_traj(model):
            lat = lat_init
            for i in range(args.steps):
                x = torch.cat([lat, img[:, s:]], dim=1)
                lat = lat + float(sigmas[i + 1] - sigmas[i]) * fwd(
                    model, x)[:, :s]
            return lat

        common.log(f"{args.steps}-step trajectories", "fidelity")
        lat = {name: run_traj(m) for name, m in models.items()}
        out["trajectory_steps"] = args.steps
        out["trajectory_snr_db_vs_fp32"] = {
            f: round(snr_db(lat["fp32"], lat[f]), 1) for f in FORMATS}
        out["trajectory_snr_db_int8_vs_bf16"] = round(
            snr_db(lat["bf16"], lat["int8_weight_only"]), 1)
        out["trajectory_snr_db_w8a8_vs_int8"] = round(
            snr_db(lat["int8_weight_only"], lat["w8a8"]), 1)
        out["trajectory_snr_db_int4_vs_bf16"] = round(
            snr_db(lat["bf16"], lat["int4_weight_only"]), 1)
    out["master"] = MASTER
    out["device"] = common.device_name(dev)
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = run(args)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
