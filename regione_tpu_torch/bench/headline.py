"""End-to-end RegionE against dense on the headline workload: the port of
the JAX package's `bench.py`.

    python -m regione_tpu_torch.bench [--device cpu]

Workload (`bench.py`'s constants): the Step1X-Edit topology at
`step1x-edit:dev` (1.26 B parameters, random weights from seed 0), a 64 x 64
token grid (4096 noise and 4096 condition tokens, a 1024^2 image), t_txt
128, batch-2 true CFG, the Step1X knobs (threshold 0.88, cache_threshold
0.02), inputs from seed 110.  With random weights a random condition latent
would mark every token edited, so `common.structured_condition` makes one
as a real edit presents it: the model's own x0 estimate with a block of
noise (block [4, 32) on each axis, ~25% of the grid after dilation).

Measured, each the best of 3 after a warm-up call: the dense 28-step edit,
the RegionE edit with the adaptive partition (the headline), and the
pinned-quarter-mask ablation (best of 2); then the latent PSNR of RegionE
against dense and the pixel PSNR through the family's decoder
(`eval.pixelprobe`).  Prints ONE JSON line with `bench.py`'s keys;
`vs_baseline` is the speedup over the reference's 2.572 (Step1X-Edit).
Times are host wall time ended by `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from regione_tpu_torch.bench import common

PRESET, GRID, T_TXT, SEED = "step1x-edit:dev", 64, 128, 110
RUNS, FORCED_RUNS = 3, 2
REFERENCE_SPEEDUP = 2.572     # the reference's Step1X-Edit headline
METRIC = "end-to-end edit speedup vs dense 28-step denoise (adaptive " \
         "partition)"


@dataclasses.dataclass
class Workload:
    """The headline's pipeline and request, with the structured condition
    latent in `ctx`."""
    preset: str
    grid: int
    pipe: object
    lat0: torch.Tensor
    ctx: object
    n_params: int


def prepare(preset: str = PRESET, grid: int = GRID, t_txt: int = T_TXT,
            seed: int = SEED, device="cuda", model=None) -> Workload:
    """Build the pipeline (Step1X-Edit, the Step1X knobs; `model`: a
    backbone of `preset` to use instead of drawing one from seed 0), draw
    the request from `seed` and probe its condition latent."""
    pipe = common.build(preset, device, backend="step1x-edit", model=model)
    rng, lat0, txt, pooled = common.seeded_inputs(pipe, grid, t_txt, seed)
    ctx_of = common.make_ctx(pipe, grid, txt, pooled)
    sampler = pipe.sampler_for(grid, grid, t_txt, batch_cache=2)
    common.log("probing x0 for a structured condition latent...")
    cond, _ = common.structured_condition(pipe, sampler, ctx_of, lat0, rng)
    return Workload(preset, grid, pipe, lat0, ctx_of(cond),
                    common.param_count(pipe.model))


def measure(w: Workload, runs: int = RUNS, forced_runs: int = FORCED_RUNS):
    """The timed edits and the row.  Returns (the JSON row, the RegionE
    edit's `SampleStats`, the launch counts of each adaptive RegionE edit,
    each set to 0 just before its edit and read just after)."""
    pipe, lat0, ctx, g = w.pipe, w.lat0, w.ctx, w.grid
    dev = lat0.device
    t_dense, (out_dense, _) = common.best_of(
        lambda: pipe.edit_latents(lat0, ctx, g, g, dense_only=True), runs)
    common.log(f"dense {t_dense:.3f}s")
    launches = []

    def regione():
        common.reset_counts()
        out = pipe.edit_latents(lat0, ctx, g, g)
        launches.append(common.read_counts())
        return out

    t_re, (out_re, stats) = common.best_of(regione, runs)
    common.log(f"regione adaptive {t_re:.3f}s (edited {stats.edited_tokens}, "
               f"cap {stats.capacity})")
    forced = common.quarter_mask(g, dev)
    t_forced, (_, fstats) = common.best_of(
        lambda: pipe.edit_latents(lat0, ctx, g, g, forced_mask=forced),
        forced_runs)
    speedup = t_dense / t_re
    out_dense, out_re = out_dense.cpu().numpy(), out_re.cpu().numpy()
    fidelity = common.psnr(out_dense, out_re)
    try:   # the timing row survives a decode failure, as in bench.py
        from regione_tpu_torch.eval.pixelprobe import pixel_psnr_vs_dense
        common.log("decoding both latents for pixel-space PSNR...")
        pix = pixel_psnr_vs_dense(out_dense, out_re, g, g, family="flux",
                                  device=dev)
    except Exception as e:  # noqa: BLE001 (reported in the row)
        pix = {"pixel_decode_error": repr(e)[:200]}
    s = g * g
    row = {
        "metric": METRIC,
        "value": round(speedup, 4),
        "unit": "x",
        "vs_baseline": round(speedup / REFERENCE_SPEEDUP, 4),
        "dense_s": round(t_dense, 4),
        "regione_s": round(t_re, 4),
        "psnr_latent_vs_dense": round(fidelity, 2),
        **pix,
        "edited_tokens": stats.edited_tokens,
        "capacity": stats.capacity,
        "edited_frac": round(stats.edited_tokens / s, 4),
        "seq_len": stats.seq_len,
        "reuse_steps": stats.reuse_steps,
        "forced_mask_s": round(t_forced, 4),
        "forced_mask_speedup": round(t_dense / t_forced, 4),
        "forced_edited_tokens": fstats.edited_tokens,
        "params": w.n_params,
        "model": w.preset,
        "device": common.device_name(dev),
    }
    return row, stats, launches


def run(preset: str = PRESET, grid: int = GRID, t_txt: int = T_TXT,
        seed: int = SEED, runs: int = RUNS, device="cuda", model=None):
    """`prepare`, then `measure`: (row, stats, launches per RegionE edit)."""
    return measure(prepare(preset, grid, t_txt, seed, device, model), runs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card cuda stops")
    args = ap.parse_args(argv)
    row, _, _ = run(device=args.device)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
