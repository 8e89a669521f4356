"""Batched serving on one card: the port of the JAX package's
`scripts/bench_serve_batch.py`.

N same-geometry requests (seeds 110, 111, ...) edited one at a time, then
as one group through `edit_latents_batch` (one batched denoise, one
capacity bucket, a cache set per request), both with the pinned quarter
mask, at `step1x-edit:dev` with the int8 (or `--cache-int4`) KV cache.
Prints one JSON line: seconds and images/s per image both ways, the cache
sets' GiB and the batched edit's largest difference from the single one.
A group that does not fit the card gives the row with `"oom": true`.

    python -m regione_tpu_torch.bench.serve_batch [--batch 2] [--runs 3]
    python -m regione_tpu_torch.bench.serve_batch --service [--requests 4]

`--service` measures `EditService.run` end to end instead (mock prompt
encoder, a small VAE, the adaptive partition; the next request prepared
while the current one denoises).  Add `--device cpu` to run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import re as regex
import time

import numpy as np
import torch

from regione_tpu_torch.bench import common
from regione_tpu_torch.models.mmdit import init_cache


def _request(pipe, grid: int, t_txt: int, seed: int):
    """One request's draws from `default_rng(seed)`: lat0, txt, cond,
    pooled (the JAX script's order)."""
    cfg, dev = pipe.cfg, pipe.device
    r = np.random.default_rng(seed)
    s = grid * grid
    lat0 = common.draw(r, (1, s, cfg.in_channels), dev)
    txt = common.draw(r, (2, t_txt, cfg.txt_in_dim), dev, cfg.dtype)
    cond = common.draw(r, (1, s, cfg.in_channels), dev)
    pooled = common.draw(r, (2, cfg.pooled_dim), dev, cfg.dtype)
    return lat0, common.make_ctx(pipe, grid, txt, pooled)(cond)


def _oom_row(e, dev, b, grid, t_txt, preset, cache_kind, t_seq):
    """The row of a group that does not fit: what the allocator held at its
    peak plus the allocation that failed, beside the card's capacity."""
    m = regex.search(r"Tried to allocate ([0-9.]+) (GiB|MiB)", str(e))
    tried = float(m.group(1)) / (1024 if m and m.group(2) == "MiB" else 1) \
        if m else None
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0
    return {
        "metric": f"batch-{b} single-chip serving ({cache_kind} KV cache)",
        "value": 0.0, "unit": "x", "vs_baseline": 0.0,
        "oom": True,
        "hbm_needed_gib": round(peak + tried, 3) if tried is not None
        else None,
        "hbm_capacity_gib": round(torch.cuda.get_device_properties(
            dev).total_memory / 2**30, 3) if on_card else None,
        "seq_s_per_image": round(t_seq, 4),
        "seq_images_per_s": round(1.0 / t_seq, 4),
        "batch": b, "grid": grid, "t_txt": t_txt,
        "model": preset, "device": common.device_name(dev),
    }


def run(batch: int = 2, grid: int = 64, t_txt: int = 128,
        preset: str = "step1x-edit:dev", cache_int4: bool = False,
        runs: int = 3, device="cuda"):
    """The sequential and the batched forced-mask edits.  Returns (the JSON
    row, detail): detail holds the batched and the single edit of request 0
    ("batched", "single", numpy) and the timed group's launch counts
    ("launches"); None for an OOM row."""
    cache_kind = "int4" if cache_int4 else "int8"
    pipe = common.build(preset, device, backend="step1x-edit",
                        cache=cache_kind)
    cfg, dev = pipe.cfg, pipe.device
    reqs = [_request(pipe, grid, t_txt, 110 + i) for i in range(batch)]
    fmask = common.quarter_mask(grid, dev)

    def edit(lat0, ctx):
        return pipe.edit_latents(lat0, ctx, grid, grid, forced_mask=fmask)

    common.log("single-image path: warm-up...", "serve_batch")
    edit(*reqs[0])
    common.sync()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        for lat0, ctx in reqs:
            edit(lat0, ctx)
            common.sync()
        times.append((time.perf_counter() - t) / batch)
    t_seq = min(times)
    common.log(f"sequential: {t_seq:.3f}s/image", "serve_batch")

    lats, ctxs = [r[0] for r in reqs], [r[1] for r in reqs]

    def group():
        common.reset_counts()
        outs, _ = pipe.edit_latents_batch(lats, ctxs, grid, grid,
                                          forced_masks=[fmask] * batch)
        return outs, common.read_counts()

    common.log(f"batch-{batch} path...", "serve_batch")
    try:
        t_bat, (outs, launches) = common.best_of(group, runs)
    except torch.cuda.OutOfMemoryError as e:
        row = _oom_row(e, dev, batch, grid, t_txt, preset, cache_kind, t_seq)
        common.log(f"batch-{batch} does not fit the card: "
                   f"{row['hbm_needed_gib']} GiB needed of "
                   f"{row['hbm_capacity_gib']}", "serve_batch")
        return row, None
    t_bat /= batch
    common.log(f"batched: {t_bat:.3f}s/image", "serve_batch")

    # parity: the batched edit of request 0 against its single edit
    ref = edit(*reqs[0])[0]
    err = float((outs[0] - ref).abs().max())
    cache_gib = sum(t.numel() * t.element_size() for t in init_cache(
        cfg, 2, 2 * grid * grid, "meta").values()) * batch / 2**30
    row = {
        "metric": f"batch-{batch} single-chip serving throughput gain "
                  f"({cache_kind} KV cache)",
        "value": round(t_seq / t_bat, 4),
        "unit": "x",
        "vs_baseline": round(t_seq / t_bat, 4),
        "seq_s_per_image": round(t_seq, 4),
        "batched_s_per_image": round(t_bat, 4),
        "seq_images_per_s": round(1.0 / t_seq, 4),
        "batched_images_per_s": round(1.0 / t_bat, 4),
        "batch": batch,
        "cache_sets_gib": round(cache_gib, 3),
        "max_abs_err_vs_single": err,
        "grid": grid,
        "t_txt": t_txt,
        "model": preset,
        "device": common.device_name(dev),
    }
    return row, {"batched": outs[0].cpu().numpy(),
                 "single": ref.cpu().numpy(), "launches": launches}


def service_e2e(preset: str = "step1x-edit:dev", requests: int = 4,
                device="cuda", size: int = 1024) -> dict:
    """`EditService.run` end to end: mock prompt encoder, VAE encode, the
    RegionE denoise (adaptive partition; with random weights it marks
    about every token edited, so this is the serving path at its largest
    capacity), VAE decode, the next request prepared meanwhile.  Images are
    `size` x `size` uint8 noise from `default_rng(0)`, edited at that size
    (1024: the size the pipeline picks for them).  Returns the row."""
    from regione_tpu_torch.models.text_encoders import MockTextEncoder
    from regione_tpu_torch.models.vae import VAEConfig
    from regione_tpu_torch.pipelines.serve import EditRequest, EditService
    from regione_tpu_torch.weights.from_jax import init_vae_params

    pipe = common.build(preset, device, backend="step1x-edit",
                        cache="int8")
    cfg, dev = pipe.cfg, pipe.device
    vae_cfg = VAEConfig(block_out_channels=(8, 16, 32, 64),
                        norm_num_groups=8, layers_per_block=1,
                        latent_channels=cfg.in_channels // 4)
    pipe.attach_vae(init_vae_params(
        vae_cfg, torch.Generator(dev).manual_seed(1), dev))
    pipe.attach_text_encoder(MockTextEncoder(
        cfg.txt_in_dim, cfg.pooled_dim or None, max_length=128))
    svc = EditService(pipe)
    rng = np.random.default_rng(0)
    reqs = [EditRequest(image=(rng.random((size, size, 3)) * 255).astype(
        np.uint8), prompt=f"edit {i}", width=size, height=size, seed=i)
        for i in range(requests)]
    svc.run(reqs[:1])                                   # warm-up
    common.sync()
    t = time.perf_counter()
    results = svc.run(reqs)
    common.sync()
    wall = time.perf_counter() - t
    return {
        "metric": "end-to-end serving latency (overlapped prep, "
                  "mock encoder + VAE, adaptive RegionE)",
        "value": round(wall / len(reqs), 4),
        "unit": "s/request",
        "vs_baseline": 1.0,
        "requests": len(reqs),
        "wall_s": round(wall, 4),
        "prep_s_mean": round(float(np.mean([r.prep_s for r in results])), 4),
        "denoise_decode_s_mean": round(
            float(np.mean([r.latency_s for r in results])), 4),
        "model": preset,
        "device": common.device_name(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--t-txt", type=int, default=128)
    ap.add_argument("--preset", default="step1x-edit:dev")
    ap.add_argument("--cache-int4", action="store_true",
                    help="nibble-packed int4 KV caches instead of int8")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--service", action="store_true",
                    help="measure EditService.run end to end (the image "
                         "path, VAE included) instead of the batched "
                         "sampler comparison")
    ap.add_argument("--out", default=None,
                    help="also write the JSON row to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card cuda stops")
    a = ap.parse_args(argv)
    if a.service:
        row = service_e2e(a.preset, a.requests, a.device)
    else:
        row, _ = run(a.batch, a.grid, a.t_txt, a.preset, a.cache_int4,
                     a.runs, a.device)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(row, f, indent=2)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
