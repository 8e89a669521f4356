"""The full 60-block Qwen-Image-Edit through a complete 28-step RegionE edit,
on one card or tensor-parallel over several: the port of the JAX package's
`scripts/exec_full_qwen60.py`.

Every one of the 60 double blocks runs at the published width (hidden 3072,
24 heads of 128) with int8 weights and modulations drawn quantized
(`ops.quant.init_quantized(quantize_mods=True)`, 20.4 B parameters, ~20 GB)
and the int8 KV cache, through all four sampler segments: the dense warm
steps, the adaptive partition and the cache write, the RAGS steps with AVD
reuse and the refresh split steps, the tail.  The recipe is the JAX
script's: threshold 0.0, capacity granularity 8, the inputs drawn from
`default_rng(110)` in its order (noise, text, condition).

    python -m regione_tpu_torch.bench.exec_full_qwen60 [--grid 8 --t-txt 32]
    python -m regione_tpu_torch.bench.exec_full_qwen60 --grid 64 --t-txt 512
    python -m regione_tpu_torch.bench.exec_full_qwen60 --grid 64 --t-txt 512 --tp 4 [--dp 2]

With `--tp` / `--dp` the command starts tp x dp rank processes itself, one
per card, joined by NCCL over a file store (`--device cpu`: gloo CPU
ranks); each draws the same weights from the seed, shards them over the
(dp, tp) mesh (`parallel.sharding.make_mesh`, `shard_params`) and runs the
edit; every dp replica edits the same request.  Rank 0 prints the JSON row
(the JAX script's keys, then the port's: `wall_s_best_of_2`, `init_s`, per
rank `ranks`: seconds, peak GiB, memplan GiB and launch counts).  The ranks
are killed after `--limit` seconds.

`wall_s_incl_compile` keeps the JAX key: it holds the first edit's wall
time, with the kernels built beforehand (there is no compile here);
`wall_s_best_of_2` the faster of the first two.  `--probe`: the condition
latent of the headline's x0 probe (`common.structured_condition`) when the
threshold-0.0 partition of random weights is degenerate; `--save-latents`
/ `--compare-to` write and compare the latents (`psnr_vs` in the row).
Times are host wall time ended by `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from regione_tpu_torch.bench import common

LIMIT_S = 1800.0       # the ranks are killed after it


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=8)
    ap.add_argument("--t-txt", type=int, default=32)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--out", default=None, help="also write the row here")
    ap.add_argument("--preset", default="qwen-image-edit",
                    help="the backbone (default the published Qwen; its 60 "
                         "blocks are asserted unless --blocks cuts them)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="override depth_double")
    ap.add_argument("--threshold", type=float, default=0.0)
    ap.add_argument("--probe", action="store_true",
                    help="the x0 probe's structured condition latent")
    ap.add_argument("--runs", type=int, default=2,
                    help="edits timed (the first, then the rest)")
    ap.add_argument("--params", default=None,
                    help="a torch.save'd quantized state dict to use "
                         "instead of the draw")
    ap.add_argument("--save-latents", default=None)
    ap.add_argument("--compare-to", default=None,
                    help="latents (.npy) to hold these against: psnr_vs")
    ap.add_argument("--limit", type=float, default=LIMIT_S)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card cuda stops")
    return ap.parse_args(argv)


def _model(args, cfg, dev):
    """The int8 weights: drawn from seed 0 on `dev`, or `--params`."""
    from regione_tpu_torch.models.mmdit import MMDiT
    from regione_tpu_torch.ops.quant import init_quantized, quantize_params
    if args.params is None:
        gen = torch.Generator(dev).manual_seed(0)
        return init_quantized(cfg, gen, dev, quantize_mods=True)
    model = quantize_params(MMDiT(cfg, torch.device("meta")),
                            quantize_mods=True)
    model.load_state_dict(torch.load(args.params), strict=True, assign=True)
    return model.to(dev).eval()


def run(args, mesh=None) -> tuple[dict, np.ndarray]:
    """The edit on this process (a rank of `mesh`, or alone): (row, the
    last edit's latents)."""
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.ops import _build
    from regione_tpu_torch.parallel.sharding import shard_params
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.utils.memplan import plan

    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh is not None and args.device != "cpu"
           else common.resolve_device(args.device))
    cfg = common.config(args.preset, "int8", blocks=args.blocks)
    if args.preset == "qwen-image-edit" and args.blocks is None and \
            cfg.depth_double != 60:
        raise AssertionError(f"depth_double {cfg.depth_double}, not 60")
    grid, t_txt = args.grid, args.t_txt
    s = grid * grid
    if dev.type == "cuda":
        _build.build()          # the kernels exist before any timing
    common.log(f"drawing the {cfg.depth_double}-block int8 weights...",
               "exec60")
    t = time.perf_counter()
    model = _model(args, cfg, dev)
    model.cfg = cfg
    common.sync()
    init_s = time.perf_counter() - t
    n_params = common.param_count(model)
    common.log(f"init {init_s:.1f}s; {n_params / 1e9:.2f}B params on "
               f"{common.device_name(dev)}", "exec60")
    tp = 1 if mesh is None else mesh.size(1)
    if mesh is not None:
        shard_params(model, mesh)
    re = DEFAULT_PARAMS["qwen-image-edit"].replace(
        threshold=args.threshold, capacity_granularity=8)
    pipe = QwenImageEditPipeline(model, re)

    rng = np.random.default_rng(110)
    lat0 = common.draw(rng, (1, s, cfg.in_channels), dev)
    txt = common.draw(rng, (2, t_txt, cfg.txt_in_dim), dev, cfg.dtype)
    cond = common.draw(rng, (1, s, cfg.in_channels), dev)
    ctx_of = common.make_ctx(pipe, grid, txt)
    if args.probe:
        sampler = pipe.sampler_for(grid, grid, t_txt, batch_cache=2)
        cond, _ = common.structured_condition(
            pipe, sampler, ctx_of, lat0, rng, band=(0.15, 0.40),
            cond=cond.cpu().numpy(), log=lambda m: common.log(m, "exec60"))
    ctx = ctx_of(cond)

    common.log(f"running the full 28-step RegionE edit "
               f"({'mesh ' + str(tuple(mesh.shape)) if mesh else 'one device'}"
               f")...", "exec60")
    walls = []
    for _ in range(max(args.runs, 1)):
        out, stats, sec, counts, peak = common.timed_edit(pipe, lat0, ctx,
                                                          grid)
        walls.append(sec)
        common.log(f"edit {sec:.3f}s, edited {stats.edited_tokens}/{s}, "
                   f"launches {counts}", "exec60")
    if not np.isfinite(out).all():
        raise AssertionError("non-finite output")
    if not 0 < stats.edited_tokens < s:
        raise AssertionError(f"degenerate partition: {stats.edited_tokens} "
                             f"of {s} edited")
    if not (stats.rags_steps > 0 and stats.reuse_steps > 0):
        raise AssertionError(f"no RAGS or reuse steps: {stats}")
    mp = plan(cfg, grid=grid, t_txt=t_txt, cache="int8", tp=tp, int8=True,
              quantize_mods=True)
    row = {
        "model": args.preset,
        "blocks": cfg.depth_double,
        "params": n_params,
        "grid": grid, "t_txt": t_txt,
        "mesh": ({"dp": mesh.size(0), "tp": tp} if mesh is not None
                 else None),
        "cache_int8": True,
        "wall_s_incl_compile": round(walls[0], 4),
        "dense_steps": stats.dense_steps,
        "rags_steps": stats.rags_steps,
        "reuse_steps": stats.reuse_steps,
        "edited_tokens": stats.edited_tokens,
        "seq_len": stats.seq_len,
        "capacity": stats.capacity,
        "finite_output": True,
        "wall_s_best_of_2": round(min(walls[:2]), 4),
        "init_s": round(init_s, 2),
        "threshold": args.threshold,
        "probe": args.probe,
        "ranks": [{"wall_s": [round(w, 4) for w in walls],
                   "peak_gib": round(peak, 3),
                   "memplan_gib": round(mp.total_bytes / 2**30, 3),
                   "memplan_param_gib": round(mp.param_bytes / 2**30, 3),
                   "launches": counts}],
        "device": common.device_name(dev),
    }
    return row, out


def _finish(args, row, lat) -> dict:
    if args.save_latents:
        np.save(args.save_latents, lat)
    if args.compare_to:
        row["psnr_vs"] = round(common.psnr(np.load(args.compare_to), lat), 2)
    if args.out:
        Path(args.out).write_text(json.dumps(row, indent=1))
    return row


def main(argv=None) -> dict:
    args = parse_args(argv)
    n = args.tp * args.dp
    if n == 1:
        row, lat = run(args)
    else:
        row, lat = spawn(args, n, argv if argv is not None
                         else sys.argv[1:])
    row = _finish(args, row, lat)
    print(json.dumps(row), flush=True)
    return row


def spawn(args, n: int, argv) -> tuple[dict, np.ndarray]:
    """n rank processes of `_rank`, one card each (NCCL) or on the CPU
    (gloo), over a file store; killed after `args.limit`.  Returns rank
    0's row with every rank's entry in `ranks`, and its latents."""
    import tempfile

    dev = common.resolve_device(args.device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"exec_full_qwen60: {n} ranks need {n} CUDA "
                               f"cards, this process sees "
                               f"{torch.cuda.device_count()}")
        from regione_tpu_torch.ops import _build
        _build.build()          # once, before the ranks load it
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        outs = common.spawn_ranks(
            "import sys; from regione_tpu_torch.bench import "
            "exec_full_qwen60 as m; m._rank(*sys.argv[1:])",
            [work, json.dumps(list(argv))], n, args.limit,
            "exec_full_qwen60",
            env={"OMP_NUM_THREADS": "1"} if dev.type == "cpu" else None)
        print(outs[0], end="", file=sys.stderr)
        rows = [json.loads((work / f"rank{r}.json").read_text())
                for r in range(n)]
        lat = np.load(work / "rank0.npy")
    row = rows[0]
    plan_keys = ("dense_steps", "rags_steps", "reuse_steps",
                 "edited_tokens", "capacity")
    if any(r[k] != row[k] for r in rows for k in plan_keys):
        raise RuntimeError(f"exec_full_qwen60: the ranks' plans disagree: "
                           f"{[[r[k] for k in plan_keys] for r in rows]}")
    row["ranks"] = [r["ranks"][0] for r in rows]
    return row, lat


def _rank(rank: str, world: str, work: str, argv: str) -> None:
    """One rank of `spawn`: joins the group (NCCL on card `rank`, or gloo
    on the CPU), runs `run` on the (dp, tp) mesh and writes its row and
    latents to rank<r>.json / .npy."""
    import torch.distributed as dist

    from regione_tpu_torch.parallel.sharding import make_mesh
    args = parse_args(json.loads(argv))
    work, rank, world = Path(work), int(rank), int(world)
    card = args.device != "cpu"
    if card:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if card else "gloo",
                            init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, dp=args.dp,
                         device_type="cuda" if card else "cpu")
        row, lat = run(args, mesh)
        np.save(work / f"rank{rank}.npy", lat)
        (work / f"rank{rank}.json").write_text(json.dumps(row))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
