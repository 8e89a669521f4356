"""The flagship step and the multi-device dry run of the port: the
counterpart of the JAX package's `__graft_entry__.py`.

    entry()              -> (step_fn, (lat0, sigma, ctx)): one dense
                            denoise step (forward, CFG combine, Euler update)
                            of the flagship Step1X-Edit topology on the card.
    dryrun_multichip(n)  -> the full four-segment 28-step RegionE plan (warm
                            steps, adaptive partition, RAGS against a
                            tp-sharded int8 KV cache, refresh, SMS) on n
                            ranks over a (dp, tp) mesh (`parallel.sharding`),
                            small shapes, both transformer topologies: one
                            rank per card joined by NCCL (the default), or
                            n CPU ranks joined by gloo (`device="cpu"`).

    python -c "from regione_tpu_torch import graft_entry as g; g.dryrun_multichip(4)"
    python -c "from regione_tpu_torch import graft_entry as g; g.dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import torch


# (seed, threshold) of each dryrun topology.  The JAX dryrun's pairs keep
# the partition partial for `jax.random` weights; `init_params` draws other
# weights, for which these pairs keep it partial near its middle (20 and
# 35 of 64 edited; the JAX pair (13, 0.3) leaves 58 of 64 for Qwen).  A
# run on the JAX package's params carried across (`params=`) takes the JAX
# pairs.
PORT_PAIRS = {"tiny-tp": (0, 0.0), "tiny-qwen-tp": (0, 0.1)}
JAX_PAIRS = {"tiny-tp": (0, 0.0), "tiny-qwen-tp": (13, 0.3)}
# On the card each topology runs at head_dim 128 in bf16, the attention
# kernels' only head width and dtype (8 heads: hidden 1024; the full
# presets' rope axes), with its weights drawn on the CPU from the seed.
# Its pairs sit inside a band of thresholds that edits the same count on
# the CPU (25 of 64 for 0.0-0.2; 38-39 of 64 for 0.15-0.2).  The card's
# bf16 kernels move the partition: 20 and 55 of 64 on four H100s at
# (dp 2, tp 2), so a new pair is checked on the card.
CARD_WIDTHS = dict(hidden=1024, head_dim=128, axes_dims=(16, 56, 56),
                   dtype=torch.bfloat16)
CARD_PAIRS = {"tiny-tp": (1, 0.1), "tiny-qwen-tp": (1, 0.175)}
DRYRUN_LIMIT_S = 120.0     # the ranks are killed after it


def _build(preset: str, grid: int, t_txt: int, seed: int = 0,
           device="cuda", state=None, cfg=None):
    """The Step1X-Edit pipeline of `preset` (or of the config `cfg`;
    weights from `seed`, or the state dict `state`) and
    `__graft_entry__._build`'s inputs, drawn from `default_rng(seed)` in
    its order: txt, cond, pooled, lat0.  Returns (cfg, model, pipe, ctx,
    lat0)."""
    from regione_tpu_torch.bench.common import draw
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.eval import resolve_device
    from regione_tpu_torch.models.mmdit import MMDiT
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.pipelines.base import EditInputs
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.weights.from_jax import init_params

    dev = resolve_device(device)
    cfg = cfg or get_config(preset)
    if state is None:
        model = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    else:
        model = MMDiT(cfg, dev).eval()
        model.load_state_dict(state, strict=True)
    pipe = Step1XEditPipeline(model, RegionEParams())
    rng = np.random.default_rng(seed)
    s = grid * grid
    txt = draw(rng, (2, t_txt, cfg.txt_in_dim), dev, cfg.dtype)
    cond = draw(rng, (1, s, cfg.in_channels), dev)
    pooled = draw(rng, (2, cfg.pooled_dim), dev, cfg.dtype)
    rope_img, rope_txt = pipe.build_rope(grid, grid, t_txt)
    ctx = EditInputs(txt=txt, cond_latent=cond, rope_img=rope_img,
                     rope_txt=rope_txt, pooled=pooled, s_noise=s)
    lat0 = draw(rng, (1, s, cfg.in_channels), dev)
    return cfg, model, pipe, ctx, lat0


def entry(preset: str = "step1x-edit:dev", grid: int = 16, t_txt: int = 32,
          device="cuda"):
    """(step_fn, (lat0, sigma, ctx)): `step_fn(lat, sigma, ctx)` runs one
    dense forward of the flagship model at grid 16, t_txt 32, the CFG
    combine and an Euler update of -0.03."""
    _, _, pipe, ctx, lat0 = _build(preset, grid, t_txt, device=device)

    @torch.inference_mode()
    def step_fn(lat, sigma, ctx):
        v, _ = pipe.dense_forward(lat, sigma, None, ctx, False)
        return lat + (-0.03) * v.float()

    return step_fn, (lat0, 0.9, ctx)


def dryrun_multichip(n_devices: int, params: dict | None = None,
                     device="cuda") -> dict:
    """The dryrun on `n_devices` ranks, each in its own process, joined
    over a file store and killed after `DRYRUN_LIMIT_S`: one rank per card
    joined by NCCL, the topologies at `CARD_WIDTHS` (raises with fewer
    cards than ranks), or with `device="cpu"` n CPU ranks joined by gloo.
    `params`: {preset: state dict} to run instead of the port's own init
    (CPU only, with the JAX dryrun's seed and threshold pairs).  Raises
    unless every rank passes; returns rank 0's {preset: plan
    statistics}."""
    from regione_tpu_torch.eval import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        if params is not None:
            raise ValueError("dryrun_multichip: params= holds the CPU "
                             "topologies (head_dim 16); pass device='cpu'")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} ranks need {n_devices} CUDA "
                f"cards, this process sees {torch.cuda.device_count()}; "
                "pass device='cpu' for CPU ranks")
        from regione_tpu_torch.ops import _build as kernels
        kernels.build()     # once, before the ranks load it
    elif dev.type != "cpu":
        raise ValueError(f"dryrun_multichip: no ranks for device {dev}")
    from regione_tpu_torch.bench.common import spawn_ranks
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        if params is not None:
            torch.save(params, work / "params.pt")
        outs = spawn_ranks(
            "import sys; from regione_tpu_torch import graft_entry as g; "
            "g._dryrun_rank(*sys.argv[1:])", [work, dev.type], n_devices,
            DRYRUN_LIMIT_S, "dryrun_multichip", env={"OMP_NUM_THREADS": "1"})
        print(outs[0], end="")
        results = [json.loads((work / f"rank{r}.json").read_text())
                   for r in range(n_devices)]
    if any(res != results[0] for res in results[1:]):
        raise RuntimeError(f"dryrun_multichip: the ranks disagree: {results}")
    return results[0]


def _dryrun_rank(rank: str, world: str, work: str, device: str) -> None:
    """One rank of `dryrun_multichip`: joins the group (NCCL on card
    `rank`, or gloo on the CPU), runs `_dryrun_multichip_impl` and writes
    its statistics to rank<r>.json."""
    import torch.distributed as dist
    work, rank, world = Path(work), int(rank), int(world)
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    try:
        path = work / "params.pt"
        params = torch.load(path) if path.exists() else None
        stats = _dryrun_multichip_impl(world, params, device)
        (work / f"rank{rank}.json").write_text(json.dumps(stats))
    finally:
        dist.destroy_process_group()


def _dryrun_multichip_impl(n_devices: int, params: dict | None = None,
                           device="cpu") -> dict:
    """The dryrun body on an initialised process group of `n_devices`
    ranks: the full plan for the Step1X / FLUX topology (`tiny-tp`: double
    and single blocks, pooled vector) and the Qwen one (`tiny-qwen-tp`:
    joint double blocks, txt_norm, no pooled vector), each with the int8 KV
    cache and capacity granularity 8, its params sharded over the mesh's tp
    (dp = 2 for an even count); on the card at `CARD_WIDTHS`, on this
    process's card.  Asserts RAGS steps and a partial partition, as the JAX
    dryrun does.  Returns {preset: statistics}."""
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.models.kv_cache import with_cache_format
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.parallel.sharding import make_mesh, shard_params
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.weights.from_jax import init_params

    card = device == "cuda"
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, dp=dp, device_type=device)
    dev = torch.device("cuda", torch.cuda.current_device()) if card \
        else torch.device("cpu")
    grid, t_txt = 8, 8
    pairs = CARD_PAIRS if card else PORT_PAIRS if params is None \
        else JAX_PAIRS
    out = {}
    for preset, pipe_cls in (("tiny-tp", Step1XEditPipeline),
                             ("tiny-qwen-tp", QwenImageEditPipeline)):
        seed, thr = pairs[preset]
        re = RegionEParams(threshold=thr, cache_threshold=0.05,
                           capacity_granularity=8)
        cfg = get_config(preset)
        state = None if params is None else params[preset]
        if card:
            cfg = dataclasses.replace(cfg, **CARD_WIDTHS)
            state = init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu").state_dict()
        cfg, model, _, ctx, lat0 = _build(preset, grid, t_txt, seed, dev,
                                          state, cfg)
        model.cfg = with_cache_format(cfg, "int8")
        shard_params(model, mesh)
        pipe = pipe_cls(model, re, true_cfg_scale=4.0)
        # the backend's rope convention (Qwen: centred frame / h / w ids)
        rope_img, rope_txt = pipe.build_rope(grid, grid, t_txt)
        ctx = dataclasses.replace(ctx, rope_img=rope_img, rope_txt=rope_txt)
        lat, stats = pipe.edit_latents(lat0, ctx, grid, grid)
        if lat.shape != lat0.shape:
            raise AssertionError(f"{preset}: latents {tuple(lat.shape)}")
        if stats.rags_steps <= 0:
            raise AssertionError(f"{preset}: plan produced no RAGS steps")
        if not 0 < stats.edited_tokens < stats.seq_len:
            raise AssertionError(
                f"{preset}: partition degenerated ({stats.edited_tokens} of "
                f"{stats.seq_len} edited): RAGS gather / scatter would not "
                "run")
        print(f"dryrun_multichip OK [{preset}]: mesh={tuple(mesh.shape)} "
              f"lat={tuple(lat.shape)} dense={stats.dense_steps} "
              f"rags={stats.rags_steps} reuse={stats.reuse_steps} "
              f"edited={stats.edited_tokens}/{stats.seq_len} int8_cache=True"
              f" device={device}",
              flush=True)
        out[preset] = dataclasses.asdict(stats)
    return out
