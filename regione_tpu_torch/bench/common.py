"""What the measuring entry points share: the model and pipeline they
build, the seeded inputs, the structured condition latent, timing, PSNR
and the kernels' launch counts.

Every time here is host wall time ended by `torch.cuda.synchronize()` (the
JAX scripts read a scalar back instead, a workaround of their TPU runtime).
The weights are random, drawn from a seed on the device by
`weights.from_jax.init_params` or, quantized, by `ops.quant.init_quantized`;
the inputs come from `numpy.random.default_rng(seed)` in each JAX script's
own draw order, so the two packages see the same numbers.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from regione_tpu_torch.core.config import DEFAULT_PARAMS, RegionEParams
from regione_tpu_torch.eval import resolve_device
from regione_tpu_torch.pipelines import PIPELINES
from regione_tpu_torch.pipelines.base import EditInputs


def log(msg: str, tag: str = "bench") -> None:
    print(f"[{tag}] {msg}", file=sys.stderr, flush=True)


def sync() -> None:
    """Wait for the card, if this process has touched it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def config(preset: str, cache: str = "bf16", act_int8: bool = False,
           blocks: int | None = None):
    """`preset`'s backbone config with the KV cache format ("bf16", "int8"
    or "int4"), W8A8 and depth_double (`blocks`) set."""
    from regione_tpu_torch.models.kv_cache import with_cache_format
    from regione_tpu_torch.models.presets import get_config
    cfg = dataclasses.replace(with_cache_format(get_config(preset), cache),
                              act_int8=act_int8)
    if blocks is not None:
        cfg = dataclasses.replace(cfg, depth_double=blocks)
    return cfg


def build(preset: str, device, seed: int = 0, *, backend: str | None = None,
          int8: bool = False, int4: bool = False, act_int8: bool = False,
          cache: str = "bf16", blocks: int | None = None,
          re: RegionEParams | None = None, model=None, **pipe_kw):
    """The pipeline of `backend` (default: the preset's name before ":")
    over `preset`'s backbone with random weights from `seed`: bf16 /
    fp32 (`init_params`), or drawn quantized (`init_quantized`: `int8`,
    or `int4` with int4 modulations, both with quantized modulations).
    `cache`: "bf16", "int8" or "int4" KV cache; `blocks`: depth_double;
    `re`: default `DEFAULT_PARAMS[backend]`.  `model`: an `MMDiT` to use
    instead of drawing one (its config must be the preset's)."""
    from regione_tpu_torch.ops.quant import init_quantized
    from regione_tpu_torch.weights.from_jax import init_params

    dev = resolve_device(device)
    backend = backend or preset.split(":")[0]
    if backend not in PIPELINES:
        raise SystemExit(f"unknown backend {backend!r}; expected one of "
                         f"{sorted(PIPELINES)} (tiny-* presets: pass the "
                         "backend as well)")
    cfg = config(preset, cache, act_int8, blocks)
    if model is None:
        gen = torch.Generator(dev).manual_seed(seed)
        if int8 or int4:
            model = init_quantized(cfg, gen, dev, quantize_mods=True,
                                   bits=4 if int4 else 8, int4_mods=int4)
        else:
            model = init_params(cfg, gen, dev)
    model.cfg = cfg
    return PIPELINES[backend](model, re or DEFAULT_PARAMS[backend], **pipe_kw)


def param_count(model) -> int:
    """Parameters, the JAX package's `param_count`: a packed int4 byte
    (`w_qp`) holds two."""
    return sum(p.numel() * (2 if n.endswith(".w_qp") else 1)
               for n, p in model.named_parameters())


def draw(rng, shape, device, dtype=torch.float32):
    """`rng.standard_normal(shape)` (float64, as the JAX scripts draw) as a
    tensor of `dtype` on `device`; None for an empty shape (a preset with
    no pooled embedding), which draws nothing."""
    x = rng.standard_normal(shape)
    return torch.from_numpy(x).to(device, dtype) if x.size else None


def seeded_inputs(pipe, grid: int, t_txt: int, seed: int):
    """`bench.py`'s draws from `default_rng(seed)`: the initial noise
    [1, S, C] (fp32), then the text [2, T, txt_in_dim] and pooled [2, P]
    embeddings (the model dtype; no pooled for P = 0).  Returns (the rng,
    for the draws that follow, lat0, txt, pooled)."""
    cfg, dev = pipe.cfg, pipe.device
    rng = np.random.default_rng(seed)
    lat0 = draw(rng, (1, grid * grid, cfg.in_channels), dev)
    txt = draw(rng, (2, t_txt, cfg.txt_in_dim), dev, cfg.dtype)
    pooled = draw(rng, (2, cfg.pooled_dim), dev, cfg.dtype)
    return rng, lat0, txt, pooled


def make_ctx(pipe, grid: int, txt, pooled=None, guidance=None
             ) -> Callable[[np.ndarray], EditInputs]:
    """cond [1, S, C] -> `EditInputs` with these embeddings and the grid's
    rope tables (built once)."""
    rope_img, rope_txt = pipe.build_rope(grid, grid, txt.shape[1])

    def ctx(cond):
        return EditInputs(txt=txt, cond_latent=torch.as_tensor(
            cond, dtype=torch.float32, device=txt.device), rope_img=rope_img,
            rope_txt=rope_txt, pooled=pooled, guidance=guidance)
    return ctx


def quarter_mask(grid: int, device) -> torch.Tensor:
    """The pinned ablation mask: the top-left quarter of the grid."""
    q = grid // 2
    block = np.zeros((grid, grid), bool)
    block[:q, :q] = True
    return torch.from_numpy(block.reshape(-1)).to(device)


def structured_condition(pipe, sampler, ctx_of, lat0, rng, *, span: int = 8,
                         band=(0.18, 0.35), cond=None, label: str = "probe",
                         log=log):
    """`bench.py`'s probe for a condition latent under which the adaptive
    partition is partial with random weights: the model's own x0 estimate
    at the partition step (the warm steps, then one dense forward and the
    `dt_final` jump) with a block replaced by noise, re-estimated under the
    new condition up to 3 times, until the edited fraction lies in `band`
    after the second estimate.  The block spans [grid/16, span*grid/16) on
    each axis before the partition's 5x5 dilation (`bench.py`: span 8,
    band 0.18-0.35; `scripts/bench_fullsize.py`: band 0.15-0.40).

    `ctx_of(cond)` builds the `EditInputs` for a condition latent; `rng`
    draws the noise block, then, unless `cond` is given, the first
    condition latent.  Returns (cond numpy [1, S, C] fp32, the last
    estimate's edited mask numpy [S])."""
    from regione_tpu_torch.core.partition import select_edited_mask
    re, grid = pipe.re, sampler.grid_h
    s, c_in = grid * grid, pipe.cfg.in_channels
    warm = sampler.plan[: re.warmup_step - 1]
    part = sampler.plan[re.warmup_step - 1]

    @torch.inference_mode()
    def x0_probe(ctx):
        ctx = dataclasses.replace(ctx, s_noise=s)
        lat = sampler._dense_steps(lat0.float(), warm, ctx)
        v, _ = pipe.dense_forward(lat, part.sigma, None, ctx, False)
        return lat + part.dt_final * v

    b0, b1 = grid // 16, grid * span // 16
    block = np.zeros((grid, grid), bool)
    block[b0:b1, b0:b1] = True
    target = block.reshape(-1)
    noise_block = rng.standard_normal((int(target.sum()), c_in))
    if cond is None:
        cond = rng.standard_normal((1, s, c_in))
    for it in range(3):
        t = time.perf_counter()
        x0 = x0_probe(ctx_of(cond))
        cond = x0.cpu().numpy().copy()
        cond[0, target] = noise_block
        mask = select_edited_mask(
            x0, torch.as_tensor(cond, dtype=torch.float32, device=x0.device),
            re.threshold, grid_h=grid, grid_w=grid,
            erosion_dilation=re.erosion_dilation)
        frac = float(mask.float().mean())
        log(f"{label}: probe {it}: edited fraction {frac:.3f} "
            f"({time.perf_counter() - t:.1f}s)")
        if band[0] <= frac <= band[1] and it >= 1:
            break
    return cond, mask.cpu().numpy()


def best_of(fn, n: int):
    """One untimed warm-up call of `fn`, then `n` timed ones, each ended by
    a synchronize.  Returns (the fastest call's seconds, the last result)."""
    out = fn()
    sync()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        out = fn()
        sync()
        times.append(time.perf_counter() - t)
    return min(times), out


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


def psnr(a, b) -> float:
    """PSNR of b against a, peak = a's range (`bench.py`)."""
    a, b = _numpy(a), _numpy(b)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    peak = float(max(a.max() - a.min(), 1e-9))
    return float(10.0 * np.log10(peak * peak / mse))


def reset_counts() -> None:
    """Set every kernel wrapper's launch count and host times to 0."""
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import fused  # noqa: F401 (registers)
    from regione_tpu_torch.ops import partition_kernel  # noqa: F401
    from regione_tpu_torch.ops import quant  # noqa: F401
    from regione_tpu_torch.utils import telemetry
    telemetry.reset_counters()
    fa.attention.long_launches = 0


def read_counts() -> dict:
    """Every kernel wrapper's launch count (K1 `attention`, K5
    `attention_long`, K2 `attention_rows2`, K2q `attention_rows2_quant`,
    K6 `attention_quant`, K3 `fused_partition`, K7 `adaln`,
    `residual_adaln`, `gated_residual`, K8 `qk_norm_rope`, K9
    `gelu_pack`, K10 `store_quantized`, K11 `swiglu_pack`)."""
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import fused
    from regione_tpu_torch.ops import partition_kernel as pk
    from regione_tpu_torch.ops import quant
    return {"attention": fa.attention.launches,
            "attention_long": fa.attention.long_launches,
            "attention_rows2": fa.attention_rows2.launches,
            "attention_rows2_quant": fa.attention_rows2_quant.launches,
            "attention_quant": fa.attention_quant.launches,
            "fused_partition": pk.fused_partition.launches,
            "adaln": fused.adaln.launches,
            "residual_adaln": fused.residual_adaln.launches,
            "gated_residual": fused.gated_residual.launches,
            "qk_norm_rope": fused.qk_norm_rope.launches,
            "gelu_pack": fused.gelu_pack.launches,
            "store_quantized": quant.store_quantized.launches,
            "swiglu_pack": fused.swiglu_pack.launches}


def spawn_ranks(code: str, args, n: int, limit: float, label: str,
                env=None) -> list[str]:
    """n processes `python -c code <rank> <n> *args`, joined by the caller's
    store, killed after `limit` seconds or once one fails.  Returns their
    outputs (stdout and stderr); raises with the first failed rank's."""
    import os
    import subprocess
    repo = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=str(repo), **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(n), *map(str, args)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    deadline = time.monotonic() + limit
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        r = failed[0]
        raise RuntimeError(f"{label}: rank {r} failed (rc "
                           f"{procs[r].returncode}):\n{outs[r][-3000:]}")
    return outs


def timed_edit(pipe, lat0, ctx, grid: int, dense_only: bool = False):
    """One edit, host wall time ended by a synchronize, launch counts set to
    0 just before and read just after, peak device memory of the edit (0
    off the card).  Returns (latents numpy, stats, seconds, counts, peak
    GiB)."""
    on_card = lat0.device.type == "cuda"
    reset_counts()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out, stats = pipe.edit_latents(lat0, ctx, grid, grid,
                                   dense_only=dense_only)
    sync()
    sec = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    return out.cpu().numpy(), stats, sec, counts, peak
