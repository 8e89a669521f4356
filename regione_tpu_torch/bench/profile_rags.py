"""The RegionE hot path broken into its pieces, each timed on the card: the
port of the JAX package's `scripts/profile_rags.py`.

  dense_scan8_ms    8 consecutive dense forwards with the cache write, one
                    synchronize at the end (the refresh / write unit)
  dense_fwd_ms      one dense forward with the cache write
  rags_fwd_ms       one RAGS forward (t_txt + cap fresh rows against the
                    frozen cache)
  rags_scan8_ms     8 consecutive RAGS forwards, one synchronize at the end
                    (the steady state of the RAGS segment)
  attn_rags_ms_x24  the attention alone at the RAGS shape (q: t_txt + cap
                    rows, keys: t_txt + S_kv rows), x the block count
  qkv_proj_ms_x24   one block's qkv projection on the active rows, x the
                    block count
  scatter_ms_x48    the in-place write of t_txt + cap rows into one
                    block's cached K, x 2 (K and V) x the block count
  avd_reuse_ms      the closed-form AVD reuse update on the active rows

    python -m regione_tpu_torch.bench.profile_rags [--cap 1024] [--cache-int8] [--scan-only]

At `step1x-edit:dev` (random weights from seed 0), grid 64, t_txt 128 by
default, the inputs drawn from `default_rng(0)` in the JAX script's order.
Prints one JSON line (the JAX script's keys; `--scan-only`: the two scans
alone).  Each time is the fastest of 10 calls after a warm-up, host wall
time ended by `torch.cuda.synchronize()` (`common.best_of`); `--device
cpu` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from regione_tpu_torch.bench import common

RUNS = 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--cache-int8", action="store_true")
    ap.add_argument("--scan-only", action="store_true",
                    help="only the steady-state scan numbers (fast sweep)")
    ap.add_argument("--preset", default="step1x-edit:dev")
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--t-txt", type=int, default=128)
    ap.add_argument("--runs", type=int, default=RUNS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card cuda stops")
    return ap.parse_args(argv)


@dataclasses.dataclass
class State:
    """What the pieces run on (the JAX script's setup)."""
    pipe: object
    ctx: object
    lat: torch.Tensor        # [1, S, C]
    lat_act: torch.Tensor    # [1, cap, C]
    ids: torch.Tensor        # [cap] int32
    cache: dict
    rng: np.random.Generator


def prepare(args, model=None) -> State:
    """The Step1X pipeline of `args.preset` (`model`: one to use instead of
    the seed-0 draw) and the script's draws from `default_rng(0)`: txt,
    cond, pooled, lat, lat_act; a zeroed cache of 2 x S_kv rows."""
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.models.kv_cache import format_of, init_cache
    cache_fmt = format_of(int8=args.cache_int8)
    pipe = common.build(args.preset, args.device, backend="step1x-edit",
                        cache=cache_fmt, re=RegionEParams(), model=model)
    cfg, dev = pipe.cfg, pipe.device
    grid, t_txt, cap = args.grid, args.t_txt, args.cap
    s = grid * grid
    rng = np.random.default_rng(0)
    txt = common.draw(rng, (2, t_txt, cfg.txt_in_dim), dev, cfg.dtype)
    cond = common.draw(rng, (1, s, cfg.in_channels), dev)
    pooled = common.draw(rng, (2, cfg.pooled_dim), dev, cfg.dtype)
    ctx = dataclasses.replace(
        common.make_ctx(pipe, grid, txt, pooled)(cond), s_noise=s)
    lat = common.draw(rng, (1, s, cfg.in_channels), dev)
    lat_act = common.draw(rng, (1, cap, cfg.in_channels), dev)
    ids = torch.arange(cap, dtype=torch.int32, device=dev)
    cache = init_cache(cfg, 2, 2 * s, dev)
    return State(pipe, ctx, lat, lat_act, ids, cache, rng)


def dense_fwd(st: State, lat=None, sigma: float = 0.7):
    """One dense forward with the cache write (in place)."""
    v, _ = st.pipe.dense_forward(st.lat if lat is None else lat, sigma,
                                 st.cache, st.ctx, True)
    return v


def rags_fwd(st: State, lat_act=None, sigma: float = 0.5):
    """One RAGS forward of the active rows against the cache."""
    v, _ = st.pipe.rags_forward(st.lat_act if lat_act is None else lat_act,
                                sigma, st.cache, st.ids, st.ctx)
    return v


def scan8(step, x, sigmas):
    """8 consecutive forwards, each feeding the next (x + 0.01 v)."""
    for sig in sigmas:
        x = x + 0.01 * step(x, float(sig))
    return x


def run(args, model=None) -> dict:
    """The JSON row."""
    from regione_tpu_torch.ops import flash_attention as fa
    st = prepare(args, model)
    cfg, dev = st.pipe.cfg, st.pipe.device
    t_txt, cap, n = args.t_txt, args.cap, args.runs
    s_kv = 2 * args.grid * args.grid
    blocks = cfg.depth_double + cfg.depth_single
    res = {"cap": cap, "cache_int8": args.cache_int8,
           "flash": "attention_tma" if dev.type == "cuda" else "plain"}

    def ms(fn):
        return common.best_of(fn, n)[0] * 1e3

    dense_sig = np.linspace(0.9, 0.4, 8, dtype=np.float32)
    rags_sig = np.linspace(0.6, 0.3, 8, dtype=np.float32)
    with torch.inference_mode():
        res["dense_scan8_ms"] = ms(lambda: scan8(
            lambda x, s: dense_fwd(st, x, s), st.lat, dense_sig))
        if not args.scan_only:
            res["dense_fwd_ms"] = ms(lambda: dense_fwd(st))
            res["rags_fwd_ms"] = ms(lambda: rags_fwd(st))
        res["rags_scan8_ms"] = ms(lambda: scan8(
            lambda x, s: rags_fwd(st, x, s), st.lat_act, rags_sig))
        if args.scan_only:
            return {k: round(v, 2) if isinstance(v, float) else v
                    for k, v in res.items()}

        # the attention alone at the RAGS shape: q rows = txt + cap, keys
        # over txt + the whole cache
        rng, h, dh = st.rng, cfg.heads, cfg.head_dim
        q = common.draw(rng, (2, h, t_txt + cap, dh), dev, torch.bfloat16)
        k = common.draw(rng, (2, h, t_txt + s_kv, dh), dev, torch.bfloat16)
        v = common.draw(rng, (2, h, t_txt + s_kv, dh), dev, torch.bfloat16)
        res["attn_rags_ms_x24"] = ms(lambda: fa.attention(q, k, v)) * blocks
        # one double block's qkv projection on the active rows
        wq = common.draw(rng, (cfg.hidden, 3 * cfg.inner), dev,
                         torch.bfloat16)
        xact = common.draw(rng, (2, t_txt + cap, cfg.hidden), dev,
                           torch.bfloat16)
        res["qkv_proj_ms_x24"] = ms(lambda: xact @ wq) * blocks
        # one block's K rows written into the cache in place
        cache_k = st.cache["dk"][0]             # [2, H, rows, dh]
        rows = common.draw(rng, (2, h, t_txt + cap, dh), dev,
                           torch.bfloat16).to(cache_k.dtype)
        sel = torch.arange(t_txt + cap, device=dev)
        res["scatter_ms_x48"] = ms(
            lambda: cache_k.index_copy_(2, sel, rows)) * 2 * blocks
        # the closed-form AVD reuse update
        res["avd_reuse_ms"] = ms(lambda: st.lat_act + 0.05 * st.lat_act)
    res = {k: round(v, 2) if isinstance(v, float) else v
           for k, v in res.items()}
    res["device"] = common.device_name(dev)
    return res


def main(argv=None) -> dict:
    row = run(parse_args(argv))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
