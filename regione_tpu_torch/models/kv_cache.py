"""The Region-Instruction K/V cache: the one module that knows its format
and its layout.

A format is one of `CACHE_FORMATS`: "bf16" (the model dtype, bf16 in every
preset), or "int8" / "int4" (`ops.quant`'s codes and fp32 row scales).  An
`MMDiTConfig` carries it as the JAX package's two exclusive bools,
`cache_int8` and `cache_int4`, which only this module reads or sets.  The
cache is a dict with the JAX pytree's leaf names (`init_cache`); a layer's
entry (`layer_kv`) is a tensor, or (rows, scales) when quantized.
"""

from __future__ import annotations

import dataclasses

import torch

from regione_tpu_torch.ops.quant import store_quantized
from regione_tpu_torch.utils import telemetry

CACHE_FORMATS = ("bf16", "int8", "int4")
SCALE_SUFFIX = "_s"
# the scale leaves' fill in a new cache (the JAX package's)
EMPTY_SCALE = 1e-12


def format_of(int8: bool = False, int4: bool = False) -> str:
    """The format two flags name (a tool's `--cache-int8` / `--cache-int4`,
    or a config's fields): int4 over int8 over "bf16"."""
    return "int4" if int4 else "int8" if int8 else "bf16"


def cache_format(cfg) -> str:
    """`cfg`'s cache format, one of `CACHE_FORMATS`."""
    assert not (cfg.cache_int8 and cfg.cache_int4), \
        "cache_int8 and cache_int4 are mutually exclusive"
    return format_of(cfg.cache_int8, cfg.cache_int4)


def with_cache_format(cfg, fmt: str):
    """`cfg` with its cache in format `fmt`."""
    if fmt not in CACHE_FORMATS:
        raise ValueError(f"cache format {fmt!r}, not one of "
                         f"{CACHE_FORMATS}")
    return dataclasses.replace(cfg, cache_int8=fmt == "int8",
                               cache_int4=fmt == "int4")


def init_cache(cfg, batch: int, s_kv_img: int, device, tp: int = 1):
    """Zeroed KV cache: {"dk", "dv"} (and {"sk", "sv"} with single blocks)
    of [L, B, H, S, dh], image rows only (txt rows re-embed every step).
    Quantized: int8 rows (S/2 packed rows under int4) and fp32 scale
    leaves "dk_s" ... of [L, B, H, S] filled with 1e-12, as in JAX.  `tp`:
    a tensor-parallel rank's cache holds its H / tp heads."""
    fmt = cache_format(cfg)
    rows = s_kv_img
    if fmt == "int4":
        if s_kv_img % 2:
            raise ValueError(f"an int4 cache needs an even row count, got "
                             f"{s_kv_img}")
        rows //= 2
    depths = {"dk": cfg.depth_double, "dv": cfg.depth_double}
    if cfg.depth_single:
        depths.update(sk=cfg.depth_single, sv=cfg.depth_single)
    cache = {}
    for key, depth in depths.items():
        cache[key] = torch.zeros(
            (depth, batch, cfg.heads // tp, rows, cfg.head_dim),
            dtype=cfg.dtype if fmt == "bf16" else torch.int8, device=device)
        if fmt != "bf16":
            cache[key + SCALE_SUFFIX] = torch.full(
                (depth, batch, cfg.heads // tp, s_kv_img), EMPTY_SCALE,
                dtype=torch.float32, device=device)
    return cache


def reset_cache(cache):
    """Refill a cache in place as `init_cache` fills a new one (zeros,
    and 1e-12 in the scale leaves); returns it."""
    for key, x in cache.items():
        if key.endswith(SCALE_SUFFIX):
            x.fill_(EMPTY_SCALE)
        else:
            x.zero_()
    return cache


def cache_bytes(cfg, batch: int, s_kv_img: int, tp: int = 1) -> int:
    """The bytes of `init_cache(cfg, batch, s_kv_img)`, its scale leaves
    included, on one of `tp` tensor-parallel ranks; allocates nothing."""
    return sum(x.numel() * x.element_size() for x in init_cache(
        cfg, batch, s_kv_img, "meta").values()) // tp


def image_rows(cache) -> int:
    """The cached image rows S: read off the scales of a quantized cache
    (an int4 rows leaf holds S/2 packed rows)."""
    return cache.get("dk" + SCALE_SUFFIX, cache["dk"]).shape[3]


def layer_kv(cache, key: str, i: int):
    """Layer i's entry of leaf `key`: a tensor, or (rows, scales) when
    quantized."""
    if key + SCALE_SUFFIX in cache:
        return cache[key][i], cache[key + SCALE_SUFFIX][i]
    return cache[key][i]


def attention_args(k_entry, v_entry):
    """A layer's K and V entries (`layer_kv`) -> (k, v, the scale keywords
    of the attention wrappers: {} for a cache in the model dtype)."""
    if isinstance(k_entry, tuple):
        (k, k_s), (v, v_s) = k_entry, v_entry
        return k, v, dict(k_scale=k_s, v_scale=v_s)
    return k_entry, v_entry, {}


def store_kv(cfg, cache, key: str, i: int, x):
    """Write mode: layer i's K or V rows into the cache, in place (a copy
    in the model dtype; under int8 / int4 the rows and scales quantized
    straight into the cache by `ops.quant.store_quantized`, K10 on the
    card), in a span `model.cache_write` (CUDA events on x; attrs: the
    block index, the cache `key`, the rows, the bytes written and the
    format: int8, int4 or the model dtype's name)."""
    fmt = cache_format(cfg)
    name = str(cfg.dtype).removeprefix("torch.") if fmt == "bf16" else fmt
    with telemetry.span("model.cache_write", events_on=x, index=i, key=key,
                        rows=x.shape[-2], format=name) as sp:
        if fmt == "bf16":
            parts = (cache[key][i],)
            parts[0].copy_(x)
        else:
            parts = (cache[key][i], cache[key + SCALE_SUFFIX][i])
            store_quantized(x, *parts, bits=4 if fmt == "int4" else 8)
        sp.set(bytes=sum(p.numel() * p.element_size() for p in parts))
