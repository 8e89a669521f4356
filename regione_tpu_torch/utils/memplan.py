"""Device-memory planning: will the weights plus a group's KV caches fit?

Counterpart of `regione_tpu/utils/memplan.py` at one device (tp 1) with
the weights in their preset dtype.  The byte counts are exact and allocate
nothing: the parameters are those of the port's `MMDiT` built on the
`meta` device, the cache those of `init_cache`'s tensors (the JAX module
takes both from `jax.eval_shape`); the activations are the JAX module's
estimate (the dominant live set of one dense forward at bf16, x2 slack).
`batch` is the number of images denoised together (`EditService.
run_batched`'s group, `RegionESampler.sample_batch`): each brings its own
cache set (`batch_cfg` rows: 2 under batch CFG) and its share of the
activations.

CLI:  python -m regione_tpu_torch.utils.memplan --preset step1x-edit \
          --grid 64 --t-txt 512 --batch 3 --cache int8
"""

from __future__ import annotations

import dataclasses
import json

import torch

# device memory of one card, bytes: the H100 SXM's 80 GB (chip_smoke.py
# prints torch.cuda.get_device_properties(0).total_memory beside it)
HBM_BYTES = {"h100": 80 * 1024**3}

CACHE_FORMATS = ("bf16", "int8", "int4")


@dataclasses.dataclass
class MemPlan:
    preset: str
    cache: str          # "bf16" (the model dtype), "int8" or "int4"
    grid: int
    t_txt: int
    batch_cfg: int
    batch: int
    param_bytes: int
    cache_bytes: int
    activation_bytes_est: int
    total_bytes: int
    params_total: int

    def fits(self, hbm: int | str = "h100", reserve_frac: float = 0.08
             ) -> bool:
        budget = HBM_BYTES[hbm] if isinstance(hbm, str) else hbm
        return self.total_bytes <= budget * (1 - reserve_frac)

    def as_dict(self):
        d = dataclasses.asdict(self)
        for k in ("param_bytes", "cache_bytes", "activation_bytes_est",
                  "total_bytes"):
            d[k + "_gib"] = round(d[k] / 1024**3, 3)
        return d


def plan(preset, grid: int = 64, t_txt: int = 512, batch_cfg: int = 2,
         cache: str = "bf16", batch: int = 1, tp: int = 1,
         int8: bool = False) -> MemPlan:
    """Bytes of the weights, of `batch` KV-cache sets and the activation
    estimate for `preset` (a name or an `MMDiTConfig`) at a grid x grid
    token grid (S_kv = 2 * grid^2 image rows) and t_txt text rows, on one
    card.  `tp` > 1 and int8 weights raise: they wait for the ROADMAP
    queue-1 items `parallel/sharding.py` and "quantized weights"."""
    from regione_tpu_torch.models.mmdit import MMDiT, init_cache
    from regione_tpu_torch.models.presets import get_config
    if tp != 1:
        raise NotImplementedError(
            "memplan.plan(tp > 1): tensor parallelism waits for the port of "
            "parallel/sharding (ROADMAP queue 1, `parallel/sharding.py`)")
    if int8:
        raise NotImplementedError(
            "memplan.plan(int8=True): quantized weights wait for the ROADMAP "
            "queue-1 item \"quantized weights\"")
    if cache not in CACHE_FORMATS:
        raise ValueError(f"cache format {cache!r}, not one of "
                         f"{CACHE_FORMATS}")
    name = preset if isinstance(preset, str) else "custom"
    cfg = get_config(preset) if isinstance(preset, str) else preset
    meta = torch.device("meta")
    params = list(MMDiT(cfg, meta).parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    s_kv = 2 * grid * grid
    cache_cfg = dataclasses.replace(cfg, cache_int8=cache == "int8",
                                    cache_int4=cache == "int4")
    cache_bytes = sum(t.numel() * t.element_size() for t in init_cache(
        cache_cfg, batch * batch_cfg, s_kv, meta).values())
    act = (batch * batch_cfg * (s_kv + t_txt)
           * max(cfg.mlp_hidden, 3 * cfg.inner, cfg.hidden) * 2) * 2
    return MemPlan(
        preset=name, cache=cache, grid=grid, t_txt=t_txt,
        batch_cfg=batch_cfg, batch=batch, param_bytes=int(param_bytes),
        cache_bytes=int(cache_bytes), activation_bytes_est=int(act),
        total_bytes=int(param_bytes + cache_bytes + act),
        params_total=int(sum(p.numel() for p in params)))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", required=True)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--t-txt", type=int, default=512)
    ap.add_argument("--batch-cfg", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1,
                    help="images denoised together, each with its own cache")
    ap.add_argument("--cache", default="bf16", choices=CACHE_FORMATS)
    ap.add_argument("--hbm", default="h100", choices=sorted(HBM_BYTES))
    args = ap.parse_args(argv)
    p = plan(args.preset, grid=args.grid, t_txt=args.t_txt,
             batch_cfg=args.batch_cfg, cache=args.cache, batch=args.batch)
    out = p.as_dict()
    out["fits_" + args.hbm] = p.fits(args.hbm)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
