"""Device-memory planning: will the weights plus a group's KV caches fit?

Counterpart of `regione_tpu/utils/memplan.py`, per card, with the weights
in their preset dtype or quantized (`int8`, with the JAX module's
`quantize_mods`, `bits` and `int4_mods`), whole or tensor-parallel (`tp`:
each leaf the rules of `parallel.sharding` split counts 1 / tp, and the
KV cache 1 / tp; the sums are made per JAX leaf, the layer stacks summed
first, as the JAX module counts).  The byte counts are
exact and allocate nothing: the parameters are those of the port's `MMDiT`
built on the `meta` device (quantized there by `ops.quant.quantize_params`),
the cache those of `init_cache`'s tensors (the JAX module takes both from
`jax.eval_shape`); the activations are the JAX module's
estimate (the dominant live set of one dense forward at bf16, x2 slack).
`batch` is the number of images denoised together (`EditService.
run_batched`'s group, `RegionESampler.sample_batch`): each brings its own
cache set (`batch_cfg` rows: 2 under batch CFG) and its share of the
activations.

CLI:  python -m regione_tpu_torch.utils.memplan --preset step1x-edit \
          --grid 64 --t-txt 512 --batch 3 --cache int8 [--tp 4] [--int8 \
          [--quantize-mods] [--bits 4 [--int4-mods]]]
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
    param_bytes: int            # per card
    cache_bytes: int            # per card
    activation_bytes_est: int
    total_bytes: int
    params_total: int
    tp: int = 1
    sharded_leaves: int = 0     # JAX leaves (layer stacks) split over tp
    # (JAX path, MiB) of the leaves over 64 MiB that stay whole at tp > 1
    replicated_big_leaves: list = dataclasses.field(default_factory=list)

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
         int8: bool = False, quantize_mods: bool = False, bits: int = 8,
         int4_mods: bool = False) -> MemPlan:
    """Bytes per card of the weights, of `batch` KV-cache sets and the
    activation estimate for `preset` (a name or an `MMDiTConfig`) at a
    grid x grid token grid (S_kv = 2 * grid^2 image rows) and t_txt text
    rows.  `int8` quantizes the weights as `ops.quant.quantize_params(
    quantize_mods=, bits=, int4_mods=)` does (bits=4: int4); a packed int4
    byte counts two parameters in `params_total`.  `tp`: the tensor-
    parallel degree (`parallel.sharding`)."""
    from regione_tpu_torch.models.mmdit import MMDiT, init_cache
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.ops.quant import quantize_params
    from regione_tpu_torch.parallel.sharding import jax_leaf, param_specs
    if cache not in CACHE_FORMATS:
        raise ValueError(f"cache format {cache!r}, not one of "
                         f"{CACHE_FORMATS}")
    name = preset if isinstance(preset, str) else "custom"
    cfg = get_config(preset) if isinstance(preset, str) else preset
    meta = torch.device("meta")
    model = MMDiT(cfg, meta)
    if int8:
        quantize_params(model, quantize_mods=quantize_mods, bits=bits,
                        int4_mods=int4_mods)
    named = list(model.named_parameters())
    specs = param_specs(model)
    leaves: dict[str, list] = {}     # JAX path -> [bytes, split over tp]
    for n, p in named:
        entry = leaves.setdefault(jax_leaf(n)[0], [0, "tp" in specs[n]])
        entry[0] += p.numel() * p.element_size()
    param_bytes = sum(nb // tp if split else nb
                      for nb, split in leaves.values())
    big = [(path, round(nb / 1024**2, 1))
           for path, (nb, split) in leaves.items()
           if not split and nb > 64 * 1024**2 and tp > 1]
    s_kv = 2 * grid * grid
    cache_cfg = dataclasses.replace(cfg, cache_int8=cache == "int8",
                                    cache_int4=cache == "int4")
    cache_bytes = sum(t.numel() * t.element_size() for t in init_cache(
        cache_cfg, batch * batch_cfg, s_kv, meta).values()) // tp
    act = (batch * batch_cfg * (s_kv + t_txt)
           * max(cfg.mlp_hidden // tp, 3 * cfg.inner // tp, cfg.hidden)
           * 2) * 2
    return MemPlan(
        preset=name, cache=cache, grid=grid, t_txt=t_txt,
        batch_cfg=batch_cfg, batch=batch, param_bytes=int(param_bytes),
        cache_bytes=int(cache_bytes), activation_bytes_est=int(act),
        total_bytes=int(param_bytes + cache_bytes + act),
        params_total=int(sum(p.numel() * (2 if n.endswith(".w_qp") else 1)
                             for n, p in named)),
        tp=tp, sharded_leaves=sum(split for _, split in leaves.values()),
        replicated_big_leaves=big)


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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (bytes per card)")
    ap.add_argument("--hbm", default="h100", choices=sorted(HBM_BYTES))
    ap.add_argument("--int8", action="store_true",
                    help="quantized weights (int8, or int4 with --bits 4)")
    ap.add_argument("--quantize-mods", action="store_true")
    ap.add_argument("--bits", type=int, default=8, choices=(4, 8))
    ap.add_argument("--int4-mods", action="store_true")
    args = ap.parse_args(argv)
    p = plan(args.preset, grid=args.grid, t_txt=args.t_txt,
             batch_cfg=args.batch_cfg, cache=args.cache, batch=args.batch,
             tp=args.tp, int8=args.int8, quantize_mods=args.quantize_mods,
             bits=args.bits, int4_mods=args.int4_mods)
    out = p.as_dict()
    out["fits_" + args.hbm] = p.fits(args.hbm)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
