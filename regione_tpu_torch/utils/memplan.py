"""Device-memory planning: will the weights plus a group's KV caches fit?

Counterpart of `regione_tpu/utils/memplan.py`, per card, with the weights
in their preset dtype or quantized (`int8`, with the JAX module's
`quantize_mods`, `bits` and `int4_mods`), whole or tensor-parallel (`tp`:
each leaf the rules of `parallel.sharding` split counts 1 / tp, and the
KV cache 1 / tp; the sums are made per JAX leaf, the layer stacks summed
first, as the JAX module counts).  The byte counts are
exact and allocate nothing: the parameters are those of the port's `MMDiT`
built on the `meta` device (quantized there by `ops.quant.quantize_params`),
the cache those of `models.kv_cache.cache_bytes` (the JAX module takes
both from `jax.eval_shape`); the activations are the JAX module's
estimate (the dominant live set of one dense forward at bf16, x2 slack).
`batch` is the number of images denoised together (`EditService.
run_batched`'s group, `RegionESampler.sample_batch`): each brings its own
cache set (`batch_cfg` rows: 2 under batch CFG) and its share of the
activations.

`encoder` adds the prompt encoder, in fp32 as the pipelines load it: a
published one by name (`ENCODER_CONFIGS`: Qwen2.5-VL-7B for the Qwen family
and Step1X, T5-XXL + CLIP-L for FLUX; `ENCODER_OF` maps a backend to its
own), or a checkpoint's text_encoder/ directory.  Its bytes are those of the
`transformers` model built on the `meta` device from the config (nothing is
downloaded or allocated).  `MemPlan.encoder_placement` then says where the
encoder may live (`models.text_encoders.PLACEMENTS`): "card" when weights
+ encoder + cache + activations fit, "offload" (on the card for the encode
only, on the host during the denoise) when weights + encoder fit, else
"host".

CLI:  python -m regione_tpu_torch.utils.memplan --preset step1x-edit \
          --grid 64 --t-txt 512 --batch 3 --cache int8 [--tp 4] [--int8 \
          [--quantize-mods] [--bits 4 [--int4-mods]]] [--encoder auto]
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import torch

from regione_tpu_torch.models.kv_cache import (CACHE_FORMATS, cache_bytes,
                                               cache_format,
                                               with_cache_format)

# device memory of one card, bytes: the H100 SXM's 80 GB (chip_smoke.py
# prints torch.cuda.get_device_properties(0).total_memory beside it)
HBM_BYTES = {"h100": 80 * 1024**3}

# the published prompt encoders' widths (their config.json), as the
# `transformers` config classes take them: (model class, config class,
# config) for each part
_QWEN25_VL_7B_TEXT = dict(
    hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
    num_attention_heads=28, num_key_value_heads=4, vocab_size=152064,
    max_position_embeddings=128000, rms_norm_eps=1e-6, rope_theta=1e6,
    rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
    tie_word_embeddings=False)
ENCODER_CONFIGS = {
    # Qwen/Qwen2.5-VL-7B-Instruct: the text_encoder/ of Qwen-Image-Edit(-2509)
    # and the multimodal encoder of Step1X-Edit
    "qwen2.5-vl-7b": (("Qwen2_5_VLForConditionalGeneration",
                       "Qwen2_5_VLConfig", dict(
                           vision_config=dict(
                               depth=32, hidden_size=1280,
                               intermediate_size=3420, num_heads=16,
                               in_channels=3, out_hidden_size=3584,
                               patch_size=14, spatial_merge_size=2,
                               temporal_patch_size=2, window_size=112,
                               fullatt_block_indexes=[7, 15, 23, 31],
                               hidden_act="silu"),
                           text_config=dict(_QWEN25_VL_7B_TEXT),
                           **_QWEN25_VL_7B_TEXT)),),
    # google/t5-v1_1-xxl's encoder (text_encoder_2/) and openai/clip-vit-
    # large-patch14's text tower (text_encoder/) of FLUX.1 Kontext
    "t5-xxl+clip-l": (("T5EncoderModel", "T5Config", dict(
                          d_model=4096, d_ff=10240, d_kv=64, num_heads=64,
                          num_layers=24, vocab_size=32128,
                          feed_forward_proj="gated-gelu",
                          relative_attention_num_buckets=32,
                          tie_word_embeddings=False)),
                      ("CLIPTextModel", "CLIPTextConfig", dict(
                          hidden_size=768, intermediate_size=3072,
                          num_hidden_layers=12, num_attention_heads=12,
                          vocab_size=49408, max_position_embeddings=77,
                          projection_dim=768))),
}
ENCODER_OF = {"qwen-image-edit": "qwen2.5-vl-7b",
              "qwen-image-edit-plus": "qwen2.5-vl-7b",
              "step1x-edit": "qwen2.5-vl-7b",
              "step1x-edit-v1p2": "qwen2.5-vl-7b",
              "flux-kontext": "t5-xxl+clip-l"}


def _model_bytes(model) -> int:
    """fp32 bytes of a model's parameters and buffers (tied ones once)."""
    return sum(t.numel() * t.element_size() for t in
               (*model.parameters(), *model.buffers()))


@functools.lru_cache(maxsize=None)
def encoder_bytes(encoder: str) -> int:
    """Bytes of a prompt encoder in fp32: a name of `ENCODER_CONFIGS`, or a
    checkpoint's text encoder directory (its config.json; a Qwen2.5-VL /
    Qwen2-VL one is the whole conditional-generation model, as
    `QwenVLPromptEncoder` loads it).  Built on the `meta` device."""
    import transformers
    if encoder in ENCODER_CONFIGS:
        parts = [(getattr(transformers, m), getattr(transformers, c)(**kw))
                 for m, c, kw in ENCODER_CONFIGS[encoder]]
    else:
        config = transformers.AutoConfig.from_pretrained(str(encoder))
        if config.model_type in ("qwen2_5_vl", "qwen2_vl"):
            from regione_tpu_torch.models.text_encoders import vl_class
            parts = [(vl_class(), config)]
        else:
            from transformers.models.auto.modeling_auto import MODEL_MAPPING
            parts = [(MODEL_MAPPING[type(config)], config)]
    total = 0
    for cls, config in parts:
        # the class itself, not `from_config`: that would take the dtype a
        # checkpoint's config.json names, where the encoders load fp32
        with torch.device("meta"):
            total += _model_bytes(cls(config))
    return total


def checkpoint_encoder(root, backend: str) -> str | None:
    """The text encoder directories `text_encoders.encoder_from_checkpoint`
    reads from a diffusers-layout checkpoint, joined by "+" (FLUX: T5 and
    CLIP), or None when it has none."""
    root = Path(root)
    names = (("text_encoder_2", "text_encoder") if backend == "flux-kontext"
             else ("text_encoder",))
    dirs = [root / n for n in names]
    if not all((d / "config.json").exists() for d in dirs):
        return None
    return "+".join(str(d) for d in dirs)


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
    encoder: str | None = None  # the prompt encoder counted, if any
    encoder_bytes: int = 0      # its fp32 bytes (in total_bytes)

    def fits(self, hbm: int | str = "h100", reserve_frac: float = 0.08
             ) -> bool:
        return self.total_bytes <= _budget(hbm, reserve_frac)

    def encoder_placement(self, hbm: int | str = "h100",
                          reserve_frac: float = 0.08) -> str:
        """Where the prompt encoder goes on a card of `hbm` bytes (or the
        name of one): "card" when the whole plan fits; "offload" when the
        weights and the encoder fit together (the encode runs before the
        cache exists, and the encoder leaves before the denoise); else
        "host"."""
        budget = _budget(hbm, reserve_frac)
        if self.total_bytes <= budget:
            return "card"
        if self.param_bytes + self.encoder_bytes <= budget:
            return "offload"
        return "host"

    def as_dict(self):
        d = dataclasses.asdict(self)
        for k in ("param_bytes", "cache_bytes", "activation_bytes_est",
                  "encoder_bytes", "total_bytes"):
            d[k + "_gib"] = round(d[k] / 1024**3, 3)
        return d


def _budget(hbm: int | str, reserve_frac: float) -> float:
    return (HBM_BYTES[hbm] if isinstance(hbm, str) else hbm) * (
        1 - reserve_frac)


def plan(preset, grid: int = 64, t_txt: int = 512, batch_cfg: int = 2,
         cache: str = "bf16", batch: int = 1, tp: int = 1,
         int8: bool = False, quantize_mods: bool = False, bits: int = 8,
         int4_mods: bool = False, encoder: str | None = None) -> MemPlan:
    """Bytes per card of the weights, of `batch` KV-cache sets and the
    activation estimate for `preset` (a name or an `MMDiTConfig`) at a
    grid x grid token grid (S_kv = 2 * grid^2 image rows) and t_txt text
    rows.  `int8` quantizes the weights as `ops.quant.quantize_params(
    quantize_mods=, bits=, int4_mods=)` does (bits=4: int4); a packed int4
    byte counts two parameters in `params_total`.  `tp`: the tensor-
    parallel degree (`parallel.sharding`).  `encoder`: the prompt
    encoder to count (`encoder_bytes`; "+"-joined parts add up), whole on
    every card."""
    from regione_tpu_torch.models.mmdit import MMDiT
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.ops.quant import quantize_params
    from regione_tpu_torch.parallel.sharding import jax_leaf, param_specs
    name = preset if isinstance(preset, str) else "custom"
    cfg = with_cache_format(
        get_config(preset) if isinstance(preset, str) else preset, cache)
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
    kv_bytes = cache_bytes(cfg, batch * batch_cfg, s_kv, tp)
    act = (batch * batch_cfg * (s_kv + t_txt)
           * max(cfg.mlp_hidden // tp, 3 * cfg.inner // tp, cfg.hidden)
           * 2) * 2
    parts = [] if not encoder else [encoder] if encoder in ENCODER_CONFIGS \
        else encoder.split("+")
    enc = sum(encoder_bytes(part) for part in parts)
    return MemPlan(
        preset=name, cache=cache, grid=grid, t_txt=t_txt,
        batch_cfg=batch_cfg, batch=batch, param_bytes=int(param_bytes),
        cache_bytes=kv_bytes, activation_bytes_est=int(act),
        total_bytes=int(param_bytes + kv_bytes + act + enc),
        params_total=int(sum(p.numel() * (2 if n.endswith(".w_qp") else 1)
                             for n, p in named)),
        tp=tp, sharded_leaves=sum(split for _, split in leaves.values()),
        replicated_big_leaves=big, encoder=encoder, encoder_bytes=int(enc))


def choose_placement(cfg, encoder: str, hbm: int | str, *, grid: int = 64,
                     t_txt: int = 512, batch_cfg: int = 2, tp: int = 1,
                     **weights) -> tuple[str, MemPlan]:
    """Where `encoder` goes beside `cfg`'s weights (`weights`: `plan`'s
    int8 / bits / quantize_mods / int4_mods, the format the denoise will
    hold) and its KV cache on a card of `hbm` bytes, decided before
    anything is loaded: (`MemPlan.encoder_placement`, the plan).  The
    defaults are a 1024^2 edit (grid 64) at the reference's 512-token
    prompt under batch CFG."""
    p = plan(cfg, grid=grid, t_txt=t_txt, batch_cfg=batch_cfg,
             cache=cache_format(cfg), tp=tp, encoder=encoder, **weights)
    return p.encoder_placement(hbm), p


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
    ap.add_argument("--encoder", default=None,
                    help="count the prompt encoder in fp32: 'auto' (the "
                         "preset's published one), a name of "
                         f"{sorted(ENCODER_CONFIGS)}, or a text encoder "
                         "directory")
    args = ap.parse_args(argv)
    encoder = (ENCODER_OF[args.preset.split(":")[0]]
               if args.encoder == "auto" else args.encoder)
    p = plan(args.preset, grid=args.grid, t_txt=args.t_txt,
             batch_cfg=args.batch_cfg, cache=args.cache, batch=args.batch,
             tp=args.tp, int8=args.int8, quantize_mods=args.quantize_mods,
             bits=args.bits, int4_mods=args.int4_mods, encoder=encoder)
    out = p.as_dict()
    out["fits_" + args.hbm] = p.fits(args.hbm)
    if encoder:
        out["encoder_placement"] = p.encoder_placement(args.hbm)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
