"""Backbone presets of the port, under the JAX package's names and numbers
(`regione_tpu/models/presets.py`): the full-width Step1X-Edit (v1.1 and
v1.2), FLUX.1 Kontext and Qwen-Image-Edit (+ Plus), their scaled
single-device variants, and the tiny CPU test configs.  The quantized-cache
flags are not part of a preset: set them with
`dataclasses.replace(cfg, cache_int8=True)` as the JAX package's
callers do."""

from __future__ import annotations

import torch

from regione_tpu_torch.models.connector import ConnectorConfig
from regione_tpu_torch.models.mmdit import MMDiTConfig

PRESETS: dict[str, MMDiTConfig] = {
    # Step1X-Edit v1.1: FLUX-topology MMDiT with the Qwen2.5-VL connector
    # (12.3 B parameters)
    "step1x-edit": MMDiTConfig(
        hidden=3072, heads=24, head_dim=128, depth_double=19, depth_single=38,
        txt_in_dim=3584, pooled_dim=768, axes_dims=(16, 56, 56),
        connector=ConnectorConfig(in_dim=3584, hidden=3584, heads=28,
                                  depth=2, pooled_dim=768),
    ),
    # Step1X-Edit v1.2: the v1.1 backbone (its own gamma table)
    "step1x-edit-v1p2": MMDiTConfig(
        hidden=3072, heads=24, head_dim=128, depth_double=19, depth_single=38,
        txt_in_dim=3584, pooled_dim=768, axes_dims=(16, 56, 56),
        connector=ConnectorConfig(in_dim=3584, hidden=3584, heads=28,
                                  depth=2, pooled_dim=768),
    ),
    # FLUX.1 Kontext dev: T5 features, CLIP pooled vector, the distilled
    # guidance embed (11.9 B parameters)
    "flux-kontext": MMDiTConfig(
        hidden=3072, heads=24, head_dim=128, depth_double=19, depth_single=38,
        txt_in_dim=4096, pooled_dim=768, guidance_embed=True,
        axes_dims=(16, 56, 56),
    ),
    # Qwen-Image-Edit: 60 joint double-stream blocks, no single blocks, no
    # pooled projection, RMSNorm on the text features (20.4 B parameters)
    "qwen-image-edit": MMDiTConfig(
        hidden=3072, heads=24, head_dim=128, depth_double=60, depth_single=0,
        txt_in_dim=3584, pooled_dim=0, axes_dims=(16, 56, 56), txt_norm=True,
    ),
    # Qwen-Image-Edit-2509 ("Plus"): the same backbone
    "qwen-image-edit-plus": MMDiTConfig(
        hidden=3072, heads=24, head_dim=128, depth_double=60, depth_single=0,
        txt_in_dim=3584, pooled_dim=0, axes_dims=(16, 56, 56), txt_norm=True,
    ),
    # scaled-down Step1X topology (1.26 B parameters, no connector)
    "step1x-edit:dev": MMDiTConfig(
        hidden=1536, heads=12, head_dim=128, depth_double=8, depth_single=16,
        txt_in_dim=1024, pooled_dim=768, axes_dims=(16, 56, 56),
    ),
    "flux-kontext:dev": MMDiTConfig(
        hidden=1536, heads=12, head_dim=128, depth_double=8, depth_single=16,
        txt_in_dim=1024, pooled_dim=768, guidance_embed=True,
        axes_dims=(16, 56, 56),
    ),
    # scaled-down Qwen topology
    "qwen-image-edit:dev": MMDiTConfig(
        hidden=1536, heads=12, head_dim=128, depth_double=24, depth_single=0,
        txt_in_dim=1024, pooled_dim=0, axes_dims=(16, 56, 56), txt_norm=True,
    ),
    # CPU unit-test configs
    "tiny": MMDiTConfig(
        hidden=32, heads=2, head_dim=16, depth_double=2, depth_single=2,
        txt_in_dim=16, pooled_dim=8, axes_dims=(4, 6, 6), time_embed_dim=32,
        mlp_ratio=2.0, in_channels=8, out_channels=8, dtype=torch.float32,
    ),
    "tiny-step1x": MMDiTConfig(
        hidden=32, heads=2, head_dim=16, depth_double=2, depth_single=2,
        txt_in_dim=16, pooled_dim=8, axes_dims=(4, 6, 6), time_embed_dim=32,
        mlp_ratio=2.0, in_channels=8, out_channels=8, dtype=torch.float32,
        connector=ConnectorConfig(in_dim=16, hidden=16, heads=2, depth=2,
                                  pooled_dim=8, time_embed_dim=32,
                                  dtype=torch.float32),
    ),
    "tiny-flux": MMDiTConfig(
        hidden=32, heads=2, head_dim=16, depth_double=2, depth_single=2,
        txt_in_dim=16, pooled_dim=8, guidance_embed=True,
        axes_dims=(4, 6, 6), time_embed_dim=32, mlp_ratio=2.0,
        in_channels=8, out_channels=8, dtype=torch.float32,
    ),
    "tiny-qwen": MMDiTConfig(
        hidden=32, heads=2, head_dim=16, depth_double=3, depth_single=0,
        txt_in_dim=16, pooled_dim=0, axes_dims=(4, 6, 6), time_embed_dim=32,
        mlp_ratio=2.0, in_channels=8, out_channels=8, dtype=torch.float32,
        txt_norm=True,
    ),
    # sharding tests: head count (8) and all feature dims divisible by
    # tp=4, so a (dp=2, tp=4) mesh splits every rule of parallel.sharding
    "tiny-tp": MMDiTConfig(
        hidden=128, heads=8, head_dim=16, depth_double=2, depth_single=2,
        txt_in_dim=16, pooled_dim=8, axes_dims=(4, 6, 6), time_embed_dim=32,
        mlp_ratio=2.0, in_channels=8, out_channels=8, dtype=torch.float32,
    ),
    # the Qwen topology under tp: joint double blocks only + txt_norm
    "tiny-qwen-tp": MMDiTConfig(
        hidden=128, heads=8, head_dim=16, depth_double=3, depth_single=0,
        txt_in_dim=16, pooled_dim=0, axes_dims=(4, 6, 6), time_embed_dim=32,
        mlp_ratio=2.0, in_channels=8, out_channels=8, dtype=torch.float32,
        txt_norm=True,
    ),
}


def get_config(name: str) -> MMDiTConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}"
                       ) from None
