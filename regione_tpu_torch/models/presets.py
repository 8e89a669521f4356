"""Backbone presets of the port, under the JAX package's names and numbers
(`regione_tpu/models/presets.py`): the full-width Step1X-Edit, its scaled
single-device variant, and the two tiny CPU test configs."""

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
    # scaled-down Step1X topology (1.26 B parameters, no connector)
    "step1x-edit:dev": MMDiTConfig(
        hidden=1536, heads=12, head_dim=128, depth_double=8, depth_single=16,
        txt_in_dim=1024, pooled_dim=768, axes_dims=(16, 56, 56),
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
}


def get_config(name: str) -> MMDiTConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}"
                       ) from None
