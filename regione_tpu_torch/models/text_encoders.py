"""Prompt encoders of the port.

Only `MockTextEncoder` so far: the port's own copy of the class in
`regione_tpu/models/text_encoders.py` (numpy, no checkpoint), seeded
pseudo-features for tests, benches and runs without the encoders'
checkpoints, equal to the JAX one for the same prompt and image
(tests/test_torch_core_config.py).  The real encoders (Qwen2.5-VL, T5 +
CLIP) wait for ROADMAP queue 1, item 10.

Interface: encode(prompt, image=None) -> (embeds [1, T, D] fp32, pooled
[1, P] fp32 | None, mask [1, T] bool), all numpy; encoding runs once per
prompt, before the denoise loop.
"""

from __future__ import annotations

import hashlib

import numpy as np


class MockTextEncoder:
    """Deterministic pseudo-embeddings: same prompt -> same features."""

    def __init__(self, dim: int, pooled_dim: int | None = None,
                 max_length: int = 128):
        self.dim = dim
        self.pooled_dim = pooled_dim
        self.max_length = max_length

    def encode(self, prompt: str, image=None):
        h = hashlib.sha256(prompt.encode())
        if image is not None:
            # fold image content into the seed so image-conditioned prompts
            # produce image-dependent features (as the VL encoders do)
            imgs = image if isinstance(image, (list, tuple)) else [image]
            for im in imgs:
                h.update(np.ascontiguousarray(np.asarray(im)).tobytes())
        seed = int.from_bytes(h.digest()[:8], "little")
        rng = np.random.default_rng(seed)
        t = min(self.max_length, max(4, len(prompt.split()) + 2))
        emb = np.zeros((1, self.max_length, self.dim), np.float32)
        emb[:, :t] = rng.standard_normal((1, t, self.dim)).astype(np.float32)
        mask = np.zeros((1, self.max_length), bool)
        mask[:, :t] = True
        pooled = (rng.standard_normal((1, self.pooled_dim)).astype(np.float32)
                  if self.pooled_dim else None)
        return emb, pooled, mask
