"""Qwen-Image-Edit and Qwen-Image-Edit-2509 ("Plus") pipeline adapters.

Counterpart of `regione_tpu/pipelines/qwen_image_edit.py`:
  * true CFG as one batch of two ([cond, uncond]), scale 4 by default; each
    batch row owns its cache slice, which is the reference's per-tag cache
    pair;
  * the norm-preserving combine: the combined velocity rescaled to the
    conditional branch's per-token norm;
  * the Qwen rotary ids: per image (frame, h, w) with frame = image index
    (noise 0, references 1, 2, ...) and centred h/w ids
    arange(n) - (n - n // 2); text rows get diagonal ids offset by
    max(h // 2, w // 2) over all images;
  * the uncond prompt is " " (a single space) unless the caller gives one;
  * Qwen-Image's scheduler: mu over 256 -> 8192 noise tokens between 0.5
    and 0.9, the sigmas stretched to end at 0.02 (`QWEN_IMAGE_SHIFT`; the
    JAX package runs FLUX.1's schedule here);
  * Plus's dual-size references: each image goes to the prompt encoder at
    ~384^2 area and to the VAE at ~1024^2 area, both multiples of 32.
The backbone is the joint double-stream MMDiT (presets "qwen-image-edit",
"qwen-image-edit-plus"), usually run with a quantized KV cache
(`MMDiTConfig.cache_int8` / `cache_int4`).  Its knobs are
`DEFAULT_PARAMS[backend]` and `gamma_for(backend)` of the port's
`core.config` and `core.gamma`.  Its VAE is the Wan VAE (`models/vae_wan.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from regione_tpu_torch.core.schedule import QWEN_IMAGE_SHIFT
from regione_tpu_torch.pipelines.base import EditPipelineBase

# reference RegionE/QwenImageEditPlus constants
CONDITION_IMAGE_AREA = 384 * 384
VAE_IMAGE_AREA = 1024 * 1024


def calculate_dimensions(target_area: int, ratio: float, multiple: int = 32
                         ) -> tuple[int, int]:
    """Resize to ~target_area preserving aspect, rounded to `multiple`
    (reference QwenImageEdit calculate_dimensions)."""
    width = round((target_area * ratio) ** 0.5)
    height = round(width / ratio)
    width = max(multiple, round(width / multiple) * multiple)
    height = max(multiple, round(height / multiple) * multiple)
    return width, height


class QwenImageEditPipeline(EditPipelineBase):
    backend = "qwen-image-edit"
    uses_batch_cfg = True
    default_negative_prompt = " "
    flow_shift = QWEN_IMAGE_SHIFT

    def __init__(self, model, re_params=None, gamma=None,
                 true_cfg_scale: float = 4.0):
        super().__init__(model, re_params, gamma,
                         true_cfg_scale=true_cfg_scale)

    def combine_cfg(self, v_pos, v_neg, sigma):
        comb = v_neg + self.true_cfg_scale * (v_pos - v_neg)
        cond_norm = torch.linalg.vector_norm(v_pos, dim=-1, keepdim=True)
        noise_norm = torch.linalg.vector_norm(comb, dim=-1, keepdim=True)
        return comb * (cond_norm / torch.clamp(noise_norm, min=1e-12))

    def target_resolution(self, width: int, height: int) -> tuple[int, int]:
        return calculate_dimensions(VAE_IMAGE_AREA, width / height, 32)

    def rope_position_ids(self, grid_h: int, grid_w: int, t_txt: int,
                          cond_grids=None):
        cond_grids = cond_grids or [(grid_h, grid_w)]
        grids = [(grid_h, grid_w)] + list(cond_grids)

        def centered(n):
            return np.arange(n, dtype=np.float32) - (n - n // 2)

        parts = []
        for idx, (h, w) in enumerate(grids):
            ys, xs = np.meshgrid(centered(h), centered(w), indexing="ij")
            ids = np.stack([np.full_like(ys, float(idx)), ys, xs], -1)
            parts.append(ids.reshape(-1, 3))
        kv_ids = np.concatenate(parts, 0).astype(np.float32)
        max_vid = max(max(h // 2, w // 2) for h, w in grids)
        tpos = (np.arange(t_txt, dtype=np.float32) + max_vid)[:, None]
        return kv_ids, np.repeat(tpos, 3, axis=1).astype(np.float32)


class QwenImageEditPlusPipeline(QwenImageEditPipeline):
    """Qwen-Image-Edit-2509: multi-reference conditioning.  The references
    are the condition latent's rows, one token grid each
    (`build_rope(..., cond_grids=[...])`, frame tags 1..N), so S_cond may
    exceed S_noise.  The two areas are attributes so that tests can shrink
    them."""

    backend = "qwen-image-edit-plus"
    condition_image_area: int = CONDITION_IMAGE_AREA
    vae_image_area: int = VAE_IMAGE_AREA

    def encoder_images(self, images, width, height):
        """Every reference at ~384^2 area, multiples of 32."""
        out = []
        for img in images:
            arr = self._to_uint8(img)
            cw, ch = calculate_dimensions(
                self.condition_image_area, arr.shape[1] / arr.shape[0], 32)
            out.append(self._resize_uint8(arr, cw, ch))
        return out

    def ref_vae_size(self, ref_w: int, ref_h: int, width: int, height: int
                     ) -> tuple[int, int]:
        """An extra reference's own ~1024^2 area (not the target's),
        multiples of 32, kept on the token factor's grid."""
        f = self.token_factor
        w, h = calculate_dimensions(self.vae_image_area, ref_w / ref_h, 32)
        return max(f, (w // f) * f), max(f, (h // f) * f)
