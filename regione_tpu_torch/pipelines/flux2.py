"""FLUX.2 [dev] pipeline adapter (the port's own: the JAX package has none).

FLUX.2 [dev] (huggingface.co/black-forest-labs/FLUX.2-dev; diffusers'
Flux2Transformer2DModel and Flux2Pipeline):
  * guidance-distilled: the guidance scale (4.0 by default) enters through
    the backbone's guidance embedding, one forward per step; true CFG only
    when `true_cfg_scale > 1`, then as a batch of two;
  * rotary ids on four axes (t, h, w, l): the noise rows (0, y, x, 0), the
    i-th reference image's rows (10 + 10 i, y, x, 0), the text rows
    (0, 0, 0, l);
  * the sigmas: linspace(1, 1/N, N) under the exponential time shift with
    FLUX.2's empirical mu (`core.schedule.FLUX2_SHIFT`);
  * the backbone (preset "flux2-dev") has the SwiGLU MLP, the shared
    modulation and no biases (`models.mmdit.MMDiTConfig`).
RegionE publishes no knobs or gamma table for FLUX.2: `DEFAULT_PARAMS` and
`gamma_for` give FLUX.1 Kontext's.  The latent path (`edit_latents`) is
complete; the image path is not: FLUX.2's VAE (32 channels packed 2 x 2
into 128) and its Mistral-Small-3.1 prompt encoder are not ported, so
`prepare_inputs` and `__call__` raise.
"""

from __future__ import annotations

import numpy as np

from regione_tpu_torch.core.schedule import FLUX2_SHIFT
from regione_tpu_torch.pipelines.base import EditPipelineBase

# the t axis of the first reference image, and the step to the next
REF_T0 = 10.0
REF_T_STEP = 10.0


def flux2_ids(grid_h: int, grid_w: int, t: float) -> np.ndarray:
    """[S, 4] (t, y, x, 0) rotary ids of one token grid."""
    ys, xs = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    ids = np.stack([np.full_like(ys, t), ys, xs, np.zeros_like(ys)], -1)
    return ids.reshape(-1, 4).astype(np.float32)


class Flux2Pipeline(EditPipelineBase):
    backend = "flux2-dev"
    uses_batch_cfg = False
    flow_shift = FLUX2_SHIFT

    def __init__(self, model, re_params=None, gamma=None,
                 guidance_scale: float = 4.0, true_cfg_scale: float = 1.0):
        super().__init__(model, re_params, gamma,
                         true_cfg_scale=true_cfg_scale)
        self.guidance_scale = guidance_scale
        if true_cfg_scale > 1.0:
            self.uses_batch_cfg = True

    def rope_position_ids(self, grid_h: int, grid_w: int, t_txt: int,
                          cond_grids=None):
        """Raw [S, 4] ids of [noise ‖ references] and the [t_txt, 4] text
        ids."""
        cond_grids = cond_grids or [(grid_h, grid_w)]
        parts = [flux2_ids(grid_h, grid_w, 0.0)]
        for i, (ch, cw) in enumerate(cond_grids):
            parts.append(flux2_ids(ch, cw, REF_T0 + REF_T_STEP * i))
        txt = np.zeros((t_txt, 4), np.float32)
        txt[:, 3] = np.arange(t_txt)
        return np.concatenate(parts, 0), txt

    def prepare_inputs(self, *args, **kw):
        raise NotImplementedError(
            "flux2-dev edits latents only (edit_latents): FLUX.2's VAE (32 "
            "channels, packed 2 x 2 into 128) and its Mistral-Small-3.1 "
            "prompt encoder are not ported")

    def __call__(self, *args, **kw):
        return self.prepare_inputs(*args, **kw)
