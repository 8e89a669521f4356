"""FLUX.1 Kontext pipeline adapter.

Counterpart of `regione_tpu/pipelines/flux_kontext.py`:
  * guidance-distilled: the guidance scale (2.5 by default) enters through
    the backbone's guidance embedding, one forward per step;
  * true CFG only when `true_cfg_scale > 1`, then as a batch of two;
  * the prompt encoders (T5 / CLIP) never see the image;
  * the input resolution snaps to the preferred Kontext list (max area
    1024^2): a square image is edited at 1024 x 1024, a 64 x 64 token grid.
"""

from __future__ import annotations

from regione_tpu_torch.pipelines.base import EditPipelineBase

# the reference's preferred (height, width) list
PREFERRED_KONTEXT_RESOLUTIONS = [
    (672, 1568), (688, 1504), (720, 1456), (752, 1392), (800, 1328),
    (832, 1248), (880, 1184), (944, 1104), (1024, 1024), (1104, 944),
    (1184, 880), (1248, 832), (1328, 800), (1392, 752), (1456, 720),
    (1504, 688), (1568, 672),
]


def snap_kontext_resolution(width: int, height: int) -> tuple[int, int]:
    """The preferred (w, h) whose aspect ratio is closest to the input's."""
    aspect = width / height
    _, w, h = min((abs(aspect - pw / ph), pw, ph)
                  for ph, pw in PREFERRED_KONTEXT_RESOLUTIONS)
    return w, h


class FluxKontextPipeline(EditPipelineBase):
    backend = "flux-kontext"
    uses_batch_cfg = False

    def __init__(self, model, re_params=None, gamma=None,
                 guidance_scale: float = 2.5, true_cfg_scale: float = 1.0):
        super().__init__(model, re_params, gamma,
                         true_cfg_scale=true_cfg_scale)
        self.guidance_scale = guidance_scale
        if true_cfg_scale > 1.0:
            self.uses_batch_cfg = True

    def target_resolution(self, width: int, height: int) -> tuple[int, int]:
        return snap_kontext_resolution(width, height)

    def encoder_images(self, images, width, height):
        """FLUX prompts are text-only."""
        return None
