"""Port of regione_tpu.pipelines."""

from regione_tpu_torch.pipelines.flux2 import Flux2Pipeline
from regione_tpu_torch.pipelines.flux_kontext import FluxKontextPipeline
from regione_tpu_torch.pipelines.qwen_image_edit import (
    QwenImageEditPipeline, QwenImageEditPlusPipeline)
from regione_tpu_torch.pipelines.step1x_edit import (Step1XEditPipeline,
                                                     Step1XEditV1P2Pipeline)

# backend -> pipeline class.  The class selects the gamma table that drives
# the stage plan, so a fallback would run another backend's plan.
PIPELINES = {"step1x-edit": Step1XEditPipeline,
             "step1x-edit-v1p2": Step1XEditV1P2Pipeline,
             "flux-kontext": FluxKontextPipeline,
             "qwen-image-edit": QwenImageEditPipeline,
             "qwen-image-edit-plus": QwenImageEditPlusPipeline,
             "flux2-dev": Flux2Pipeline}
