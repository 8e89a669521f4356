"""Step1X-Edit v1.1 and v1.2 pipeline adapters.

Counterpart of `regione_tpu/pipelines/step1x_edit.py`: true CFG as a batch
of two, and the norm-processed guidance.  The reference compares its
timestep in sigma*1000 units against `timesteps_truncate` = 0.93, so the
norm-processed branch fires at effectively every step; this is matched, not
fixed.  process_diff_norm is where(n > 1, n ** k, 1) with k = 0.4.
"""

from __future__ import annotations

import numpy as np
import torch

from regione_tpu_torch.pipelines.base import EditPipelineBase


def process_diff_norm(diff_norm, k: float):
    return torch.where(diff_norm > 1.0, diff_norm.pow(k),
                       torch.ones_like(diff_norm))


class Step1XEditPipeline(EditPipelineBase):
    backend = "step1x-edit"
    uses_batch_cfg = True

    def __init__(self, model, re_params=None, gamma=None,
                 true_cfg_scale: float = 6.0,
                 timesteps_truncate: float = 0.93,
                 process_norm_power: float = 0.4):
        super().__init__(model, re_params, gamma,
                         true_cfg_scale=true_cfg_scale)
        self.timesteps_truncate = timesteps_truncate
        self.process_norm_power = process_norm_power

    def combine_cfg(self, v_pos, v_neg, sigma: float):
        diff = v_pos - v_neg
        scaled = self.true_cfg_scale * diff
        # reference-unit timestep = sigma * 1000, compared in fp32
        if np.float32(sigma) * np.float32(1000.0) <= self.timesteps_truncate:
            return v_neg + scaled
        diff_norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
        return v_neg + scaled / process_diff_norm(diff_norm,
                                                  self.process_norm_power)


class Step1XEditV1P2Pipeline(Step1XEditPipeline):
    """Step1X-Edit v1.2: v1.1's transformer and CFG with its own fitted
    gamma table (the backend name selects it).  Its thinker / reflection
    loop runs around the call: `pipelines.thinker.edit_with_reflection`."""
    backend = "step1x-edit-v1p2"
