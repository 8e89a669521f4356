"""Each backend's flow-match schedule in the port (`core.schedule.FlowShift`,
`EditPipelineBase.flow_shift`).

  * Qwen-Image-Edit (and Plus) run their published scheduler: its sigmas
    equal, to 1e-6, a transcription of diffusers'
    FlowMatchEulerDiscreteScheduler under Qwen-Image's
    scheduler_config.json (mu over 256 -> 8192 tokens between 0.5 and
    0.9, the exponential shift, `stretch_shift_to_terminal` to 0.02);
  * FLUX.1 Kontext and Step1X-Edit (v1.1, v1.2) keep FLUX.1's schedule:
    sigmas and stage plans bit-equal to `build_sigmas(mu=calculate_shift
    (S))`, which the JAX package computes for every backend;
  * `build_sigmas(shift_terminal=None)` is the schedule without a stretch.
"""

import math

import numpy as np
import pytest
import torch

from regione_tpu_torch.core.config import DEFAULT_PARAMS
from regione_tpu_torch.core.gamma import gamma_for
from regione_tpu_torch.core.schedule import (FLUX_SHIFT, QWEN_IMAGE_SHIFT,
                                             build_sigmas, build_stage_plan,
                                             calculate_shift)
from regione_tpu_torch.models.mmdit import MMDiT
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.pipelines import PIPELINES

QWEN = ("qwen-image-edit", "qwen-image-edit-plus")
FLUX_FAMILY = ("flux-kontext", "step1x-edit", "step1x-edit-v1p2")


def diffusers_qwen_sigmas(steps: int, image_seq_len: int) -> np.ndarray:
    """diffusers' QwenImageEditPipeline.__call__ (its sigmas and mu) and
    FlowMatchEulerDiscreteScheduler.set_timesteps, with Qwen-Image's
    scheduler config, transcribed."""
    base_image_seq_len, max_image_seq_len = 256, 8192
    base_shift, max_shift, shift_terminal = 0.5, 0.9, 0.02
    sigmas = np.linspace(1.0, 1 / steps, steps)
    m = (max_shift - base_shift) / (max_image_seq_len - base_image_seq_len)
    b = base_shift - m * base_image_seq_len
    mu = image_seq_len * m + b
    sigmas = np.array(sigmas).astype(np.float32)
    sigmas = math.exp(mu) / (math.exp(mu) + (1 / sigmas - 1) ** 1.0)
    one_minus_z = 1 - sigmas
    scale_factor = one_minus_z[-1] / (1 - shift_terminal)
    sigmas = 1 - (one_minus_z / scale_factor)
    sigmas = torch.from_numpy(sigmas).to(dtype=torch.float32)
    return torch.cat([sigmas, torch.zeros(1)]).numpy()


@pytest.mark.parametrize("seq", [1024, 4096, 8192])
@pytest.mark.parametrize("backend", QWEN)
def test_qwen_sigmas_match_diffusers(backend, seq):
    got = PIPELINES[backend].flow_shift.sigmas(28, seq)
    want = diffusers_qwen_sigmas(28, seq)
    assert got.dtype == np.float32 and got.shape == (29,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[-2] == np.float32(0.02) and got[-1] == 0.0


def test_qwen_mu_at_4096_tokens():
    s = QWEN_IMAGE_SHIFT
    mu = calculate_shift(4096, s.base_image_seq_len, s.max_image_seq_len,
                         s.base_shift, s.max_shift)
    assert mu == pytest.approx(0.693548, abs=1e-6)
    assert calculate_shift(4096) == pytest.approx(1.15)


@pytest.mark.parametrize("seq", [256, 1024, 4096, 9216])
@pytest.mark.parametrize("backend", FLUX_FAMILY)
def test_flux_family_sigmas_are_unchanged(backend, seq):
    assert PIPELINES[backend].flow_shift == FLUX_SHIFT
    got = PIPELINES[backend].flow_shift.sigmas(28, seq)
    assert np.array_equal(got, build_sigmas(28, mu=calculate_shift(seq)))


def test_shift_terminal_none_is_no_stretch():
    mu = calculate_shift(4096)
    assert np.array_equal(build_sigmas(28, mu=mu, shift_terminal=None),
                          build_sigmas(28, mu=mu))
    stretched = build_sigmas(28, mu=mu, shift_terminal=0.1)
    assert stretched[0] == 1.0 and stretched[-2] == np.float32(0.1)


def _pipe(backend):
    preset = {"flux-kontext": "tiny-flux", "step1x-edit": "tiny-step1x",
              "step1x-edit-v1p2": "tiny-step1x"}.get(backend, "tiny-qwen")
    model = MMDiT(get_config(preset), "meta")
    return PIPELINES[backend](model, DEFAULT_PARAMS[backend])


@pytest.mark.parametrize("backend", FLUX_FAMILY + QWEN)
def test_each_pipeline_plans_over_its_schedule(backend):
    """The sampler's plan at a 64 x 64 grid: FLUX.1's schedule for the
    FLUX family, bit for bit; Qwen-Image's for Qwen, whose plan differs
    from the one FLUX.1's schedule would give."""
    pipe = _pipe(backend)
    plan = pipe.sampler_for(64, 64, 8, 1).plan
    re, gamma = DEFAULT_PARAMS[backend], gamma_for(backend)
    flux = build_stage_plan(re, build_sigmas(28, mu=calculate_shift(4096)),
                            gamma)
    if backend in FLUX_FAMILY:
        assert plan == flux
    else:
        assert plan == build_stage_plan(
            re, QWEN_IMAGE_SHIFT.sigmas(28, 4096), gamma)
        assert [s.sigma for s in plan] != [s.sigma for s in flux]
        assert [s.reuse for s in plan] != [s.reuse for s in flux]
