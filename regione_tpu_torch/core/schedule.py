"""Flow-match sigma schedule and the static RegionE stage plan.

The port's own copy of `regione_tpu/core/schedule.py` (numpy only), held
equal to it by tests/test_torch_core_config.py.  The port's sampler runs
the plan eagerly; the text below is the JAX module's.

The central TPU-native design decision of this framework lives here: in the
reference, stage control (dense vs region steps, KV cache write phases,
refresh bookkeeping, and the adaptive-velocity-decay cache decision) is
Python-side mutable state interleaved with device work every step
(reference RegionE/Step1XEdit/inplace.py:332-366, utils.py:384-415,
inplace.py:635-644).  All of those decisions are functions of *host-known*
quantities only: the step index, the timestep schedule, the fitted gamma
table, and the config.  We therefore precompute the entire 28-step plan on
the host as a list of immutable `StepPlan` records; the jitted sampler is
traced against this static plan, so XLA sees straight-line fixed-shape code
(with `lax.scan` over the uniform step runs) and zero host<->device syncs
inside a segment.

Sigma math mirrors diffusers' FlowMatchEulerDiscreteScheduler with dynamic
("exponential") shifting, as every backend's scheduler config sets it:
  - base sigmas  : linspace(1, 1/steps, steps)
  - time shift   : sigma' = e^mu / (e^mu + (1/sigma - 1))
  - mu           : calculate_shift(image_seq_len)  (reference utils.py:18-28),
                   over the backend's own (base, max) sequence lengths and
                   shifts: FLUX.1 / Step1X 256 -> 4096 tokens, 0.5 -> 1.15;
                   Qwen-Image 256 -> 8192, 0.5 -> 0.9 (`FlowShift`)
  - terminal     : Qwen-Image stretches the shifted sigmas so that the last
                   one is its `shift_terminal` (0.02); FLUX.1 does not
  - timesteps    : sigma * num_train_timesteps (=1000); terminal sigma 0.
The JAX package computes FLUX.1's schedule for every backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from regione_tpu_torch.core.config import RegionEParams


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """Linear interpolation of the flow-match shift exponent mu in the image
    sequence length (reference RegionE/Step1XEdit/utils.py:18-28)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def build_sigmas(
    num_steps: int,
    mu: float | None = None,
    shift: float = 1.0,
    use_dynamic_shifting: bool = True,
    shift_terminal: float | None = None,
) -> np.ndarray:
    """Return sigmas of length num_steps + 1 (terminal 0 appended), fp32.

    With use_dynamic_shifting (the Flux-family default) applies the
    exponential time shift with exponent mu; otherwise the static shift
    sigma' = shift*sigma / (1 + (shift-1)*sigma).  With shift_terminal,
    diffusers' `stretch_shift_to_terminal` follows: 1 - sigma scaled so
    that the last sigma before the terminal 0 is shift_terminal.
    """
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if use_dynamic_shifting:
        if mu is None:
            raise ValueError("dynamic shifting requires mu (see calculate_shift)")
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    if shift_terminal is not None:
        one_minus = 1.0 - sigmas
        scale = one_minus[-1] / (1.0 - shift_terminal)
        sigmas = 1.0 - one_minus / scale
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FlowShift:
    """A backend's dynamic shift, as its `scheduler_config.json` gives it
    (diffusers' FlowMatchEulerDiscreteScheduler with
    `use_dynamic_shifting` and the exponential time shift): mu from the
    noise token count, interpolated between (base_image_seq_len,
    base_shift) and (max_image_seq_len, max_shift); the sigmas stretched
    to `shift_terminal` where it is set."""

    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.15
    shift_terminal: float | None = None

    def sigmas(self, num_steps: int, image_seq_len: int) -> np.ndarray:
        mu = calculate_shift(image_seq_len, self.base_image_seq_len,
                             self.max_image_seq_len, self.base_shift,
                             self.max_shift)
        return build_sigmas(num_steps, mu=mu,
                            shift_terminal=self.shift_terminal)


# FLUX.1 (Kontext dev) and Step1X-Edit
FLUX_SHIFT = FlowShift()
# Qwen-Image / Qwen-Image-Edit (huggingface.co/Qwen/Qwen-Image-Edit,
# scheduler/scheduler_config.json)
QWEN_IMAGE_SHIFT = FlowShift(base_image_seq_len=256, max_image_seq_len=8192,
                             base_shift=0.5, max_shift=0.9,
                             shift_terminal=0.02)


# ---------------------------------------------------------------------------
# Stage plan
# ---------------------------------------------------------------------------

# kv_phase values (mirror the attention-processor phase switch,
# reference RegionE/Step1XEdit/inplace.py:723-757)
KV_NORMAL = "normal"          # dense, no cache interaction
KV_CACHE_WRITE = "cache_write"  # dense, store K/V cache
KV_RAGS = "rags"              # gathered query, in-place KV row update

# scheduler roles (reference inplace.py:635-685)
SCHED_EULER = "euler"
SCHED_PARTITION = "partition"   # warmup-1: token_selector + split step
SCHED_REFRESH = "refresh"       # dense refresh: split step with next jump

# layout transition applied AFTER the step (reference utils.py:384-415)
AFTER_NONE = "none"
AFTER_SHRINK = "shrink"   # gather latents to edited-only
AFTER_MERGE = "merge"     # scatter edited latents back into the full grid


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Everything the sampler needs to know about denoise step ``i``,
    fully determined on the host before tracing."""

    index: int
    sigma: float          # sigma_i
    sigma_next: float     # sigma_{i+1}
    timestep: float       # sigma_i * 1000
    dense: bool           # full-sequence step (condition latents concatenated,
                          # reference inplace.py:377-378)
    kv_phase: str         # KV_NORMAL / KV_CACHE_WRITE / KV_RAGS
    sched_role: str       # SCHED_EULER / SCHED_PARTITION / SCHED_REFRESH
    dt: float             # sigma_next - sigma (normal Euler increment)
    dt_jump: float | None  # unedited long jump: sigma_target - sigma
    dt_final: float | None  # partition x0 estimate: sigma_last - sigma
    reuse: bool           # AVD: reuse decayed cached velocity, skip forward
    ratio: float          # AVD decay ratio for this step (1.0 when recomputing)
    after: str            # AFTER_NONE / AFTER_SHRINK / AFTER_MERGE

    @property
    def is_rags(self) -> bool:
        return self.kv_phase == KV_RAGS


def build_stage_plan(
    params: RegionEParams,
    sigmas: np.ndarray,
    gamma: Sequence[float],
) -> list[StepPlan]:
    """Precompute the full per-step plan.

    Faithfully replays the reference's interleaved mutable-state control
    flow (loop-top AVD decision inplace.py:342-360; scheduler refresh
    bookkeeping inplace.py:635-644; Manager.step layout transitions
    utils.py:384-415) as a single host-side pass, so the device code never
    branches on any of it.
    """
    params.validate()
    steps = params.num_inference_steps
    warmup = params.warmup_step
    post = params.post_step
    assert len(sigmas) == steps + 1
    if params.allow_custom_steps and len(gamma) < steps - 1:
        # custom-step runs beyond the fitted 28 (dense baselines, or a
        # user-supplied partial table): transitions without fitted data
        # pad to +inf, which the AVD branch's ratio >= 1 test maps to
        # "recompute, reset accumulate" — never reuse, so padded steps
        # can only be conservative (inplace.py:346-349)
        gamma = list(gamma) + [float("inf")] * (steps - 1 - len(gamma))
    assert len(gamma) >= steps - 1, "gamma table too short for step count"
    timesteps = np.asarray(sigmas[:steps], dtype=np.float64) * 1000.0

    # refresh targets with sentinel, converted to 0-based step indices
    refresh_rt = [r - 1 for r in params.refresh_with_sentinel]

    plan: list[StepPlan] = []
    prev_refresh: int | None = None
    next_refresh: int | None = None
    accumulate = 1.0

    for i in range(steps):
        is_partition = i == warmup - 1
        is_refresh = (
            prev_refresh is not None and i == prev_refresh
        )
        dense = (
            i <= warmup - 1
            or i > steps - post - 1
            or is_refresh
        )

        # --- KV phase (reference inplace.py:723-757) ---
        if i < warmup - 1 or i > steps - post - 1:
            kv_phase = KV_NORMAL
        elif is_partition or is_refresh:
            kv_phase = KV_CACHE_WRITE
        else:
            kv_phase = KV_RAGS

        # --- AVD cache decision (reference inplace.py:342-360) ---
        # NOTE: this is evaluated with prev_refresh as of the *top* of the
        # loop iteration, before the scheduler updates it.
        forced = (
            i <= warmup
            or i > steps - post - 1
            or (prev_refresh is not None and i == prev_refresh)
        )
        reuse = False
        ratio = 1.0
        if not forced:
            r = float(gamma[i - 1]) * (1.0 + (timesteps[i] - timesteps[i - 1]) / 1000.0)
            if r >= 1.0:
                accumulate = 1.0
            else:
                acc2 = accumulate * r
                if (1.0 - acc2) > params.cache_threshold:
                    accumulate = 1.0
                else:
                    reuse = True
                    ratio = r
                    accumulate = acc2
        else:
            accumulate = 1.0

        # --- scheduler role + jump targets (reference inplace.py:635-682) ---
        sched_role = SCHED_EULER
        dt_jump = None
        dt_final = None
        if is_partition:
            sched_role = SCHED_PARTITION
            prev_refresh = refresh_rt.pop(0)
            dt_jump = float(sigmas[prev_refresh] - sigmas[i])
            dt_final = float(sigmas[-1] - sigmas[i])
        elif is_refresh and len(refresh_rt) != 0:
            sched_role = SCHED_REFRESH
            next_refresh = refresh_rt.pop(0)
            dt_jump = float(sigmas[next_refresh] - sigmas[i])

        # --- layout transition after this step (reference utils.py:384-415,
        # where current_step has already been incremented to i+1) ---
        after = AFTER_NONE
        nxt = i + 1
        if nxt == warmup:
            after = AFTER_SHRINK
        elif nxt == steps - post:
            after = AFTER_MERGE
            prev_refresh = None
        elif prev_refresh is not None and nxt == prev_refresh:
            after = AFTER_MERGE
        elif prev_refresh is not None and nxt == prev_refresh + 1:
            after = AFTER_SHRINK
            prev_refresh = next_refresh

        plan.append(
            StepPlan(
                index=i,
                sigma=float(sigmas[i]),
                sigma_next=float(sigmas[i + 1]),
                timestep=float(timesteps[i]),
                dense=dense,
                kv_phase=kv_phase,
                sched_role=sched_role,
                dt=float(sigmas[i + 1] - sigmas[i]),
                dt_jump=dt_jump,
                dt_final=dt_final,
                reuse=reuse,
                ratio=float(ratio),
                after=after,
            )
        )

    return plan


def plan_segments(plan: list[StepPlan]) -> list[tuple[str, list[StepPlan]]]:
    """Group the plan into maximal uniform-shape runs for lax.scan:
    returns [(kind, steps)] with kind in {"dense", "rags"}.  Dense runs are
    full-sequence steps; rags runs are gathered edited-capacity steps.
    The layout transition of a step's `after` field ends its run."""
    segments: list[tuple[str, list[StepPlan]]] = []
    cur_kind: str | None = None
    cur: list[StepPlan] = []
    for sp in plan:
        kind = "dense" if sp.dense else "rags"
        if kind != cur_kind and cur:
            segments.append((cur_kind, cur))
            cur = []
        cur_kind = kind
        cur.append(sp)
        if sp.after != AFTER_NONE:
            segments.append((cur_kind, cur))
            cur, cur_kind = [], None
    if cur:
        segments.append((cur_kind, cur))
    return segments


def describe_plan(plan: list[StepPlan]) -> str:
    """Human-readable one-line-per-step dump for debugging/tests."""
    rows = []
    for sp in plan:
        rows.append(
            f"{sp.index:2d} sig={sp.sigma:.4f} {'DENSE' if sp.dense else 'rags '}"
            f" kv={sp.kv_phase:11s} sched={sp.sched_role:9s}"
            f" {'REUSE x%.4f' % sp.ratio if sp.reuse else 'compute     '}"
            f" after={sp.after}"
        )
    return "\n".join(rows)
