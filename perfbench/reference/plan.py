"""The RegionE stage plan, frozen for the benchmark's plain reference.

A copy of the sigma schedule and the host-static stage plan of
`regione_tpu_torch/core/schedule.py` (itself a copy of the JAX package's
`regione_tpu/core/schedule.py`), with the capacity rule of
`regione_tpu_torch/core/config.py`.  It imports nothing of the program: the
benchmark holds the program to this plan, so the plan may not move with it.

Sigmas follow diffusers' FlowMatchEulerDiscreteScheduler with the
exponential time shift of the Flux family; the plan replays the reference
RegionE's per-step decisions (dense or RAGS, cache write, split steps with
their long jumps, AVD reuse from the fitted gamma table) as one list.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

EULER, PARTITION, REFRESH = "euler", "partition", "refresh"


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The RegionE knobs of a configuration file's "regione" group."""
    num_inference_steps: int
    warmup_step: int
    post_step: int
    refresh_step: tuple
    threshold: float
    cache_threshold: float
    erosion_dilation: bool
    similarity_type: str
    capacity_granularity: int

    @classmethod
    def of(cls, group: dict) -> "Knobs":
        g = dict(group)
        g["refresh_step"] = tuple(sorted(int(r) for r in g["refresh_step"]))
        return cls(**g)


@dataclasses.dataclass(frozen=True)
class Step:
    index: int
    sigma: float
    dense: bool
    role: str             # EULER / PARTITION / REFRESH
    dt: float
    dt_jump: float | None
    dt_final: float | None
    reuse: bool           # AVD: the cached velocity, no forward
    ratio: float


def calculate_shift(seq_len: int, base_len: int = 256, max_len: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    m = (max_shift - base_shift) / (max_len - base_len)
    return seq_len * m + base_shift - m * base_len


def sigmas(steps: int, seq_len: int) -> np.ndarray:
    """steps + 1 sigmas, the terminal 0 appended, fp32."""
    mu = calculate_shift(seq_len)
    s = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    s = math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))
    return np.concatenate([s, [0.0]]).astype(np.float32)


def pick_capacity(n_edited: int, seq_len: int, granularity: int) -> int:
    """The RAGS row bucket: the count rounded up to the granularity,
    clamped to the sequence."""
    cap = max(granularity, -(-max(int(n_edited), 1) // granularity)
              * granularity)
    return min(cap, seq_len)


def build_plan(k: Knobs, sig: np.ndarray, gamma) -> list[Step]:
    """The plan of every step; `gamma` is rounded to float16, the type in
    which the reference RegionE declares its fitted tables."""
    gamma = np.asarray(gamma, np.float16)
    steps, warmup, post = k.num_inference_steps, k.warmup_step, k.post_step
    timesteps = np.asarray(sig[:steps], np.float64) * 1000.0
    # 0-based refresh targets, the sentinel (the first smooth step) last
    targets = [r - 1 for r in k.refresh_step] + [steps - post]
    plan, prev, nxt_refresh, acc = [], None, None, 1.0
    for i in range(steps):
        is_part = i == warmup - 1
        is_refresh = prev is not None and i == prev
        dense = i <= warmup - 1 or i > steps - post - 1 or is_refresh
        forced = i <= warmup or i > steps - post - 1 or is_refresh
        reuse, ratio = False, 1.0
        if forced:
            acc = 1.0
        else:
            r = float(gamma[i - 1]) * (
                1.0 + (timesteps[i] - timesteps[i - 1]) / 1000.0)
            if r >= 1.0:
                acc = 1.0
            elif 1.0 - acc * r > k.cache_threshold:
                acc = 1.0
            else:
                reuse, ratio, acc = True, r, acc * r
        role, dt_jump, dt_final = EULER, None, None
        if is_part:
            role = PARTITION
            prev = targets.pop(0)
            dt_jump = float(sig[prev] - sig[i])
            dt_final = float(sig[-1] - sig[i])
        elif is_refresh and targets:
            role = REFRESH
            nxt_refresh = targets.pop(0)
            dt_jump = float(sig[nxt_refresh] - sig[i])
        # the layout transition after step i
        n = i + 1
        if n == steps - post:
            prev = None
        elif prev is not None and n == prev + 1 and n != warmup:
            prev = nxt_refresh
        plan.append(Step(i, float(sig[i]), dense, role,
                         float(sig[i + 1] - sig[i]), dt_jump, dt_final,
                         reuse, float(ratio)))
    return plan


def counts(plan: list[Step]) -> dict:
    """The plan's step counts, as the program's stats name them."""
    return {"dense_steps": sum(s.dense for s in plan),
            "rags_steps": sum(not s.dense for s in plan),
            "reuse_steps": sum(s.reuse for s in plan)}
