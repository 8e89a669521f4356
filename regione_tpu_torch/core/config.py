"""RegionE hyperparameter configuration and validation.

The port's own copy of `regione_tpu/core/config.py` (numpy-free, no JAX):
the same names, defaults and rules, held equal to the JAX module by
tests/test_torch_core_config.py.

Mirrors the knobs and validation rules of the reference implementation:
  - per-backend defaults table      -> reference RegionE/tool/RegionE.py:1-7
  - Manager.set_parameters asserts  -> reference RegionE/Step1XEdit/utils.py:370-382
  - sentinel refresh step append    -> reference RegionE/Step1XEdit/utils.py:382

The reference hard-pins ``num_inference_steps == 28`` because the per-model
adaptive-velocity-decay gamma tables were fitted offline at 28 steps
(reference RegionE/tool/RegionE.py:44). We keep the same rule but allow it to
be relaxed when a custom gamma table of matching length is supplied.
"""

from __future__ import annotations

import dataclasses


def _parse_refresh(refresh) -> tuple[int, ...]:
    """Accept the reference's comma-string form ("16") or any int sequence."""
    if isinstance(refresh, str):
        items = [int(x) for x in refresh.split(",") if x.strip() != ""]
    elif isinstance(refresh, int):
        items = [refresh]
    else:
        items = [int(x) for x in refresh]
    return tuple(sorted(items))


@dataclasses.dataclass(frozen=True)
class RegionEParams:
    """The six RegionE knobs plus bookkeeping, identical in name and meaning
    to the reference CLI flags (reference src/Step1X-Edit/main.py:14-33).

    Attributes:
      num_inference_steps: total denoise steps (gamma tables fitted at 28).
      warmup_step: number of dense stabilization (STS) steps; partition
        happens during step ``warmup_step - 1``.
      post_step: number of final dense smooth (SMS) steps.
      refresh_step: 1-based dense-refresh targets, strictly inside
        ``(warmup_step + 1, steps - post_step - 1]`` and non-adjacent.
      threshold: similarity threshold; tokens with similarity <= threshold
        are *edited* (reference RegionE/Step1XEdit/utils.py:313).
      cache_threshold: max accumulated AVD velocity-decay error before a
        forced recompute (reference RegionE/Step1XEdit/inplace.py:355).
      erosion_dilation: apply 3x3-cross erosion + 5x5-square dilation to the
        edited mask on the token grid (reference utils.py:195-217).
      similarity_type: one of cosine/dot/euclidean/mse/diff_std
        (reference utils.py:288-310).
      rags_capacity: static edited-token capacity for the gathered RAGS
        phase. ``None`` -> chosen at runtime (rounded up to a bucket);
        an int pins it; 0 disables gathering (full-mask formulation).
        TPU-specific: XLA requires static shapes, so the data-dependent
        edited-token count is rounded up to a capacity bucket.
      capacity_granularity: bucket rounding multiple for rags_capacity
        (MXU-friendly multiples of 128/256).
    """

    num_inference_steps: int = 28
    warmup_step: int = 6
    post_step: int = 2
    refresh_step: tuple[int, ...] = (16,)
    threshold: float = 0.88
    cache_threshold: float = 0.02
    erosion_dilation: bool = True
    similarity_type: str = "cosine"
    rags_capacity: int | None = None
    capacity_granularity: int = 128
    allow_custom_steps: bool = False

    def __post_init__(self):
        object.__setattr__(self, "refresh_step", _parse_refresh(self.refresh_step))

    # -- validation (same rules as reference utils.py:370-382) ---------------

    def validate(self) -> "RegionEParams":
        steps = self.num_inference_steps
        if not self.allow_custom_steps:
            assert steps == 28, (
                "Changing the inference step requires fitting a new gamma "
                "(set allow_custom_steps=True and supply a gamma table)."
            )
        assert self.warmup_step >= 1, "warmup_step must be >= 1"
        assert self.post_step >= 0
        r = self.refresh_step
        assert len(r) > 0, "at least one refresh step required"
        assert min(r) > self.warmup_step + 1 and max(r) <= steps - self.post_step - 1, (
            f"refresh steps {r} must lie in ({self.warmup_step + 1}, "
            f"{steps - self.post_step - 1}]"
        )
        assert not any(
            abs(r[i] - r[i + 1]) == 1 for i in range(len(r) - 1)
        ), "Refresh steps must not be adjacent."
        if self.similarity_type not in ("cosine", "dot", "euclidean", "mse", "diff_std"):
            raise ValueError(f"unknown similarity_type {self.similarity_type!r}")
        return self

    @property
    def refresh_with_sentinel(self) -> tuple[int, ...]:
        """Refresh list with the sentinel target appended: the first SMS step
        (1-based), i.e. ``steps - post_step + 1``.  The sentinel is never a
        dense refresh itself; it only provides the final long-jump sigma
        target for unedited tokens (reference utils.py:382)."""
        return self.refresh_step + (self.num_inference_steps - self.post_step + 1,)

    def replace(self, **kw) -> "RegionEParams":
        return dataclasses.replace(self, **kw)


# Per-backend defaults, mirroring reference RegionE/tool/RegionE.py:1-7.
# Keyed by backend name used throughout this package.
DEFAULT_PARAMS: dict[str, RegionEParams] = {
    "flux-kontext": RegionEParams(threshold=0.93, cache_threshold=0.04),
    "step1x-edit": RegionEParams(threshold=0.88, cache_threshold=0.02),
    "step1x-edit-v1p2": RegionEParams(threshold=0.88, cache_threshold=0.02),
    "qwen-image-edit": RegionEParams(threshold=0.80, cache_threshold=0.03),
    "qwen-image-edit-plus": RegionEParams(threshold=0.80, cache_threshold=0.03),
}


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def pick_capacity(n_edited: int, seq_len: int, granularity: int = 128) -> int:
    """Choose the static RAGS capacity bucket for a data-dependent edited
    count.  Rounded up to `granularity` (the MXU/VPU tile is 128; a coarser
    multiple only wastes RAGS rows as padding — at a 48x48 grid a 576-token
    quarter region would round to 768 under granularity 256, inflating
    every RAGS step by 33%) and clamped to seq_len.  Buckets keep
    recompilation bounded; compiled samplers are cached per bucket."""
    cap = max(granularity, round_up(max(int(n_edited), 1), granularity))
    return min(cap, seq_len)
