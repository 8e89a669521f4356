"""Public plugin facade: `RegionEHelper` — same surface as the reference
(RegionE/tool/RegionE.py:9-51): construct around a pipeline, optionally
`set_params(...)`, then `enable()` / `disable()`.

The port's own copy of `regione_tpu/api.py` over the port's
`core.config`; the port's pipelines carry `re`, `_regione_enabled` and
`_samplers` as the JAX ones do.

In the reference, `enable()` monkeypatches a diffusers pipeline (class swap,
scheduler rebuild, attention-processor install — inplace.py:52-71).  Here
the pipelines are native to this framework and carry both the dense and the
accelerated path; the helper toggles which path `edit_latents`/`__call__`
takes and manages the validated RegionE parameter set, preserving the
reference's defaults table and the hard ``num_inference_steps == 28`` pin
(RegionE/tool/RegionE.py:44 — the gamma tables are fitted at 28 steps).
"""

from __future__ import annotations

from typing import Any

from regione_tpu_torch.core.config import DEFAULT_PARAMS

# Per-backend defaults, same values as reference RegionE/tool/RegionE.py:1-7.
BACKEND_DEFAULTS: dict[str, dict[str, Any]] = {
    name: dict(
        num_inference_steps=p.num_inference_steps,
        warmup_step=p.warmup_step,
        post_step=p.post_step,
        refresh_step=",".join(str(r) for r in p.refresh_step),
        threshold=p.threshold,
        cache_threshold=p.cache_threshold,
        erosion_dilation=p.erosion_dilation,
    )
    for name, p in DEFAULT_PARAMS.items()
}

# reference class-name keys -> backend names (so code written against the
# reference's config table keeps working)
_REFERENCE_CLASS_ALIASES = {
    "FluxKontextPipeline": "flux-kontext",
    "Step1XEditPipeline": "step1x-edit",
    "Step1XEditPipelineV1P2": "step1x-edit-v1p2",
    "QwenImageEditPipeline": "qwen-image-edit",
    "QwenImageEditPlusPipeline": "qwen-image-edit-plus",
}


class RegionEHelper:
    """Enable/disable RegionE acceleration on a pipeline.

    >>> helper = RegionEHelper(pipeline)
    >>> helper.set_params(warmup_step=6, refresh_step="16", threshold=0.88,
    ...                   cache_threshold=0.02)
    >>> helper.enable()
    >>> images = pipeline(image=..., prompt=...)
    >>> helper.disable()   # back to the vanilla dense 28-step path
    """

    def __init__(self, pipeline):
        self.pipeline = pipeline
        backend = getattr(pipeline, "backend", None)
        backend = _REFERENCE_CLASS_ALIASES.get(
            type(pipeline).__name__, backend)
        if backend not in DEFAULT_PARAMS:
            raise ValueError(
                f"Unsupported pipeline {type(pipeline).__name__!r} "
                f"(backend={backend!r}); supported: {sorted(DEFAULT_PARAMS)}")
        self.backend = backend
        self.params = DEFAULT_PARAMS[backend]
        self.enabled = False

    def set_params(self, **kwargs) -> "RegionEHelper":
        """Override any of the six RegionE knobs; validates like the
        reference Manager.set_parameters (utils.py:370-382), including the
        28-step pin."""
        assert kwargs.get("num_inference_steps", 28) == 28 or kwargs.get(
            "allow_custom_steps"), (
            "num_inference_steps is fixed at 28 (fitted gamma tables); pass "
            "allow_custom_steps=True with a custom gamma to override")
        self.params = self.params.replace(**kwargs).validate()
        self._push()
        return self

    def enable(self) -> "RegionEHelper":
        self.enabled = True
        self._push()
        return self

    def disable(self) -> "RegionEHelper":
        self.enabled = False
        self._push()
        return self

    def _push(self):
        self.pipeline.re = self.params.validate()
        self.pipeline._regione_enabled = self.enabled
        # parameter changes invalidate compiled samplers (plan changes)
        if hasattr(self.pipeline, "_samplers"):
            self.pipeline._samplers.clear()
