"""Fitted per-backend adaptive-velocity-decay (AVD) gamma tables.

The port's own copy of `regione_tpu/core/gamma.py`, held equal to it by
tests/test_torch_core_config.py, with one table more for the port's own
backend, FLUX.2 [dev].

These are offline-fitted constants (27 values = one per timestep transition
at 28 inference steps) taken from the reference implementation; they are not
derivable and must be preserved exactly to reproduce the cache/recompute
schedule (reference RegionE/<Model>/inplace.py:47-50 for each backend).
Stored as float16-rounded values exactly as the reference declares them.
"""

from __future__ import annotations

import numpy as np

GAMMA_TABLES: dict[str, np.ndarray] = {
    # reference RegionE/Step1XEdit/inplace.py:47-49
    "step1x-edit": np.array(
        [0.9746, 0.9593, 1.0036, 1.0084, 1.0106, 1.0114, 1.0138, 1.0163,
         1.0152, 1.0163, 1.0197, 1.0186, 1.0219, 1.0218, 1.0223, 1.0266,
         1.0272, 1.0305, 1.0311, 1.0362, 1.0385, 1.0423, 1.0500, 1.0536,
         1.0671, 1.0866, 1.1015], dtype=np.float16),
    # reference RegionE/Step1XEditV1P2/inplace.py:48-50
    "step1x-edit-v1p2": np.array(
        [0.7936, 0.9807, 1.0063, 1.0205, 0.9946, 1.0125, 1.0116, 1.0125,
         1.0172, 1.0171, 1.0183, 1.0170, 1.0170, 1.0236, 1.0263, 1.0264,
         1.0277, 1.0321, 1.0338, 1.0361, 1.0396, 1.0454, 1.0492, 1.0566,
         1.0696, 1.0879, 1.1179], dtype=np.float16),
    # reference RegionE/FluxKontext/inplace.py:47-50
    "flux-kontext": np.array(
        [0.8352, 0.9986, 1.0090, 1.0097, 1.0161, 1.0152, 1.0160, 1.0173,
         1.0177, 1.0199, 1.0213, 1.0203, 1.0257, 1.0236, 1.0235, 1.0278,
         1.0302, 1.0311, 1.0352, 1.0371, 1.0391, 1.0459, 1.0498, 1.0581,
         1.0693, 1.0866, 1.1090], dtype=np.float16),
    # reference RegionE/QwenImageEdit/inplace.py:47-50
    "qwen-image-edit": np.array(
        [1.0195, 1.0233, 1.0243, 1.0185, 1.0321, 1.0208, 1.0260, 1.0233,
         1.0258, 1.0292, 1.0316, 1.0306, 1.0289, 1.0347, 1.0329, 1.0402,
         1.0378, 1.0384, 1.0413, 1.0444, 1.0526, 1.0400, 1.0555, 1.0439,
         1.0357, 1.0118, 0.7603], dtype=np.float16),
    # reference RegionE/QwenImageEditPlus/inplace.py:47-50
    "qwen-image-edit-plus": np.array(
        [1.0186, 1.0241, 1.0236, 1.0205, 1.0298, 1.0221, 1.0248, 1.0246,
         1.0269, 1.0275, 1.0323, 1.0311, 1.0298, 1.0353, 1.0343, 1.0397,
         1.0387, 1.0393, 1.0404, 1.0458, 1.0507, 1.0418, 1.0518, 1.0426,
         1.0311, 1.0068, 0.7628], dtype=np.float16),
}


# the port's own: RegionE fits no table for FLUX.2 [dev], so FLUX.1
# Kontext's (assumed: the same flow-match family, 28 steps)
GAMMA_TABLES["flux2-dev"] = GAMMA_TABLES["flux-kontext"]


def gamma_for(backend: str) -> np.ndarray:
    try:
        return GAMMA_TABLES[backend]
    except KeyError:
        raise KeyError(
            f"no fitted gamma table for backend {backend!r}; "
            f"known: {sorted(GAMMA_TABLES)}"
        ) from None
