"""Port of regione_tpu.eval: the evaluation stack.

`metrics` (PSNR / SSIM on numpy, LPIPS through `lpips_torch`), `merge`
(item-weighted task aggregation), `run_metrics` (their CLI), `preprocess`
(the benchmark dumps' reshaping), `lpips_torch` (LPIPS(AlexNet) with
F.conv2d on an explicit device), `pixelprobe` (decoded-image PSNR of
RegionE latents against dense ones), `viescore` / `run_viescore` (the
VIEScore judge harness and its CLI).  The numpy-only modules are the
port's own copies of the JAX package's; nothing here imports JAX.
"""

import torch


def resolve_device(name) -> torch.device:
    """`name` as a torch device; a CUDA device with no card raises (an
    evaluation is never moved to the CPU behind the caller's back)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} needs a CUDA card and none is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev
