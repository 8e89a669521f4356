"""LPIPS(AlexNet) in PyTorch on an explicit device: the port of
`regione_tpu/eval/lpips_jax.py`.

The reference computes LPIPS with the `lpips` package
(`evaluation/metric_all_task.py:4,47,100`: `lpips.LPIPS(net='alex')` on
[-1,1]-scaled NCHW tensors).  This module computes the same function
without that package or torchvision:

  * the torchvision-AlexNet `features` trunk (5 conv stages, taps after
    each ReLU, a 3x3/2 max-pool after stages 0 and 1),
  * the LPIPS input scaling layer (fixed shift/scale constants),
  * per-tap channel-unit-normalisation (eps 1e-10), squared difference, the
    learned 1x1 "lin" weights (no bias), spatial averaging, and the sum over
    taps.

The JAX package computes these with `lax.conv_general_dilated` and
`reduce_window`, outside any Pallas kernel; here they are `F.conv2d`,
`F.relu` and `F.max_pool2d` (cuDNN on the card).  The weights are the
`.npz` that `save_lpips_npz` writes (keys `conv{i}_w`, `conv{i}_b`,
`lin{i}`), the same file the JAX package reads and writes; point
`$REGIONE_LPIPS_WEIGHTS` at it and `eval.metrics.lpips_distance` uses it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from regione_tpu_torch.eval import resolve_device

# torchvision AlexNet `features` conv stages: (out_ch, kernel, stride, pad)
_ALEX_STAGES = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)  # max-pool follows these stage indices

# lpips.ScalingLayer constants (lpips/lpips.py): x -> (x - shift) / scale
# on [-1,1]-scaled RGB.
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision AlexNet `features` module indices of the five convs
_TV_IDX = (0, 3, 6, 8, 10)


def _params_on(params: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device, torch.float32)
            for k, v in params.items()}


@torch.no_grad()
def lpips_forward(params: dict, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """LPIPS(alex) between batched NCHW fp32 images already scaled to
    [-1, 1], on their device.  `params` from `lpips_params_from_torch` /
    `load_lpips_npz` (numpy arrays are moved to the images' device).
    Returns shape [N] distances."""
    dev = a.device
    if any(not torch.is_tensor(v) or v.device != dev
           for v in params.values()):
        params = _params_on(params, dev)
    shift = torch.as_tensor(_SHIFT, device=dev).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=dev).view(1, 3, 1, 1)
    xs = [(a.float() - shift) / scale, (b.float() - shift) / scale]
    total = None
    for i, (_, _, stride, pad) in enumerate(_ALEX_STAGES):
        w, bias = params[f"conv{i}_w"], params[f"conv{i}_b"]
        feats = []
        for j in range(2):
            xs[j] = F.relu(F.conv2d(xs[j], w, bias, stride=stride,
                                    padding=pad))
            # unit-normalise over channels (lpips.normalize_tensor, eps=1e-10)
            norm = torch.sqrt(torch.sum(xs[j] ** 2, dim=1, keepdim=True))
            feats.append(xs[j] / (norm + 1e-10))
        d = (feats[0] - feats[1]) ** 2
        # learned 1x1 conv, no bias (lin{i}.model.1.weight), spatial mean
        val = torch.mean(torch.sum(d * params[f"lin{i}"].view(1, -1, 1, 1),
                                   dim=1), dim=(1, 2))
        total = val if total is None else total + val
        if i in _POOL_AFTER:
            # torch MaxPool2d(3, 2): no padding, floor output size
            xs = [F.max_pool2d(x, 3, 2) for x in xs]
    return total


def lpips_pair_uint8(params: dict, a: np.ndarray, b: np.ndarray) -> float:
    """Distance between two HWC uint8 images (the reference's usage:
    `metric_all_task.py:95-100` scales with lpips.im2tensor semantics,
    pixel/127.5 - 1), where `params` lie (numpy params: on the card)."""
    first = next(iter(params.values()))
    dev = first.device if torch.is_tensor(first) else resolve_device("cuda")

    def tensor(img):
        x = torch.from_numpy(np.asarray(img, np.float32) / 127.5 - 1.0)
        return x.permute(2, 0, 1)[None].to(dev)

    return float(lpips_forward(params, tensor(a), tensor(b))[0])


# ---------------------------------------------------------------- weights

def lpips_params_from_torch(alexnet_sd: dict, lins_sd: dict) -> dict:
    """The params dict (numpy fp32) from two torch state dicts:

      * `alexnet_sd`: the torchvision AlexNet checkpoint
        (`features.{0,3,6,8,10}.{weight,bias}`, full-model dicts with
        `classifier.*` keys are fine — extras ignored);
      * `lins_sd`: the lpips package's trained linear weights
        (`lin{i}.model.1.weight`, [1, C, 1, 1]).
    """
    def arr(t):
        return np.asarray(t.detach().cpu().to(torch.float32).numpy())

    params = {}
    for i, tv in enumerate(_TV_IDX):
        w = arr(alexnet_sd[f"features.{tv}.weight"])
        b = arr(alexnet_sd[f"features.{tv}.bias"])
        oc, k, s, p = _ALEX_STAGES[i]
        if w.shape != (oc, w.shape[1], k, k):
            raise ValueError(f"conv{i}: unexpected shape {w.shape}")
        params[f"conv{i}_w"] = w
        params[f"conv{i}_b"] = b
        lw = arr(lins_sd[f"lin{i}.model.1.weight"])
        if lw.shape != (1, oc, 1, 1):
            raise ValueError(f"lin{i}: expected (1,{oc},1,1), got {lw.shape}")
        params[f"lin{i}"] = lw[0, :, 0, 0]
    return params


def save_lpips_npz(alexnet_path: str, lins_path: str, out_path: str) -> None:
    """One-time offline conversion: torchvision alexnet .pth + lpips
    alex .pth -> a single .npz consumed at eval time."""
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lins = torch.load(lins_path, map_location="cpu", weights_only=True)
    np.savez(out_path, **lpips_params_from_torch(alex, lins))


def load_lpips_npz(path: str, device="cuda") -> dict:
    """The `.npz` weights as fp32 tensors on `device` (default the card)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(dev, torch.float32)
                for k in z.files}
