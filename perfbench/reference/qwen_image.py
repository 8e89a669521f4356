"""The plain RegionE edit of Qwen-Image-Edit, over the edit of `sampler.py`.

What Qwen-Image-Edit (huggingface.co/Qwen/Qwen-Image-Edit: the
transformer's and the scheduler's config, diffusers'
QwenImageTransformer2DModel and QwenImageEditPipeline, RegionE's
QwenImageEdit plug-in) changes in that edit, each written here from the
model's description:

  * the backbone is joint double-stream blocks only (`model.forward` with
    no single blocks), no pooled vector and no guidance embedding; the
    raw text features pass through an RMSNorm (fp32, eps 1e-6, the
    weight `txt_norm.scale`) before `txt_in`;
  * rotary ids: each image's (frame, h, w), frame 0 for the noise and 1
    for the condition, h and w centred: arange(n) - (n - n // 2); the
    text rows on the diagonal from max(h // 2, w // 2), the same id on
    all three axes;
  * true CFG as a batch of two, combined norm-preservingly: comb = neg +
    s (pos - neg), then comb ||pos|| / ||comb|| per token over channels;
  * the scheduler: mu interpolated over the configuration's `schedule`
    group (256 -> 8192 noise tokens, 0.5 -> 0.9), the exponential time
    shift, then the sigmas stretched so that the last is 0.02
    (diffusers' `stretch_shift_to_terminal`); the plan is built from
    them by `plan.build_plan`;
  * the stored K / V go through the int8 cache the configuration states:
    per row and head, scale = amax |x| / 127 + 1e-12, codes x / scale
    rounded half to even and clamped to +-127, dequantized to the model
    dtype, after each write.

Departures from the published model: the prompt's text rows are all
valid (no padding mask), as the harness gives them; the sigmas are
computed in float64 and rounded to float32 once (diffusers rounds the
base sigmas to float32 first).  Products in float32 run with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import model as M
from perfbench.reference import plan as P
from perfbench.reference import sampler

INT8_MAX = 127.0


def layout(config: dict) -> list:
    """The weights of `inputs.layout` and the text RMSNorm's scale."""
    return inputs.layout(config) + [
        ("txt_norm.scale", (config["model"]["txt_in_dim"],), inputs.NORM, 0)]


def sigmas(steps: int, seq_len: int, sched: dict) -> np.ndarray:
    """steps + 1 sigmas of the `schedule` group, the terminal 0 appended,
    fp32."""
    mu = P.calculate_shift(seq_len, sched["base_image_seq_len"],
                           sched["max_image_seq_len"], sched["base_shift"],
                           sched["max_shift"])
    s = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    s = math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))
    one_minus = 1.0 - s
    s = 1.0 - one_minus / (one_minus[-1] / (1.0 - sched["shift_terminal"]))
    return np.concatenate([s, [0.0]]).astype(np.float32)


def rotary_ids(grid: int, t_txt: int, device):
    """([2 S, 3] ids of the noise and the condition rows, [t_txt, 3] ids
    of the text rows)."""
    c = torch.arange(grid, device=device) - (grid - grid // 2)
    ys, xs = torch.meshgrid(c, c, indexing="ij")
    img = torch.cat([torch.stack([torch.full_like(ys, f), ys, xs],
                                 -1).reshape(-1, 3) for f in (0, 1)])
    txt = (torch.arange(t_txt, device=device) + grid // 2)[:, None]
    return img.float(), txt.expand(t_txt, 3).float()


def int8_round_trip(x):
    """x [..., S, D] through the int8 cache, back in x's dtype."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / INT8_MAX + 1e-12
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return (q * scale).to(x.dtype)


class Reference(sampler.Reference):
    """The plain Qwen-Image-Edit edit (see the module docstring)."""

    def __init__(self, config: dict, weights: dict, grid: int, device,
                 lower=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(config, weights, grid, device, lower)
        sig = sigmas(self.knobs.num_inference_steps, self.s,
                     config["schedule"])
        self.plan = P.build_plan(self.knobs, sig, config["gamma"])
        img, txt = rotary_ids(grid, config["text"]["t_txt"], device)
        axes, theta = self.m["axes_dims"], self.m["rope_theta"]
        self.rope_img = M.rope_tables(img, axes, theta)
        self.rope_txt = M.rope_tables(txt, axes, theta)
        self.int8 = bool(self.m.get("cache_int8"))

    def velocity(self, rows, sigma: float, req, mode="dense", store=None,
                 edited=None, keep=None):
        txt = M.rmsnorm(req["txt"], self.lin.w["txt_norm.scale"])
        v = super().velocity(rows, sigma, dict(req, txt=txt), mode, store,
                             edited, keep)
        if mode == "write" and self.int8:
            for key, kv in store.items():
                store[key] = tuple(int8_round_trip(x) for x in kv)
        return v

    def combine(self, pos, neg, sigma: float):
        comb = neg + self.cfg_scale * (pos - neg)
        pos_norm = torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
        comb_norm = torch.linalg.vector_norm(comb, dim=-1, keepdim=True)
        return comb * (pos_norm / comb_norm.clamp_min(1e-12))
