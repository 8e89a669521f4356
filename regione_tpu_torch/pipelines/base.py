"""Backend-generic editing pipeline (latent path): wires the MMDiT backbone
to the RegionE sampler.

Counterpart of the latent-space part of `regione_tpu/pipelines/base.py`:
  * latent token geometry and 3-axis RoPE ids (noise tokens axis0 = 0, the
    condition grids axis0 = 1, 2, ...: one tag per reference image);
  * the condition latent (all references, so S_cond may exceed S_noise) is
    concatenated on dense steps only; the partition compares against its
    first S_noise rows;
  * classifier-free guidance as a batch of two ([cond, uncond]) through the
    backbone, combined by `combine_cfg`.
The image-level path (VAE, text encoders, `__call__`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from regione_tpu.core.config import RegionEParams
from regione_tpu.core.gamma import gamma_for
from regione_tpu.core.schedule import (build_sigmas, build_stage_plan,
                                       calculate_shift)
from regione_tpu_torch.core.sampler import RegionESampler
from regione_tpu_torch.models.layers import gather_rope, rope_table
from regione_tpu_torch.models.mmdit import (MODE_DENSE, MODE_RAGS,
                                            MODE_WRITE, MMDiT, init_cache)


def latent_grid_ids(grid_h: int, grid_w: int, axis0: int = 0) -> np.ndarray:
    """[S, 3] (axis0, y, x) rotary position ids for a token grid."""
    ys, xs = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    ids = np.stack([np.full_like(ys, axis0), ys, xs], axis=-1)
    return ids.reshape(-1, 3).astype(np.float32)


def txt_ids(t_txt: int) -> np.ndarray:
    """Text rotary ids: zeros (FLUX/Step1X convention)."""
    return np.zeros((t_txt, 3), np.float32)


@dataclasses.dataclass
class EditInputs:
    """Per-image prepared inputs threaded through the sampler hooks."""
    txt: torch.Tensor              # [Bc, T_txt, txt_in_dim] (Bc = 2 with CFG)
    cond_latent: torch.Tensor      # [1, S_cond, C], all references
    rope_img: Any                  # (cos, sin) over S_kv = S_noise + S_cond
    rope_txt: Any                  # (cos, sin) over T_txt rows
    pooled: torch.Tensor | None = None     # [Bc, pooled_dim]
    txt_bias: torch.Tensor | None = None   # [Bc, 1, 1, T_txt + S_kv]
    s_noise: int | None = None             # noise rows (set by edit_latents)


class EditPipelineBase:
    """Shared machinery; subclasses set `backend` and the CFG policy."""

    backend: str = "generic"
    uses_batch_cfg: bool = False   # duplicate inputs on the batch axis
    cond_axis0: int = 1            # rope axis-0 tag of condition tokens

    def __init__(self, model: MMDiT, re_params: RegionEParams | None = None,
                 gamma: np.ndarray | None = None,
                 true_cfg_scale: float = 1.0):
        self.model = model
        self.cfg = model.cfg
        self.re = (re_params or RegionEParams()).validate()
        self.gamma = gamma if gamma is not None else gamma_for(self.backend)
        self.true_cfg_scale = true_cfg_scale
        self._samplers: dict[tuple, RegionESampler] = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- backend hooks ------------------------------------------------------

    def combine_cfg(self, v_pos, v_neg, sigma: float):
        """Default: plain true-CFG combine."""
        return v_neg + self.true_cfg_scale * (v_pos - v_neg)

    @property
    def do_cfg(self) -> bool:
        return self.uses_batch_cfg and self.true_cfg_scale > 1.0

    # -- rope / geometry ----------------------------------------------------

    def build_rope(self, grid_h: int, grid_w: int, t_txt: int,
                   cond_grids=None):
        """Rotary tables for the [noise ‖ conditions] rows and the txt rows.
        cond_grids: the (h, w) token grids of the condition image(s), each
        with its own axis-0 tag; default one grid equal to the noise grid."""
        kv_ids, t_ids = self.rope_position_ids(grid_h, grid_w, t_txt,
                                               cond_grids)
        dev = self.device
        rope_img = rope_table(torch.from_numpy(kv_ids).to(dev),
                              self.cfg.axes_dims, self.cfg.rope_theta)
        rope_txt = rope_table(torch.from_numpy(t_ids).to(dev),
                              self.cfg.axes_dims, self.cfg.rope_theta)
        return rope_img, rope_txt

    def rope_position_ids(self, grid_h: int, grid_w: int, t_txt: int,
                          cond_grids=None):
        """Raw [S, 3] rotary ids for [noise ‖ conditions] and txt."""
        cond_grids = cond_grids or [(grid_h, grid_w)]
        parts = [latent_grid_ids(grid_h, grid_w, 0)]
        for i, (ch, cw) in enumerate(cond_grids):
            parts.append(latent_grid_ids(ch, cw, self.cond_axis0 + i))
        return np.concatenate(parts, 0), txt_ids(t_txt)

    # -- model forward hooks passed to the sampler --------------------------

    def _expand_cfg(self, x):
        return torch.cat([x, x], dim=0) if self.do_cfg else x

    def _combine(self, v, sigma: float):
        v = v.float()
        if self.do_cfg:
            v_pos, v_neg = v.chunk(2, dim=0)
            return self.combine_cfg(v_pos, v_neg, sigma)
        return v

    def _timestep(self, b: int, sigma: float, device):
        """sigma as the backbone sees it: rounded to the model dtype (bf16
        at full width) before the timestep embedding, as the JAX package
        does (`jnp.full((b,), sigma, cfg.dtype)`)."""
        return torch.full((b,), float(np.float32(sigma)), dtype=self.cfg.dtype,
                          device=device)

    def dense_forward(self, lat, sigma, cache, ctx: EditInputs, write: bool):
        """Full-sequence forward over [noise ‖ condition] image rows."""
        s_noise = lat.shape[1]
        dt = self.cfg.dtype
        cond = ctx.cond_latent.to(dt).expand(lat.shape[0], -1, -1)
        img_in = self._expand_cfg(torch.cat([lat.to(dt), cond], dim=1))
        t = self._timestep(img_in.shape[0], sigma, lat.device)
        v, cache = self.model(
            img_in, ctx.txt, t, ctx.rope_img, ctx.rope_txt,
            pooled=ctx.pooled, mode=MODE_WRITE if write else MODE_DENSE,
            cache=cache, txt_bias=ctx.txt_bias)
        return self._combine(v[:, :s_noise], sigma), cache

    def rags_forward(self, lat_act, sigma, cache, ids, ctx: EditInputs):
        """Gathered edited-token forward against the frozen KV cache."""
        img_in = self._expand_cfg(lat_act.to(self.cfg.dtype))
        t = self._timestep(img_in.shape[0], sigma, lat_act.device)
        # the sampler pads ids with s_noise, which is a REAL cache row (the
        # first condition token); remap pads past the cache to s_kv, which
        # the RAGS bias masks and its stale-row scatter drops
        s_noise = ctx.s_noise or ctx.cond_latent.shape[1]
        s_kv = s_noise + ctx.cond_latent.shape[1]
        ids_cache = torch.where(ids < s_noise, ids, s_kv)
        rope_act = gather_rope(ctx.rope_img, ids_cache)
        v, cache = self.model(
            img_in, ctx.txt, t, rope_act, ctx.rope_txt, pooled=ctx.pooled,
            mode=MODE_RAGS, cache=cache, sel_img_ids=ids_cache,
            txt_bias=ctx.txt_bias)
        return self._combine(v, sigma), cache

    # -- sampler construction ------------------------------------------------

    def sampler_for(self, grid_h: int, grid_w: int, t_txt: int,
                    batch_cache: int, s_cond: int | None = None
                    ) -> RegionESampler:
        s_noise = grid_h * grid_w
        s_cond = s_noise if s_cond is None else s_cond
        key = (grid_h, grid_w, t_txt, batch_cache, s_cond)
        if key not in self._samplers:
            sigmas = build_sigmas(self.re.num_inference_steps,
                                  mu=calculate_shift(s_noise))
            plan = build_stage_plan(self.re, sigmas, self.gamma)
            s_kv = s_noise + s_cond
            dev = self.device

            def make_cache():
                return init_cache(self.cfg, batch_cache, s_kv, dev)

            self._samplers[key] = RegionESampler(
                plan, self.re, grid_h=grid_h, grid_w=grid_w,
                dense_forward=self.dense_forward,
                rags_forward=self.rags_forward, init_cache=make_cache)
        return self._samplers[key]

    # -- top-level latent-space edit -----------------------------------------

    @torch.inference_mode()
    def edit_latents(self, latents0, ctx: EditInputs, grid_h: int,
                     grid_w: int, dense_only: bool = False,
                     forced_mask=None, timed: bool = False):
        """latents0 [1, S_noise, C] initial noise -> (latents fp32, stats);
        stats is None for the dense-only baseline."""
        batch_cache = 2 if self.do_cfg else 1
        sampler = self.sampler_for(grid_h, grid_w, ctx.txt.shape[1],
                                   batch_cache, s_cond=ctx.cond_latent.shape[1])
        s_noise = latents0.shape[1]
        ctx = dataclasses.replace(ctx, s_noise=s_noise)
        if dense_only:
            return sampler.sample_dense(latents0, ctx), None
        return sampler.sample(latents0, ctx.cond_latent[:, :s_noise], ctx,
                              forced_mask=forced_mask, timed=timed)
