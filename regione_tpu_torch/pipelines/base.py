"""Backend-generic editing pipeline: wires the MMDiT backbone to the RegionE
sampler, and a VAE and a prompt encoder around it.

Counterpart of `regione_tpu/pipelines/base.py`.  Latent path:
  * latent token geometry and 3-axis RoPE ids (noise tokens axis0 = 0, the
    condition grids axis0 = 1, 2, ...: one tag per reference image);
  * the condition latent (all references, so S_cond may exceed S_noise) is
    concatenated on dense steps only; the partition compares against its
    first S_noise rows;
  * classifier-free guidance as a batch of two ([cond, uncond]) through the
    backbone, combined by `combine_cfg`; FLUX's distilled guidance scale
    rides in `EditInputs.guidance`;
  * the sigmas come from the backend's scheduler constants (`flow_shift`),
    and with the gamma table they set the stage plan;
  * `edit_latents` runs the dense baseline when `RegionEHelper.disable()`
    has cleared `_regione_enabled`;
  * `edit_latents_batch` edits a group of same-geometry requests in one
    batched denoise (`RegionESampler.sample_batch`).  Under CFG the group's
    rows are [pos_0 ... pos_{B-1}, neg_0 ... neg_{B-1}], the order
    `_expand_cfg` (cat([x, x])) and `_combine` (chunk(2)) assume, and the
    cache rows follow it.  On a (dp, tp) mesh (`parallel.sharding`) each
    dp rank denoises its share of the requests on its tp group;
  * a model sharded by `parallel.sharding.shard_params` carries its mesh,
    which `edit_latents` hands to the sampler;
  * spans of `utils.telemetry`: `pipeline.edit` around each
    `edit_latents` / `edit_latents_batch` call (the edit: its attrs gain
    the kernel wrappers' launches and host ns), `pipeline.dense_forward` /
    `pipeline.rags_forward` around each call of the two hooks, all with
    CUDA events on a card.
Image path (`prepare_inputs`, `__call__`): the target resolution policy,
the VAE encode of every reference, the prompt embeddings of both CFG halves
(padded to one length, the padding masked by a -1e9 text bias), the initial
noise (`initial_latents`), then decode and the caller's geometry restored.
Images are numpy HWC on the host; bilinear resizes antialias when
shrinking, as `jax.image.resize` does.  The prompt encoder is any object
with the JAX package's `encode(prompt, image=None) -> (embeds [1, T, D],
pooled [1, P] | None, mask [1, T])` (numpy), e.g.
`regione_tpu_torch.models.text_encoders.MockTextEncoder`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from regione_tpu_torch.core.config import RegionEParams
from regione_tpu_torch.core.gamma import gamma_for
from regione_tpu_torch.core.sampler import RegionESampler
from regione_tpu_torch.core.schedule import (FLUX_SHIFT, FlowShift,
                                             build_stage_plan)
from regione_tpu_torch.models.layers import gather_rope, rope_table
from regione_tpu_torch.models.mmdit import (MODE_DENSE, MODE_RAGS,
                                            MODE_WRITE, MMDiT, init_cache)
from regione_tpu_torch.models.vae import pack_latents, unpack_latents
from regione_tpu_torch.parallel.sharding import dp_all_gather
from regione_tpu_torch.utils import telemetry


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
    guidance: torch.Tensor | None = None   # [Bc] fp32 (FLUX guidance scale)
    txt_bias: torch.Tensor | None = None   # [Bc, 1, 1, T_txt + S_kv]
    s_noise: int | None = None             # noise rows (set by edit_latents)


class EditPipelineBase:
    """Shared machinery; subclasses set `backend`, the CFG policy and the
    image-conditioning hooks."""

    backend: str = "generic"
    uses_batch_cfg: bool = False   # duplicate inputs on the batch axis
    cond_axis0: int = 1            # rope axis-0 tag of condition tokens
    # uncond text when the caller passes none: "" (Step1X); the Qwen family
    # overrides with " "
    default_negative_prompt: str = ""
    # the scheduler's dynamic shift (its scheduler_config.json): FLUX.1's;
    # the Qwen family overrides with Qwen-Image's
    flow_shift: FlowShift = FLUX_SHIFT

    def __init__(self, model: MMDiT, re_params: RegionEParams | None = None,
                 gamma: np.ndarray | None = None,
                 true_cfg_scale: float = 1.0):
        self.model = model
        self.cfg = model.cfg
        self.re = (re_params or RegionEParams()).validate()
        self.gamma = gamma if gamma is not None else gamma_for(self.backend)
        self.true_cfg_scale = true_cfg_scale
        self._samplers: dict[tuple, RegionESampler] = {}
        self._regione_enabled = True   # RegionEHelper.enable() / disable()
        self.vae = None
        self.text_encoder = None

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
        with telemetry.span("pipeline.dense_forward", events_on=lat,
                            rows=lat.shape[1], write=write):
            return self._dense(lat, sigma, cache, ctx, write)

    def _dense(self, lat, sigma, cache, ctx, write):
        s_noise = lat.shape[1]
        dt = self.cfg.dtype
        cond = ctx.cond_latent.to(dt).expand(lat.shape[0], -1, -1)
        img_in = self._expand_cfg(torch.cat([lat.to(dt), cond], dim=1))
        t = self._timestep(img_in.shape[0], sigma, lat.device)
        v, cache = self.model(
            img_in, ctx.txt, t, ctx.rope_img, ctx.rope_txt,
            pooled=ctx.pooled, guidance=ctx.guidance,
            mode=MODE_WRITE if write else MODE_DENSE, cache=cache,
            txt_bias=ctx.txt_bias)
        return self._combine(v[:, :s_noise], sigma), cache

    def rags_forward(self, lat_act, sigma, cache, ids, ctx: EditInputs):
        """Gathered edited-token forward against the frozen KV cache; ids
        [K] (one partition) or [B, K] (one per image, expanded with the
        CFG rows)."""
        with telemetry.span("pipeline.rags_forward", events_on=lat_act,
                            rows=lat_act.shape[1]):
            return self._rags(lat_act, sigma, cache, ids, ctx)

    def _rags(self, lat_act, sigma, cache, ids, ctx):
        img_in = self._expand_cfg(lat_act.to(self.cfg.dtype))
        t = self._timestep(img_in.shape[0], sigma, lat_act.device)
        # the sampler pads ids with s_noise, which is a REAL cache row (the
        # first condition token); remap pads past the cache to s_kv, which
        # the RAGS bias masks and its stale-row scatter drops
        s_noise = ctx.s_noise or ctx.cond_latent.shape[1]
        s_kv = s_noise + ctx.cond_latent.shape[1]
        ids_cache = torch.where(ids < s_noise, ids, s_kv)
        if ids_cache.dim() == 2:
            ids_cache = self._expand_cfg(ids_cache)
        rope_act = gather_rope(ctx.rope_img, ids_cache)
        v, cache = self.model(
            img_in, ctx.txt, t, rope_act, ctx.rope_txt, pooled=ctx.pooled,
            guidance=ctx.guidance, mode=MODE_RAGS, cache=cache,
            sel_img_ids=ids_cache, txt_bias=ctx.txt_bias)
        return self._combine(v, sigma), cache

    # -- sampler construction ------------------------------------------------

    def sampler_for(self, grid_h: int, grid_w: int, t_txt: int,
                    batch_cache: int, s_cond: int | None = None
                    ) -> RegionESampler:
        s_noise = grid_h * grid_w
        s_cond = s_noise if s_cond is None else s_cond
        key = (grid_h, grid_w, t_txt, batch_cache, s_cond)
        if key not in self._samplers:
            sigmas = self.flow_shift.sigmas(self.re.num_inference_steps,
                                            s_noise)
            plan = build_stage_plan(self.re, sigmas, self.gamma)
            s_kv = s_noise + s_cond
            dev = self.device

            def make_cache():
                return init_cache(self.cfg, batch_cache, s_kv, dev,
                                  self.model.tp_size)

            self._samplers[key] = RegionESampler(
                plan, self.re, grid_h=grid_h, grid_w=grid_w,
                dense_forward=self.dense_forward,
                rags_forward=self.rags_forward, init_cache=make_cache)
        return self._samplers[key]

    # -- top-level latent-space edit -----------------------------------------

    @torch.inference_mode()
    def edit_latents(self, latents0, ctx: EditInputs, grid_h: int,
                     grid_w: int, dense_only: bool = False,
                     forced_mask=None):
        """latents0 [1, S_noise, C] initial noise -> (latents fp32, stats);
        stats is None for the dense baseline, which runs when `dense_only`
        is set or RegionE is disabled (`RegionEHelper.disable()`)."""
        with telemetry.span("pipeline.edit", events_on=latents0, edit=True,
                            grid=(grid_h, grid_w), batch=latents0.shape[0],
                            backend=self.backend):
            return self._edit(latents0, ctx, grid_h, grid_w, dense_only,
                              forced_mask)

    def _edit(self, latents0, ctx, grid_h, grid_w, dense_only, forced_mask):
        batch_cache = 2 if self.do_cfg else 1
        sampler = self.sampler_for(grid_h, grid_w, ctx.txt.shape[1],
                                   batch_cache, s_cond=ctx.cond_latent.shape[1])
        s_noise = latents0.shape[1]
        ctx = dataclasses.replace(ctx, s_noise=s_noise)
        if dense_only or not self._regione_enabled:
            return sampler.sample_dense(latents0, ctx), None
        return sampler.sample(latents0, ctx.cond_latent[:, :s_noise], ctx,
                              forced_mask=forced_mask, mesh=self.model.mesh)

    @torch.inference_mode()
    def edit_latents_batch(self, latents_list, ctx_list, grid_h: int,
                           grid_w: int, forced_masks=None, mesh=None):
        """Edit B same-geometry images in one batched denoise
        (`RegionESampler.sample_batch`): the images share the weights, the
        rope tables and one capacity bucket; each keeps its own partition,
        edited ids and cache rows.  latents_list: B tensors [1, S_noise, C];
        ctx_list: B `EditInputs` (from `prepare_inputs` or built by hand)
        with equal shapes and rope tables; forced_masks: None or B masks
        [S].  Returns (B latents [1, S, C] fp32, B SampleStats).

        `mesh`: a (dp, tp) `DeviceMesh` (`parallel.sharding.make_mesh`;
        every rank calls with the whole group).  The request axis goes over
        "dp", as the JAX package's `P("dp")` places it: when dp divides B
        each dp rank denoises its B / dp requests (their cache sets only) on
        its tp group; otherwise every dp rank denoises the whole group.  The
        weights are those of `self.model`, sharded over the same mesh's
        "tp" by `shard_params` or whole.  The group shares one capacity
        bucket, the largest count over all B.  Every rank returns all B
        latents and stats."""
        with telemetry.span("pipeline.edit",
                            events_on=next(iter(latents_list), None),
                            edit=True, grid=(grid_h, grid_w),
                            batch=len(latents_list), backend=self.backend):
            return self._edit_batch(latents_list, ctx_list, grid_h, grid_w,
                                    forced_masks, mesh)

    def _edit_batch(self, latents_list, ctx_list, grid_h, grid_w,
                    forced_masks, mesh):
        if None not in (mesh, self.model.mesh) and mesh is not self.model.mesh:
            raise ValueError("edit_latents_batch: the model is sharded over "
                             "another mesh")
        if mesh is None:
            mesh = self.model.mesh
        if not len(latents_list) == len(ctx_list) >= 1:
            raise ValueError(f"{len(latents_list)} latents for "
                             f"{len(ctx_list)} inputs")
        c0 = ctx_list[0]
        # the whole group rides c0's rope tables: equal-length condition
        # sequences with other grid decompositions (Plus references) would
        # denoise with wrong positional ids
        ref = (*c0.rope_img, *c0.rope_txt)
        for c in ctx_list[1:]:
            got = (*c.rope_img, *c.rope_txt)
            if not all(map(torch.equal, got, ref)):
                raise ValueError(
                    "edit_latents_batch: requests with differing rope "
                    "tables (condition grid decomposition / tags) cannot "
                    "share a batch; group them by rope content first "
                    "(EditService.run_batched does)")
        n_all = len(ctx_list)
        dp = 1 if mesh is None else mesh.size(0)
        split = dp > 1 and n_all % dp == 0
        if split:
            r, k = mesh.get_local_rank("dp"), n_all // dp
            latents_list = latents_list[r * k:(r + 1) * k]
            ctx_list = ctx_list[r * k:(r + 1) * k]
            if forced_masks is not None:
                forced_masks = forced_masks[r * k:(r + 1) * k]

        def stack(name):
            """The group's rows of a per-request field of Bc rows ([pos;
            neg] under CFG): all images' row 0, then all images' row 1."""
            vals = [getattr(c, name) for c in ctx_list]
            if vals[0] is None:
                return None
            return torch.cat([v[k:k + 1] for k in range(vals[0].shape[0])
                              for v in vals])

        s_noise = latents_list[0].shape[1]
        cond = torch.cat([c.cond_latent for c in ctx_list])
        ctx_b = EditInputs(txt=stack("txt"), cond_latent=cond,
                           rope_img=c0.rope_img, rope_txt=c0.rope_txt,
                           pooled=stack("pooled"), guidance=stack("guidance"),
                           txt_bias=stack("txt_bias"), s_noise=s_noise)
        group = len(ctx_list)
        sampler = self.sampler_for(
            grid_h, grid_w, ctx_b.txt.shape[1],
            group * (2 if self.do_cfg else 1), s_cond=cond.shape[1])
        lat_b = torch.cat([torch.as_tensor(x) for x in latents_list])
        fm = None
        if forced_masks is not None:
            fm = torch.stack([torch.as_tensor(m) for m in forced_masks])
        out, stats = sampler.sample_batch(lat_b, cond[:, :s_noise], ctx_b,
                                          forced_masks=fm, mesh=mesh)
        if split:
            out = dp_all_gather(mesh, out)
            counts = dp_all_gather(mesh, torch.tensor(
                [st.edited_tokens for st in stats], device=out.device))
            stats = [dataclasses.replace(stats[0], edited_tokens=int(c))
                     for c in counts.tolist()]
        return [out[i:i + 1] for i in range(n_all)], stats

    # -- image-level API ------------------------------------------------------

    def attach_vae(self, vae) -> "EditPipelineBase":
        """`vae`: a `models.vae.AutoencoderKL` or `models.vae_wan.WanVAE`."""
        self.vae = vae
        return self

    def attach_text_encoder(self, encoder) -> "EditPipelineBase":
        self.text_encoder = encoder
        return self

    @property
    def token_factor(self) -> int:
        """Pixels per latent token edge: the VAE's spatial factor x patch 2."""
        return self.vae.cfg.spatial_factor * 2 if self.vae is not None else 16

    def target_resolution(self, width: int, height: int) -> tuple[int, int]:
        """Default: ~1024^2 area, multiples of the token factor.  Backends
        override (the Kontext snap, Qwen's /32)."""
        area = 1024 * 1024
        ratio = width / height
        f = self.token_factor
        w = int(round((area * ratio) ** 0.5 / f) * f)
        h = int(round((w / ratio) / f) * f)
        return max(f, w), max(f, h)

    def _to_array(self, image) -> np.ndarray:
        """PIL / uint8 / float image -> float32 [H, W, 3] in [-1, 1]."""
        arr = np.asarray(image)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        if arr.max() > 1.5:  # 0..255 floats
            arr = arr / 255.0
        return arr * 2.0 - 1.0

    def _resize(self, arr: np.ndarray, w: int, h: int) -> np.ndarray:
        """Bilinear resize of a float [H, W, C] array to [h, w, C],
        antialiased when shrinking (`jax.image.resize(..., "bilinear")`)."""
        x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        y = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w),
                          mode="bilinear", align_corners=False,
                          antialias=True)
        return y[0].permute(1, 2, 0).numpy()

    def _to_uint8(self, image) -> np.ndarray:
        """PIL / float / uint8 image -> uint8 [H, W, 3] (encoder input)."""
        arr = np.asarray(image)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
            if arr.max() <= 1.5:  # 0..1 floats
                arr = arr * 255.0
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr

    def _resize_uint8(self, image, w: int, h: int) -> np.ndarray:
        arr = self._resize(self._to_uint8(image).astype(np.float32), w, h)
        return np.clip(np.round(arr), 0, 255).astype(np.uint8)

    # -- prompt-encoder conditioning hooks -----------------------------------

    def encoder_images(self, images: list, width: int, height: int):
        """Image(s) the prompt encoder sees, for both CFG halves.  Default
        (Step1X, Qwen): the edit target resized to the output resolution, as
        uint8 HWC.  FLUX overrides with None, Plus with its 384^2-area
        recipe over every reference."""
        return [self._resize_uint8(images[0], width, height)]

    def ref_vae_size(self, ref_w: int, ref_h: int, width: int, height: int
                     ) -> tuple[int, int]:
        """VAE resolution of an extra reference image: its aspect at the
        edit target's area, multiples of the token factor (Plus overrides)."""
        f = self.token_factor
        ratio = ref_w / ref_h
        area = width * height
        ew = max(f, int(round((area * ratio) ** 0.5 / f) * f))
        eh = max(f, int(round((ew / ratio) / f) * f))
        return ew, eh

    @torch.inference_mode()
    def encode_image(self, image, width: int, height: int) -> torch.Tensor:
        """VAE-encode an image at (width, height) into condition tokens
        [1, S, 4 * C_lat] fp32 on the pipeline's device."""
        arr = self._resize(self._to_array(image), width, height)
        vae_dev = next(self.vae.parameters()).device
        x = torch.from_numpy(arr).permute(2, 0, 1)[None].to(vae_dev)
        z = self.vae.normalize_latents(self.vae.encode(x))
        return pack_latents(z).float().to(self.device)

    def prepare_inputs(self, image, prompt: str,
                       negative_prompt: str | None = None,
                       width: int | None = None, height: int | None = None,
                       guidance_scale: float | None = None):
        """Encode the image(s) and prompts; build the rope tables and the
        `EditInputs`.  `image` may be a list (Plus): the first is the edit
        target (the output grid and the partition's reference, its latent
        rows first); each later one is a reference on its own rope tag.
        Returns (ctx, (width, height, grid_h, grid_w, (w0, h0))) with
        (w0, h0) the caller's geometry."""
        if negative_prompt is None:
            negative_prompt = self.default_negative_prompt
        images = list(image) if isinstance(image, (list, tuple)) else [image]
        h0, w0 = np.asarray(images[0]).shape[:2]
        f = self.token_factor
        if width is None or height is None:
            width, height = self.target_resolution(width or w0, height or h0)
        width, height = max(f, (width // f) * f), max(f, (height // f) * f)
        grid_h, grid_w = height // f, width // f

        cond_parts = [self.encode_image(images[0], width, height)]
        cond_grids = [(grid_h, grid_w)]
        for extra in images[1:]:
            rh, rw = np.asarray(extra).shape[:2]
            ew, eh = self.ref_vae_size(rw, rh, width, height)
            cond_parts.append(self.encode_image(extra, ew, eh))
            cond_grids.append((eh // f, ew // f))
        cond = torch.cat(cond_parts, dim=1)

        # the same encoder image(s) condition both CFG halves
        enc_imgs = self.encoder_images(images, width, height)
        # an offloaded encoder comes to the card once for both encodes
        on_device = getattr(self.text_encoder, "on_device",
                            contextlib.nullcontext)
        with on_device():
            emb, pooled, mask = self.text_encoder.encode(prompt,
                                                         image=enc_imgs)
            if self.do_cfg:
                emb_n, pooled_n, mask_n = self.text_encoder.encode(
                    negative_prompt, image=enc_imgs)
        if self.do_cfg:
            # the halves may come at different lengths: pad both to the
            # longer, the padding masked by the text bias
            t_max = max(emb.shape[1], emb_n.shape[1])

            def pad_t(a):
                widths = [(0, 0), (0, t_max - a.shape[1])] + \
                    [(0, 0)] * (a.ndim - 2)
                return np.pad(a, widths)

            emb = np.concatenate([pad_t(emb), pad_t(emb_n)], 0)
            mask = np.concatenate([pad_t(mask), pad_t(mask_n)], 0)
            # the negative half takes the negative prompt's pooled vector
            if pooled is not None:
                pooled = np.concatenate([pooled, pooled_n], 0)
        dev, dt = self.device, self.cfg.dtype
        txt = torch.from_numpy(np.asarray(emb, np.float32)).to(dev, dt)
        if pooled is not None:
            pooled = torch.from_numpy(np.asarray(pooled, np.float32)).to(dev,
                                                                         dt)

        t_txt = txt.shape[1]
        s_kv = grid_h * grid_w + cond.shape[1]
        bias = np.zeros((mask.shape[0], 1, 1, t_txt + s_kv), np.float32)
        bias[..., :t_txt] = np.where(mask, 0.0, -1e9)[:, None, None, :]
        rope_img, rope_txt = self.build_rope(grid_h, grid_w, t_txt,
                                             cond_grids=cond_grids)

        guidance = None
        if self.cfg.guidance_embed:
            gs = guidance_scale if guidance_scale is not None else getattr(
                self, "guidance_scale", 3.5)
            # fp32 into the timestep embedding (no rounding to the model
            # dtype, unlike sigma)
            guidance = torch.full((txt.shape[0],), gs, dtype=torch.float32,
                                  device=dev)

        ctx = EditInputs(txt=txt, cond_latent=cond, rope_img=rope_img,
                         rope_txt=rope_txt, pooled=pooled, guidance=guidance,
                         txt_bias=torch.from_numpy(bias).to(dev))
        return ctx, (width, height, grid_h, grid_w, (w0, h0))

    def initial_latents(self, seed: int, shape) -> torch.Tensor:
        """The edit's initial noise: standard normal fp32 on the pipeline's
        device from `torch.Generator(device).manual_seed(seed)` (the JAX
        package draws it with `jax.random.normal(PRNGKey(seed))`: the same
        distribution, not the same bits)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device,
                           dtype=torch.float32)

    @torch.inference_mode()
    def decode_latents(self, lat, grid_h: int, grid_w: int) -> np.ndarray:
        """Latents [1, S, C] -> the decoded image, float [H, W, 3] in
        [0, 1] on the host."""
        vae_dev = next(self.vae.parameters()).device
        z = unpack_latents(lat.float().to(vae_dev), grid_h, grid_w)
        img = self.vae.decode(self.vae.denormalize_latents(z))
        img = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0)
        return img[0].permute(1, 2, 0).cpu().numpy()

    @torch.inference_mode()
    def __call__(self, image, prompt: str, negative_prompt: str | None = None,
                 width: int | None = None, height: int | None = None,
                 seed: int = 0, guidance_scale: float | None = None,
                 output_type: str = "np", resize_to_input: bool = True):
        """Instruction edit: encode -> (RegionE) denoise -> decode.  Needs
        `attach_vae` and `attach_text_encoder`.  Returns (image, stats):
        float [H, W, 3] in [0, 1] (uint8 with output_type="uint8"), stats
        None for the dense path.

        resize_to_input: return the edit at the caller's geometry (the
        reference plugin's post-pass); False keeps the processed
        resolution.  An explicit width and height are kept as given."""
        if self.vae is None or self.text_encoder is None:
            raise RuntimeError(
                "attach_vae(...) and attach_text_encoder(...) first (or use "
                "edit_latents for latent-space operation)")
        explicit_size = width is not None and height is not None
        ctx, (width, height, grid_h, grid_w, (in_w, in_h)) = \
            self.prepare_inputs(image, prompt, negative_prompt, width,
                                height, guidance_scale)
        lat0 = self.initial_latents(
            seed, (1, grid_h * grid_w, self.cfg.in_channels))
        lat, stats = self.edit_latents(lat0, ctx, grid_h, grid_w)
        img = self.decode_latents(lat, grid_h, grid_w)
        if (resize_to_input and not explicit_size
                and (in_w, in_h) != (width, height)):
            img = np.clip(self._resize(img, in_w, in_h), 0.0, 1.0)
        if output_type == "uint8":
            img = (img * 255).round().astype(np.uint8)
        return img, stats
