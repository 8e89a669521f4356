"""The RegionE denoise driver: STS -> (RAGS <-> refresh)* -> SMS, eager.

Counterpart of `regione_tpu/core/sampler.py`.  The host-static stage plan
(`regione_tpu_torch.core.schedule`, the JAX module's copy) decides every
step before the loop starts; the four segments run eagerly:

  1. `_warm`: the dense stabilisation steps;
  2. `_part`: the partition split-step (a cache-writing forward, the
     edited mask, the split step, and the device-side edited-first id
     order).  It ends at the one host sync of an edit: the edited count,
     which picks the static capacity bucket;
  3. `_rest`: RAGS runs, refresh split-steps and the merge/shrink layout
     transitions; a run of AVD reuse steps collapses to one fused
     multiply-add (lat += avd * sum(dt_i * ratio_i)), with no model call;
  4. `_sms`: the trailing dense smooth steps.

Each segment is a span of `utils.telemetry` (`sampler.warm`,
`sampler.partition`, `sampler.rest`, `sampler.sms`, with CUDA events on a
card), and so is the host sync (`sampler.sync`, the host's wait alone).

Latents stay full-length [B, S_noise, C] fp32; the RAGS phase gathers them
to a fixed capacity with sentinel-padded ids (core.masking), and padded rows
are re-zeroed every step.

`sample_batch` edits a group of requests in one pass: the JAX package's
`vmap` over requests becomes the batch axis written out, each image with
its own partition, edited ids and cache rows, all at one capacity bucket
(the largest count's), so each step launches the kernels of one image.

Backends plug in with two hooks:
  dense_forward(lat [B,S,C] f32, sigma, cache, ctx, write) -> (v, cache)
  rags_forward(lat_act [B,K,C] f32, sigma, cache, ids, ctx) -> (v, cache)
with ids [K] (`sample`: one partition for the batch) or [B, K]
(`sample_batch`: one per image).

On a (dp, tp) mesh (`parallel.sharding`) the ranks agree at the host
sync: the tp ranks take tp rank 0's partition masks (one broadcast, so
every rank of a group launches collectives of the same sizes), and in
`sample_batch` the dp ranks gather their edited counts, so the whole group
shares one capacity bucket, as the unsharded group does.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from regione_tpu_torch.core.config import RegionEParams, pick_capacity
from regione_tpu_torch.core.schedule import (
    SCHED_PARTITION,
    SCHED_REFRESH,
    StepPlan,
    plan_segments,
)
from regione_tpu_torch.core import masking
from regione_tpu_torch.core.partition import (select_edited_mask,
                                              select_edited_masks)
from regione_tpu_torch.parallel.sharding import dp_all_gather, tp_broadcast
from regione_tpu_torch.utils import telemetry


@dataclasses.dataclass
class SampleStats:
    """Per-image observability.  `sts_s` and `rest_s` stay 0.0: the
    fields keep the struct equal to the JAX package's, which times its
    segments there; the port's segments are `utils.telemetry` spans."""
    edited_tokens: int
    capacity: int
    seq_len: int
    reuse_steps: int
    dense_steps: int
    rags_steps: int
    sts_s: float = 0.0
    rest_s: float = 0.0


class RegionESampler:
    """Generic RegionE loop driver, parameterised by backend hooks."""

    def __init__(self, plan: list[StepPlan], params_re: RegionEParams, *,
                 grid_h: int, grid_w: int, dense_forward: Callable,
                 rags_forward: Callable, init_cache: Callable[[], Any]):
        self.plan = plan
        self.re = params_re
        self.grid_h = grid_h
        self.grid_w = grid_w
        self.dense_forward = dense_forward
        self.rags_forward = rags_forward
        self.init_cache = init_cache
        self._segments = self._split_segments()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def sample(self, latents0, cond_latent, ctx, forced_mask=None,
               mesh=None):
        """Run the accelerated denoise.  latents0/cond_latent:
        [B, S_noise, C].  `forced_mask` [S] overrides the adaptive
        partition; `mesh`: the (dp, tp) mesh of a sharded model.
        Returns (final latents fp32, stats)."""
        s_noise = latents0.shape[1]
        if self.re.warmup_step > 1:
            lat = self._warm(latents0, ctx)
        else:
            # the later segments update their latents; keep the caller's
            lat = latents0.float().clone()
        lat, mask, ids_sorted, cache = self._part(lat, cond_latent, ctx,
                                                  forced_mask, mesh=mesh)
        # THE one host sync: the edited count picks the capacity bucket;
        # the id set itself stays on the device
        with telemetry.span("sampler.sync") as sp:
            n_edit = int(mask.sum())
            sp.set(edited=n_edit)
        cap = self.re.rags_capacity or pick_capacity(
            n_edit, s_noise, self.re.capacity_granularity)
        if n_edit > cap:
            # only with a user-pinned rags_capacity
            warnings.warn(
                f"edited tokens ({n_edit}) exceed pinned rags_capacity "
                f"({cap}); the highest-index {n_edit - cap} edited tokens "
                "will be treated as unedited", stacklevel=2)
            ids = torch.as_tensor(masking.mask_to_padded_ids(
                mask.cpu().numpy(), cap), device=lat.device)
            keep = torch.zeros((s_noise + 1,), dtype=torch.bool,
                               device=lat.device)
            keep[ids.long()] = True
            mask = keep[:s_noise]
            ids_cap = ids
        else:
            ids_cap = ids_sorted[:cap]
        lat, _ = self._rest(lat, ids_cap, mask, cache, ctx)
        if self._sms_steps:
            lat = self._sms(lat, ctx)
        stats = SampleStats(
            edited_tokens=n_edit, capacity=cap, seq_len=s_noise,
            reuse_steps=sum(sp.reuse for sp in self.plan),
            dense_steps=sum(sp.dense for sp in self.plan),
            rags_steps=sum(not sp.dense for sp in self.plan))
        return lat, stats

    @torch.inference_mode()
    def sample_batch(self, latents0_b, cond_b, ctx_b, forced_masks=None,
                     mesh=None):
        """Edit B images at once, each with its own partition: the JAX
        package's `sample_batch` (its `vmap` over requests) with the batch
        axis written out.  latents0_b / cond_b: [B, S_noise, C], one image
        per row; ctx_b: the images' inputs stacked by the pipeline
        (`EditPipelineBase.edit_latents_batch`); `forced_masks` [B, S]
        overrides the partitions.  One K3 launch partitions the group, and
        one host sync reads the B edited counts; the group shares the
        capacity bucket of the largest count (a pinned `rags_capacity`
        truncates each image's ids to it, as the JAX package's
        `mask_to_padded_ids` does, and leaves the masks as they are).
        On a `mesh` the rows are this dp rank's images: the capacity
        bucket is that of the largest count over every dp rank's.
        Returns (latents [B, S, C] fp32, one SampleStats per image: its own
        edited_tokens, the shared capacity)."""
        s_noise = latents0_b.shape[1]
        if self.re.warmup_step > 1:
            lat = self._warm(latents0_b, ctx_b)
        else:
            lat = latents0_b.float().clone()
        lat, mask, ids_sorted, cache = self._part(
            lat, cond_b, ctx_b, forced_masks, per_image=True, mesh=mesh)
        counts = mask.sum(-1)
        top = counts.max()[None]
        if mesh is not None:
            top = dp_all_gather(mesh, top).max()
        with telemetry.span("sampler.sync") as sp:
            counts = counts.tolist()     # THE one host sync: B counts
            sp.set(edited=counts)
        cap = self.re.rags_capacity or pick_capacity(
            int(top), s_noise, self.re.capacity_granularity)
        # each row: its edited ids ascending, then ids _rest pads with the
        # sentinel (mask_to_padded_ids of the row's mask, on the device)
        lat, _ = self._rest(lat, ids_sorted[:, :cap], mask, cache, ctx_b)
        if self._sms_steps:
            lat = self._sms(lat, ctx_b)
        return lat, [SampleStats(
            edited_tokens=int(c), capacity=cap, seq_len=s_noise,
            reuse_steps=sum(sp.reuse for sp in self.plan),
            dense_steps=sum(sp.dense for sp in self.plan),
            rags_steps=sum(not sp.dense for sp in self.plan))
            for c in counts]

    @torch.inference_mode()
    def sample_dense(self, latents0, ctx):
        """Vanilla dense Euler over the whole plan, through the same
        model hook."""
        return self._dense_steps(latents0.float(), self.plan, ctx)

    # ------------------------------------------------------------------
    # segment 1: STS + partition
    # ------------------------------------------------------------------

    def _dense_steps(self, lat, steps, ctx):
        """Plain-Euler cache-free dense steps (warm, SMS, dense baseline)."""
        for sp in steps:
            v, _ = self.dense_forward(lat, sp.sigma, None, ctx, False)
            lat = lat + sp.dt * v.float()
        return lat

    def _warm(self, latents, ctx):
        steps = self.plan[: self.re.warmup_step - 1]
        with telemetry.span("sampler.warm", events_on=latents,
                            steps=len(steps)):
            return self._dense_steps(latents.float(), steps, ctx)

    def _part(self, latents, cond_latent, ctx, forced_mask=None,
              per_image=False, mesh=None):
        """Partition split-step: one cache-writing forward, the edited mask
        ([S]; per_image: [B, S], one per image; on a mesh tp rank 0's), and
        the edited/unedited split step.  Returns the masks' edited-first id
        orders beside."""
        with telemetry.span("sampler.partition", events_on=latents, steps=1):
            return self._part_step(latents, cond_latent, ctx, forced_mask,
                                   per_image, mesh)

    def _part_step(self, latents, cond_latent, ctx, forced_mask, per_image,
                   mesh):
        part = self.plan[self.re.warmup_step - 1]
        assert part.sched_role == SCHED_PARTITION
        lat = latents.float()
        cache = self.init_cache()
        v, cache = self.dense_forward(lat, part.sigma, cache, ctx, True)
        v = v.float()
        x0 = lat + part.dt_final * v
        if forced_mask is not None:
            mask = forced_mask.to(device=lat.device, dtype=torch.bool)
        else:
            select = select_edited_masks if per_image else select_edited_mask
            mask = select(
                x0, cond_latent.float(), self.re.threshold,
                grid_h=self.grid_h, grid_w=self.grid_w,
                erosion_dilation=self.re.erosion_dilation,
                similarity_type=self.re.similarity_type)
        if mesh is not None:
            mask = tp_broadcast(mesh, mask)
        # edited rows take the Euler step, unedited rows long-jump to the
        # refresh sigma
        lat = masking.where_rows(mask, lat + part.dt * v,
                                 lat + part.dt_jump * v)
        # edited ids first, ascending (stable sort of ~mask; torch sorts no
        # bool, hence the cast)
        ids_sorted = torch.argsort((~mask).to(torch.int8), dim=-1,
                                   stable=True)
        return lat, mask, ids_sorted.to(torch.int32), cache

    # ------------------------------------------------------------------
    # segment 2: RAGS / refresh / SMS
    # ------------------------------------------------------------------

    def _split_segments(self):
        """(rest_segments, sms_tail): the post-warmup plan split into the
        cache-phase segments of _rest and the trailing run of plain dense
        (non-refresh) steps run by _sms."""
        segs = plan_segments(self.plan[self.re.warmup_step:])
        tail: list[StepPlan] = []
        if segs and segs[-1][0] == "dense":
            kind, steps = segs[-1]
            n = len(steps)
            while n > 0 and steps[n - 1].sched_role != SCHED_REFRESH:
                n -= 1
            tail = steps[n:]
            if n == 0:
                segs = segs[:-1]
            elif tail:
                segs = segs[:-1] + [(kind, steps[:n])]
        return segs, tail

    @property
    def _sms_steps(self):
        return self._segments[1]

    def _rest(self, lat, ids, mask, cache, ctx):
        segs, _ = self._segments
        with telemetry.span("sampler.rest", events_on=lat,
                            steps=sum(len(steps) for _, steps in segs)):
            return self._rest_steps(lat, ids, mask, cache, ctx)

    def _rest_steps(self, lat, ids, mask, cache, ctx):
        s_noise = lat.shape[1]
        # sentinel-pad on the device: slots past the edited count become
        # s_noise (an identity for host-built, already padded id sets); ids
        # [K] with mask [S], or one row each per image
        count = mask.sum(-1, keepdim=True)
        slot = torch.arange(ids.shape[-1], device=ids.device)
        ids = torch.where(slot < count, ids, s_noise).to(torch.int32)
        valid = (ids < s_noise)[..., None].float()
        segs, _ = self._segments
        avd_full = torch.zeros_like(lat)
        for si, (kind, steps) in enumerate(segs):
            if kind == "rags":
                lat_act = masking.gather_rows(lat, ids)
                avd_act = masking.gather_rows(avd_full, ids)
                cache, lat_act = self._rags_runs(lat_act, avd_act, cache, ids,
                                                 valid, steps, ctx)
                lat = masking.scatter_rows(lat, ids, lat_act)
                continue
            later_rags = any(k == "rags" for k, _ in segs[si + 1:])
            for sp in steps:
                if sp.sched_role == SCHED_REFRESH:
                    # the sentinel refresh (no RAGS after it) still does the
                    # split-step merge but skips the cache rebuild
                    if later_rags:
                        v, cache = self.dense_forward(lat, sp.sigma, cache,
                                                      ctx, True)
                    else:
                        v, _ = self.dense_forward(lat, sp.sigma, None, ctx,
                                                  False)
                    v = v.float()
                    lat = masking.where_rows(mask, lat + sp.dt * v,
                                             lat + sp.dt_jump * v)
                    avd_full = v
                else:
                    v, _ = self.dense_forward(lat, sp.sigma, None, ctx, False)
                    lat = lat + sp.dt * v.float()
        return lat, cache

    def _sms(self, lat, ctx):
        with telemetry.span("sampler.sms", events_on=lat,
                            steps=len(self._sms_steps)):
            return self._dense_steps(lat, self._sms_steps, ctx)

    def _rags_runs(self, lat_act, avd_act, cache, ids, valid, steps, ctx):
        """A RAGS segment split at the (statically known) AVD reuse runs:
        a run of reuse steps is one multiply-add with the un-decayed cached
        velocity (lat += avd * sum dt_i * ratio_i); a compute step runs the
        model over the gathered rows and refreshes the cached velocity."""
        i, n = 0, len(steps)
        while i < n:
            if steps[i].reuse:
                const = 0.0
                while i < n and steps[i].reuse:
                    const += steps[i].dt * steps[i].ratio
                    i += 1
                lat_act = (lat_act + torch.tensor(const, dtype=torch.float32)
                           * avd_act) * valid
            else:
                sp = steps[i]
                v, cache = self.rags_forward(lat_act, sp.sigma, cache, ids,
                                             ctx)
                avd_act = v.float()
                lat_act = (lat_act + sp.dt * avd_act) * valid
                i += 1
        return cache, lat_act
