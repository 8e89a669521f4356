"""The plain RegionE edit of the benchmark's reference: one step at a time
over the frozen plan (`plan.py`) and the plain model (`model.py`).

An edit of the latent path, as the reference RegionE defines it:
  * the warm-up steps and the partition step are dense over [noise ‖
    condition] rows; the partition step stores the image K / V, estimates
    x0 with one jump to the last sigma, and marks a token edited where the
    cosine of its x0 estimate and its condition latent is at most the
    threshold, then erodes (3x3 cross) and dilates (5x5 square) the mask,
    cells outside the grid counting as 0;
  * edited tokens take the Euler step; the others jump to the next refresh
    target's sigma and wait there;
  * RAGS steps run the model over the edited tokens alone against the
    stored K / V of the rest, or (AVD reuse) add the last computed
    velocity times the step's decay ratio, with no forward;
  * a refresh step is dense, stores the K / V again while RAGS steps
    follow, and splits as the partition step did (the velocity it computes
    is the one later reuse steps start from);
  * the smooth steps at the end are dense.
Classifier-free guidance runs as a batch of two [cond, uncond] and
combines by the configuration's rule (Step1X: the norm-processed
combine); FLUX's distilled guidance scale enters the model instead.

No padding, no capacity bucket and no gather of a fixed size: the
edited rows are exactly the edited tokens.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import model as M
from perfbench.reference import plan as P


class Reference:
    """The plain edit of one configuration (its parsed JSON file) at one
    grid, over a dict of weights.  `lower`: the control's precision (see
    `model.Linear`)."""

    def __init__(self, config: dict, weights: dict, grid: int, device,
                 lower=None):
        self.c = config
        self.m = config["model"]
        self.dt = getattr(torch, config["dtype"])
        self.lin = M.Linear(weights, lower)
        self.knobs = P.Knobs.of(config["regione"])
        self.grid = grid
        self.s = grid * grid
        sig = P.sigmas(self.knobs.num_inference_steps, self.s)
        self.plan = P.build_plan(self.knobs, sig, config["gamma"])
        g = config["guidance"]
        self.cfg_scale = float(g.get("true_cfg_scale", 1.0))
        self.batch_cfg = self.cfg_scale > 1.0
        ids = torch.cat([M.grid_ids(grid, grid, 0, device),
                         M.grid_ids(grid, grid, config["cond_axis0"],
                                    device)])
        self.rope_img = M.rope_tables(ids, self.m["axes_dims"],
                                      self.m["rope_theta"])
        t_txt = config["text"]["t_txt"]
        self.rope_txt = M.rope_tables(torch.zeros(t_txt, 3, device=device),
                                      self.m["axes_dims"],
                                      self.m["rope_theta"])

    # -- one forward and the guidance combine ------------------------------

    def velocity(self, rows, sigma: float, req, mode="dense", store=None,
                 edited=None, keep=None):
        """rows [1, n, C] fp32: all noise rows (dense / write) or the edited
        ones (rags).  Returns the combined velocity [1, n, C] fp32."""
        dt, n = self.dt, rows.shape[1]
        if mode == "rags":
            img = rows.to(dt)
            table = (self.rope_img[0][edited], self.rope_img[1][edited])
        else:
            img = torch.cat([rows.to(dt), req["cond"].to(dt)], 1)
            table = self.rope_img
        if self.batch_cfg:
            img = torch.cat([img, img])
        b = img.shape[0]
        t = torch.full((b,), float(np.float32(sigma)), dtype=dt,
                       device=img.device)
        v = M.forward(self.lin, self.m, img, req["txt"], t, table,
                      self.rope_txt, pooled=req.get("pooled"),
                      guidance=req.get("guidance"), mode=mode, store=store,
                      keep=keep)
        v = v[:, :n].float()
        if not self.batch_cfg:
            return v
        pos, neg = v.chunk(2)
        return self.combine(pos, neg, sigma)

    def combine(self, pos, neg, sigma: float):
        g = self.c["guidance"]
        diff = pos - neg
        scaled = self.cfg_scale * diff
        if g.get("combine") != "norm_processed" or (
                np.float32(sigma) * np.float32(1000.0)
                <= g["timesteps_truncate"]):
            return neg + scaled
        norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
        k = g["process_norm_power"]
        return neg + scaled / torch.where(norm > 1.0, norm.pow(k),
                                          torch.ones_like(norm))

    # -- the partition -------------------------------------------------------

    def partition(self, x0, cond):
        """(edited mask [S] bool, the cosines [S]) of the x0 estimate
        against the condition's noise-grid rows."""
        x, c = x0[0].float(), cond[0].float()
        cos = (x * c).sum(-1) / torch.sqrt(
            ((x * x).sum(-1) * (c * c).sum(-1)).clamp_min(1e-12))
        mask = cos <= self.knobs.threshold
        if self.knobs.erosion_dilation:
            g = mask.float().reshape(1, 1, self.grid, self.grid)
            p = F.pad(g, (1, 1, 1, 1))
            eroded = torch.minimum(
                torch.minimum(g, p[..., :-2, 1:-1]),
                torch.minimum(torch.minimum(p[..., 2:, 1:-1],
                                            p[..., 1:-1, :-2]),
                              p[..., 1:-1, 2:]))
            mask = (F.max_pool2d(eroded, 5, stride=1, padding=2) > 0.5
                    ).reshape(-1)
        return mask, cos

    def x0_estimate(self, lat0, req):
        """The partition step's x0 estimate: the warm-up steps, one dense
        forward and the jump to the last sigma (the traffic's probe)."""
        k = self.knobs
        lat = lat0.float()
        for sp in self.plan[:k.warmup_step - 1]:
            lat = lat + sp.dt * self.velocity(lat, sp.sigma, req)
        part = self.plan[k.warmup_step - 1]
        return lat + part.dt_final * self.velocity(lat, part.sigma, req)

    # -- the edit ------------------------------------------------------------

    def edit(self, lat0, req):
        """One RegionE edit.  Returns (latents [1, S, C] fp32, a dict:
        mask, the partition's cosines, and the plan statistics the program
        reports)."""
        k, s = self.knobs, self.s
        lat = lat0.float().clone()
        for sp in self.plan[:k.warmup_step - 1]:
            lat = lat + sp.dt * self.velocity(lat, sp.sigma, req)
        part = self.plan[k.warmup_step - 1]
        store = {}
        v = self.velocity(lat, part.sigma, req, "write", store)
        mask, cos = self.partition(lat + part.dt_final * v,
                                   req["cond"][:, :s])
        sel = mask[None, :, None]
        lat = torch.where(sel, lat + part.dt * v, lat + part.dt_jump * v)
        edited = torch.nonzero(mask).reshape(-1)
        s_kv = s + req["cond"].shape[1]
        stale = torch.zeros(s_kv, dtype=torch.bool, device=lat.device)
        stale[edited] = True
        keep = torch.nonzero(~stale).reshape(-1)
        avd = torch.zeros_like(lat)
        rest = self.plan[k.warmup_step:]
        for j, sp in enumerate(rest):
            if sp.dense:
                later_rags = any(not q.dense for q in rest[j + 1:])
                if sp.role == P.REFRESH:
                    if later_rags:
                        store = {}
                        v = self.velocity(lat, sp.sigma, req, "write", store)
                    else:
                        v = self.velocity(lat, sp.sigma, req)
                    lat = torch.where(sel, lat + sp.dt * v,
                                      lat + sp.dt_jump * v)
                    avd = v
                else:
                    lat = lat + sp.dt * self.velocity(lat, sp.sigma, req)
            elif sp.reuse:
                lat[:, edited] = lat[:, edited] + (sp.dt * sp.ratio) * \
                    avd[:, edited]
            else:
                v = self.velocity(lat[:, edited], sp.sigma, req, "rags",
                                  store, edited, keep)
                avd = avd.clone()
                avd[:, edited] = v
                lat[:, edited] = lat[:, edited] + sp.dt * v
        n = int(mask.sum())
        info = {"mask": mask, "cos": cos, "edited_tokens": n,
                "capacity": P.pick_capacity(n, s, k.capacity_granularity),
                **P.counts(self.plan)}
        return lat, info
