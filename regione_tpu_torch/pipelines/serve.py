"""Serving: edit a stream of requests on one pipeline.

Counterpart of `regione_tpu/pipelines/serve.py`:

  * `EditService.run(requests)` denoises one request at a time and
    prepares the next one (host resize, VAE encode, prompt encoding, the
    initial noise) on a worker thread meanwhile.  On a card the worker's
    work goes to a CUDA stream of its own, so its kernels and copies do not
    queue behind the denoise, and the denoise's one host sync (the edited
    count) waits for the denoise's stream alone.  The denoise's stream
    waits on an event recorded after the preparation before it touches the
    prepared tensors, and each of them is marked as used by that stream
    (`record_stream`), so the allocator does not hand its memory to the
    next preparation while the denoise still reads it.
  * `EditService.run_batched(requests, max_batch)` groups requests of the
    same geometry (token grid, text length, condition length and rope
    tables) and denoises each group of up to `max_batch` in one batched
    pass (`EditPipelineBase.edit_latents_batch`).

Each result carries its own `SampleStats` (its own edited-token count even
when batched) and the stages `StageTimer` recorded for it: "prep" (on the
worker, ended by its stream), "denoise" and "decode".  `latency_s` is the
request's wall time (denoise and decode); in a group it is the group's
time over its size, the group's time beside it.  The initial noise is the
pipeline's `initial_latents(seed)`, torch's generator, not `jax.random`'s
bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np
import torch

from regione_tpu_torch.utils.telemetry import StageTimer


def _rope_digest(ctx) -> str:
    """Content hash of a request's rope tables.  Positional encoding is
    fully determined by them (grid decomposition, the references' axis-0
    tags), so two requests may share a batch iff their digests match."""
    h = hashlib.sha1()
    for t in (*ctx.rope_img, *ctx.rope_txt):
        a = t.detach().cpu().numpy()
        h.update(str((a.shape, a.dtype)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class EditRequest:
    image: Any                    # array / PIL, or a list (multi-reference)
    prompt: str
    negative_prompt: str | None = None  # None: the backend's default
    width: int | None = None
    height: int | None = None
    seed: int = 0


@dataclasses.dataclass
class EditResult:
    """One edited image (uint8 [H, W, 3]) and what was observed of it.
    `stats` is this request's SampleStats (None for the dense path);
    `latency_s` its wall time in `run`, and in `run_batched` its share of
    the group's time (`group_latency_s` / `group_size`); `stages` the
    seconds of its "prep", "denoise" and "decode" stages (a group's
    denoise is shared by its requests)."""
    image: np.ndarray
    stats: Any
    latency_s: float
    prep_s: float
    group_size: int = 1
    group_latency_s: float | None = None
    stages: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Prepared:
    ctx: Any
    lat0: torch.Tensor
    grid_h: int
    grid_w: int
    resize_to: tuple | None
    ready: Any                    # CUDA event after the preparation, or None
    timer: StageTimer


class EditService:
    """Overlapped-prep, sequential-denoise edit service over one pipeline
    (with its VAE and prompt encoder attached)."""

    def __init__(self, pipeline, use_regione: bool = True):
        self.pipe = pipeline
        self.pipe._regione_enabled = use_regione
        dev = self.pipe.device
        # the preparations' stream (run() prepares on a worker thread)
        self._prep_stream = (torch.cuda.Stream(device=dev)
                             if dev.type == "cuda" else None)

    def _prepare(self, req: EditRequest) -> tuple[_Prepared, float]:
        timer = StageTimer()
        stream = self._prep_stream
        ready = None
        with timer.stage("prep"), (torch.cuda.stream(stream) if stream
                                   else contextlib.nullcontext()):
            ctx, (w, h, gh, gw, input_size) = self.pipe.prepare_inputs(
                req.image, req.prompt, req.negative_prompt, req.width,
                req.height)
            lat0 = self.pipe.initial_latents(
                req.seed, (1, gh * gw, self.pipe.cfg.in_channels))
            if stream is not None:
                ready = torch.cuda.Event()
                ready.record(stream)
                ready.synchronize()     # prep_s includes the device's work
        # output geometry as pipe.__call__ gives it: the caller's size
        # restored unless BOTH width and height were requested
        explicit = req.width is not None and req.height is not None
        resize_to = (input_size if not explicit and input_size != (w, h)
                     else None)
        prepared = _Prepared(ctx, lat0, gh, gw, resize_to, ready, timer)
        return prepared, timer.segments["prep"]

    def _adopt(self, p: _Prepared) -> None:
        """Hand a preparation's tensors to the current (denoise) stream:
        wait for its event, and mark each tensor used by this stream."""
        if p.ready is None:
            return
        cur = torch.cuda.current_stream(self.pipe.device)
        cur.wait_event(p.ready)
        fields = [getattr(p.ctx, f.name) for f in dataclasses.fields(p.ctx)]
        for t in [p.lat0, *p.ctx.rope_img, *p.ctx.rope_txt, *fields]:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(cur)

    def _finish(self, img_01: np.ndarray, resize_to) -> np.ndarray:
        """[H, W, C] float in [0, 1] -> uint8, restored to the caller's
        geometry when `resize_to` is set."""
        if resize_to is not None:
            img_01 = np.clip(self.pipe._resize(img_01, *resize_to), 0.0, 1.0)
        return (img_01 * 255).round().astype(np.uint8)

    def _decode(self, p: _Prepared, lat) -> np.ndarray:
        with p.timer.stage("decode"):
            img = self.pipe.decode_latents(lat, p.grid_h, p.grid_w)
            return self._finish(img, p.resize_to)

    def _denoise_decode(self, p: _Prepared) -> tuple[np.ndarray, Any]:
        self._adopt(p)
        with p.timer.stage("denoise", sync_on=p.lat0):
            lat, stats = self.pipe.edit_latents(p.lat0, p.ctx, p.grid_h,
                                                p.grid_w)
        return self._decode(p, lat), stats

    def run(self, requests: Sequence[EditRequest]) -> list[EditResult]:
        """Each request in turn; the next one's preparation overlaps this
        one's denoise and decode."""
        results: list[EditResult] = []
        with ThreadPoolExecutor(max_workers=1) as prep_pool:
            fut = prep_pool.submit(self._prepare, requests[0])
            for i in range(len(requests)):
                prepared, prep_s = fut.result()
                if i + 1 < len(requests):
                    fut = prep_pool.submit(self._prepare, requests[i + 1])
                t0 = time.perf_counter()
                img, stats = self._denoise_decode(prepared)
                results.append(EditResult(
                    image=img, stats=stats,
                    latency_s=time.perf_counter() - t0, prep_s=prep_s,
                    stages=prepared.timer.as_dict()))
        return results

    def run_batched(self, requests: Sequence[EditRequest],
                    max_batch: int = 4, mesh=None) -> list[EditResult]:
        """Group same-geometry requests and denoise each group of up to
        `max_batch` in one batched pass; results in request order.
        `mesh` must be None (see `EditPipelineBase.edit_latents_batch`)."""
        prepped = [self._prepare(req) for req in requests]
        # the group key: token grid, text and condition lengths, and the
        # rope tables' content (equal-length condition sequences can
        # decompose into different grids: same shapes, other positions)
        groups: dict[tuple, list[int]] = {}
        for i, (p, _) in enumerate(prepped):
            groups.setdefault(
                (p.grid_h, p.grid_w, p.ctx.txt.shape[-2],
                 p.ctx.cond_latent.shape[-2], _rope_digest(p.ctx)),
                []).append(i)
        results: dict[int, EditResult] = {}
        for (gh, gw, *_), idxs in groups.items():
            for lo in range(0, len(idxs), max_batch):
                chunk = idxs[lo:lo + max_batch]
                for i in chunk:
                    self._adopt(prepped[i][0])
                t0 = time.perf_counter()
                timer = StageTimer()
                with timer.stage("denoise",
                                 sync_on=prepped[chunk[0]][0].lat0):
                    outs, stats = self.pipe.edit_latents_batch(
                        [prepped[i][0].lat0 for i in chunk],
                        [prepped[i][0].ctx for i in chunk], gh, gw,
                        mesh=mesh)
                imgs = []
                for i, lat in zip(chunk, outs):
                    p = prepped[i][0]
                    p.timer.segments["denoise"] = timer.segments["denoise"]
                    imgs.append(self._decode(p, lat))
                group_s = time.perf_counter() - t0
                for i, img, st in zip(chunk, imgs, stats):
                    p, prep_s = prepped[i]
                    results[i] = EditResult(
                        image=img, stats=st,
                        latency_s=group_s / len(chunk), prep_s=prep_s,
                        group_size=len(chunk), group_latency_s=group_s,
                        stages=p.timer.as_dict())
        return [results[i] for i in range(len(requests))]
