"""Drive the PyTorch port of RegionE end to end on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card and nvcc; no arguments

Phases, each printing its lines and seconds; any failure exits non-zero:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build the hand-written kernels from regione_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version at the slices' shapes,
     with its error bound, and both times (CUDA events): K1, K2, K3 (grids
     32, 64, 160, 256, 48 x 80 and a ragged 37 x 53), K2q (int8 and int4
     cache, at Qwen's grid-64 shape 1152 + 8192 too), K5 (K1 past 12,288
     keys) and K6, ragged shapes (T, S1 and, under int4, S2 / 2 off the
     128-row tile) included; beside each its bound (the least time the
     card could take: operations at the peak rate or bytes at the memory
     rate, whichever is larger), beside K3 its device time (its calls
     captured in a CUDA graph; K3 also over a group of B = 1, 2, 4 images
     at 64 x 64 and B = 3 at grid 32 in one launch, each image's mask
     equal to its own B = 1 launch) and the launch floor (a call of
     `torch.zeros(1).zero_()`) and, for the attention kernels, the fastest
     `scaled_dot_product_attention` backend on the same inputs (timed
     only: the port never calls it);
  3f. the fused block kernels (`ops.fused`, csrc/fused_block.cu) against
     their plain versions in bf16: K7 AdaLN, residual + AdaLN and the
     residual alone (modulation vectors as `_modulation`'s strided chunk
     views), K8 qk-RMSNorm + RoPE from the strided linear1 split, into a
     packed buffer at row offset t_txt, and v's packing alone, K9 [attn ‖
     gelu(mlp_h)] and the GELU alone, at the headline's shape (B 2, 8320
     rows, hidden 1536, 12 heads), Qwen's and FLUX's at grid 64 (8704
     rows, hidden 3072, 24 heads; B 2 and 1), a headline RAGS step (1152
     rows, [B, cap, 128] RoPE tables), a Qwen tp 4 rank (6 heads; K8 and
     K9 only) and a ragged B 1 (8283 rows); each with its kernel and plain
     ms and its bound (bytes at the HBM rate), and the one PyTorch call of
     the same function where there is one (`torch.addcmul` for the
     residual alone, `F.gelu` for the GELU alone; timed only); then
     FLUX.2 [dev]'s shapes: K7's three modes at hidden 6144 ([1, 8704,
     6144], a dense 1024^2 forward's [txt ‖ img] stream) and K11 [attn ‖
     silu(a) * b], bit for bit, over a single block's linear1 output (the
     gate of [1, 8704, 36864] at row stride 55296, attn [1, 8704, 6144])
     and the gate alone over a double block's [1, 4096, 36864]; every later
     MMDiT edit on the card launches each of K7 and K8, and K9 or (FLUX.2)
     K11 (the checks below read their counts);
  3c. K10, the K/V cache's quantizer (`ops.quant.store_quantized`,
     csrc/kv_quant.cu), from the image rows' strided view of a joint
     buffer into a cache layer: codes and scales bit-equal to the eager
     `quantize_kv_heads{,4}` at Qwen's write forward (int8 and int4), a
     FLUX single block's image rows and a Qwen tp 4 rank's 6 heads, with
     its call and device ms, the eager quantizer's and its bound; every
     later RegionE edit with an int8 / int4 cache launches K10, and none
     with a bf16 cache;
  4. small head_dim-128 models: the card's path against the port's CPU
     path on the same weights and inputs: Step1X topology (bf16 cache),
     Qwen topology with the int8 and the int4 cache, Qwen-Image-Edit-Plus
     with two 64 x 64 references (dense S past 12,288: K5), and
     `sdpa_cached` over a quantized cache alone (K6), and the FLUX.2
     topology (SwiGLU through K11, shared modulation, no biases, 4-axis
     ids) with the int8 cache; then, on the card
     alone, the Step1X topology with 64 in / out channels at grid 160
     (S 25,600, a 2560 x 2560 image): a dense and a RegionE edit, K3 once,
     a partial partition, latent PSNR against dense;
  5. the Step1X-Edit slice at full published width and depth with random
     bf16 weights: a dense 28-step edit and the RegionE edit of two
     requests through `Step1XEditPipeline.edit_latents`, with the kernels'
     launch counts, the plan statistics, the timings and the latent PSNR of
     RegionE against dense; then its device time by kernel group
     (torch.profiler) and the device's idle share;
  4q. the quantized weight formats (int8 weight-only, W8A8, int4 with int4
     modulations) on phase 4's Step1X, FLUX and Qwen topologies at hidden
     512, card bf16 against CPU fp32 on the same `quantize_params` codes;
     then `torch._int_mm` at each W8A8 shape they ran, bit for bit against
     the exact int32 product (on the card and on the CPU);
  serve (a), on phase 5's weights: three requests with partial
     partitions of different sizes, each through `edit_latents`, then as
     one group through `edit_latents_batch` (one K3 launch, one capacity):
     per-image counts, latent PSNR of batched against single >= 40 dB,
     seconds per image and images/s both ways, peaks, the group's profile,
     `memplan.plan` beside the card's bytes, K2 at the group's shape;
  5b. the Qwen-Image-Edit slice at full published width and depth (60
     double blocks, 20.4 B parameters, random bf16 weights) at its native
     1024 x 1024 (grid 64): one request, its dense edit, the int8-cache
     RegionE edit (once: its warm repeat was cut to keep the run near 800
     s), then the int4- and the bf16-cache RegionE edits on the same
     weights; the profiles of the
     dense, the int8 and the bf16 RegionE edit; K2q (int8, int4) and K2 at
     this path's shape (t_txt + capacity fresh rows over the cache);
  6. the image-level path (image in, image out), fp32 VAEs with cuDNN's
     default TF32 convs:
     6d. (run after phase 4) each VAE family at full channel width, card
         against the port's CPU path at 64 x 64 pixels, with TF32 convs off
         and on, and both settings' encode / decode times at full size;
     6b. (run on phase 5b's weights) Qwen-Image-Edit through `__call__` at
         512 x 512 with the published-size Wan VAE and the int8 cache;
     6a. FLUX.1 Kontext at full width (19 + 38 blocks, random bf16
         weights, built by the CLI's `build_pipeline`) with the
         published-size AutoencoderKL through `pipe(image, prompt)`: a
         900 x 900 image snapped to 1024 x 1024 (a 64 x 64 token grid) and
         restored; two RegionE calls and a dense one through
         `RegionEHelper.disable()`, pixel PSNR of RegionE against dense;
         the denoise's profile; then K1, K2 and K3 at this path's shapes
         against their plain versions;
     serve (b), on 6a's pipeline: `EditService.run` and
         `run_batched(max_batch=2)` over two 900 x 900 requests and one
         1200 x 800 (two geometry groups): uint8 outputs at the input
         geometry, pixel PSNR of batched against single >= 40 dB, and
         `run` against 6a's `pipe(image, prompt, seed=3)`;
     6c. the CLI's `run_demo` on that pipeline, writing demo_0.png;
  8. the JAX package's full-size weight formats at full width and depth:
     8b. (run on phase 5b's weights, after 6b) Qwen-Image-Edit with int4
         weights and int4 modulations, quantized in place, and the int4
         cache, at grid 64: a dense and a RegionE latent edit of 5b's
         request;
     8a. (after 6a) FLUX.1 Kontext W8A8 with the int8 cache, built by the
         CLI's `build_pipeline(--int8 --act_int8)`: a dense and a RegionE
         `pipe(image, prompt)` of 6a's request; then `torch._int_mm` at
         each of its W8A8 shapes;
     each with its speedup, plan statistics, peak memory, the weights'
     bytes beside memplan's (equal), the PSNR of RegionE against dense
     (>= 30 dB) and against the bf16-weight edit of the same request;
  7. checkpoint loading at full width, depth cut to 2 double and 4 single
     blocks (Qwen 2 double; Step1X with its 2-block connector): FLUX,
     Step1X and Qwen models with their published-size VAEs written as
     diffusers-layout bf16 safetensors under build/ckpt/, loaded through
     `build_pipeline(--model_path)` (bytes, seconds, GB/s), each loaded
     edit equal to the in-memory model's bit for bit; a quantized model
     round-tripped through `checkpoint.save` / `mmdit_from_checkpoint`;
  9. the real prompt encoder: the port's synthetic Qwen2.5-VL checkpoint
     through `QwenVLPromptEncoder` on the card against the CPU, then a
     `pipe(image, prompt)` of a small Qwen topology through `--model_path`
     with that text_encoder/;
  10. the v1.2 thinker and the evaluation stack:
     10a. (after serve (a), on phase 5's weights) Step1X-Edit v1.2 through
         `edit_with_reflection` at 512 x 512 with the local Qwen2.5-VL
         thinker (the synthetic checkpoint) on the card, at most 2 tries:
         per try K1, K2 and K3 once; with `EchoThinker` and reflection off
         the image of the plain call bit for bit; the VLM's seconds beside
         the edits';
     10d. (after 8b) `pixelprobe.pixel_psnr_vs_dense` on phase 5's dense
         and RegionE latents (AutoencoderKL, 512 x 512) and 5b's (Wan,
         1024 x 1024): pixel PSNR >= 30 dB beside the latent PSNR, decode
         ms, peak memory, only the decoder on the card;
     10b. (after 6c, on 6a's pipeline) the CLI's `run_evaluation` at
         --size_level 512, vanilla and RegionE, then `run_metrics` (LPIPS
         on the card over seeded weights), `merge`, and `run_viescore`
         with the dry-run and the local Qwen2.5-VL judge: CSV PSNR against
         the PNGs', `Latency:` against the timing lists;
     10c. LPIPS on the card against the CPU at 512^2 and 1024^2 (TF32
         convs off), ms a pair;
  11. the sharded port (`parallel.sharding`; run after 7, on its Step1X
     and Qwen checkpoints) on 4 ranks, each a process of its own on the
     one card, joined by gloo through the host (NCCL refuses two ranks on
     one device); each rank reads only its slices of the files:
     11a. Qwen at grid 64 with the int8 cache on tp 4: a dense and a
         RegionE latent edit; then its RegionE edit with int4 weights on
         (dp 2, tp 2);
     11b. Step1X (with its connector) at grid 32 on (dp 2, tp 2): one
         `edit_latents_batch(mesh=)` of two requests, one per dp rank;
     11c. NCCL at world size 1: `shard_params` at tp 1 and one RegionE
         edit, bit for bit the unsharded one;
     each against the unsharded edit of the same checkpoint: equal plan
     statistics, latent PSNR >= 40 dB on every rank, each rank's weight
     bytes equal to memplan's, its launches of K1, K2 / K2q and K3.  The
     seconds are gloo's through the host, not tensor-parallel speed.
  12. (after 10a, once phase 5's weights have left the card) the measuring
     entry points, `regione_tpu_torch.bench` and `graft_entry`, on the
     headline workload: `headline.run`'s (bench.py's) step1x-edit:dev at
     grid 64, t_txt 128, best of 3, its JSON row on a line of its own
     (bench.py's keys, a partial partition with the plan's reuse count,
     latent and pixel PSNR >= 30 dB, each adaptive RegionE edit K1 > 0, K2
     > 0, K2q 0, K3 once), its dense and RegionE profiles, K1 and K2 at
     its shapes; then `profile_steps` at those shapes, `serve_batch` (B 2:
     K2q > 0, batched against single >= 40 dB), `fullsize --preset
     step1x-edit` at full width on a 32 x 32 grid, and one
     `graft_entry.entry()` step.
  13. (right after 12) the prompt encoder's placement and the JAX
     package's last scripts on the port:
     13a. `memplan.choose_placement` for Qwen / Plus / FLUX / Step1X with
         their published fp32 prompt encoders (meta-device builds) on this
         card (Qwen and Plus must offload), then the synthetic Qwen2.5-VL
         offloaded and resident against the fp32 CPU encoder;
     13b. `bench.exec_full_qwen60` at full width (60 blocks, 20.4 B int8
         weights, int8 cache) at grid 64, t_txt 512, one rank: its row,
         plan statistics, init seconds, K1, K2q and K3 launched; then K1
         and K2q at its per-rank shapes under tp 4 (6 heads) and K1 and K2
         at Step1X's under tp 2 (12 heads, grid 32), each against its
         plain version with its bound and cuDNN's time;
     13c. `bench.profile_rags` at its defaults and with `--cache-int8
         --scan-only`;
     13d. `bench.fidelity_int8` at its defaults (the formats on the card,
         the fp32 master on the CPU);
     13e. `scripts/torch_run_minibench.sh --dev`: the CLI's evaluation
         runs, `run_metrics`, `merge` and `run_viescore` on the card, in
         processes of their own started beside 13d (whose fp32 master
         holds the CPU while the card idles).
Each path's launch counts are set to 0 just before it and read just after.
The line before the last is the kernels' JSON record, the last line the
device record.  Imports no JAX and nothing of the JAX package: the port
(`regione_tpu_torch`) only.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np

from regione_tpu_torch.bench.common import (psnr, read_counts, reset_counts,
                                            structured_condition, timed_edit)
from regione_tpu_torch.models import kv_cache

T0 = time.perf_counter()
DEVICE = "cuda"


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def phase_environment():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs the port "
             "on a CUDA card and never falls back to the CPU")
    from regione_tpu_torch.ops._build import find_nvcc
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}")
    nvcc = find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    log(f"nvcc {nvcc}: {ver[-1] if ver else '?'}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device 0: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from regione_tpu_torch.ops import _build
    t = time.perf_counter()
    path, out = _build.build()
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    _build.load()
    log(f"built {path.name} from {len(_build.sources())} sources in "
        f"{time.perf_counter() - t:.2f}s")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# bf16 output of the kernel vs the plain version: both round the output to
# bf16 (up to one ulp apart, 2^-7 of the value) and round P to bf16 at
# different points (normalised vs not).  Bound: 2e-2 of the output's scale.
ATTN_REL_BOUND = 2e-2

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate outside
# the tensor cores, HBM3 bandwidth (at the full 700 W power limit)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(flops, nbytes, peak=PEAK_BF16):
    """(ms, "operations" or "bytes"): the least time the card could take
    for `flops` at `peak` and `nbytes` (each input read once, each output
    written once) at the HBM rate, whichever is larger."""
    ops_s, bytes_s = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def attention_work(b, h, t, s_fresh, s_cache=0, cache_bytes=2.0,
                   bias=True, scales=False):
    """(flops, bytes) of q [b, h, t, 128] over s_fresh bf16 K/V rows and
    s_cache cache rows of `cache_bytes` per value (int8 1, int4 0.5), with
    fp32 row scales for a quantized cache and an fp32 bias row; output
    bf16 [b, t, h * 128]."""
    d, s = 128, s_fresh + s_cache
    nbytes = (2 * b * h * t * d * 2 + 2 * b * h * s_fresh * d * 2
              + 2 * b * h * s_cache * d * cache_bytes
              + (2 * b * h * s_cache * 4 if scales else 0)
              + (b * s * 4 if bias else 0))
    return 4 * b * h * t * s * d, nbytes


def library_ms(q, k, v, bias, iters):
    """(ms, backend) of the fastest `F.scaled_dot_product_attention`
    backend that accepts q [B, H, T, D] over k/v [B, H, S, D] with the bias
    as a bf16 mask [B, 1, 1, S]: cuDNN, memory-efficient, and flash where
    there is no mask; (None, None) if none does.  A yardstick only."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
    backends = [SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    if mask is None:
        backends.append(SDPBackend.FLASH_ATTENTION)
    best = (None, None)
    for be in backends:
        try:
            with warnings.catch_warnings(), sdpa_kernel([be]):
                warnings.simplefilter("ignore")
                ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), iters)
        except RuntimeError:            # the backend refuses these inputs
            continue
        if best[0] is None or ms < best[0]:
            best = (ms, be.name)
    return best


def cuda_ms(fn, iters=5, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n):
    """Device ms per call of `fn`: n calls captured in one CUDA graph, the
    graph replayed under CUDA events (no host work between launches)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay, 5) / n


def _heads_view(rng, b, h, t, d, device):
    """[B, H, T, D] bf16 as the model makes it: a head-split view of a
    [B, T, H*D] tensor (non-contiguous, as `split_heads` returns)."""
    import torch
    x = torch.from_numpy(rng.standard_normal((b, t, h * d), np.float32))
    x = x.to(device=device, dtype=torch.bfloat16)
    return x.view(b, t, h, d).transpose(1, 2)


def _held(label, got, want, ms, pms, work=None, lib=(None, None)):
    """Error of the kernel's bf16 output against the plain version, within
    ATTN_REL_BOUND of the output's scale; `work` (flops, bytes) gives the
    bound, `lib` the library call's (ms, backend).  Logs and returns the
    record."""
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    max_abs = float(err.max())
    ok = bool(torch.isfinite(got).all()) and max_abs <= ATTN_REL_BOUND * scale
    bound_ms, bound_by = bound(*work) if work else (None, None)
    extra = ""
    if work:
        extra = (f" ({work[0] / ms / 1e9:.0f} TFLOP/s) bound {bound_ms:.3f} "
                 f"ms by {bound_by}, library "
                 + (f"{lib[0]:.3f} ms ({lib[1]})" if lib[0] else "none"))
    log(f"{label}: max_abs {max_abs:.3e} max_rel {max_abs / scale:.3e} "
        f"(bound {ATTN_REL_BOUND:.0e} x {scale:.3e}) "
        f"kernel {ms:.3f} ms plain {pms:.3f} ms{extra} "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=max_abs, ms=ms, plain_ms=pms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib[0],
                library=lib[1])


def _head_chunks(h, b, t, s):
    """Heads per piece of a plain version whose fp32 logits [b, ., t, s]
    stay under ~2 GB (at s = 8320 in one piece they would be ~13 GB)."""
    return max(1, min(h, int(2e9 // (4 * b * t * s))))


def _chunked(fn, h, chunk, *heads_args):
    """fn over head slices of its [B, H, ., D] arguments, joined on the
    [B, T, H*D] output's last dim."""
    import torch

    def run():
        outs = []
        for h0 in range(0, h, chunk):
            sl = slice(h0, h0 + chunk)
            outs.append(fn(*(a[:, sl] if a is not None and a.dim() >= 3
                             else a for a in heads_args)))
        return torch.cat(outs, dim=-1)
    return run


def check_attention(rng, b, h, t, s, with_bias, iters, kid="K1"):
    """K1 (K5 past 12,288 keys) at [b, h, t, d] over s keys; the plain
    version runs in head chunks."""
    import torch
    from regione_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    d = 128
    q = _heads_view(rng, b, h, t, d, dev)
    k = _heads_view(rng, b, h, s, d, dev)
    v = _heads_view(rng, b, h, s, d, dev)
    bias = None
    if with_bias:
        bn = np.zeros((b, s), np.float32)
        bn[:, 100:128] = -1e9                 # padded text columns
        bn[:, rng.random(s) < 0.05] = -1e30   # masked rows
        bias = torch.from_numpy(bn).to(dev)
    plain = _chunked(lambda q_, k_, v_: fa.attention_reference(q_, k_, v_,
                                                               bias),
                     h, _head_chunks(h, b, t, s), q, k, v)
    got = fa.attention(q, k, v, bias)
    want = plain()
    ms = cuda_ms(lambda: fa.attention(q, k, v, bias), iters)
    pms = cuda_ms(plain, max(1, iters // 2))
    return _held(f"{kid} attention [{b},{h},{t},{d}] x S={s} "
                 f"bias={with_bias}", got, want, ms, pms,
                 attention_work(b, h, t, s, bias=with_bias),
                 library_ms(q, k, v, bias, iters))


def _rags_bias(rng, b, t1, cap, s_cache):
    """A RAGS-style bias: pad slots and stale cache rows at -1e30."""
    import torch
    bn = np.zeros((b, t1 + s_cache), np.float32)
    n_pad = cap // 8
    bn[:, t1 - n_pad:t1] = -1e30                         # pad slots
    stale = rng.choice(s_cache // 2, cap - n_pad, replace=False)
    bn[:, t1 + stale] = -1e30                            # stale cache rows
    return torch.from_numpy(bn).to(DEVICE)


def check_rows2(rng, b, h, t_txt, cap, s_cache, iters, bits=16):
    """K2 (bits 16: bf16 cache) or K2q (bits 8 / 4: the cache quantized by
    `ops.quant` on the card): q over [fresh txt+cap rows ‖ cache] with a
    RAGS-style bias."""
    import torch
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import quant
    dev = torch.device(DEVICE)
    d = 128
    t1 = t_txt + cap
    q = _heads_view(rng, b, h, t1, d, dev)
    k1 = _heads_view(rng, b, h, t1, d, dev).contiguous()
    v1 = _heads_view(rng, b, h, t1, d, dev).contiguous()
    kc = _heads_view(rng, b, h, s_cache, d, dev).contiguous()
    vc = _heads_view(rng, b, h, s_cache, d, dev).contiguous()
    bias = _rags_bias(rng, b, t1, cap, s_cache)
    if bits == 16:
        def kernel():
            return fa.attention_rows2(q, k1, v1, kc, vc, bias)

        def plain():
            return fa.attention_rows2_reference(q, k1, v1, kc, vc, bias)
        label = "K2 rows2"
    else:
        qz = quant.quantize_kv_heads if bits == 8 else \
            quant.quantize_kv_heads4
        (kq, ks), (vq, vs) = qz(kc), qz(vc)
        # the library call's cache, dequantized beforehand (not timed)
        kc = quant.dequantize_cache(kq, ks, q.dtype)
        vc = quant.dequantize_cache(vq, vs, q.dtype)

        def kernel():
            return fa.attention_rows2(q, k1, v1, kq, vq, bias, k_scale=ks,
                                      v_scale=vs)

        def plain():
            return fa.attention_rows2_quant_reference(q, k1, v1, kq, vq, ks,
                                                      vs, bias)
        label = f"K2q rows2 int{bits}"
    got = kernel()
    want = plain()
    ms = cuda_ms(kernel, iters)
    pms = cuda_ms(plain, iters)
    # the library call attends over [fresh ‖ cache] concatenated beforehand
    # (the concatenation is not timed)
    k_all, v_all = torch.cat([k1, kc], 2), torch.cat([v1, vc], 2)
    lib = library_ms(q, k_all, v_all, bias, iters)
    del k_all, v_all, kc, vc
    return _held(f"{label} [{b},{h},{t1},{d}] x ({t1} fresh + {s_cache} "
                 "cache)", got, want, ms, pms,
                 attention_work(b, h, t1, t1, s_cache, bits / 8,
                                scales=bits != 16), lib)


def check_attention_quant(rng, b, h, t, s, bits, iters):
    """K6: q over an int8 / int4 K/V alone (quantized on the card), no
    bias; the plain version (dequantize, then K1's) runs in head chunks."""
    import torch
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import quant
    dev = torch.device(DEVICE)
    d = 128
    q = _heads_view(rng, b, h, t, d, dev)
    qz = quant.quantize_kv_heads if bits == 8 else quant.quantize_kv_heads4
    kq, ks = qz(_heads_view(rng, b, h, s, d, dev))
    vq, vs = qz(_heads_view(rng, b, h, s, d, dev))
    plain = _chunked(fa.attention_quant_reference, h,
                     _head_chunks(h, b, t, s), q, kq, vq, ks, vs)

    def kernel():
        return fa.attention(q, kq, vq, k_scale=ks, v_scale=vs)
    got = kernel()
    want = plain()
    ms = cuda_ms(kernel, iters)
    pms = cuda_ms(plain, max(1, iters // 2))
    # the library call's K/V, dequantized beforehand (not timed)
    lib = library_ms(q, quant.dequantize_cache(kq, ks, q.dtype),
                     quant.dequantize_cache(vq, vs, q.dtype), None, iters)
    return _held(f"K6 attention int{bits} [{b},{h},{t},{d}] x S={s}", got,
                 want, ms, pms,
                 attention_work(b, h, t, 0, s, bits / 8, bias=False,
                                scales=True), lib)


def launch_floor_ms(iters):
    """The launch floor, a yardstick for K3 (not a bound): CUDA-event ms of
    `torch.zeros(1).zero_()` over `iters` back-to-back calls from Python,
    and the device ms of one `zero_()` of a 1-element tensor per node of a
    CUDA graph."""
    import torch
    one = torch.zeros(1, device=DEVICE)
    return (cuda_ms(lambda: torch.zeros(1, device=DEVICE).zero_(), iters),
            graph_ms(one.zero_, iters))


def check_partition(rng, grid_h, grid_w, d, iters, batch=None):
    """K3 on a [grid_h, grid_w, d] fp32 pair, or on `batch` of them in one
    launch (each image its own edited block).  Masks must agree except at
    tokens whose fp64 similarity lies within 1e-5 of the threshold; with
    morphology, the plain morphology over the kernel's own threshold
    decisions must equal the kernel exactly; a batch's masks must equal
    each image's own B = 1 launch bit for bit."""
    import torch
    from regione_tpu_torch.ops import partition_kernel as pk
    dev = torch.device(DEVICE)
    s = grid_h * grid_w
    n = batch or 1
    thr = 0.88
    x0 = rng.standard_normal((n, s, d)).astype(np.float32)
    cond = x0 + 0.35 * rng.standard_normal((n, s, d)).astype(np.float32)
    for i in range(n):
        blk = np.zeros((grid_h, grid_w), bool)
        blk[grid_h // 8: grid_h * (4 + i) // 8,
            grid_w // 8: grid_w * (4 + i) // 8] = True
        cond[i, blk.reshape(-1)] = rng.standard_normal(
            (int(blk.sum()), d)).astype(np.float32)
    if batch is None:
        x0, cond = x0[0], cond[0]
    x0_t = torch.from_numpy(x0).to(dev)
    cond_t = torch.from_numpy(cond).to(dev)
    x64, c64 = x0.astype(np.float64), cond.astype(np.float64)
    sim = (x64 * c64).sum(-1) / np.sqrt((x64 * x64).sum(-1)
                                        * (c64 * c64).sum(-1) + 1e-12)
    near = np.abs(sim - thr) < 1e-5
    args = (x0_t, cond_t, thr, grid_h, grid_w)
    raw = pk.fused_partition(*args, False)
    full = pk.fused_partition(*args, True)
    torch.cuda.synchronize()
    raw_ref = pk.partition_reference(*args, False)
    diff = (raw != raw_ref).cpu().numpy()
    ok = not (diff & ~near).any()
    morph = pk.remove_scattered_points(raw.reshape(*raw.shape[:-1], grid_h,
                                                   grid_w))
    ok = ok and bool((morph.reshape(full.shape) == full).all())
    full_ref = pk.partition_reference(*args, True)
    n_diff = int((full_ref != full).sum())
    ok = ok and (n_diff == 0 or bool(near.any()))
    alone = ""
    if batch is not None:
        same = [torch.equal(full[i], pk.fused_partition(
            x0_t[i], cond_t[i], thr, grid_h, grid_w, True)) for i in range(n)]
        ok = ok and all(same)
        alone = (f", each image equal to its B = 1 launch "
                 f"{'yes' if all(same) else f'NO {same}'}")
    ms = cuda_ms(lambda: pk.fused_partition(*args, True), iters)
    dev_ms = graph_ms(lambda: pk.fused_partition(*args, True), iters)
    pms = cuda_ms(lambda: pk.partition_reference(*args, True), iters)
    floor, floor_dev = launch_floor_ms(iters)
    edited = full.reshape(n, s).sum(-1).tolist()
    label = f"K3 partition {grid_h}x{grid_w}x{d}" + (
        f", batch {batch} in one launch" if batch is not None else "")
    log(f"{label}: edited {edited} of {s}, raw-mask differences "
        f"{int(diff.sum())}, tokens within 1e-5 of the threshold "
        f"{int(near.sum())}, final-mask differences {n_diff}{alone}; kernel "
        f"{ms:.4f} ms a call ({dev_ms:.4f} ms on the device, CUDA graph), "
        f"plain {pms:.4f} ms {'ok' if ok else 'FAIL'}")
    # bound: two fp32 [S, d] inputs read, a bool [S] written, each image;
    # three dot products of d a token on the fp32 units.  No single
    # library call computes the partition
    bound_ms, bound_by = bound(6 * n * s * d, n * (2 * s * d * 4 + s),
                               PEAK_FP32)
    log(f"{label}: bound {bound_ms:.5f} ms by {bound_by}; launch floor "
        f"{floor:.4f} ms a call of torch.zeros(1).zero_() ({floor_dev:.4f} "
        f"ms a zero_() on the device), {iters} calls; library none")
    # max |plain - kernel| over the 0/1 final masks
    return dict(ok=ok, max_abs_err=float(n_diff > 0), ms=ms, plain_ms=pms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                library=None)


def phase_kernels(grid, qwen_grid):
    """Each kernel at the slices' shapes, ragged shapes (T, S1 and, under
    int4, S2 / 2 off the 128-row tile, B 1) included; returns the record of
    each kernel at the shape its path gives it (grid `grid`, t_txt 128; K2q
    at Qwen's grid `qwen_grid` with capacity a quarter of the grid, which
    phase 5b measures again at the capacity its partition gives)."""
    rng = np.random.default_rng(0)
    s_main = 128 + 2 * grid * grid
    cap = grid * grid // 4
    q_cap, q_cache = qwen_grid * qwen_grid // 4, 2 * qwen_grid * qwen_grid
    results, ok = {}, True
    for b, t, bias in ((2, s_main, False), (2, s_main, True), (2, 8320, False),
                       (2, 8320, True), (1, 8320 - 37, True)):
        r = check_attention(rng, b, 24, t, t, bias, iters=5)
        ok &= r["ok"]
        if t == s_main and not bias:
            results["attention"] = r
    r = check_attention(rng, 2, 28, 128, 128, False, iters=20)  # connector
    ok &= r["ok"]
    # K5: 128 txt + 3 x 4096 rows (Plus, two 64 x 64 references)
    r = check_attention(rng, 2, 24, 128 + 3 * 4096, 128 + 3 * 4096, False,
                        iters=3, kid="K5")
    ok &= r["ok"]
    results["attention_long"] = r
    for bits in (16, 8, 4):
        for t_txt, c, s_cache in ((128, q_cap, q_cache),
                                  (128, cap, 2 * grid * grid)):
            r = check_rows2(rng, 2, 24, t_txt, c, s_cache, iters=10,
                            bits=bits)
            ok &= r["ok"]
            if bits == 16 and s_cache == 2 * grid * grid:
                results["attention_rows2"] = r
            elif bits != 16 and s_cache == q_cache:
                results[f"rows2_int{bits}"] = r
    # ragged K2: 4219 fresh rows (not a multiple of 128) over 8192, B 1;
    # ragged int4 K2q: 1147 fresh rows over 8064 (4032 packed rows, each
    # nibble half ending mid-tile), B 1
    for c, s_cache, bits in ((4096 - 5, 8192, 16), (1019, 8064, 4)):
        r = check_rows2(rng, 1, 24, 128, c, s_cache, iters=10, bits=bits)
        ok &= r["ok"]
    # K6 at S 2176 (int4: 1088 packed rows, the nibble seam mid-tile), then
    # a ragged int4 one, B 1
    for b, t, s, bits in ((2, s_main, s_main, 8), (2, s_main, s_main, 4),
                          (1, 1147, 4350, 4)):
        r = check_attention_quant(rng, b, 24, t, s, bits, iters=5)
        ok &= r["ok"]
        if b == 2:
            results[f"attention_quant_int{bits}"] = r
    # K3 at the grids of 512^2 to 4096^2 images (d 64), a 768 x 1280 one
    # and a ragged one: 160 and 256 lie past the 24,576 tokens an earlier
    # one-CTA version of the kernel held
    for gh, gw in ((64, 64), (32, 32), (160, 160), (256, 256), (48, 80),
                   (37, 53)):
        r = check_partition(rng, gh, gw, 64, iters=20)
        ok &= r["ok"]
        if gh == gw == grid:
            results["fused_partition"] = r
    # K3 over a group of requests in one launch: B = 1, 2, 4 at 64 x 64 (4
    # is the last batch of 8 x 8 tiles in one wave) and phase_serve's B = 3
    # at grid 32
    for b, g in ((1, 64), (2, 64), (4, 64), (3, grid)):
        r = check_partition(rng, g, g, 64, iters=20, batch=b)
        ok &= r["ok"]
        if (b, g) == (3, grid):
            results["fused_partition_batched"] = r
    if not ok:
        fail("a kernel disagrees with its plain version")
    return results


# ---------------------------------------------------------------------------
# phase 3f: the fused block kernels K7-K9 and K11 against their plain
# versions
# ---------------------------------------------------------------------------

# the fused kernels' launch counters (`ops.fused`, `read_counts` keys); the
# last two are the MLP's gates, K9 (GELU) and K11 (SwiGLU, FLUX.2)
FUSED = ("adaln", "residual_adaln", "gated_residual", "qk_norm_rope",
         "gelu_pack", "swiglu_pack")


def fused_ok(counts) -> bool:
    """Every MMDiT forward on the card launches each fused wrapper: K7's
    three modes, K8, and one MLP gate, K9 or K11 (the double block's
    gate-only mode at least), never both."""
    gates = [counts[k] > 0 for k in FUSED[-2:]]
    return all(counts[k] > 0 for k in FUSED[:-2]) and sum(gates) == 1


def check_fused(label, kernel, plain, nbytes, flops, iters=10,
                library=(None, None), exact=False):
    """A fused kernel's bf16 output(s) against its plain version on the
    same inputs, within ATTN_REL_BOUND of the output's scale (`exact`:
    bit for bit, as `torch.equal`); kernel and
    plain ms by CUDA events (the kernel's a call from Python, and on the
    device: its calls captured in one CUDA graph); bound: `nbytes` (inputs
    read once, outputs written once) at the HBM rate or `flops` at the
    fp32 rate.  `library` (fn, name): the one PyTorch call that computes
    the same function, timed as a yardstick (its output is not checked);
    (None, None) where no single call does (AdaLN, K8, K9 with the
    concatenation)."""
    import torch
    got, want = kernel(), plain()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    torch.cuda.synchronize()
    max_abs = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    ok = all(bool(torch.isfinite(g).all()) and g.shape == w.shape
             for g, w in zip(got, want)) and max_abs <= ATTN_REL_BOUND * scale
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    ok = ok and (same or not exact)
    ms = cuda_ms(kernel, iters)
    dev_ms = graph_ms(kernel, iters)
    pms = cuda_ms(plain, iters)
    lib_ms = cuda_ms(library[0], iters) if library[0] else None
    bound_ms, bound_by = bound(flops, nbytes, PEAK_FP32)
    log(f"{label}: max_abs {max_abs:.3e} max_rel {max_abs / scale:.3e} "
        f"(bound {ATTN_REL_BOUND:.0e} x {scale:.3e}"
        + (f"; bit-equal {same}" if exact else "") + f") kernel {ms:.4f} ms a "
        f"call, {dev_ms:.4f} ms on the device (CUDA graph; "
        f"{nbytes / dev_ms / 1e6:.0f} GB/s), plain {pms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}, library "
        + (f"{lib_ms:.4f} ms ({library[1]}) " if lib_ms else "none ")
        + ("ok" if ok else "FAIL"))
    return dict(ok=ok, max_abs_err=max_abs, ms=ms, plain_ms=pms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library=library[1], graph_ms=dev_ms)


# (label, B, rows, hidden, heads, rope table per batch row, K7 too): the
# headline's single block (step1x-edit:dev, grid 64, t_txt 128), Qwen at
# grid 64 (t_txt 512, CFG batch 2), FLUX at grid 64 (B 1), a headline RAGS
# step (128 + 1024 rows, [B, cap, 128] tables), a Qwen tp 4 rank (6 heads;
# its residual stream is not sharded, so K7 there is Qwen grid 64's shape
# and is not run again) and a ragged B 1 row count
FUSED_SHAPES = (("headline", 2, 8320, 1536, 12, False, True),
                ("qwen grid 64", 2, 8704, 3072, 24, False, True),
                ("flux grid 64", 1, 8704, 3072, 24, False, True),
                ("headline rags", 2, 1152, 1536, 12, True, True),
                ("qwen tp 4 rank", 2, 8704, 3072, 6, False, False),
                ("ragged", 1, 8283, 1536, 12, False, True))


def phase_fused():
    """3f: K7 (AdaLN; residual + AdaLN; the residual alone), K8 (q and k
    of a single block from the strided linear1 split; a double block's
    image rows packed at offset t_txt; v's packing alone) and K9 (the
    single block's [attn ‖ gelu(mlp_h)] from the strided split; the
    double block's GELU alone) at FUSED_SHAPES (K7 where the entry says
    so), each against its plain version; then FLUX.2's K7 and K11
    (`check_flux2_fused`).  Returns the headline's records and FLUX.2's."""
    import torch
    import torch.nn.functional as F
    from regione_tpu_torch.models.layers import rope_table
    from regione_tpu_torch.ops import fused
    dev, bf = torch.device(DEVICE), torch.bfloat16
    rng = np.random.default_rng(15)

    def t(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(
            shape, np.float32)).to(dev, bf)
    results, ok = {}, True
    for label, b, s, h, heads, per_batch, k7 in FUSED_SHAPES:
        inner, mlp = heads * 128, 4 * heads * 128
        e = b * s                       # rows of the batch
        x = t(b, s, h, scale=2.0)
        y = t(b, s, h)
        # the modulation's strided views: chunks of [B, 1, 6h]
        shift, scale, gate = t(b, 1, 6 * h, scale=0.3).chunk(6, dim=-1)[:3]
        row = e * h * 2                 # bytes of one [B, S, h] bf16
        recs = {} if not k7 else {
            "adaln": check_fused(
                f"3f K7 adaln, {label} [{b},{s},{h}]",
                lambda: fused.adaln(x, shift, scale),
                lambda: fused.adaln_reference(x, shift, scale),
                2 * row, 12 * e * h),
            "residual_adaln": check_fused(
                f"3f K7 residual_adaln, {label} [{b},{s},{h}]",
                lambda: fused.residual_adaln(x, gate, y, shift, scale),
                lambda: (fused.gated_residual_reference(x, gate, y),
                         fused.adaln_reference(
                             fused.gated_residual_reference(x, gate, y),
                             shift, scale)),
                4 * row, 14 * e * h),
            "gated_residual": check_fused(
                f"3f K7 gated_residual, {label} [{b},{s},{h}]",
                lambda: fused.gated_residual(x, gate, y),
                lambda: fused.gated_residual_reference(x, gate, y),
                3 * row, 2 * e * h,
                library=(lambda: torch.addcmul(x, gate, y), "addcmul"))}
        # K8: q of a single block, a column slice of linear1's output
        wide = t(b, s, 3 * inner + mlp)
        q = wide[..., :inner]
        ids = torch.stack([torch.zeros(s), torch.arange(s) // 64,
                           torch.arange(s) % 64], -1).to(dev)
        rope = rope_table(ids, (16, 56, 56))
        if per_batch:
            rope = tuple(torch.stack([c, c.flip(0)][:b]) for c in rope)
        norm = (1.0 + 0.2 * torch.randn(128, generator=torch.Generator()
                                        .manual_seed(0))).to(dev, bf)
        tables = (b if per_batch else 1) * s * 128 * 4 * 2
        heads_b = e * inner * 2
        recs["qk_norm_rope"] = check_fused(
            f"3f K8 qk_norm_rope, {label}: q [{b},{s},{inner}] of the "
            f"linear1 split (row stride {wide.stride(1)})"
            + (", [B, S, 128] tables" if per_batch else ""),
            lambda: fused.qk_norm_rope(q, heads, norm, rope),
            lambda: fused.qk_norm_rope_reference(q, heads, norm, rope),
            2 * heads_b + tables, 12 * e * inner)
        # K8 at a row offset: a double block's image rows after t_txt text
        # rows of a packed [B, H, t_txt + S, 128] buffer (the tables of the
        # image rows), and v's packing alone
        t_txt = 128
        packed = torch.empty((b, heads, t_txt + s, 128), dtype=bf,
                             device=dev)
        proj = t(b, s, inner)
        r = check_fused(
            f"3f K8 qk_norm_rope, {label}: a projection's [{b},{s},{inner}]"
            f" into rows {t_txt}.. of [{b},{heads},{t_txt + s},128]",
            lambda: fused.qk_norm_rope(proj, heads, norm, rope, out=packed,
                                       row0=t_txt)[:, :, t_txt:],
            lambda: fused.qk_norm_rope_reference(proj, heads, norm, rope),
            2 * heads_b + tables, 12 * e * inner)
        ok &= r["ok"]
        r = check_fused(
            f"3f K8 v packing alone, {label}",
            lambda: fused.qk_norm_rope(proj, heads, out=packed,
                                       row0=t_txt)[:, :, t_txt:],
            lambda: fused.qk_norm_rope_reference(proj, heads),
            2 * heads_b, 0)
        ok &= r["ok"] and r["max_abs_err"] == 0.0
        # K9: [attn ‖ gelu(mlp_h)] from the split, and the GELU alone
        attn = t(b, s, inner)
        mlp_h = wide[..., 3 * inner:]
        recs["gelu_pack"] = check_fused(
            f"3f K9 gelu_pack, {label}: [{b},{s},{inner}] ‖ gelu of "
            f"[{b},{s},{mlp}] (row stride {wide.stride(1)})",
            lambda: fused.gelu_pack(attn, mlp_h),
            lambda: fused.gelu_pack_reference(attn, mlp_h),
            2 * 2 * e * (inner + mlp), 12 * e * mlp)
        r = check_fused(
            f"3f K9 gelu alone, {label}: [{b},{s},{mlp}]",
            lambda: fused.gelu_pack(None, mlp_h),
            lambda: fused.gelu_pack_reference(None, mlp_h),
            2 * 2 * e * mlp, 12 * e * mlp,
            library=(lambda: F.gelu(mlp_h, approximate="tanh"), "F.gelu"))
        ok &= r["ok"] and all(rec["ok"] for rec in recs.values())
        if label == "headline":
            results.update({f"fused_{k}": v for k, v in recs.items()})
        del x, y, wide, packed, proj, attn
    flux2 = check_flux2_fused(t)
    ok &= all(r["ok"] for r in flux2.values())
    results.update(flux2)
    if not ok:
        fail("a fused kernel disagrees with its plain version")
    return results


def check_flux2_fused(t, rows=8704, h=6144, inner=6144, mlp=18432):
    """FLUX.2 [dev]'s shapes (1024^2 edit: 512 text + 4096 noise + 4096
    reference rows): K7's three modes at [1, rows, h], the 24-chunk
    instantiation; K11 over a single block's linear1 output [1, rows, 3 *
    inner + 2 * mlp] (the gate at that row stride) with attn [1, rows,
    inner], and the gate alone over a double block's MLP input projection
    [1, 4096, 2 * mlp]; K11 bit for bit (it rounds where `F.silu(a) * b`
    does).  `t(*shape, scale)`: a seeded bf16 tensor on the card.  Returns
    the records (`fused_flux2_*`, `fused_swiglu_pack`)."""
    import torch.nn.functional as F
    from regione_tpu_torch.ops import fused
    x, y = t(1, rows, h, scale=2.0), t(1, rows, h)
    shift, scale, gate = t(1, 1, 6 * h, scale=0.3).chunk(6, dim=-1)[:3]
    row, e = rows * h * 2, rows * h
    shape = f"FLUX.2 [1,{rows},{h}]"
    recs = {
        "fused_flux2_adaln": check_fused(
            f"3f K7 adaln, {shape}",
            lambda: fused.adaln(x, shift, scale),
            lambda: fused.adaln_reference(x, shift, scale), 2 * row,
            12 * e),
        "fused_flux2_residual_adaln": check_fused(
            f"3f K7 residual_adaln, {shape}",
            lambda: fused.residual_adaln(x, gate, y, shift, scale),
            lambda: (fused.gated_residual_reference(x, gate, y),
                     fused.adaln_reference(
                         fused.gated_residual_reference(x, gate, y),
                         shift, scale)),
            4 * row, 14 * e),
        "fused_flux2_gated_residual": check_fused(
            f"3f K7 gated_residual, {shape}",
            lambda: fused.gated_residual(x, gate, y),
            lambda: fused.gated_residual_reference(x, gate, y), 3 * row,
            2 * e)}
    del x, y
    wide = t(1, rows, 3 * inner + 2 * mlp, scale=2.0)
    attn, gated = t(1, rows, inner), wide[..., 3 * inner:]
    # reads attn and both halves once, writes [attn ‖ gate]; silu(a) * b
    # is about 5 operations an output column
    recs["fused_swiglu_pack"] = check_fused(
        f"3f K11 swiglu_pack, FLUX.2 single block: [1,{rows},{inner}] ‖ "
        f"the gate of [1,{rows},{2 * mlp}] (row stride {wide.stride(1)})",
        lambda: fused.swiglu_pack(attn, gated),
        lambda: fused.swiglu_pack_reference(attn, gated),
        2 * rows * (2 * inner + 3 * mlp), 5 * rows * mlp, exact=True)
    del wide, attn, gated
    img = t(1, 4096, 2 * mlp, scale=2.0)
    a, b = img.chunk(2, dim=-1)
    recs["fused_flux2_swiglu_gate"] = check_fused(
        f"3f K11 the gate alone, FLUX.2 double block: [1,4096,{2 * mlp}]",
        lambda: fused.swiglu_pack(None, img),
        lambda: fused.swiglu_pack_reference(None, img),
        2 * 4096 * 3 * mlp, 5 * 4096 * mlp, exact=True,
        library=(lambda: F.silu(a) * b, "F.silu(a) * b"))
    return recs


# ---------------------------------------------------------------------------
# phase 3c: K10, the K/V cache's quantizer, against the eager quantizer
# ---------------------------------------------------------------------------

# (label, B, H, text rows before the image rows, image rows S, bits): Qwen's
# write forward at 1024^2 (int8, int4), a FLUX single block's image rows at
# 1024^2, a Qwen tp 4 rank's 6 heads
KV_QUANT_SHAPES = (("qwen write", 2, 24, 1392, 8192, 8),
                   ("qwen write int4", 2, 24, 1392, 8192, 4),
                   ("flux single block", 1, 24, 512, 8192, 8),
                   ("qwen tp 4 rank", 2, 6, 1392, 8192, 8))


def phase_kv_quant(iters=20):
    """3c: K10 (`ops.quant.store_quantized`) at KV_QUANT_SHAPES, from the
    image rows' strided view x[:, :, t:] of a joint [B, H, t + S, 128] bf16
    buffer into layer 1 of a two-layer cache, held bit-equal to the eager
    `quantize_kv_heads{,4}` and `copy_` into layer 0; the kernel's ms a
    call (CUDA events) and on the device (its calls in one CUDA graph), the
    eager path's ms, and the bound (x read once, codes and scales written
    once, at the HBM rate).  Returns Qwen's int8 and int4 records."""
    import torch
    from regione_tpu_torch.ops import quant
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(24)
    results, ok = {}, True
    for label, b, h, t_len, s, bits in KV_QUANT_SHAPES:
        joint = torch.randn((b, h, t_len + s, 128), generator=gen).mul_(3.0)
        x = joint.to(dev, torch.bfloat16)[:, :, t_len:]
        rows = torch.zeros((2, b, h, s // 2 if bits == 4 else s, 128),
                           dtype=torch.int8, device=dev)
        scales = torch.zeros((2, b, h, s), device=dev)
        eager = (quant.quantize_kv_heads4 if bits == 4
                 else quant.quantize_kv_heads)

        def kernel():
            quant.store_quantized(x, rows[1], scales[1], bits)

        def plain():
            r, sc = eager(x)
            rows[0].copy_(r)
            scales[0].copy_(sc)
        kernel()
        plain()
        torch.cuda.synchronize()
        max_abs = max(float((rows[1].int() - rows[0].int()).abs().max()),
                      float((scales[1] - scales[0]).abs().max()))
        equal = (torch.equal(rows[1], rows[0])
                 and torch.equal(scales[1], scales[0]))
        nbytes = x.numel() * 2 + rows[1].numel() + scales[1].numel() * 4
        ms = cuda_ms(kernel, iters)
        dev_ms = graph_ms(kernel, iters)
        pms = cuda_ms(plain, iters)
        bound_ms, bound_by = bound(4 * x.numel(), nbytes, PEAK_FP32)
        log(f"3c K10 store_quantized, {label}: int{bits} [{b},{h},{s},128] "
            f"at row {t_len} of [{b},{h},{t_len + s},128]; codes and scales "
            f"bit-equal {equal} (max abs diff {max_abs:.3e}); kernel "
            f"{ms:.4f} ms a call, {dev_ms:.4f} ms on the device (CUDA "
            f"graph; {nbytes / dev_ms / 1e6:.0f} GB/s), eager {pms:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) "
            + ("ok" if equal else "FAIL"))
        ok &= equal
        if label.startswith("qwen write"):
            results[f"kv_quant_int{bits}"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=pms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, library=None,
                graph_ms=dev_ms)
        del joint, x, rows, scales
    if not ok:
        fail("K10 disagrees with the eager quantizer")
    return results


# ---------------------------------------------------------------------------
# phases 4-6: the small reference, the slice, the profile
# ---------------------------------------------------------------------------

T_TXT = 128
PSNR_MIN = 30.0


def release():
    """Free what the last phase left on the card."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _ctx(txt, pooled, cond, rope):
    import torch
    from regione_tpu_torch.pipelines.base import EditInputs
    return EditInputs(txt=txt, cond_latent=torch.as_tensor(
        cond, dtype=torch.float32, device=txt.device), rope_img=rope[0],
        rope_txt=rope[1], pooled=pooled)


def card_vs_cpu(label, cfg, pipe_cls, re, grid, t_txt, forced,
                cond_grids=None, quant=None):
    """One forced-mask edit of a small model on the CPU in fp32 (the plain
    versions, held against the JAX package by the CPU tests) and on the
    card in bf16 (the kernels), same weights and inputs: equal stats,
    latent PSNR >= 30 dB.  `quant`: `quantize_params` flags applied to the
    CPU model, whose codes and scales the card model takes as they are
    (its other tensors in bf16).  Returns the card run's launch counts."""
    import torch
    from regione_tpu_torch.models.mmdit import MMDiT
    from regione_tpu_torch.ops.quant import quantize_params, quantized_shells
    from regione_tpu_torch.weights.from_jax import init_params
    card_cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    if cfg.connector is not None:
        card_cfg = dataclasses.replace(card_cfg, connector=dataclasses.replace(
            cfg.connector, dtype=torch.bfloat16))
    ref_model = init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    if quant is not None:
        quantize_params(ref_model, **quant)
    card_model = MMDiT(card_cfg, torch.device(DEVICE)).eval()
    quantized_shells(card_model, ref_model.state_dict())
    card_model.load_state_dict(ref_model.state_dict())
    s = grid * grid
    s_cond = sum(h * w for h, w in cond_grids) if cond_grids else s
    txt_dim = cfg.connector.in_dim if cfg.connector else cfg.txt_in_dim
    rng = np.random.default_rng(5)
    bc = 2 if pipe_cls.uses_batch_cfg else 1
    txt = rng.standard_normal((bc, t_txt, txt_dim)).astype(np.float32)
    pooled = rng.standard_normal((bc, cfg.pooled_dim)).astype(np.float32)
    cond = 0.5 * rng.standard_normal((1, s_cond, cfg.in_channels)).astype(
        np.float32)
    lat0 = rng.standard_normal((1, s, cfg.in_channels)).astype(np.float32)
    outs = []
    for model in (ref_model, card_model):
        pipe = pipe_cls(model, re)
        dev = pipe.device
        ctx = _ctx(torch.from_numpy(txt).to(dev, model.cfg.dtype),
                   torch.from_numpy(pooled).to(dev, model.cfg.dtype)
                   if cfg.pooled_dim and cfg.connector is None else None,
                   cond, pipe.build_rope(grid, grid, t_txt, cond_grids))
        if cfg.guidance_embed:
            ctx = dataclasses.replace(ctx, guidance=torch.full(
                (bc,), 2.5, device=dev))
        reset_counts()
        out, stats = pipe.edit_latents(
            torch.from_numpy(lat0).to(dev), ctx, grid, grid,
            forced_mask=torch.from_numpy(forced.reshape(-1)).to(dev))
        outs.append((out.float().cpu().numpy(), stats, read_counts()))
    (ref, s_ref, _), (got, s_got, counts) = outs
    p = psnr(ref, got)
    ok = s_ref == s_got and bool(np.isfinite(got).all()) and p >= PSNR_MIN
    log(f"small reference, {label} (head_dim 128, grid {grid}, S_kv "
        f"{s + s_cond}, forced mask): card bf16 vs CPU fp32 latent PSNR "
        f"{p:.2f} dB (min {PSNR_MIN}), stats "
        f"{'equal' if s_ref == s_got else f'{s_ref} vs {s_got}'}, card "
        f"launches {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}: the card's path disagrees with the CPU reference")
    return counts


def phase_small_reference():
    """Small head_dim-128 models, card against CPU (`card_vs_cpu`): the
    Step1X topology (bf16 cache); the Qwen topology (joint double blocks,
    txt_norm) with (a) the int8 and (b) the int4 cache; (c) Plus with two
    64 x 64 references, whose dense steps attend over 16 + 3 x 4096 keys,
    past the resident budget (K5); (d) the FLUX.2 topology with the int8
    cache (`check_flux2_small`: K11).  Then `sdpa_cached` over a quantized
    cache alone (K6).  Returns each path's card launch counts."""
    import torch
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.models.connector import ConnectorConfig
    from regione_tpu_torch.models.mmdit import MMDiTConfig
    from regione_tpu_torch.ops.flash_attention import RESIDENT_KEYS
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline, QwenImageEditPlusPipeline)
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    conn = ConnectorConfig(in_dim=64, hidden=256, heads=2, depth=1,
                           pooled_dim=32, time_embed_dim=64,
                           dtype=torch.float32)
    small = dict(hidden=256, heads=2, head_dim=128, depth_double=2,
                 time_embed_dim=64, mlp_ratio=2.0, in_channels=16,
                 out_channels=16, dtype=torch.float32)
    forced = np.zeros((8, 8), bool)
    forced[1:5, 2:7] = True
    re = RegionEParams(capacity_granularity=16)
    counts = {}
    card_vs_cpu("step1x topology, bf16 cache",
                MMDiTConfig(depth_single=2, txt_in_dim=256, pooled_dim=32,
                            connector=conn, **small),
                Step1XEditPipeline, re, 8, 16, forced)
    qwen = MMDiTConfig(depth_single=0, txt_in_dim=64, pooled_dim=0,
                       txt_norm=True, **small)
    for bits in (8, 4):
        cfg = kv_cache.with_cache_format(qwen, f"int{bits}")
        c = card_vs_cpu(f"qwen topology, int{bits} cache", cfg,
                        QwenImageEditPipeline, re, 8, 16, forced)
        if not (c["attention_rows2_quant"] > 0 and c["attention_rows2"] == 0
                and c["attention"] > 0):
            fail(f"qwen int{bits} small reference: launch counts {c}")
    counts["flux2_small"] = check_flux2_small(small, re, forced)
    # (c) Plus: noise 64 x 64 and two 64 x 64 references: dense S = 16 +
    # 12,288 keys; one attention head keeps the CPU reference short
    forced = np.zeros((64, 64), bool)
    forced[8:24, 10:30] = True
    c = card_vs_cpu("qwen-image-edit-plus, two 64x64 references, int8 "
                    "cache", kv_cache.with_cache_format(
                        dataclasses.replace(qwen, heads=1), "int8"),
                    QwenImageEditPlusPipeline,
                    RegionEParams(capacity_granularity=64), 64, 16, forced,
                    cond_grids=[(64, 64), (64, 64)])
    if not (c["attention_long"] > 0 and c["attention_rows2_quant"] > 0):
        fail(f"plus small reference: no launch past {RESIDENT_KEYS} keys "
             f"({c})")
    counts["plus"] = c
    counts.update(check_sdpa_cached_alone())
    return counts


def check_flux2_small(small, re, forced):
    """The FLUX.2 topology at phase 4's small widths (mlp ratio 3, two
    double and two single blocks), SwiGLU through K11, shared modulation,
    no biases, 4-axis ids, the int8 cache of the flux2-dev cell, card
    against CPU: its card edit's launch counts (K11, never K9)."""
    from regione_tpu_torch.models.mmdit import MMDiTConfig
    from regione_tpu_torch.pipelines.flux2 import Flux2Pipeline
    cfg = MMDiTConfig(**{**small, "mlp_ratio": 3.0}, depth_single=2,
                      txt_in_dim=64, pooled_dim=0, guidance_embed=True,
                      axes_dims=(32, 32, 32, 32), rope_theta=2000.0,
                      flux2_block=True)
    c = card_vs_cpu("flux2 topology, int8 cache",
                    kv_cache.with_cache_format(cfg, "int8"), Flux2Pipeline,
                    re, 8, 16, forced)
    if not (c["swiglu_pack"] > 0 and c["gelu_pack"] == 0 and fused_ok(c)
            and c["attention_rows2_quant"] > 0 and c["store_quantized"] > 0):
        fail(f"flux2 small reference: launch counts {c}")
    return c


def check_sdpa_cached_alone():
    """`layers.sdpa_cached(q, None, cache_k, cache_v)` over an int8 and an
    int4 cache (the JAX package's `txt_kv=None` branch, kernel K6): card
    bf16 against the CPU fp32 path on the same codes and scales, within
    ATTN_REL_BOUND.  Returns the card calls' launch counts."""
    import torch
    from regione_tpu_torch.models.layers import sdpa_cached
    from regione_tpu_torch.ops import quant
    rng = np.random.default_rng(7)
    b, h, t, s, d = 2, 2, 144, 144, 128
    q = torch.from_numpy(rng.standard_normal((b, h, t, d), np.float32))
    kv = [torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32))
          for _ in range(2)]
    counts = {}
    for bits in (8, 4):
        qz = quant.quantize_kv_heads if bits == 8 else quant.quantize_kv_heads4
        cache = [qz(x) for x in kv]
        want = sdpa_cached(q, None, *cache)
        card = [tuple(a.to(DEVICE) for a in c) for c in cache]
        reset_counts()
        got = sdpa_cached(q.to(DEVICE, torch.bfloat16), None, *card)
        counts[f"quant_int{bits}"] = read_counts()
        held = _held(f"sdpa_cached over an int{bits} cache alone "
                     f"[{b},{h},{t},{d}] x S={s} (card vs CPU fp32)", got,
                     want.to(got.device), float("nan"), float("nan"))
        if not held["ok"] or \
                counts[f"quant_int{bits}"]["attention_quant"] != 1:
            fail(f"sdpa_cached int{bits}: {counts[f'quant_int{bits}']}")
    return counts


def probe_condition(pipe, sampler, txt, pooled, rope, lat0, r, label,
                    span=7):
    """`bench.common.structured_condition` for a request of these
    embeddings and rope tables: the condition latent (numpy [1, S, C])
    under which the partition is partial (span 7: ~20% of the grid)."""
    return structured_condition(
        pipe, sampler, lambda c: _ctx(txt, pooled, c, rope), lat0, r,
        span=span, label=label, log=log)[0]


def check_edit(label, out, stats, counts, dense, shape, cache):
    """The RegionE edit's checks: finite latents of the right shape, a
    partial partition with RAGS steps, PSNR against dense, and the launch
    counts of its cache format (K2 for bf16, K2q and K10 for int8 / int4;
    K1 > 0, K3 == 1, each fused wrapper K7-K9 > 0).  Returns the PSNR."""
    p = psnr(dense, out)
    finite = bool(np.isfinite(dense).all() and np.isfinite(out).all())
    log(f"{label}: edited_tokens {stats.edited_tokens} capacity "
        f"{stats.capacity} seq_len {stats.seq_len} dense_steps "
        f"{stats.dense_steps} rags_steps {stats.rags_steps} reuse_steps "
        f"{stats.reuse_steps}; psnr_latent_vs_dense {p:.2f} dB, finite "
        f"{finite}, shape {out.shape}")
    rags, other = (("attention_rows2", "attention_rows2_quant")
                   if cache == "bf16" else
                   ("attention_rows2_quant", "attention_rows2"))
    problems = []
    if not (counts["attention"] > 0 and counts[rags] > 0
            and counts[other] == 0 and counts["fused_partition"] == 1
            and fused_ok(counts)
            and (counts["store_quantized"] > 0) == (cache != "bf16")):
        problems.append(f"launch counts {counts}")
    if not 0 < stats.edited_tokens < stats.seq_len:
        problems.append(f"partition not partial ({stats.edited_tokens})")
    if stats.rags_steps <= 0:
        problems.append("no RAGS steps")
    if not finite or out.shape != shape:
        problems.append("latents not finite or of the wrong shape")
    if not p >= PSNR_MIN:
        problems.append(f"PSNR {p:.2f} < {PSNR_MIN}")
    if problems:
        fail(f"{label}: " + "; ".join(problems))
    return p


def _request(cfg, seed, grid):
    import torch
    r = np.random.default_rng(seed)
    lat0 = torch.from_numpy(r.standard_normal(
        (1, grid * grid, cfg.in_channels), np.float32)).to(DEVICE)
    return r, lat0


def phase_slice(grid):
    """Step1X-Edit at full width and depth on the card: the dense edit and
    the RegionE edit of two requests.  Returns the kernels' launch counts
    in the timed RegionE edit (the second request), the pipeline with its
    context, and that request's dense and RegionE latents (for 10d)."""
    import torch
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.weights.from_jax import init_params

    dev = torch.device(DEVICE)
    cfg = get_config("step1x-edit")
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"step1x-edit: {n_params / 1e9:.3f} B params, {cfg.dtype} on {dev} in "
        f"{time.perf_counter() - t:.1f}s")
    re = RegionEParams(warmup_step=6, post_step=2, refresh_step=(16,),
                       threshold=0.88, cache_threshold=0.02)
    pipe = Step1XEditPipeline(model, re, true_cfg_scale=6.0)
    rng = np.random.default_rng(110)
    rope = pipe.build_rope(grid, grid, T_TXT)
    txt = torch.from_numpy(rng.standard_normal(
        (2, T_TXT, cfg.txt_in_dim), np.float32)).to(dev, cfg.dtype)
    pooled = torch.from_numpy(rng.standard_normal(
        (2, cfg.pooled_dim), np.float32)).to(dev, cfg.dtype)
    sampler = pipe.sampler_for(grid, grid, T_TXT, 2)
    runs = []
    for req, seed in enumerate((110, 111)):
        label = f"step1x request {req}"
        r, lat0 = _request(cfg, seed, grid)
        cond = probe_condition(pipe, sampler, txt, pooled, rope, lat0, r,
                               label)
        ctx = _ctx(txt, pooled, cond, rope)
        dense, _, dense_s, dense_counts, _ = timed_edit(pipe, lat0, ctx, grid,
                                                        dense_only=True)
        out, stats, regione_s, counts, peak = timed_edit(pipe, lat0, ctx,
                                                         grid)
        log(f"{label}: dense launches {dense_counts}")
        log(f"{label}: RegionE launches {counts}")
        log(f"{label}: dense_s {dense_s:.3f} regione_s {regione_s:.3f} "
            f"speedup {dense_s / regione_s:.3f}x, peak device memory "
            f"{peak:.1f} GiB")
        check_edit(label, out, stats, counts, dense,
                   (1, grid * grid, cfg.out_channels), "bf16")
        runs.append(counts)
    return runs[-1], (pipe, ctx, lat0), (dense, out)


def phase_large_grid(grid=160):
    """A card-only edit past the 24,576 tokens an earlier one-CTA K3
    held: phase 4's small Step1X topology widened to the published in /
    out channels of 64 (hidden 256, 2 heads of 128, 2 double and 2 single
    blocks, t_txt 16, random bf16 weights) at grid `grid` (a 2560 x 2560
    image: S 25,600, the dense steps over 51,216 keys), with
    `structured_condition`'s probe so the partition is partial; a dense
    and a RegionE edit through `edit_latents`, held by `check_edit` (K3
    once, a partial partition, RAGS steps, latent PSNR against dense).
    Returns the RegionE edit's launch counts."""
    import torch
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.models.connector import ConnectorConfig
    from regione_tpu_torch.models.mmdit import MMDiTConfig
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.weights.from_jax import init_params
    dev = torch.device(DEVICE)
    t_txt = 16
    conn = ConnectorConfig(in_dim=64, hidden=256, heads=2, depth=1,
                           pooled_dim=32, time_embed_dim=64,
                           dtype=torch.bfloat16)
    cfg = MMDiTConfig(hidden=256, heads=2, head_dim=128, depth_double=2,
                      depth_single=2, time_embed_dim=64, mlp_ratio=2.0,
                      in_channels=64, out_channels=64, txt_in_dim=256,
                      pooled_dim=32, connector=conn, dtype=torch.bfloat16)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    re = RegionEParams(warmup_step=6, post_step=2, refresh_step=(16,),
                       threshold=0.88, cache_threshold=0.02)
    pipe = Step1XEditPipeline(model, re, true_cfg_scale=6.0)
    rng = np.random.default_rng(160)
    rope = pipe.build_rope(grid, grid, t_txt)
    txt = torch.from_numpy(rng.standard_normal(
        (2, t_txt, conn.in_dim), np.float32)).to(dev, cfg.dtype)
    sampler = pipe.sampler_for(grid, grid, t_txt, 2)
    label = f"step1x small topology, grid {grid}"
    r, lat0 = _request(cfg, 161, grid)
    cond = probe_condition(pipe, sampler, txt, None, rope, lat0, r, label)
    ctx = _ctx(txt, None, cond, rope)
    dense, _, dense_s, dense_counts, _ = timed_edit(pipe, lat0, ctx, grid,
                                                    dense_only=True)
    out, stats, regione_s, counts, peak = timed_edit(pipe, lat0, ctx, grid)
    log(f"{label}: dense launches {dense_counts}")
    log(f"{label}: RegionE launches {counts}")
    log(f"{label}: dense_s {dense_s:.3f} regione_s {regione_s:.3f} speedup "
        f"{dense_s / regione_s:.3f}x, peak device memory {peak:.1f} GiB")
    check_edit(label, out, stats, counts, dense,
               (1, grid * grid, cfg.out_channels), "bf16")
    del pipe, model, ctx, lat0
    release()
    return counts


def phase_qwen_slice(grid, preset="qwen-image-edit"):
    """Qwen-Image-Edit at full width and depth on the card, random bf16
    weights, batch-2 CFG at scale 4 with the norm-preserving combine, the
    Qwen knobs, at grid `grid` (64: the native 1024 x 1024): one request,
    its dense edit, the int8-cache RegionE edit,
    then the int4- and the bf16-cache RegionE edits on the same weights and
    request (only the config's cache flags change); the profiles of the
    dense and the int8 RegionE edit, and of the bf16 RegionE edit (the
    control for the quantized formats); then the RAGS kernels at this
    path's shape.  Returns {cache format: launch counts}, the model (int8
    cache), the kernels' records at this path's shape and the request with
    its bf16-weight edits (lat0, ctx, dense latents, the int4-cache RegionE
    latents) for phase 8b, and the dense and int8-cache RegionE latents
    (for 10d)."""
    import torch
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.weights.from_jax import init_params

    dev = torch.device(DEVICE)
    cfg = kv_cache.with_cache_format(get_config(preset), "int8")
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{preset}: {n_params / 1e9:.3f} B params, {cfg.dtype} on {dev} in "
        f"{time.perf_counter() - t:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    re = DEFAULT_PARAMS["qwen-image-edit"]
    pipe = QwenImageEditPipeline(model, re)
    rng = np.random.default_rng(120)
    rope = pipe.build_rope(grid, grid, T_TXT)
    txt = torch.from_numpy(rng.standard_normal(
        (2, T_TXT, cfg.txt_in_dim), np.float32)).to(dev, cfg.dtype)
    sampler = pipe.sampler_for(grid, grid, T_TXT, 2)
    shape = (1, grid * grid, cfg.out_channels)
    label = f"qwen grid {grid}"
    r, lat0 = _request(cfg, 121, grid)
    cond = probe_condition(pipe, sampler, txt, None, rope, lat0, r, label)
    ctx = _ctx(txt, None, cond, rope)
    dense, _, dense_s, dense_counts, dense_peak = timed_edit(
        pipe, lat0, ctx, grid, dense_only=True)
    log(f"{label}: dense_s {dense_s:.3f}, launches {dense_counts}, peak "
        f"device memory {dense_peak:.1f} GiB")
    counts, outs, secs = {}, {}, {}
    for name in ("int8", "int4", "bf16"):
        model.cfg = kv_cache.with_cache_format(cfg, name)
        out, stats, sec, c, peak = timed_edit(
            QwenImageEditPipeline(model, re), lat0, ctx, grid)
        log(f"{label}, {name} cache: launches {c}")
        log(f"{label}, {name} cache: regione_s {sec:.3f} speedup "
            f"{dense_s / sec:.3f}x, K2q launches "
            f"{c['attention_rows2_quant']}, K2 launches "
            f"{c['attention_rows2']}, peak device memory {peak:.1f} GiB")
        check_edit(f"{label}, {name} cache", out, stats, c, dense, shape,
                   name)
        counts[name], outs[name], secs[name] = c, out, sec
    model.cfg = cfg
    log(f"{label}: regione_s by cache format: " + ", ".join(
        f"{n} {sec:.3f}" for n, sec in secs.items())
        + f"; int8 - bf16 {secs['int8'] - secs['bf16']:+.3f} s, int4 - bf16 "
        f"{secs['int4'] - secs['bf16']:+.3f} s")
    log(f"{label}, cache formats against the bf16 cache: int8 "
        f"{psnr(outs['bf16'], outs['int8']):.2f} dB, int4 "
        f"{psnr(outs['bf16'], outs['int4']):.2f} dB latent PSNR")
    phase_profile(f"{label} int8", pipe, ctx, lat0, grid)
    model.cfg = kv_cache.with_cache_format(cfg, "bf16")
    phase_profile(f"{label} bf16", QwenImageEditPipeline(model, re), ctx,
                  lat0, grid, modes=(False,))
    model.cfg = cfg
    request = (lat0, ctx, dense, outs["int4"])
    del pipe
    release()
    # K2q and K2 at this path's shape: t_txt + capacity fresh rows over the
    # 2 * grid^2-row cache, batch 2, the model's heads
    krng = np.random.default_rng(8)
    checks = {key: check_rows2(krng, 2, cfg.heads, T_TXT, stats.capacity,
                               2 * grid * grid, iters=10, bits=bits)
              for key, bits in (("rows2_int8", 8), ("rows2_int4", 4),
                                ("qwen_rows2_bf16", 16))}
    if not all(r["ok"] for r in checks.values()):
        fail("a kernel disagrees with its plain version at the Qwen shapes")
    return counts, model, checks, request, (dense, outs["int8"])


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "attention_tma_kernel" in n:
        return "attention K1/K2/K2q"
    if "partition_kernel" in n:
        return "partition K3"
    if any(k in n for k in ("fused_adaln", "fused_qk_norm_rope",
                            "fused_gelu_pack", "fused_swiglu_pack")):
        return "fused K7/K8/K9/K11 (AdaLN, qk-norm + RoPE, MLP gate)"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return "GEMM (cuBLAS)"
    if "kv_quant_store" in n:
        return "cache quantizer K10"
    return "other (eager elementwise, copies)"


def phase_profile(name, pipe, ctx, lat0, grid, modes=(True, False)):
    """Device time by kernel group over one dense and one RegionE edit
    (`modes`: dense_only of each edit profiled; `profile_run`)."""
    for dense_only in modes:
        profile_run(f"{name} {'dense' if dense_only else 'RegionE'} edit",
                    lambda: pipe.edit_latents(lat0, ctx, grid, grid,
                                              dense_only=dense_only))


def profile_run(label, run):
    """Device time by kernel group of `run()` (torch.profiler's CUDA
    trace), and the device's idle share: 1 - kernel time / host wall time
    of the run (one stream, kernels never overlap)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from regione_tpu_torch.ops._build import BUILD_DIR
    trace_dir = BUILD_DIR.parent / "profile"     # inside the checkout
    trace_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    path = str(trace_dir / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    groups, names = {}, {}
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        dur = float(ev.get("dur", 0.0)) / 1e6
        groups[_kernel_group(ev["name"])] = groups.get(
            _kernel_group(ev["name"]), 0.0) + dur
        short = ev["name"][:70]
        names[short] = names.get(short, 0.0) + dur
    busy = sum(groups.values())
    log(f"profile {label}: wall {wall:.3f}s (profiled), kernel time "
        f"{busy:.3f}s, device idle share {1 - busy / wall:.3f}")
    for g, sec in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {sec:.3f}s ({sec / busy:.3f} of kernel time)")
    for n, sec in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {sec:.3f}s {n}")


# ---------------------------------------------------------------------------
# phase 7: serving
# ---------------------------------------------------------------------------

SERVE_PSNR_MIN = 40.0


def phase_serve_latent(pipe, ctx0, grid, seeds=(110, 111, 112)):
    """Serve (a), on phase 5's Step1X-Edit weights: three requests (one
    per seed, each with `structured_condition`'s probe at its own block
    size, so the partitions are partial and their edited counts differ),
    each through `edit_latents`, then all three through
    `edit_latents_batch` twice (warm, then timed).  Each image's
    edited_tokens must equal its own edit's, at least two counts differ,
    the capacity is the largest count's bucket, the latent PSNR against
    the image's own edit >= 40 dB, K3 launches once for the group and K2
    more than zero.  Logs the seconds per image and images/s both ways,
    the peaks, the batched edit's profile, `memplan.plan`'s bytes beside
    the card's (its cache bytes must equal what `init_cache` allocates),
    and K2 at the group's RAGS shape.  Returns the timed batch's launch
    counts and K2's record."""
    import torch
    from regione_tpu_torch.core.config import pick_capacity
    from regione_tpu_torch.utils import memplan
    re, cfg = pipe.re, pipe.cfg
    s = grid * grid
    sampler = pipe.sampler_for(grid, grid, T_TXT, 2)
    rope = (ctx0.rope_img, ctx0.rope_txt)
    lats, ctxs, seq = [], [], []
    for k, seed in enumerate(seeds):
        label = f"serve (a) request {seed}"
        r, lat0 = _request(cfg, seed, grid)
        cond = probe_condition(pipe, sampler, ctx0.txt, ctx0.pooled, rope,
                               lat0, r, label, span=5 + 2 * k)
        ctx = _ctx(ctx0.txt, ctx0.pooled, cond, rope)
        out, stats, sec, counts, peak = timed_edit(pipe, lat0, ctx, grid)
        log(f"{label}: edit_latents {sec:.3f} s, edited_tokens "
            f"{stats.edited_tokens} capacity {stats.capacity}, launches "
            f"{counts}, peak device memory {peak:.2f} GiB")
        lats.append(lat0)
        ctxs.append(ctx)
        seq.append((out, stats, sec, peak))
    n = len(seeds)
    runs = []
    for name in ("warm", "timed"):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        outs, stats = pipe.edit_latents_batch(lats, ctxs, grid, grid)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        runs.append((outs, stats, sec, read_counts(),
                     torch.cuda.max_memory_allocated() / 2**30))
        log(f"serve (a) edit_latents_batch of {n} ({name}): {sec:.3f} s, "
            f"launches {runs[-1][3]}, peak device memory "
            f"{runs[-1][4]:.2f} GiB")
    outs, stats, batch_s, counts, peak = runs[-1]
    seq_s = sum(x[2] for x in seq)
    log(f"serve (a) step1x grid {grid}, {n} requests: sequential "
        f"{seq_s / n:.3f} s an image ({n / seq_s:.3f} images/s, peak "
        f"{max(x[3] for x in seq):.2f} GiB), batched {batch_s / n:.3f} s an "
        f"image ({n / batch_s:.3f} images/s, peak {peak:.2f} GiB): batched "
        f"/ sequential time {batch_s / seq_s:.3f}")
    problems = []
    edited = [st.edited_tokens for st in stats]
    want_cap = re.rags_capacity or pick_capacity(max(edited), s,
                                                 re.capacity_granularity)
    for i, (out, st) in enumerate(zip(outs, stats)):
        ref, ref_st = seq[i][0], seq[i][1]
        got = out.cpu().numpy()
        p = psnr(ref, got)
        log(f"serve (a) image {i}: edited_tokens {st.edited_tokens} (own "
            f"edit {ref_st.edited_tokens}), capacity {st.capacity} (own "
            f"{ref_st.capacity}), latent PSNR against its own edit "
            f"{p:.2f} dB (min {SERVE_PSNR_MIN})")
        if st.edited_tokens != ref_st.edited_tokens:
            problems.append(f"image {i} edited {st.edited_tokens} vs "
                            f"{ref_st.edited_tokens}")
        if not (np.isfinite(got).all() and got.shape == ref.shape
                and p >= SERVE_PSNR_MIN):
            problems.append(f"image {i}: PSNR {p:.2f}, shape {got.shape}")
    if len(set(edited)) < 2 or not all(0 < e < s for e in edited):
        problems.append(f"edited counts {edited}: not partial and distinct")
    if any(st.capacity != want_cap for st in stats):
        problems.append(f"capacity {stats[0].capacity}, bucket {want_cap}")
    if not (counts["fused_partition"] == 1 and counts["attention_rows2"] > 0
            and counts["attention"] > 0
            and counts["attention_rows2_quant"] == 0 and fused_ok(counts)):
        problems.append(f"launch counts {counts}")
    if problems:
        fail("serve (a): " + "; ".join(problems))
    profile_run(f"serve (a) step1x edit_latents_batch of {n}",
                lambda: pipe.edit_latents_batch(lats, ctxs, grid, grid))

    # memplan's budget beside the card's bytes
    plan = memplan.plan(cfg, grid=grid, t_txt=T_TXT, batch_cfg=2,
                        cache="bf16", batch=n)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cache = kv_cache.init_cache(cfg, 2 * n, 2 * s, torch.device(DEVICE))
    torch.cuda.synchronize()
    cache_bytes = torch.cuda.memory_allocated() - before
    del cache
    weights = sum(p.numel() * p.element_size()
                  for p in pipe.model.parameters())
    log(f"serve (a) memplan of the model's config, grid {grid} t_txt "
        f"{T_TXT} batch "
        f"{n}: params {plan.param_bytes} B (the model's {weights} B), cache "
        f"{plan.cache_bytes} B (init_cache allocated {cache_bytes} B), "
        f"activations {plan.activation_bytes_est} B (estimate), total "
        f"{plan.total_bytes / 2**30:.2f} GiB against a measured peak of "
        f"{peak:.2f} GiB; card total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B, "
        f"HBM_BYTES['h100'] {memplan.HBM_BYTES['h100']} B, fits "
        f"{plan.fits('h100')}")
    if plan.cache_bytes != cache_bytes or plan.param_bytes != weights:
        fail("serve (a): memplan's bytes differ from the card's")

    # K2 at this group's RAGS shape: 2n CFG rows, t_txt + capacity fresh
    # rows over the 2 * grid^2-row cache
    k2 = check_rows2(np.random.default_rng(12), 2 * n, cfg.heads, T_TXT,
                     stats[0].capacity, 2 * s, iters=10)
    if not k2["ok"]:
        fail("serve (a): K2 disagrees with its plain version at the "
             "group's shape")
    return counts, k2


def phase_serve_images(pipe, size, ref_image):
    """Serve (b), on phase 6a's FLUX.1 Kontext pipeline: three requests
    (two size x size images, one 1200 x 800: two geometry groups), after
    one untimed request warms the 1200 x 800 geometry: each prepared then
    denoised in turn (no overlap), then through `EditService.run` (the
    next request prepared meanwhile) and `run_batched(max_batch=2)`; the
    first two timed against each other say what the prefetch saves.  Each
    output is uint8 at its input geometry, the groups have sizes 2 and 1,
    the pixel PSNR of `run_batched` against `run` is >= 40 dB per request,
    and the first
    request (6a's image, prompt and seed) against 6a's own
    `pipe(image, prompt, seed=3)` too.  Logs each request's latency_s,
    prep_s, group_latency_s and stages.  Random weights leave the
    partitions degenerate (all edited): logged, not failed.  Returns
    `run_batched`'s launch counts."""
    import torch
    from regione_tpu_torch.pipelines.serve import (EditRequest, EditResult,
                                                   EditService)
    reqs = [EditRequest(image=structured_image(11, size, size),
                        prompt=PROMPT, seed=3),
            EditRequest(image=structured_image(12, size, size),
                        prompt=PROMPT, seed=4),
            EditRequest(image=structured_image(13, 800, 1200),
                        prompt=PROMPT, seed=5)]
    svc = EditService(pipe)

    def unoverlapped():
        """`run` without its prefetch: each request prepared, then
        denoised and decoded, in turn on one thread and stream."""
        out = []
        for req in reqs:
            prepared, prep_s = svc._prepare(req)
            t = time.perf_counter()
            img, stats = svc._denoise_decode(prepared)
            out.append(EditResult(image=img, stats=stats,
                                  latency_s=time.perf_counter() - t,
                                  prep_s=prep_s,
                                  stages=prepared.timer.as_dict()))
        return out

    svc.run(reqs[2:])       # warms the 1200 x 800 geometry (untimed)
    outs, secs = {}, {}
    for name, fn in (("prepare then denoise", unoverlapped),
                     ("run", lambda: svc.run(reqs)),
                     ("run_batched", lambda: svc.run_batched(reqs,
                                                             max_batch=2))):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[name] = sec = time.perf_counter() - t
        outs[name] = (res, read_counts())
        log(f"serve (b) {name}: {sec:.3f} s for {len(reqs)} requests "
            f"({len(reqs) / sec:.3f} images/s), launches {outs[name][1]}")
        for i, r in enumerate(res):
            st = r.stats
            log(f"  request {i}: latency_s {r.latency_s:.3f} prep_s "
                f"{r.prep_s:.3f} group_size {r.group_size} group_latency_s "
                + (f"{r.group_latency_s:.3f}" if r.group_latency_s else "-")
                + f" stages {({k: round(v, 3) for k, v in r.stages.items()})}"
                f" edited_tokens {st.edited_tokens} / {st.seq_len} "
                f"capacity {st.capacity} "
                f"({'partial' if 0 < st.edited_tokens < st.seq_len else 'DEGENERATE'})"
                f"; image {r.image.dtype} {r.image.shape}")
    (seq, seq_counts), (bat, counts) = outs["run"], outs["run_batched"]
    log(f"serve (b) prefetch: run {secs['run']:.3f} s against prepare then "
        f"denoise {secs['prepare then denoise']:.3f} s (run / unoverlapped "
        f"{secs['run'] / secs['prepare then denoise']:.3f}; the "
        f"preparations took {sum(r.prep_s for r in seq):.3f} s in run); "
        f"run_batched / run {secs['run_batched'] / secs['run']:.3f}")
    problems = []
    if [r.group_size for r in bat] != [2, 2, 1]:
        problems.append(f"groups {[r.group_size for r in bat]}")
    for i, (req, a, b) in enumerate(zip(reqs, seq, bat)):
        shape = np.asarray(req.image).shape
        p = pixel_psnr(a.image, b.image)
        log(f"serve (b) request {i}: run_batched vs run pixel PSNR {p:.2f} "
            f"dB (min {SERVE_PSNR_MIN}), max {int(np.abs(a.image.astype(int) - b.image).max())} levels")
        for img in (a.image, b.image):
            if img.dtype != np.uint8 or img.shape != shape:
                problems.append(f"request {i}: {img.dtype} {img.shape}")
        if not p >= SERVE_PSNR_MIN:
            problems.append(f"request {i}: PSNR {p:.2f}")
    p0 = pixel_psnr(ref_image, seq[0].image)
    log(f"serve (b) request 0 vs 6a's pipe(image, prompt, seed=3): pixel "
        f"PSNR {p0:.2f} dB, max {int(np.abs(ref_image.astype(int) - seq[0].image).max())} levels")
    if not p0 >= SERVE_PSNR_MIN:
        problems.append(f"run vs pipe(): PSNR {p0:.2f}")
    if not (seq_counts["fused_partition"] == 3 and
            counts["fused_partition"] == 2 and counts["attention"] > 0 and
            counts["attention_rows2"] > 0 and fused_ok(counts)):
        problems.append(f"launch counts {seq_counts}, {counts}")
    if problems:
        fail("serve (b): " + "; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 6: the image-level path
# ---------------------------------------------------------------------------

PROMPT = "replace the red disc with a blue square and make the sky darker"
# card against CPU fp32 for the fp32 VAEs: with TF32 convs off, fp32 summed
# in another order (1e-4 of the output's scale); on, TF32's 10-bit mantissa
# through ~30 convs, bounded where an 8-bit image could move by about two
# levels of its range (1e-2 of the scale)
VAE_BOUND = {False: 1e-4, True: 1e-2}


def structured_image(seed, h, w):
    """A seeded RGB uint8 test image: smooth colour fields, a few flat
    discs and boxes, mild noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx + 1), 0.5 + 0.4 * np.cos(5 * yy),
                    0.5 + 0.3 * np.sin(4 * (xx + yy))], -1)
    for k in range(6):
        cy, cx, rad = r.uniform(0.15, 0.85), r.uniform(0.15, 0.85), \
            r.uniform(0.05, 0.15)
        shape = ((yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2 if k % 2 == 0 else
                 (abs(yy - cy) < rad) & (abs(xx - cx) < rad))
        img[shape] = r.uniform(0, 1, 3)
    img += 0.02 * r.standard_normal(img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def pixel_psnr(a, b) -> float:
    """PSNR of uint8 image b against a, peak 255."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _image_tensor(img, device):
    import torch
    x = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)
    return x.permute(2, 0, 1)[None].to(device)


def vae_times(vae, size, iters=3):
    """CUDA-event ms of one encode at size x size pixels and one decode
    of its latents."""
    import torch
    x = _image_tensor(structured_image(9, size, size), DEVICE)
    with torch.inference_mode():
        z = vae.encode(x)
        enc = cuda_ms(lambda: vae.encode(x), iters)
        dec = cuda_ms(lambda: vae.decode(z), iters)
    return enc, dec


def phase_vae_card_vs_cpu(sizes=(("AutoencoderKL", 1024), ("Wan", 512)),
                          small=64):
    """6d: each VAE family at its published widths, random fp32 weights:
    encode and decode on the card against the port's CPU path at
    small x small pixels, with cuDNN TF32 convs off and on (torch's
    default), within VAE_BOUND; and each setting's encode / decode ms at
    full size.  Leaves TF32 convs on for the image phases."""
    import torch
    from regione_tpu_torch.models.vae import VAEConfig, vae_module
    from regione_tpu_torch.models.vae_wan import WanVAEConfig
    from regione_tpu_torch.weights.from_jax import init_vae_params
    cfgs = {"AutoencoderKL": VAEConfig(), "Wan": WanVAEConfig()}
    ok = True
    for family, size in sizes:
        cfg = cfgs[family]
        cpu = init_vae_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
        card = vae_module(cfg)(cfg, torch.device(DEVICE)).eval()
        card.load_state_dict(cpu.state_dict())
        n = sum(p.numel() for p in cpu.parameters())
        x = _image_tensor(structured_image(4, small, small), "cpu")
        with torch.inference_mode():
            z_ref = cpu.encode(x)
            img_ref = cpu.decode(z_ref)
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.inference_mode():
                z = card.encode(x.to(DEVICE)).cpu()
                img = card.decode(z_ref.to(DEVICE)).cpu()
            errs = [float((got - want).abs().max() / want.abs().max())
                    for got, want in ((z, z_ref), (img, img_ref))]
            good = max(errs) <= VAE_BOUND[tf32]
            ok &= good
            enc, dec = vae_times(card, size)
            log(f"6d {family} ({n / 1e6:.1f} M params, fp32), cudnn TF32 "
                f"{tf32}: card vs CPU at {small}x{small}: encode "
                f"{errs[0]:.2e}, decode {errs[1]:.2e} of the output scale "
                f"(bound {VAE_BOUND[tf32]:.0e}) {'ok' if good else 'FAIL'}; "
                f"at {size}x{size}: encode {enc:.2f} ms, decode {dec:.2f} ms")
        del cpu, card
        release()
    torch.backends.cudnn.allow_tf32 = True
    log(f"cudnn allow_tf32 {torch.backends.cudnn.allow_tf32} (torch's "
        f"default) for the image phases")
    if not ok:
        fail("a VAE on the card disagrees with its CPU path")


def timed_call(pipe, image, **kw):
    """One `pipe(image, PROMPT)`, host wall time ended by a synchronize,
    launch counts set to 0 just before and read just after, the call's peak
    device memory.  Returns (image, stats, seconds, counts, peak GiB)."""
    import torch
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out, stats = pipe(image, PROMPT, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    return (out, stats, sec, read_counts(),
            torch.cuda.max_memory_allocated() / 2**30)


def check_image(label, out, stats, counts, shape, rags):
    """An image-level RegionE edit's checks: uint8 of the caller's geometry
    (a float image: finite, in [0, 1]); K1 > 0, K3 == 1, the RAGS kernel of
    its cache format > 0 and the other 0.  A degenerate partition (none or
    all edited, possible with random weights) is logged, not failed."""
    problems = []
    if out.shape != shape:
        problems.append(f"shape {out.shape}, expected {shape}")
    if out.dtype != np.uint8 and not (np.isfinite(out).all() and
                                      0.0 <= out.min() <= out.max() <= 1.0):
        problems.append("image not finite in [0, 1]")
    other = ("attention_rows2" if rags == "attention_rows2_quant"
             else "attention_rows2_quant")
    if not (counts["attention"] > 0 and counts["fused_partition"] == 1
            and counts[rags] > 0 and counts[other] == 0 and fused_ok(counts)):
        problems.append(f"launch counts {counts}")
    partial = 0 < stats.edited_tokens < stats.seq_len
    log(f"{label}: edited_tokens {stats.edited_tokens} capacity "
        f"{stats.capacity} seq_len {stats.seq_len} dense_steps "
        f"{stats.dense_steps} rags_steps {stats.rags_steps} reuse_steps "
        f"{stats.reuse_steps} ({'partial' if partial else 'DEGENERATE'} "
        f"partition); launches {counts}; output {out.dtype} {out.shape}")
    if problems:
        fail(f"{label}: " + "; ".join(problems))


def phase_qwen_image(model, size=512, vae_cfg=None):
    """6b: Qwen-Image-Edit through `__call__` on the phase-5b weights (int8
    cache), with the published-size Wan VAE (random fp32 weights) and the
    port's MockTextEncoder: one RegionE edit at size x size."""
    import torch
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.models.text_encoders import MockTextEncoder
    from regione_tpu_torch.models.vae_wan import WanVAEConfig
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.weights.from_jax import init_vae_params
    dev = torch.device(DEVICE)
    vae = init_vae_params(vae_cfg or WanVAEConfig(),
                          torch.Generator(dev).manual_seed(2), dev)
    pipe = QwenImageEditPipeline(model, DEFAULT_PARAMS["qwen-image-edit"])
    pipe.attach_vae(vae).attach_text_encoder(
        MockTextEncoder(model.cfg.txt_in_dim, None, max_length=T_TXT))
    image = structured_image(21, 600, 480)
    out, stats, sec, counts, peak = timed_call(
        pipe, image, width=size, height=size, seed=7, output_type="uint8")
    enc, dec = vae_times(vae, size)
    log(f"6b qwen-image-edit __call__ ({image.shape[1]}x{image.shape[0]} in, "
        f"{size}x{size} explicit, int8 cache, Wan VAE): {sec:.3f} s end to "
        f"end, peak device memory {peak:.1f} GiB; Wan encode {enc:.2f} ms, "
        f"decode {dec:.2f} ms at {size}x{size}")
    check_image("6b qwen image", out, stats, counts, (size, size, 3),
                "attention_rows2_quant")
    del pipe, vae
    release()
    return counts


def phase_flux_image(preset="flux-kontext", vae_cfg=None, size=900,
                     te=None, eval_size=512):
    """6a, serve (b), 6c and 10b: FLUX.1 Kontext at full width through the
    image-level entry points.  The CLI's `build_pipeline` builds the
    backbone (random bf16 weights from --seed); 6a edits with it through a
    `FluxKontextPipeline` holding the published-size AutoencoderKL, and
    serve (b) serves three requests on that pipeline
    (`phase_serve_images`); 6c runs the CLI's `run_demo` on the CLI's own
    pipeline; 10b (`phase_eval_chain`, with the VLM checkpoint `te`) runs
    the evaluation stack on 6a's pipeline.  Returns the launch counts of
    the timed RegionE call, of serve (b)'s `run_batched`, of the CLI edit
    and of 10b's RegionE run, the kernel checks at this path's shapes, and
    6a's timed RegionE image (uint8, for 8a)."""
    import torch
    from PIL import Image

    from regione_tpu_torch.api import RegionEHelper
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.models.text_encoders import MockTextEncoder
    from regione_tpu_torch.cli import main as cli
    from regione_tpu_torch.models.vae import VAEConfig
    from regione_tpu_torch.ops._build import BUILD_DIR
    from regione_tpu_torch.pipelines.flux_kontext import FluxKontextPipeline
    from regione_tpu_torch.weights.from_jax import init_vae_params

    dev = torch.device(DEVICE)
    out_dir = BUILD_DIR.parent / "image_phase"      # inside the checkout
    out_dir.mkdir(parents=True, exist_ok=True)
    image = structured_image(11, size, size)
    cli.save_png(out_dir / "input.png", image)
    args = cli.make_parser().parse_args([
        "--backend", "flux-kontext", "--preset", preset, "--random_weights",
        "--use_regione", "--device", DEVICE, "--image_path",
        str(out_dir / "input.png"), "--prompt", PROMPT, "--output_dir",
        str(out_dir)])
    t = time.perf_counter()
    cli_pipe = cli.build_pipeline(args)
    torch.cuda.synchronize()
    model = cli_pipe.model
    cfg = model.cfg
    log(f"{preset}: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"params, {cfg.dtype} on {dev}, guidance_embed {cfg.guidance_embed}, "
        f"built by the CLI in {time.perf_counter() - t:.1f}s")

    vae_cfg = vae_cfg or VAEConfig()
    vae = init_vae_params(vae_cfg, torch.Generator(dev).manual_seed(1), dev)
    pipe = FluxKontextPipeline(model, DEFAULT_PARAMS["flux-kontext"])
    pipe.attach_vae(vae).attach_text_encoder(
        MockTextEncoder(cfg.txt_in_dim, cfg.pooled_dim, max_length=T_TXT))
    helper = RegionEHelper(pipe).enable()
    width, height = pipe.target_resolution(size, size)
    grid = height // pipe.token_factor
    t = time.perf_counter()
    ctx, _ = pipe.prepare_inputs(image, PROMPT)
    torch.cuda.synchronize()
    log(f"6a flux-kontext: {size}x{size} input snapped to {width}x{height}, "
        f"grid {grid}x{width // pipe.token_factor}, S_kv "
        f"{ctx.rope_img[0].shape[0]} + t_txt {ctx.txt.shape[1]}; prepare_inputs (host resize, VAE "
        f"encode, prompt) {time.perf_counter() - t:.3f} s")
    shape = (size, size, 3)
    runs = {}
    for name, kw in (("regione 0", dict(output_type="np")),
                     ("regione 1", dict(output_type="uint8")),
                     ("dense", dict(output_type="uint8"))):
        if name == "dense":
            helper.disable()
        runs[name] = timed_call(pipe, image, seed=3, **kw)
        out, stats, sec, counts, peak = runs[name]
        log(f"6a flux {name}: {sec:.3f} s end to end, peak device memory "
            f"{peak:.1f} GiB, launches {counts}")
        if stats is not None:
            check_image(f"6a flux {name}", out, stats, counts, shape,
                        "attention_rows2")
    dense, _, dense_s, dense_counts, _ = runs["dense"]
    out, stats, regione_s, counts, peak = runs["regione 1"]
    if dense_counts["fused_partition"] or dense_counts["attention_rows2"]:
        fail(f"6a: the disabled helper did not run the dense path "
             f"({dense_counts})")
    enc, dec = vae_times(vae, width)
    first = (runs["regione 0"][0] * 255).round().astype(np.uint8)
    log(f"6a flux image: dense_s {dense_s:.3f} regione_s {regione_s:.3f} "
        f"speedup {dense_s / regione_s:.3f}x, pixel PSNR RegionE vs dense "
        f"{pixel_psnr(dense, out):.2f} dB (uint8, peak 255), RegionE calls 0 "
        f"and 1 differ by at most {int(np.abs(first.astype(int) - out).max())}"
        f" levels; AutoencoderKL encode {enc:.2f} ms, decode {dec:.2f} ms at "
        f"{width}x{height}; peak device memory {peak:.1f} GiB")

    # serve (b): EditService on this pipeline, its first request 6a's
    paths = {"serve_images": phase_serve_images(pipe, size, out)}

    # the denoise alone (the image call less prepare_inputs and the VAE
    # decode), profiled
    helper.enable()
    lat0 = pipe.initial_latents(3, (1, grid * grid, cfg.in_channels))
    phase_profile("flux", pipe, ctx, lat0, grid)

    # the kernels at this path's shapes: dense K1 over S_kv + t_txt rows
    # with the text bias, RAGS K2 over t_txt + capacity fresh rows and the
    # S_kv-row cache, K3 on the grid
    rng = np.random.default_rng(6)
    s_kv, t_txt = ctx.rope_img[0].shape[0], ctx.txt.shape[1]
    del ctx, runs, lat0
    release()
    checks = {
        "attention": check_attention(rng, 1, cfg.heads, s_kv + t_txt,
                                     s_kv + t_txt, True, iters=5),
        "attention_rows2": check_rows2(rng, 1, cfg.heads, t_txt,
                                       stats.capacity, s_kv, iters=10),
        "fused_partition": check_partition(rng, grid, grid, cfg.in_channels,
                                           iters=20)}
    if not all(r["ok"] for r in checks.values()):
        fail("a kernel disagrees with its plain version at the FLUX shapes")

    # 6c: the CLI's own demo path on the CLI's pipeline
    reset_counts()
    t = time.perf_counter()
    cli.run_demo(cli_pipe, args)
    cli_counts = read_counts()
    written = np.asarray(Image.open(out_dir / "demo_0.png"))
    log(f"6c CLI run_demo: {time.perf_counter() - t:.3f} s, wrote "
        f"{out_dir / 'demo_0.png'} {written.dtype} {written.shape}, launches "
        f"{cli_counts}")
    if written.shape != shape or cli_counts["fused_partition"] != 1 or \
            cli_counts["attention"] == 0 or cli_counts["attention_rows2"] == 0:
        fail(f"6c: CLI output {written.shape} or launches {cli_counts}")
    paths.update(flux_image=counts, cli=cli_counts)

    # 10b: the evaluation stack on 6a's pipeline
    t = time.perf_counter()
    paths["eval_chain"] = phase_eval_chain(pipe, helper, te, eval_size)
    log(f"phase 10b (eval chain: CLI generation, metrics, merge, VIEScore) "
        f"done in {time.perf_counter() - t:.1f}s")
    return paths, checks, out


# ---------------------------------------------------------------------------
# phase 4q: the quantized weight formats, small, card against CPU
# ---------------------------------------------------------------------------

# the weight formats of the JAX package's full-size records: the flags of
# `quantize_params` and `MMDiTConfig.act_int8`
WEIGHT_FORMATS = {
    "int8": (dict(), False),
    "w8a8": (dict(quantize_mods=True), True),
    "int4": (dict(quantize_mods=True, bits=4, int4_mods=True), False),
}
# (M, K, N) of the card's `layers.int_mm` calls, by path (`record_int_mm`)
INT_MM_SHAPES: dict[str, set] = {}


def record_int_mm(path: str):
    """From here on, record under `path` the (M, K, N) of every
    `layers.int_mm` call on the card: the W8A8 shapes that path runs."""
    from regione_tpu_torch.models import layers
    inner = getattr(layers.int_mm, "inner", layers.int_mm)
    shapes = INT_MM_SHAPES.setdefault(path, set())

    def recording(x8, w_q):
        if x8.is_cuda:
            shapes.add((x8.numel() // x8.shape[-1], x8.shape[-1],
                        w_q.shape[0]))
        return inner(x8, w_q)

    recording.inner = inner
    layers.int_mm = recording


def check_int_mm(label, shapes, rows=16):
    """`layers.int_mm` (torch._int_mm; fewer than 17 rows padded) on the
    card at each (M, K, N), random int8 codes, bit for bit: every row
    against an exact product on the card (fp32 GEMMs, TF32 off, over K
    chunks of 1024, so every partial sum of int8 products stays below 2^24
    and is exact) and `rows` rows against the CPU's int32 product; beside
    each, its time and a bf16 GEMM's of the same shape (CUDA events)."""
    import torch
    from regione_tpu_torch.models import layers
    int_mm = getattr(layers.int_mm, "inner", layers.int_mm)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEVICE).manual_seed(9)
    ok = True
    for m, k, n in sorted(shapes):
        a, w = (torch.randint(-127, 128, shape, generator=g, device=DEVICE,
                              dtype=torch.int8) for shape in ((m, k), (n, k)))
        got = int_mm(a, w)
        exact = torch.zeros((m, n), dtype=torch.int32, device=DEVICE)
        for k0 in range(0, k, 1024):
            exact += (a[:, k0:k0 + 1024].float()
                      @ w[:, k0:k0 + 1024].float().t()).to(torch.int32)
        idx = torch.linspace(0, m - 1, min(m, rows), device=DEVICE).long()
        cpu = int_mm(a[idx].cpu(), w.cpu())
        good = torch.equal(got, exact) and torch.equal(got[idx].cpu(), cpu)
        ok &= good
        ab, wb = a.bfloat16(), w.bfloat16()
        ms = cuda_ms(lambda: int_mm(a, w), iters=5)
        bf = cuda_ms(lambda: ab @ wb.t(), iters=5)
        log(f"{label}: int_mm [{m},{k}] x [{k},{n}]{' (padded to 17 rows)' if m < 17 else ''} "
            f"{'equal' if good else 'DIFFERENT'} to the exact product on "
            f"the card and to the CPU's int32 product ({min(m, rows)} rows); "
            f"{ms:.3f} ms, a bf16 GEMM {bf:.3f} ms")
        del a, w, ab, wb, got, exact
    if not ok:
        fail(f"{label}: torch._int_mm on the card is not the exact int32 "
             f"product")


def phase_small_quantized():
    """4q: phase 4's two-block head_dim-128 topologies, Step1X (with its
    connector), FLUX (guidance embed, pooled vector) and Qwen (txt_norm), at
    hidden 512 (4 heads of 128, so the projections reach the 512-wide
    reduction int4 takes), each in the three weight formats of
    WEIGHT_FORMATS (int8 weight-only, W8A8 with the modulations, int4 with
    int4 modulations): card bf16 against CPU fp32 on the same
    `quantize_params` codes (`card_vs_cpu`); then `int_mm` at every W8A8
    shape these edits ran on the card.  Returns the card runs' launch
    counts."""
    import torch
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.models.connector import ConnectorConfig
    from regione_tpu_torch.models.mmdit import MMDiTConfig
    from regione_tpu_torch.pipelines.flux_kontext import FluxKontextPipeline
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    record_int_mm("4q")
    small = dict(hidden=512, heads=4, head_dim=128, depth_double=2,
                 time_embed_dim=64, mlp_ratio=2.0, in_channels=16,
                 out_channels=16, dtype=torch.float32)
    conn = ConnectorConfig(in_dim=64, hidden=512, heads=4, depth=1,
                           pooled_dim=32, time_embed_dim=64,
                           dtype=torch.float32)
    topologies = {
        "step1x": (MMDiTConfig(depth_single=2, txt_in_dim=512, pooled_dim=32,
                               connector=conn, **small), Step1XEditPipeline),
        "flux": (MMDiTConfig(depth_single=2, txt_in_dim=64, pooled_dim=32,
                             guidance_embed=True, **small),
                 FluxKontextPipeline),
        "qwen": (MMDiTConfig(depth_single=0, txt_in_dim=64, pooled_dim=0,
                             txt_norm=True, **small), QwenImageEditPipeline),
    }
    forced = np.zeros((8, 8), bool)
    forced[1:5, 2:7] = True
    re = RegionEParams(capacity_granularity=16)
    counts = {}
    for topo, (cfg, pipe_cls) in topologies.items():
        for fmt, (flags, act) in WEIGHT_FORMATS.items():
            c = card_vs_cpu(f"4q {topo} topology, {fmt} weights",
                            dataclasses.replace(cfg, act_int8=act), pipe_cls,
                            re, 8, 16, forced, quant=flags)
            if not (c["attention"] > 0 and c["attention_rows2"] > 0):
                fail(f"4q {topo} {fmt}: launch counts {c}")
            counts[f"{topo}_{fmt}"] = c
    check_int_mm("4q", INT_MM_SHAPES["4q"])
    return counts


# ---------------------------------------------------------------------------
# phase 7: checkpoint loading at full width
# ---------------------------------------------------------------------------

def diffusers_transformer_state(model, naming: str) -> dict:
    """The port's MMDiT state dict under diffusers' tensor names, the
    inverse of `weights.convert`: naming "flux" (FluxTransformer2DModel),
    "step1x" (its time_embed / vec_embed embedders and the connector, whose
    q / k / v are one fused self_attn_qkv) or "qwen"
    (QwenImageTransformer2DModel's img_in / txt_in / img_mod.1 / img_mlp
    ...)."""
    import torch
    sd, cfg, out = model.state_dict(), model.cfg, {}
    q = naming == "qwen"

    def lin(src, dst):
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    def embed(src, dst):
        lin(f"{src}.in_", f"{dst}.linear_1")
        lin(f"{src}.out", f"{dst}.linear_2")

    step1x = naming == "step1x"
    lin("x_embedder", "img_in" if q else "x_embedder")
    lin("txt_in", "txt_in" if q else "context_embedder")
    if cfg.txt_norm:
        out["txt_norm.weight"] = sd["txt_norm.scale"]
    embed("time_in", "time_embed" if step1x
          else "time_text_embed.timestep_embedder")
    if cfg.pooled_dim:
        embed("vector_in", "vec_embed" if step1x
              else "time_text_embed.text_embedder")
    if cfg.guidance_embed:
        embed("guidance_in", "time_text_embed.guidance_embedder")
    lin("final_proj", "proj_out")
    for leaf in ("weight", "bias"):     # [shift, scale] -> [scale, shift]
        t = sd[f"final_mod.{leaf}"]
        out[f"norm_out.linear.{leaf}"] = torch.cat(
            [t[t.shape[0] // 2:], t[:t.shape[0] // 2]])
    attn = {"img_attn": ("to_q", "to_k", "to_v", "to_out.0", "norm_q",
                         "norm_k"),
            "txt_attn": ("add_q_proj", "add_k_proj", "add_v_proj",
                         "to_add_out", "norm_added_q", "norm_added_k")}
    for i in range(cfg.depth_double):
        s, d = f"double_blocks.{i}", f"transformer_blocks.{i}"
        lin(f"{s}.img_mod", f"{d}.img_mod.1" if q else f"{d}.norm1.linear")
        lin(f"{s}.txt_mod",
            f"{d}.txt_mod.1" if q else f"{d}.norm1_context.linear")
        for stream, names in attn.items():
            for name, n in zip(("q", "k", "v", "out"), names):
                lin(f"{s}.{stream}.{name}", f"{d}.attn.{n}")
            out[f"{d}.attn.{names[4]}.weight"] = sd[
                f"{s}.{stream}.norm_q.scale"]
            out[f"{d}.attn.{names[5]}.weight"] = sd[
                f"{s}.{stream}.norm_k.scale"]
        for stream, n in (("img_mlp", "img_mlp" if q else "ff"),
                          ("txt_mlp", "txt_mlp" if q else "ff_context")):
            lin(f"{s}.{stream}.in_", f"{d}.{n}.net.0.proj")
            lin(f"{s}.{stream}.out", f"{d}.{n}.net.2")
    inner = cfg.inner
    for i in range(cfg.depth_single):
        s, d = f"single_blocks.{i}", f"single_transformer_blocks.{i}"
        lin(f"{s}.mod", f"{d}.norm.linear")
        for leaf in ("weight", "bias"):
            t = sd[f"{s}.linear1.{leaf}"]
            for k, n in enumerate(("attn.to_q", "attn.to_k", "attn.to_v")):
                out[f"{d}.{n}.{leaf}"] = t[k * inner:(k + 1) * inner]
            out[f"{d}.proj_mlp.{leaf}"] = t[3 * inner:]
        lin(f"{s}.linear2", f"{d}.proj_out")
        out[f"{d}.attn.norm_q.weight"] = sd[f"{s}.norm_q.scale"]
        out[f"{d}.attn.norm_k.weight"] = sd[f"{s}.norm_k.scale"]
    if cfg.connector is not None:
        c = "connector."
        lin("connector.in_proj", f"{c}S.input_embedder")
        lin("connector.t_embed.in_", f"{c}S.t_embedder.mlp.0")
        lin("connector.t_embed.out", f"{c}S.t_embedder.mlp.2")
        embed("connector.c_embed", f"{c}S.c_embedder")
        lin("connector.global_proj", f"{c}global_proj_out")
        out[f"{c}scale_factor"] = sd["connector.scale_factor"]
        for i in range(cfg.connector.depth):
            s = f"connector.blocks.{i}"
            d = f"{c}S.individual_token_refiner.blocks.{i}"
            for n in ("norm1", "norm2"):
                out[f"{d}.{n}.weight"] = sd[f"{s}.{n}.scale"]
                out[f"{d}.{n}.bias"] = sd[f"{s}.{n}.bias"]
            for leaf in ("weight", "bias"):
                out[f"{d}.self_attn_qkv.{leaf}"] = torch.cat(
                    [sd[f"{s}.attn.{x}.{leaf}"] for x in "qkv"])
            lin(f"{s}.attn.out", f"{d}.self_attn_proj")
            lin(f"{s}.mlp.in_", f"{d}.mlp.fc1")
            lin(f"{s}.mlp.out", f"{d}.mlp.fc2")
            lin(f"{s}.mod", f"{d}.adaLN_modulation.1")
    return out


def diffusers_vae_state(vae) -> tuple[dict, dict]:
    """The port's VAE under diffusers' names and its config.json, the
    inverse of `weights.convert`: AutoencoderKL, or AutoencoderKLWan (each
    2-D kernel becomes a causal 3-D one whose last time tap it is, zeros
    before; the down / up blocks one flattened list of residual and
    resample blocks)."""
    import torch
    from regione_tpu_torch.models.vae_wan import WanVAEConfig
    sd, cfg, out = vae.state_dict(), vae.cfg, {}
    wan = isinstance(cfg, WanVAEConfig)

    def conv(s, d):
        w = sd[f"{s}.weight"]
        if wan and not s.endswith(("downsample", "upsample")):
            w3 = w.new_zeros(w.shape[:2] + (w.shape[-1],) + w.shape[2:])
            w3[:, :, -1] = w
            w = w3
        out[f"{d}.weight"], out[f"{d}.bias"] = w, sd[f"{s}.bias"]

    def norm(s, d):
        if wan:
            out[f"{d}.gamma"] = sd[f"{s}.gamma"].reshape(-1, 1, 1, 1)
        else:
            out[f"{d}.weight"], out[f"{d}.bias"] = sd[f"{s}.scale"], \
                sd[f"{s}.bias"]

    def resnet(s, d):
        norm(f"{s}.norm1", f"{d}.norm1")
        conv(f"{s}.conv1", f"{d}.conv1")
        norm(f"{s}.norm2", f"{d}.norm2")
        conv(f"{s}.conv2", f"{d}.conv2")
        if f"{s}.shortcut.weight" in sd:
            conv(f"{s}.shortcut", f"{d}.conv_shortcut")

    def mid(s, d):
        resnet(f"{s}.res1", f"{d}.resnets.0")
        a = f"{d}.attentions.0"
        if wan:
            norm(f"{s}.attn.norm", f"{a}.norm")
            for name, n in (("qkv", "to_qkv"), ("proj", "proj")):
                out[f"{a}.{n}.weight"] = sd[f"{s}.attn.{name}.weight"][
                    :, :, None, None]
                out[f"{a}.{n}.bias"] = sd[f"{s}.attn.{name}.bias"]
        else:
            norm(f"{s}.attn.norm", f"{a}.group_norm")
            for name, n in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                            ("out", "to_out.0")):
                out[f"{a}.{n}.weight"] = sd[f"{s}.attn.{name}.weight"]
                out[f"{a}.{n}.bias"] = sd[f"{s}.attn.{name}.bias"]
        resnet(f"{s}.res2", f"{d}.resnets.1")

    for part in ("encoder", "decoder"):
        lv, res = (("down", "downsample") if part == "encoder"
                   else ("up", "upsample"))
        conv(f"{part}.conv_in", f"{part}.conv_in")
        conv(f"{part}.conv_out", f"{part}.conv_out")
        mid(f"{part}.mid", f"{part}.mid_block")
        if wan:
            norm(f"{part}.norm_out", f"{part}.norm_out")
            n_res = cfg.num_res_blocks + (part == "decoder")
            idx = 0
            for i in range(len(cfg.dim_mult)):
                for j in range(n_res):
                    resnet(f"{part}.{lv}.{i}.resnets.{j}",
                           f"{part}.{lv}_blocks.{idx}")
                    idx += 1
                if f"{part}.{lv}.{i}.{res}.weight" in sd:
                    conv(f"{part}.{lv}.{i}.{res}",
                         f"{part}.{lv}_blocks.{idx}.resample.1")
                    idx += 1
        else:
            norm(f"{part}.norm_out", f"{part}.conv_norm_out")
            n_res = cfg.layers_per_block + (part == "decoder")
            for i in range(len(cfg.block_out_channels)):
                for j in range(n_res):
                    resnet(f"{part}.{lv}.{i}.resnets.{j}",
                           f"{part}.{lv}_blocks.{i}.resnets.{j}")
                if f"{part}.{lv}.{i}.{res}.weight" in sd:
                    conv(f"{part}.{lv}.{i}.{res}",
                         f"{part}.{lv}_blocks.{i}.{lv}samplers.0.conv")
    if wan:
        conv("encoder.quant_conv", "quant_conv")
        conv("decoder.post_quant_conv", "post_quant_conv")
        config = {"_class_name": "AutoencoderKLWan",
                  "z_dim": cfg.latent_channels, "base_dim": cfg.base_dim,
                  "dim_mult": list(cfg.dim_mult),
                  "num_res_blocks": cfg.num_res_blocks,
                  "latents_mean": list(cfg.latents_mean),
                  "latents_std": list(cfg.latents_std)}
    else:
        config = {"_class_name": "AutoencoderKL",
                  "latent_channels": cfg.latent_channels,
                  "block_out_channels": list(cfg.block_out_channels),
                  "layers_per_block": cfg.layers_per_block,
                  "norm_num_groups": cfg.norm_num_groups,
                  "scaling_factor": cfg.scaling_factor,
                  "shift_factor": cfg.shift_factor}
    return out, config


def write_diffusers_dir(root, model, naming, vae, shards=2):
    """A diffusers-layout checkpoint directory of bf16 safetensors
    (`weights.checkpoint.save`): transformer/ in `shards` files, vae/ with
    its config.json.  Returns the bytes written."""
    import torch
    from regione_tpu_torch.weights import checkpoint
    state = {k: v.to(torch.bfloat16)
             for k, v in diffusers_transformer_state(model, naming).items()}
    keys = sorted(state)
    for i in range(shards):
        checkpoint.save(
            root / "transformer"
            / f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}"
              ".safetensors", {k: state[k] for k in keys[i::shards]})
    vstate, config = diffusers_vae_state(vae)
    checkpoint.save(root / "vae" / "diffusion_pytorch_model.safetensors",
                    {k: v.to(torch.bfloat16) for k, v in vstate.items()})
    (root / "vae" / "config.json").write_text(json.dumps(config))
    return sum(f.stat().st_size for f in root.rglob("*.safetensors"))


def _plan(stats):
    """A sampler's plan statistics (its timing fields left out)."""
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if not k.endswith("_s")}


def _bf16_values(module):
    """Round a module's fp32 tensors to bf16 values in place, so a bf16
    file of it loads back to exactly these values."""
    import torch
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.to(torch.bfloat16))


# phase 7's families: the backend of each naming, and the depth cut of its
# checkpoint (reduced: 2 double and 4 single blocks; Qwen 2 double;
# Step1X's connector at its published 2 blocks)
CKPT_BACKENDS = {"flux": "flux-kontext", "step1x": "step1x-edit",
                 "qwen": "qwen-image-edit"}
CKPT_DEPTH = {"flux": dict(depth_double=2, depth_single=4),
              "step1x": dict(depth_double=2, depth_single=4),
              "qwen": dict(depth_double=2)}


def ckpt_root():
    from regione_tpu_torch.ops._build import BUILD_DIR
    return BUILD_DIR.parent / "ckpt"           # inside the checkout


def ckpt_config(naming):
    from regione_tpu_torch.models import presets
    return dataclasses.replace(presets.get_config(CKPT_BACKENDS[naming]),
                               **CKPT_DEPTH[naming])


def phase_checkpoints(grid=32, size=512, vae_cfgs=None):
    """7: checkpoint loading at full width, the depth cut (reduced: 2 double
    and 4 single blocks; Qwen 2 double; Step1X's connector at its published
    2 blocks).  For each naming family (FLUX, Step1X, Qwen) a model at its
    preset's published widths with random bf16 weights on the card and the
    family's published-size VAE (AutoencoderKL; Wan for Qwen; fp32, its
    values rounded to bf16) are written as a diffusers-layout directory of
    bf16 safetensors under build/ckpt/ (`write_diffusers_dir`: the inverse
    name map lives here, not in the package), then loaded through the CLI's
    `build_pipeline(--model_path)`: bytes, load seconds and GB/s (the files
    were just written, so the host reads them from its page cache).  The
    loaded pipeline's RegionE edit must equal the in-memory model's bit for
    bit: latents at grid `grid` (Step1X, Qwen), the uint8 image of a
    size x size `pipe(image, prompt)` (FLUX).  `vae_cfgs`: the
    (AutoencoderKL, Wan) configs, the published ones by default.  Then the
    loaded FLUX model,
    quantized to int8 (with its modulations), round-trips through
    `checkpoint.save` / `mmdit_from_checkpoint`."""
    import shutil

    import torch
    from regione_tpu_torch.cli import main as cli
    from regione_tpu_torch.models import presets
    from regione_tpu_torch.models.text_encoders import MockTextEncoder
    from regione_tpu_torch.models.vae import VAEConfig
    from regione_tpu_torch.models.vae_wan import WanVAEConfig
    from regione_tpu_torch.ops.quant import quantize_params
    from regione_tpu_torch.weights import checkpoint
    from regione_tpu_torch.weights.from_jax import init_params, init_vae_params
    dev = torch.device(DEVICE)
    kl, wan = vae_cfgs or (VAEConfig(), WanVAEConfig())
    families = {"flux": kl, "step1x": kl, "qwen": wan}
    out_root = ckpt_root()
    image = structured_image(17, size, size)
    for naming, vae_cfg in families.items():
        backend = CKPT_BACKENDS[naming]
        preset = f"{backend}:ckpt"
        cfg = ckpt_config(naming)
        presets.PRESETS[preset] = cfg
        model = init_params(cfg, torch.Generator(dev).manual_seed(7), dev)
        vae = init_vae_params(vae_cfg, torch.Generator(dev).manual_seed(8),
                              dev)
        _bf16_values(vae)
        root = out_root / naming
        shutil.rmtree(root, ignore_errors=True)
        t = time.perf_counter()
        nbytes = write_diffusers_dir(root, model, naming, vae)
        write_s = time.perf_counter() - t
        args = cli.make_parser().parse_args([
            "--backend", backend, "--preset", preset, "--model_path",
            str(root), "--device", DEVICE, "--use_regione"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        loaded = cli.build_pipeline(args)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        n_params = sum(p.numel() for p in model.parameters())
        log(f"7 {naming} ({backend} widths, {cfg.depth_double} double + "
            f"{cfg.depth_single} single blocks, {n_params / 1e9:.3f} B "
            f"params; {type(vae).__name__} {vae_cfg.__class__.__name__}): "
            f"wrote {nbytes} B of bf16 safetensors in {write_s:.2f} s; "
            f"build_pipeline(--model_path) loaded them in {load_s:.2f} s, "
            f"{nbytes / load_s / 1e9:.2f} GB/s")
        mine = type(loaded)(model, loaded.re)
        mine.attach_vae(vae).attach_text_encoder(
            MockTextEncoder(cfg.txt_in_dim, cfg.pooled_dim or None))
        if naming == "flux":
            outs = [timed_call(p, image, width=size, height=size, seed=3,
                               output_type="uint8") for p in (mine, loaded)]
        else:
            r, lat0 = _request(cfg, 70, grid)
            txt_dim = cfg.connector.in_dim if cfg.connector else \
                cfg.txt_in_dim
            txt = torch.from_numpy(r.standard_normal(
                (2, T_TXT, txt_dim), np.float32)).to(dev, cfg.dtype)
            cond = r.standard_normal((1, grid * grid, cfg.in_channels))
            outs = []
            for p in (mine, loaded):
                ctx = _ctx(txt, None, cond, p.build_rope(grid, grid, T_TXT))
                outs.append(timed_edit(p, lat0, ctx, grid))
        (a, sa, *_), (b, sb, _, counts, _) = outs
        want, got = vae.state_dict(), loaded.vae.state_dict()
        same_vae = sorted(want) == sorted(got) and all(
            torch.equal(got[k], want[k]) for k in want)
        same = bool(np.array_equal(a, b)) and _plan(sa) == _plan(sb) and \
            same_vae
        log(f"7 {naming}: the loaded pipeline's RegionE edit "
            f"{'equals' if same else 'DIFFERS FROM'} the in-memory model's "
            f"bit for bit ({'uint8 image' if naming == 'flux' else 'latents'}"
            f" {b.shape}, edited_tokens {sb.edited_tokens}); the loaded "
            f"{type(loaded.vae).__name__} {'equals' if same_vae else 'DIFFERS FROM'} "
            f"the written one; launches {counts}")
        if not same:
            fail(f"7 {naming}: the loaded checkpoint's edit differs")
        if naming == "flux":
            quantize_params(loaded.model, quantize_mods=True)
            path = out_root / "flux_int8.safetensors"
            t = time.perf_counter()
            checkpoint.save(path, loaded.model.state_dict())
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            back = checkpoint.mmdit_from_checkpoint(path, cfg, DEVICE)
            torch.cuda.synchronize()
            back_s = time.perf_counter() - t
            want, got = loaded.model.state_dict(), back.state_dict()
            same = sorted(want) == sorted(got) and all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                for k in want)
            size = path.stat().st_size
            log(f"7 flux int8 (quantize_mods) round trip through "
                f"checkpoint.save / mmdit_from_checkpoint: {size} B, saved "
                f"in {save_s:.2f} s, loaded in {back_s:.2f} s "
                f"({size / back_s / 1e9:.2f} GB/s); state dicts "
                f"{'equal' if same else 'DIFFERENT'}")
            if not same:
                fail("7: the quantized checkpoint did not round-trip")
            del back, want, got
            path.unlink()
            shutil.rmtree(root, ignore_errors=True)
        # Step1X's and Qwen's directories stay for phase 11
        del model, vae, loaded, mine, outs
        release()


# ---------------------------------------------------------------------------
# phase 8: the JAX package's full-size weight formats
# ---------------------------------------------------------------------------

def _fidelity():
    """The JAX package's FIDELITY.json figures (TPU runs of its own, shown
    beside the port's for reference only)."""
    from pathlib import Path
    path = Path(__file__).resolve().parent / "FIDELITY.json"
    if not path.exists():
        return "FIDELITY.json not in this checkout"
    f = json.loads(path.read_text())
    return (f"the JAX package's FIDELITY.json (its own model, width "
            f"{f['width']}, depth {f['depth']}): forward SNR vs fp32 "
            f"{f['forward_snr_db_vs_fp32']} dB, trajectory SNR vs fp32 over "
            f"{f['trajectory_steps']} steps "
            f"{f['trajectory_snr_db_vs_fp32']} dB")


def _weights_against_memplan(label, model, **plan_kw):
    """The model's weight bytes on the card beside `memplan.plan`'s; they
    must be equal."""
    import torch
    from regione_tpu_torch.ops.quant import quantized_bytes
    from regione_tpu_torch.utils import memplan
    weights = quantized_bytes(model)
    plan = memplan.plan(model.cfg, **plan_kw)
    log(f"{label}: weights on the card {weights} B "
        f"({weights / 2**30:.2f} GiB), memplan.plan({plan_kw}) "
        f"{plan.param_bytes} B; allocated now "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if weights != plan.param_bytes:
        fail(f"{label}: memplan's weight bytes differ from the card's")


def phase_flux_w8a8(bf16_out, size=900):
    """8a: FLUX.1 Kontext at full width and depth in the format of the JAX
    package's FULLSIZE_FLUX_W8A8 record: built by the CLI's
    `build_pipeline(--int8 --act_int8)` (random bf16 weights from --seed,
    6a's, quantized in place to int8 with the modulations; W8A8) with the
    int8 KV cache and 6a's published-size AutoencoderKL: 6a's request (a
    900^2 image snapped to 1024^2, seed 3) once dense and once RegionE.
    K1 > 0, K2q > 0, K2 = 0, K3 once; pixel PSNR of RegionE against dense
    >= 30 dB; the PSNR against 6a's bf16-weight edit (`bf16_out`) logged
    with no limit (random weights).  Then `int_mm` at every W8A8 shape of
    the two calls.  Returns the RegionE call's launch counts."""
    import torch
    from regione_tpu_torch.api import RegionEHelper
    from regione_tpu_torch.cli import main as cli
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.models.text_encoders import MockTextEncoder
    from regione_tpu_torch.models.vae import VAEConfig
    from regione_tpu_torch.ops._build import BUILD_DIR
    from regione_tpu_torch.pipelines.flux_kontext import FluxKontextPipeline
    from regione_tpu_torch.weights.from_jax import init_vae_params
    dev = torch.device(DEVICE)
    record_int_mm("8a")
    image = structured_image(11, size, size)
    args = cli.make_parser().parse_args([
        "--backend", "flux-kontext", "--random_weights", "--use_regione",
        "--int8", "--act_int8", "--device", DEVICE, "--image_path",
        str(BUILD_DIR.parent / "image_phase" / "input.png"), "--prompt",
        PROMPT])
    t = time.perf_counter()
    model = cli.build_pipeline(args).model
    torch.cuda.synchronize()
    log(f"8a flux-kontext W8A8 built by the CLI (--int8 --act_int8: init, "
        f"then quantize in place) in {time.perf_counter() - t:.1f}s")
    model.cfg = kv_cache.with_cache_format(model.cfg, "int8")
    _weights_against_memplan("8a flux-kontext W8A8", model, int8=True,
                             quantize_mods=True)
    pipe = FluxKontextPipeline(model, DEFAULT_PARAMS["flux-kontext"])
    pipe.attach_vae(init_vae_params(
        VAEConfig(), torch.Generator(dev).manual_seed(1), dev)
    ).attach_text_encoder(MockTextEncoder(model.cfg.txt_in_dim,
                                          model.cfg.pooled_dim,
                                          max_length=T_TXT))
    helper = RegionEHelper(pipe).disable()
    dense, _, dense_s, dense_counts, dense_peak = timed_call(
        pipe, image, seed=3, output_type="uint8")
    helper.enable()
    out, stats, regione_s, counts, peak = timed_call(
        pipe, image, seed=3, output_type="uint8")
    log(f"8a flux W8A8, int8 cache: dense launches {dense_counts}, peak "
        f"{dense_peak:.1f} GiB")
    check_image("8a flux W8A8, int8 cache, RegionE", out, stats, counts,
                (size, size, 3), "attention_rows2_quant")
    p = pixel_psnr(dense, out)
    log(f"8a flux W8A8, int8 cache: dense_s {dense_s:.3f} regione_s "
        f"{regione_s:.3f} speedup {dense_s / regione_s:.3f}x, pixel PSNR "
        f"RegionE vs dense {p:.2f} dB (min {PSNR_MIN}), peak device memory "
        f"{peak:.1f} GiB; against 6a's bf16-weight, bf16-cache edit of the "
        f"same request: RegionE {pixel_psnr(bf16_out, out):.2f} dB (no "
        f"limit: random weights); {_fidelity()}")
    if dense_counts["fused_partition"] or not p >= PSNR_MIN:
        fail(f"8a: dense launches {dense_counts}, PSNR {p:.2f}")
    del pipe, model, helper
    release()
    check_int_mm("8a", INT_MM_SHAPES["8a"])
    return counts


def phase_qwen_int4(model, req, grid):
    """8b: Qwen-Image-Edit at full width and depth in the format of the JAX
    package's FULLSIZE_QWEN60_1024 record: phase 5b's weights quantized in
    place (int4, the modulations int4 too; each bf16 weight freed as its
    codes are made) with the int4 KV cache, 5b's request at grid `grid`:
    one dense and one RegionE latent edit (`check_edit`: K2q > 0, K2 = 0,
    K3 once, a partial partition, latent PSNR >= 30 dB against dense), the
    weights' bytes equal to memplan's, and the latent PSNR against 5b's
    bf16-weight edits of the same request (dense; RegionE with the int4
    cache), with no limit.  Returns the RegionE edit's launch counts."""
    import torch
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.ops.quant import quantize_params
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    lat0, ctx, dense_bf16, int4_bf16 = req
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    quantize_params(model, quantize_mods=True, bits=4, int4_mods=True)
    torch.cuda.synchronize()
    log(f"8b qwen-image-edit: quantize_params(bits=4, int4_mods) in place in "
        f"{time.perf_counter() - t:.1f}s, allocated {before / 2**30:.2f} -> "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    model.cfg = kv_cache.with_cache_format(model.cfg, "int4")
    _weights_against_memplan("8b qwen-image-edit int4", model, int8=True,
                             quantize_mods=True, bits=4, int4_mods=True)
    pipe = QwenImageEditPipeline(model, DEFAULT_PARAMS["qwen-image-edit"])
    shape = (1, grid * grid, model.cfg.out_channels)
    dense, _, dense_s, dense_counts, dense_peak = timed_edit(
        pipe, lat0, ctx, grid, dense_only=True)
    out, stats, regione_s, counts, peak = timed_edit(pipe, lat0, ctx, grid)
    log(f"8b qwen int4 weights, int4 cache: dense launches {dense_counts}, "
        f"RegionE launches {counts}")
    p = check_edit("8b qwen int4 weights, int4 cache", out, stats, counts,
                   dense, shape, "int4")
    log(f"8b qwen int4 weights, int4 cache, grid {grid}: dense_s "
        f"{dense_s:.3f} regione_s {regione_s:.3f} speedup "
        f"{dense_s / regione_s:.3f}x, psnr_latent_vs_dense {p:.2f} dB, peak "
        f"device memory dense {dense_peak:.1f} / RegionE {peak:.1f} GiB; "
        f"against 5b's bf16-weight edits of the same request: dense "
        f"{psnr(dense_bf16, dense):.2f} dB, RegionE (int4 cache both) "
        f"{psnr(int4_bf16, out):.2f} dB (no limit: random weights); "
        f"{_fidelity()}")
    del pipe
    return counts


# ---------------------------------------------------------------------------
# phase 9: the real prompt encoder
# ---------------------------------------------------------------------------

ENCODER_BOUND = 1e-4    # fp32 on both sides, TF32 off (matmuls and convs):
                        # summation order only


def phase_encoder(hidden=64, size=256, te=None):
    """9: the port's synthetic Qwen2.5-VL checkpoint (`weights.tiny_vl`,
    hidden `hidden`; `te`: one built already, as `vl_checkpoint` writes
    it) through `QwenVLPromptEncoder` on the card against its
    CPU run (fp32 both: embeddings within ENCODER_BOUND of their scale,
    masks equal); then one `pipe(image, prompt)` at size x size through the
    CLI's `build_pipeline(--model_path)` on a directory holding that
    text_encoder/ beside a small Qwen topology (txt_in_dim = hidden, 2
    double blocks of 2 heads of 128) and a small Wan VAE, written as in
    phase 7: the prompt encoder is the real one on the card, the image of
    the caller's geometry, K1 > 0, K2 > 0, K3 once."""
    import shutil

    import torch
    from regione_tpu_torch.cli import main as cli
    from regione_tpu_torch.models import presets
    from regione_tpu_torch.models.mmdit import MMDiTConfig
    from regione_tpu_torch.models.text_encoders import (
        QWEN_EDIT_TEMPLATE, QwenVLPromptEncoder)
    from regione_tpu_torch.models.vae_wan import WanVAEConfig
    from regione_tpu_torch.ops._build import BUILD_DIR
    from regione_tpu_torch.weights import tiny_vl
    from regione_tpu_torch.weights.from_jax import init_params, init_vae_params
    import transformers
    dev = torch.device(DEVICE)
    root = BUILD_DIR.parent / "ckpt" / "vl"
    if te is None:
        shutil.rmtree(root, ignore_errors=True)
        te = tiny_vl.build_checkpoint(str(root), hidden=hidden)
    image = structured_image(23, 300, 240)
    encs = [QwenVLPromptEncoder(te, variant="qwen-image-edit",
                                template=QWEN_EDIT_TEMPLATE, device=d)
            for d in (DEVICE, "cpu")]
    # fp32 on the card: the vision tower's patch conv too (6d leaves cuDNN's
    # TF32 convs on for the image phases)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    (emb, _, mask), (ref, _, ref_mask) = (e.encode(PROMPT, image=[image])
                                         for e in encs)
    torch.backends.cudnn.allow_tf32 = tf32
    err = float(np.abs(emb - ref).max() / np.abs(ref).max())
    ok = err <= ENCODER_BOUND and np.array_equal(mask, ref_mask)
    log(f"9 transformers {transformers.__version__}: QwenVLPromptEncoder "
        f"(tiny_vl, hidden {hidden}) on {encs[0].model.device} against the "
        f"CPU: embeddings {emb.shape}, max error {err:.2e} of their scale "
        f"(bound {ENCODER_BOUND:.0e}), masks "
        f"{'equal' if np.array_equal(mask, ref_mask) else 'DIFFERENT'}")
    if not ok:
        fail("9: the prompt encoder on the card disagrees with its CPU run")
    del encs
    cfg = MMDiTConfig(hidden=256, heads=2, head_dim=128, depth_double=2,
                      depth_single=0, txt_in_dim=hidden, pooled_dim=0,
                      txt_norm=True, time_embed_dim=64, mlp_ratio=2.0,
                      in_channels=64, out_channels=64, dtype=torch.bfloat16)
    presets.PRESETS["qwen-image-edit:vl"] = cfg
    vae = init_vae_params(WanVAEConfig(base_dim=16, dim_mult=(1, 2, 2, 2),
                                       num_res_blocks=1),
                          torch.Generator(dev).manual_seed(4), dev)
    write_diffusers_dir(root, init_params(
        cfg, torch.Generator(dev).manual_seed(5), dev), "qwen", vae)
    pipe = cli.build_pipeline(cli.make_parser().parse_args([
        "--backend", "qwen-image-edit", "--preset", "qwen-image-edit:vl",
        "--model_path", str(root), "--device", DEVICE, "--use_regione"]))
    enc = pipe.text_encoder
    out, stats, sec, counts, peak = timed_call(
        pipe, image, width=size, height=size, seed=5, output_type="uint8")
    log(f"9 qwen-image-edit (small topology) through --model_path with the "
        f"real encoder ({type(enc).__name__} on {enc.model.device}): "
        f"{sec:.3f} s end to end")
    if not isinstance(enc, QwenVLPromptEncoder) or \
            enc.model.device.type != dev.type:
        fail(f"9: the pipeline's encoder is {type(enc).__name__}")
    check_image("9 qwen with the real encoder", out, stats, counts,
                (size, size, 3), "attention_rows2")
    del pipe, enc, vae
    shutil.rmtree(root, ignore_errors=True)
    release()
    return counts

# ---------------------------------------------------------------------------
# phase 10: the v1.2 thinker and the evaluation stack
# ---------------------------------------------------------------------------

def vl_checkpoint(hidden=64):
    """The synthetic Qwen2.5-VL checkpoint (`weights.tiny_vl`) under
    build/ckpt/vl/text_encoder, written anew: the VLM of 10a and 10b, the
    prompt encoder of phase 9."""
    import shutil

    from regione_tpu_torch.ops._build import BUILD_DIR
    from regione_tpu_torch.weights import tiny_vl
    root = BUILD_DIR.parent / "ckpt" / "vl"
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    te = tiny_vl.build_checkpoint(str(root), hidden=hidden)
    log(f"tiny_vl checkpoint (hidden {hidden}) written in "
        f"{time.perf_counter() - t:.1f}s")
    return te


def phase_thinker(pipe, te, size=512, vae_cfg=None):
    """10a: the Step1X-Edit v1.2 outer loop at full width, on phase 5's
    weights (`step1x-edit-v1p2` is the v1.1 topology with its own gamma
    table): a `Step1XEditV1P2Pipeline` over the same model with the
    published-size AutoencoderKL and 6a's MockTextEncoder, through
    `edit_with_reflection` at size x size with the local Qwen2.5-VL thinker
    (`te`) on the card, at most 2 tries.  Checks the uint8 output, 1-2
    tries, a score in `best_info`, per try K1 > 0, K3 once and K2 > 0
    (`check_image`); then with `EchoThinker` and reflection off, the output
    equal to `pipe(image, prompt, seed)` bit for bit.  Logs the seconds of
    the VLM's think and reflect calls beside the edits'.  Returns the
    launch counts of the last try."""
    import torch
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.models.text_encoders import MockTextEncoder
    from regione_tpu_torch.models.vae import VAEConfig
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditV1P2Pipeline
    from regione_tpu_torch.pipelines.thinker import (
        EchoThinker, edit_with_reflection, local_vlm_thinker)
    from regione_tpu_torch.weights.from_jax import init_vae_params
    dev = torch.device(DEVICE)
    cfg = pipe.cfg
    v12 = Step1XEditV1P2Pipeline(pipe.model,
                                 DEFAULT_PARAMS["step1x-edit-v1p2"])
    vae = init_vae_params(vae_cfg or VAEConfig(),
                          torch.Generator(dev).manual_seed(1), dev)
    v12.attach_vae(vae).attach_text_encoder(
        MockTextEncoder(cfg.txt_in_dim, cfg.pooled_dim, max_length=T_TXT))
    image = structured_image(31, 600, 560)
    shape = (size, size, 3)

    tries = []

    def counted(img, prompt, **kw):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, stats = v12(img, prompt, **kw)
        torch.cuda.synchronize()
        tries.append((time.perf_counter() - t, read_counts(), stats, out))
        return out, stats

    t = time.perf_counter()
    thinker = local_vlm_thinker(te, device=DEVICE, max_new_tokens=8)
    log(f"10a local_vlm_thinker(tiny_vl, device={DEVICE!r}) loaded in "
        f"{time.perf_counter() - t:.2f}s")
    vlm_calls = []
    vlm = thinker.vlm

    def timed_vlm(images, text):
        torch.cuda.synchronize()
        t = time.perf_counter()
        reply = vlm(images, text)
        torch.cuda.synchronize()
        vlm_calls.append(("think" if len(images) == 1 else "reflect",
                          time.perf_counter() - t, reply))
        return reply

    thinker.vlm = timed_vlm
    t = time.perf_counter()
    best, info = edit_with_reflection(counted, image, PROMPT, thinker=thinker,
                                      max_try_cnt=2, seed=13, width=size,
                                      height=size)
    total = time.perf_counter() - t
    for name, sec, reply in vlm_calls:
        log(f"10a VLM {name}: {sec:.3f} s, reply {reply[:40]!r}")
    for i, (sec, counts, stats, out) in enumerate(tries):
        log(f"10a try {i} (prompt {info['think_info'][i]['prompt'][:40]!r}, "
            f"success {info['think_info'][i]['success']}): edit {sec:.3f} s")
        check_image(f"10a try {i}", out, stats, counts, shape,
                    "attention_rows2")
    log(f"10a edit_with_reflection: {total:.3f} s end to end, "
        f"{len(tries)} tries, VLM {sum(c[1] for c in vlm_calls):.3f} s in "
        f"{len(vlm_calls)} calls, edits {sum(x[0] for x in tries):.3f} s; "
        f"best_info {info['best_info']}; output {best.dtype} {best.shape}")
    problems = []
    if best.shape != shape or best.dtype != np.uint8:
        problems.append(f"output {best.dtype} {best.shape}")
    if not 1 <= len(tries) == len(info["images"]) <= 2:
        problems.append(f"{len(tries)} tries")
    if "score" not in info["best_info"]:
        problems.append(f"best_info {info['best_info']}")

    echo, einfo = edit_with_reflection(v12, image, PROMPT,
                                       thinker=EchoThinker(),
                                       enable_reflection=False, seed=17,
                                       width=size, height=size)
    plain, _ = v12(image, PROMPT, seed=17, width=size, height=size,
                   output_type="uint8")
    same = np.array_equal(echo, plain)
    log(f"10a EchoThinker, reflection off: {len(einfo['images'])} try, "
        f"output {'equal' if same else 'DIFFERENT'} to pipe(image, prompt, "
        f"seed=17) (max {int(np.abs(echo.astype(int) - plain).max())} "
        f"levels apart)")
    if not same or len(einfo["images"]) != 1:
        problems.append("EchoThinker's edit differs from the plain call")
    if problems:
        fail("10a: " + "; ".join(problems))
    del v12, vae, thinker, vlm
    release()
    return tries[-1][1]


def seeded_lpips_npz(path, seed=0):
    """LPIPS(alex) weights of the published shapes, seeded random (the
    AlexNet and lin weights are not in the repository), written as the
    `.npz` both packages read."""
    from regione_tpu_torch.eval import lpips_torch
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for i, (oc, k, _, _) in enumerate(lpips_torch._ALEX_STAGES):
        params[f"conv{i}_w"] = (rng.standard_normal((oc, cin, k, k)) /
                                np.sqrt(cin * k * k)).astype(np.float32)
        params[f"conv{i}_b"] = (0.1 * rng.standard_normal(oc)).astype(
            np.float32)
        params[f"lin{i}"] = np.abs(rng.standard_normal(oc)).astype(
            np.float32)
        cin = oc
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **params)
    return path


def phase_eval_chain(pipe, helper, te, size=512):
    """10b, on 6a's FLUX.1 Kontext pipeline (mirrors
    tests/test_eval_chain.py and the reference's script/Evaluation.sh): one
    synthetic task of 2 items (metadata.jsonl + img/), the CLI's
    `run_evaluation` with --size_level `size` twice, vanilla (under
    `RegionEHelper.disable()`) and RegionE; `run_metrics` with LPIPS on the
    card over seeded weights; `merge.merge_direction` of both roots;
    `run_viescore.main` with the dry-run judge and with the local
    Qwen2.5-VL judge (`te`, on the card, give-up parsing).  Checks each CSV
    row's PSNR against the PSNR of the same PNG pair, `Latency:` against
    the mean of each time_consuming.json list, LPIPS finite, the VIEScore
    statistics in [0, 10].  Returns the RegionE run's launch counts."""
    import csv
    import shutil

    from PIL import Image

    from regione_tpu_torch.cli import main as cli
    from regione_tpu_torch.eval import merge, metrics, run_metrics
    from regione_tpu_torch.eval import run_viescore
    from regione_tpu_torch.ops._build import BUILD_DIR
    root = BUILD_DIR.parent / "eval_chain"
    shutil.rmtree(root, ignore_errors=True)
    task = root / "bench" / "TE"
    (task / "img").mkdir(parents=True)
    with open(task / "metadata.jsonl", "w") as fh:
        for k in range(2):
            Image.fromarray(structured_image(41 + k, 700, 600)).save(
                task / "img" / f"k{k}.png")
            fh.write(json.dumps({"key": f"k{k}", "image": f"k{k}.png",
                                 "prompt": PROMPT}) + "\n")
    van, reg = root / "vanilla", root / "regione"
    args = cli.make_parser().parse_args([
        "--backend", "flux-kontext", "--evaluation", "--eval_dir",
        str(root / "bench"), "--size_level", str(size), "--seed", "3",
        "--device", DEVICE])
    counts = {}
    for name, out_dir in (("vanilla", van), ("regione", reg)):
        (helper.disable if name == "vanilla" else helper.enable)()
        args.output_dir = str(out_dir)
        reset_counts()
        t = time.perf_counter()
        cli.run_evaluation(pipe, args)
        counts[name] = read_counts()
        log(f"10b run_evaluation ({name}, --size_level {size}): "
            f"{time.perf_counter() - t:.3f} s, launches {counts[name]}")
    helper.enable()
    if counts["vanilla"]["fused_partition"] or \
            counts["vanilla"]["attention_rows2"] or \
            counts["regione"]["fused_partition"] != 2 or \
            counts["regione"]["attention_rows2"] == 0:
        fail(f"10b: launch counts {counts}")

    npz = seeded_lpips_npz(BUILD_DIR.parent / "lpips_alex.npz")
    t = time.perf_counter()
    res = run_metrics.main(["--folder1", str(van), "--folder2", str(reg),
                            "--lpips_weights", str(npz), "--device", DEVICE])
    log(f"10b run_metrics (LPIPS on {DEVICE}): "
        f"{time.perf_counter() - t:.3f} s")
    problems = []
    table = {r["Filename"]: r for r in csv.DictReader(
        open(reg / "TE" / "metric.csv"))}
    for row in res["TE"]:
        a, b = (np.asarray(Image.open(d / "TE" / "generation" / row["file"]))
                for d in (van, reg))
        own = metrics.psnr(a, b)
        written = table[row["file"]]
        log(f"10b {row['file']}: {a.shape}, PSNR {written['PSNR']} (own "
            f"{own:.4f}), SSIM {written['SSIM']}, LPIPS {written['LPIPS']}")
        if written["PSNR"] != f"{own:.4f}" or not np.isfinite(row["lpips"]) \
                or a.shape != (size, size, 3):
            problems.append(f"{row['file']}: {written}, own PSNR {own}")
    for name, d in (("vanilla", van), ("regione", reg)):
        text = merge.merge_direction(str(d), is_pretrain=name == "vanilla")
        lat = json.load(open(d / "TE" / "time_consuming.json"))[
            "time_consuming_list"]
        log(f"10b merged_metric.txt ({name}): "
            + text.strip().replace("\n", ", "))
        if f"Latency: {np.mean(lat):.4f}" not in text:
            problems.append(f"{name} latency {text!r} vs {lat}")
    for judge, extra in (("dryrun", []),
                         ("qwen25vl", ["--vlm_path", te, "--workers", "1",
                                       "--max_new_tokens", "8"])):
        t = time.perf_counter()
        stats = run_viescore.main(["--data_dir", str(root / "bench"),
                                   "--gen_root", str(reg), "--backbone",
                                   judge, "--device", DEVICE] + extra)
        rows = list(csv.DictReader(open(reg / "TE" /
                                        f"{judge}_vie_score.csv")))
        o = stats["overall"]
        log(f"10b run_viescore --backbone {judge}: "
            f"{time.perf_counter() - t:.3f} s, n {stats['n']}, sc "
            f"{o.get('sc')}, pq {o.get('pq')}, o {o.get('o')}, guessed "
            f"{sum(int(r['guessed']) for r in rows)} of {len(rows)}")
        if stats["n"] != 2 or not all(0.0 <= o[k] <= 10.0
                                      for k in ("sc", "pq", "o")):
            problems.append(f"{judge} statistics {stats}")
    if problems:
        fail("10b: " + "; ".join(problems))
    return counts["regione"]


LPIPS_BOUND = 1e-4      # of the distance: fp32 both sides, TF32 off


def phase_lpips(sizes=(512, 1024)):
    """10c: LPIPS(alex) over 10b's seeded weights on the card against the
    CPU, with cuDNN's TF32 convs off (6d leaves them on), on a structured
    image and a perturbed copy at each size: within LPIPS_BOUND of the
    distance; ms per pair on the card (CUDA events) with TF32 off and
    on."""
    import torch
    from regione_tpu_torch.eval import lpips_torch
    from regione_tpu_torch.ops._build import BUILD_DIR
    npz = seeded_lpips_npz(BUILD_DIR.parent / "lpips_alex.npz")
    params = {d: lpips_torch.load_lpips_npz(str(npz), device=d)
              for d in (DEVICE, "cpu")}
    tf32 = torch.backends.cudnn.allow_tf32
    ok = True
    for size in sizes:
        a = structured_image(51, size, size)
        r = np.random.default_rng(size)
        b = np.clip(a.astype(int) + r.integers(-12, 13, a.shape), 0, 255
                    ).astype(np.uint8)
        x = {d: (_image_tensor(a, d), _image_tensor(b, d))
             for d in (DEVICE, "cpu")}
        t = time.perf_counter()
        want = float(lpips_torch.lpips_forward(params["cpu"], *x["cpu"])[0])
        cpu_s = time.perf_counter() - t
        ms = {}
        for on in (False, True):
            torch.backends.cudnn.allow_tf32 = on
            got = float(lpips_torch.lpips_forward(params[DEVICE],
                                                  *x[DEVICE])[0])
            ms[on] = cuda_ms(lambda: lpips_torch.lpips_forward(
                params[DEVICE], *x[DEVICE]), iters=5)
            if not on:
                err = abs(got - want) / abs(want)
        good = err <= LPIPS_BOUND and np.isfinite(got)
        ok &= good
        log(f"10c LPIPS {size}x{size}: card {got:.6f} vs CPU {want:.6f}, "
            f"relative error {err:.2e} with TF32 convs off (bound "
            f"{LPIPS_BOUND:.0e}) {'ok' if good else 'FAIL'}; card "
            f"{ms[False]:.3f} ms a pair (TF32 off), {ms[True]:.3f} ms (on); "
            f"CPU {cpu_s * 1e3:.1f} ms")
    torch.backends.cudnn.allow_tf32 = tf32
    if not ok:
        fail("10c: LPIPS on the card disagrees with the CPU")


def phase_pixelprobe(probes):
    """10d: `pixelprobe.pixel_psnr_vs_dense` on dense and RegionE latents
    of earlier phases, `probes` = [(label, dense, regione, grid, family)]:
    pixel PSNR (>= PSNR_MIN) beside the latent PSNR, the decode's ms (CUDA
    events) and the probe's peak device memory; only the decoder on the
    card."""
    import torch
    from regione_tpu_torch.eval import pixelprobe
    problems = []
    for label, dense, regione, grid, family in probes:
        release()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        res = pixelprobe.pixel_psnr_vs_dense(dense, regione, grid, grid,
                                             family=family, device=DEVICE)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        _, vae = pixelprobe.decoder_for_family(family, device=DEVICE)
        places = ({p.device.type for p in vae.decoder.parameters()},
                  {p.device.type for p in vae.encoder.parameters()})
        dec_ms = cuda_ms(lambda: pixelprobe.decode_tokens(
            vae, dense, grid, grid), iters=2)
        del vae
        p_lat = psnr(dense, regione)
        log(f"10d {label} ({family}): {res['pixel_decoder']}; pixel PSNR "
            f"{res['psnr_pixel_vs_dense']} dB, SSIM "
            f"{res['ssim_pixel_vs_dense']} (latent PSNR {p_lat:.2f} dB); "
            f"probe {sec:.3f} s, decode {dec_ms:.2f} ms an image, peak "
            f"{peak:.2f} GiB over the {base / 2**30:.2f} GiB resident; "
            f"decoder on {sorted(places[0])}, encoder on {sorted(places[1])}")
        if not res["psnr_pixel_vs_dense"] >= PSNR_MIN:
            problems.append(f"{label} pixel PSNR {res['psnr_pixel_vs_dense']}")
        if places != ({torch.device(DEVICE).type}, {"cpu"}):
            problems.append(f"{label} placement {places}")
    release()
    if problems:
        fail("10d: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# phase 12: the measuring entry points on the headline workload
# ---------------------------------------------------------------------------

# bench.py's row, key for key (the pixel keys are its `pixel_psnr_vs_dense`
# dict's)
HEADLINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "dense_s", "regione_s",
    "psnr_latent_vs_dense", "psnr_pixel_vs_dense", "ssim_pixel_vs_dense",
    "pixel_decoder", "edited_tokens", "capacity", "edited_frac", "seq_len",
    "reuse_steps", "forced_mask_s", "forced_mask_speedup",
    "forced_edited_tokens", "params", "model", "device")


def phase_bench():
    """12: `regione_tpu_torch.bench` and `graft_entry` on the card.  The
    headline (`headline.run`'s workload: step1x-edit:dev, grid 64, t_txt
    128, best of 3) with the launch counts of each adaptive RegionE edit
    set to 0 just before it and read just after: its row on a line of its
    own, bench.py's keys, a partial partition with RAGS steps and the
    plan's reuse count, latent and pixel PSNR >= 30 dB, each adaptive
    RegionE edit K1 > 0, K2 > 0, K2q 0, K3 once and K7-K9 > 0; the
    profiles of its dense and RegionE edits; K1 and K2 at its shapes.
    Then `profile_steps` at the same shapes, `serve_batch` (B 2,
    one run: K2q > 0, batched against single >= SERVE_PSNR_MIN), `fullsize
    --preset step1x-edit` at full width with the grid cut to 32, one run,
    and one `graft_entry.entry()` step.  Returns (the launch counts of the
    headline's last adaptive RegionE edit, K1's and K2's records)."""
    import torch
    from regione_tpu_torch import graft_entry
    from regione_tpu_torch.bench import (fullsize, headline, profile_steps,
                                         serve_batch)
    from regione_tpu_torch.ops._build import BUILD_DIR
    problems = []
    g = headline.GRID
    w = headline.prepare(device=DEVICE)
    row, stats, launches = headline.measure(w)
    print(json.dumps(row), flush=True)
    plan = profile_steps.plan_counts(w.pipe.sampler_for(
        g, g, headline.T_TXT, 2).plan)
    log(f"12 headline: plan {plan}, stats {stats}; launches of each "
        f"adaptive RegionE edit {launches}")
    if tuple(row) != HEADLINE_KEYS:
        problems.append(f"headline keys {list(row)}")
    if not (0 < row["edited_tokens"] < g * g and stats.rags_steps > 0
            and row["reuse_steps"] == plan["reuse"]):
        problems.append(f"headline plan {stats} against {plan}")
    if not (row["psnr_latent_vs_dense"] >= PSNR_MIN
            and row.get("psnr_pixel_vs_dense", 0) >= PSNR_MIN):
        problems.append("headline PSNR")
    if any(not (c["attention"] > 0 and c["attention_rows2"] > 0
                and c["attention_rows2_quant"] == 0
                and c["fused_partition"] == 1 and fused_ok(c))
           for c in launches):
        problems.append(f"headline launches {launches}")
    phase_profile("12 headline", w.pipe, w.ctx, w.lat0, g)
    rng = np.random.default_rng(12)
    s_kv = 2 * g * g
    checks = {"headline_attention": check_attention(
        rng, 2, w.pipe.cfg.heads, headline.T_TXT + s_kv,
        headline.T_TXT + s_kv, False, iters=5),
        "headline_rows2": check_rows2(
            rng, 2, w.pipe.cfg.heads, headline.T_TXT, stats.capacity, s_kv,
            iters=10)}
    if not all(r["ok"] for r in checks.values()):
        problems.append("a kernel disagrees at the headline's shapes")
    del w
    release()

    t = time.perf_counter()
    prof = profile_steps.run(device=DEVICE, runs=3)
    log(f"12 profile_steps ({time.perf_counter() - t:.1f}s): "
        f"{json.dumps(prof)}")
    if prof["plan_counts"] != plan:
        problems.append(f"profile_steps plan {prof['plan_counts']}")
    release()

    t = time.perf_counter()
    srow, detail = serve_batch.run(batch=2, grid=g, runs=1, device=DEVICE)
    p = psnr(detail["single"], detail["batched"]) if detail else float("nan")
    log(f"12 serve_batch ({time.perf_counter() - t:.1f}s): "
        f"{json.dumps(srow)}; batched against single {p:.2f} dB (min "
        f"{SERVE_PSNR_MIN}), max_abs_err_vs_single "
        f"{srow.get('max_abs_err_vs_single')}, group launches "
        f"{detail and detail['launches']}")
    if detail is None or not p >= SERVE_PSNR_MIN or \
            detail["launches"]["attention_rows2_quant"] <= 0:
        problems.append("serve_batch")
    release()

    t = time.perf_counter()
    frow = fullsize.run(fullsize.parse_args(
        ["--preset", "step1x-edit", "--grid", "32", "--runs", "1",
         "--device", DEVICE, "--out",
         str(BUILD_DIR.parent / "bench" / "FULLSIZE_GRID32.json")]))
    log(f"12 fullsize ({time.perf_counter() - t:.1f}s): {json.dumps(frow)}")
    if not (frow["psnr_latent_vs_dense"] >= PSNR_MIN
            and frow.get("psnr_pixel_vs_dense", 0) >= PSNR_MIN
            and frow["edited_tokens"] == 32 * 32 // 4):
        problems.append("fullsize")
    release()

    step_fn, args = graft_entry.entry(device=DEVICE)
    out = step_fn(*args)
    torch.cuda.synchronize()
    ok = tuple(out.shape) == tuple(args[0].shape) and \
        bool(torch.isfinite(out).all())
    log(f"12 graft_entry.entry(): one dense step {tuple(out.shape)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        problems.append("entry()")
    del step_fn, args, out
    release()
    if problems:
        fail("12: " + "; ".join(problems))
    return launches[-1], checks


# ---------------------------------------------------------------------------
# phase 13: the prompt encoder's placement and the JAX package's last scripts
# ---------------------------------------------------------------------------

PLACEMENT_PRESETS = ("qwen-image-edit", "qwen-image-edit-plus",
                     "flux-kontext", "step1x-edit")


def phase_encoder_placement(te):
    """13a: `memplan.choose_placement` with each family's published prompt
    encoder (built on the meta device) on this card at grid 64, t_txt 512:
    Qwen / Plus must not keep their fp32 Qwen2.5-VL-7B on the card (it
    does not fit beside the bf16 weights and cache); then the synthetic
    Qwen2.5-VL (`te`, phase 10a's tiny_vl) through `QwenVLPromptEncoder`
    offloaded and resident on the card, each against the fp32 CPU encoder
    (embeddings within ENCODER_BOUND of their scale, masks equal); the
    offloaded one holds no tensor on the card after its encode."""
    import torch
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.models.text_encoders import (
        QWEN_EDIT_TEMPLATE, QwenVLPromptEncoder)
    from regione_tpu_torch.utils import memplan
    problems = []
    hbm = torch.cuda.get_device_properties(0).total_memory
    for preset in PLACEMENT_PRESETS:
        choice, p = memplan.choose_placement(
            get_config(preset), memplan.ENCODER_OF[preset], hbm,
            batch_cfg=1 if preset == "flux-kontext" else 2)
        d = p.as_dict()
        log(f"13a memplan {preset} + {p.encoder} (fp32) at grid 64, t_txt "
            f"512: weights {d['param_bytes_gib']} + encoder "
            f"{d['encoder_bytes_gib']} + cache {d['cache_bytes_gib']} + "
            f"activations {d['activation_bytes_est_gib']} = "
            f"{d['total_bytes_gib']} GiB on a {hbm / 2**30:.2f} GiB card: "
            f"placement {choice}")
        if preset.startswith("qwen") and choice != "offload":
            problems.append(f"{preset}: placement {choice}")
    image = structured_image(23, 300, 240)
    ref = QwenVLPromptEncoder(te, template=QWEN_EDIT_TEMPLATE, device="cpu")
    want, _, want_mask = ref.encode(PROMPT, image=[image])
    del ref
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for placement in ("offload", "card"):
        enc = QwenVLPromptEncoder(te, template=QWEN_EDIT_TEMPLATE,
                                  device=DEVICE, placement=placement)
        with enc.on_device():
            with enc.on_device():       # re-entrant: one copy for both
                got, _, mask = enc.encode(PROMPT, image=[image])
                on_card = {t.device.type for t in enc.model.parameters()}
        after = {t.device.type for t in enc.model.parameters()}
        err = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"13a tiny_vl {placement}: on the card during the encode "
            f"{on_card}, after it {after}, host -> card copy "
            f"{enc.copy_s:.4f} s; embeddings {got.shape} max error "
            f"{err:.2e} of their scale against the fp32 CPU encoder (bound "
            f"{ENCODER_BOUND:.0e}), masks "
            f"{'equal' if np.array_equal(mask, want_mask) else 'DIFFERENT'}")
        if not (err <= ENCODER_BOUND and np.array_equal(mask, want_mask)
                and on_card == {"cuda"}
                and after == ({"cpu"} if placement == "offload"
                              else {"cuda"})):
            problems.append(f"tiny_vl {placement}")
        del enc
    torch.backends.cudnn.allow_tf32 = tf32
    release()
    if problems:
        fail("13a: " + "; ".join(problems))


def phase_ported_scripts(te):
    """13: the encoder's placement (13a), then the ports of the JAX
    package's last scripts on the card: `exec_full_qwen60` at full width
    (60 blocks, int8 weights and cache) at grid 64, t_txt 512, tp 1, one
    run (13b; plan statistics, init seconds, launches K1 > 0, K2q > 0, K2
    0, K3 once); K1 and K2q at its per-rank shapes under tp 4 (6 of 24
    heads, 13b's capacity: a tp 4 rank launches each as often as 13b does,
    PERF.md section 6) and K1 and K2 at Step1X's under tp 2 (12 heads,
    phase 11b's grid 32); `profile_rags` at its defaults and with
    `--cache-int8 --scan-only` (13c); `fidelity_int8` at its defaults
    (13d); the `torch_run_minibench.sh --dev` chain on the card (13e), in
    its own processes while 13d's fp32 master holds the CPU and leaves the
    card idle.  Returns (13b's launch counts, the kernels' records)."""
    import os
    import signal
    from regione_tpu_torch.bench import (exec_full_qwen60, fidelity_int8,
                                         profile_rags)
    from regione_tpu_torch.ops._build import BUILD_DIR
    problems = []
    t = time.perf_counter()
    phase_encoder_placement(te)
    log(f"13a done in {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    row = exec_full_qwen60.main(["--grid", "64", "--t-txt", "512", "--runs",
                                 "1", "--device", DEVICE])
    rank = row["ranks"][0]
    log(f"13b exec_full_qwen60 ({time.perf_counter() - t:.1f}s, init "
        f"{row['init_s']} s): plan dense {row['dense_steps']} rags "
        f"{row['rags_steps']} reuse {row['reuse_steps']}, edited "
        f"{row['edited_tokens']}/{row['seq_len']}, capacity "
        f"{row['capacity']}; peak {rank['peak_gib']} GiB, memplan "
        f"{rank['memplan_gib']} GiB; launches {rank['launches']}")
    c = rank["launches"]
    if not (row["blocks"] == 60 and row["finite_output"]
            and c["attention"] > 0 and c["attention_rows2_quant"] > 0
            and c["attention_rows2"] == 0 and c["fused_partition"] == 1):
        problems.append(f"13b exec_full_qwen60 {row}")
    release()
    rng = np.random.default_rng(13)
    s_kv = 2 * 64 * 64
    checks = {
        "tp4_attention": check_attention(rng, 2, 6, 512 + s_kv, 512 + s_kv,
                                         False, iters=5),
        "tp4_rows2_int8": check_rows2(rng, 2, 6, 512, row["capacity"], s_kv,
                                      iters=10, bits=8),
        "tp2_attention": check_attention(rng, 2, 12, T_TXT + 2 * 32 * 32,
                                         T_TXT + 2 * 32 * 32, False,
                                         iters=10),
        "tp2_rows2": check_rows2(rng, 2, 12, T_TXT, 384, 2 * 32 * 32,
                                 iters=10)}
    if not all(r["ok"] for r in checks.values()):
        problems.append("a kernel disagrees at the sharded shapes")
    release()

    for argv in ([], ["--cache-int8", "--scan-only"]):
        t = time.perf_counter()
        prow = profile_rags.main(argv + ["--runs", "3", "--device", DEVICE])
        log(f"13c profile_rags {' '.join(argv) or '(defaults)'} "
            f"({time.perf_counter() - t:.1f}s): {json.dumps(prow)}")
        if not all(v > 0 for k, v in prow.items() if k.endswith(
                ("_ms", "_x24", "_x48"))):
            problems.append(f"13c profile_rags {argv}")
        release()

    t = t13e = time.perf_counter()
    out = BUILD_DIR.parent / "minibench"
    out.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "minibench.log", "w+") as sink:
        minibench = subprocess.Popen(
            ["bash", "scripts/torch_run_minibench.sh", str(out), "--dev"],
            stdout=sink, stderr=subprocess.STDOUT, start_new_session=True,
            env=dict(os.environ, PYTHON=sys.executable))
        try:
            frow = fidelity_int8.main(["--device", DEVICE])
            log(f"13d fidelity_int8 ({time.perf_counter() - t:.1f}s, beside "
                f"13e): {json.dumps(frow)}")
            snr = frow["trajectory_snr_db_vs_fp32"]
            if not (snr["bf16"] >= snr["int8_weight_only"]
                    > snr["int4_weight_only"] > 0):
                problems.append(f"13d fidelity_int8 {snr}")
            release()
            rc = minibench.wait(timeout=300)
        finally:
            if minibench.poll() is None:
                os.killpg(minibench.pid, signal.SIGKILL)
                minibench.wait()
        sink.seek(0)
        tail = sink.read().strip().splitlines()[-6:]
    log(f"13e torch_run_minibench.sh --dev ({time.perf_counter() - t13e:.1f}"
        f"s from its start beside 13d, rc {rc}): {' | '.join(tail)}")
    metric = sorted(out.glob("regione/*/metric.csv"))
    if rc != 0 or not metric:
        problems.append(f"13e minibench rc {rc}")
    if problems:
        fail("13: " + "; ".join(problems))
    return c, checks


# ---------------------------------------------------------------------------
# phase 11: the sharded port (tensor and data parallelism)
# ---------------------------------------------------------------------------

SHARD_WORLD = 4
SHARD_LIMIT_S = 420     # the ranks' hard limit; they are killed after it
SHARD_PSNR_MIN = 40.0   # sharded against unsharded (PERF.md section 2)
STEP1X_RE = dict(warmup_step=6, post_step=2, refresh_step=(16,),
                 threshold=0.88, cache_threshold=0.02)


def _shard_configs():
    """phase 11's configs: Qwen with the int8 cache, Step1X (bf16 cache),
    each at phase 7's depth cut."""
    return (kv_cache.with_cache_format(ckpt_config("qwen"), "int8"),
            ckpt_config("step1x"))


def _device_ctx(x, pipe, grid):
    import torch
    dev, dt = torch.device(DEVICE), pipe.cfg.dtype
    txt = x["txt"].to(dev, dt)
    pooled = None if x.get("pooled") is None else x["pooled"].to(dev, dt)
    return _ctx(txt, pooled, x["cond"],
                pipe.build_rope(grid, grid, txt.shape[1]))


def sharded_rank(work: str, rank: str, world: str) -> None:
    """One rank of phase 11, in its own process on the one card: joins the
    gloo group of the file store in `work`, loads its shards of phase 7's
    checkpoints and runs 11a (Qwen on tp 4: a dense and a RegionE edit;
    then the int4 checkpoint on (dp 2, tp 2): a RegionE edit) and 11b
    (Step1X on (dp 2, tp 2): `edit_latents_batch` of two requests).
    Writes its latents, plan statistics, launch counts, weight and cache
    bytes and seconds to work/rank<rank>.pt."""
    import datetime
    from pathlib import Path

    import torch
    import torch.distributed as dist
    from regione_tpu_torch.core.config import DEFAULT_PARAMS, RegionEParams
    from regione_tpu_torch.ops import _build
    from regione_tpu_torch.ops.quant import quantized_bytes
    from regione_tpu_torch.parallel.sharding import make_mesh
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.utils import memplan
    from regione_tpu_torch.weights.checkpoint import mmdit_from_checkpoint
    from regione_tpu_torch.weights.convert import load_converted

    work, rank, world = Path(work), int(rank), int(world)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()                 # built by the parent's phase 2
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    qcfg, scfg = _shard_configs()
    root = ckpt_root()
    res = {}

    def weights(label, model, mesh, **plan_kw):
        plan = memplan.plan(model.cfg, tp=mesh.size(1), **plan_kw)
        res[label + "_bytes"] = (quantized_bytes(model), plan.param_bytes,
                                 getattr(model, "loaded_bytes", None))

    # 11a: Qwen, tp 4
    mesh4 = make_mesh(dp=1)
    t = time.perf_counter()
    model = load_converted(root / "qwen", qcfg, load_text_encoder=False,
                           device=DEVICE, mesh=mesh4)[0]
    res["qwen_load_s"] = time.perf_counter() - t
    weights("qwen", model, mesh4)
    pipe = QwenImageEditPipeline(model, DEFAULT_PARAMS["qwen-image-edit"])
    x, grid = inputs["qwen"], inputs["qwen_grid"]
    ctx = _device_ctx(x, pipe, grid)
    lat0 = x["lat0"].to(DEVICE)
    for name, dense in (("qwen_dense", True), ("qwen", False)):
        out, st, sec, counts, peak = timed_edit(pipe, lat0, ctx, grid,
                                                dense_only=dense)
        res[name] = (out, st and _plan(st), sec, counts, peak)
    del model, pipe
    release()
    # 11a: the int4 checkpoint, (dp 2, tp 2): the request replicated over dp
    mesh22 = make_mesh(dp=2)
    t = time.perf_counter()
    model = mmdit_from_checkpoint(work / "qwen_int4.safetensors", qcfg,
                                  DEVICE, mesh=mesh22)
    res["qwen_int4_load_s"] = time.perf_counter() - t
    weights("qwen_int4", model, mesh22, int8=True, bits=4)
    pipe = QwenImageEditPipeline(model, DEFAULT_PARAMS["qwen-image-edit"])
    out, st, sec, counts, peak = timed_edit(pipe, lat0, ctx, grid)
    res["qwen_int4"] = (out, _plan(st), sec, counts, peak)
    del model, pipe
    release()
    # 11b: Step1X with its connector, (dp 2, tp 2), a group of two
    t = time.perf_counter()
    model = load_converted(root / "step1x", scfg, load_text_encoder=False,
                           device=DEVICE, mesh=mesh22)[0]
    res["step1x_load_s"] = time.perf_counter() - t
    weights("step1x", model, mesh22)
    pipe = Step1XEditPipeline(model, RegionEParams(**STEP1X_RE),
                              true_cfg_scale=6.0)
    grid = inputs["step1x_grid"]
    ctxs = [_device_ctx(x, pipe, grid) for x in inputs["step1x"]]
    lats = [x["lat0"].to(DEVICE) for x in inputs["step1x"]]
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs, stats = pipe.edit_latents_batch(lats, ctxs, grid, grid,
                                          mesh=mesh22)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    (key, sampler), = pipe._samplers.items()
    cache = kv_cache.init_cache(scfg, key[3], grid * grid + key[4],
                                "meta", tp=mesh22.size(1))
    res["step1x"] = ([o.cpu().numpy() for o in outs],
                     [_plan(s) for s in stats], sec, read_counts())
    res["step1x_cache"] = ({k: tuple(v.shape) for k, v in cache.items()},
                           sum(v.numel() * v.element_size()
                               for v in cache.values()))
    torch.save(res, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def _launch_ranks(work, world):
    """The ranks, each a process of its own with its output in
    work/rank<r>.log."""
    import os
    from pathlib import Path
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here))
    code = ("import sys, chip_smoke; "
            "chip_smoke.sharded_rank(*sys.argv[1:])")
    procs = []
    for r in range(world):
        with open(work / f"rank{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(work), str(r), str(world)],
                cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT))
    return procs


def _wait_ranks(procs, deadline):
    """Wait for the ranks; kill them all at the deadline or as soon as one
    fails.  Returns the problem, or None."""
    problem = None
    while any(p.poll() is None for p in procs):
        if any(p.returncode not in (None, 0) for p in procs):
            problem = "a rank failed"
            break
        if time.monotonic() > deadline:
            problem = f"the ranks ran past {SHARD_LIMIT_S} s"
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    if problem is None and any(p.returncode for p in procs):
        problem = "a rank failed"
    return problem


def phase_sharded(qwen_grid=64, step1x_grid=32):
    """11: the sharded port on phase 7's full-width checkpoints (depth cut:
    2 double blocks for Qwen, 2 double + 4 single and the 2-block connector
    for Step1X), on SHARD_WORLD ranks in their own processes on the one
    card, joined by gloo through the host (NCCL refuses two ranks on one
    device).  Each rank loads only its slices from the files.
      11a. Qwen at grid 64 with the int8 cache on tp 4: a dense and a
           RegionE latent edit; then the same request's RegionE edit with
           int4 weights (the parent's `quantize_params(bits=4)`, written by
           `checkpoint.save`) on (dp 2, tp 2), the request replicated over
           dp;
      11b. Step1X (bf16 cache) at grid 32 on (dp 2, tp 2):
           `edit_latents_batch(mesh=)` of two requests with partial
           partitions of different sizes, one per dp rank;
      11c. NCCL at world size 1 (in this process): `shard_params` at tp 1
           on the Step1X model and one RegionE edit, bit-equal to the
           unsharded one.
    Each is held against the unsharded edit of the same checkpoint here:
    equal plan statistics, latent PSNR >= 40 dB on every rank, each rank's
    weight bytes equal to memplan.plan(tp=)'s.  Returns {path: launch
    counts of rank 0} for the record."""
    import shutil

    import torch
    import torch.distributed as dist
    from regione_tpu_torch.core.config import DEFAULT_PARAMS, RegionEParams
    from regione_tpu_torch.ops.quant import quantize_params
    from regione_tpu_torch.parallel.sharding import make_mesh, shard_params
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.weights import checkpoint
    from regione_tpu_torch.weights.convert import load_converted

    qcfg, scfg = _shard_configs()
    root = ckpt_root()
    work = root.parent / "sharded"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    # the unsharded references, and the requests
    model = load_converted(root / "qwen", qcfg, load_text_encoder=False,
                           device=DEVICE)[0]
    qre = DEFAULT_PARAMS["qwen-image-edit"]
    pipe = QwenImageEditPipeline(model, qre)
    g = qwen_grid
    rope = pipe.build_rope(g, g, T_TXT)
    rng = np.random.default_rng(131)
    txt = torch.from_numpy(rng.standard_normal(
        (2, T_TXT, qcfg.txt_in_dim), np.float32)).to(DEVICE, qcfg.dtype)
    r, lat0 = _request(qcfg, 132, g)
    cond = probe_condition(pipe, pipe.sampler_for(g, g, T_TXT, 2), txt, None,
                           rope, lat0, r, "11a qwen")
    ctx = _ctx(txt, None, cond, rope)
    refs = {"qwen_dense": timed_edit(pipe, lat0, ctx, g, dense_only=True),
            "qwen": timed_edit(pipe, lat0, ctx, g)}
    inputs = {"qwen": {"lat0": lat0.cpu(), "txt": txt.cpu(),
                       "cond": cond},
              "qwen_grid": g, "step1x_grid": step1x_grid}
    quantize_params(model, bits=4)
    checkpoint.save(work / "qwen_int4.safetensors", model.state_dict())
    refs["qwen_int4"] = timed_edit(QwenImageEditPipeline(model, qre), lat0,
                                   ctx, g)
    del model, pipe
    release()
    smodel = load_converted(root / "step1x", scfg, load_text_encoder=False,
                            device=DEVICE)[0]
    spipe = Step1XEditPipeline(smodel, RegionEParams(**STEP1X_RE),
                               true_cfg_scale=6.0)
    g = step1x_grid
    rope = spipe.build_rope(g, g, T_TXT)
    rng = np.random.default_rng(141)
    stxt = torch.from_numpy(rng.standard_normal(
        (2, T_TXT, scfg.connector.in_dim), np.float32)).to(DEVICE,
                                                           scfg.dtype)
    sampler = spipe.sampler_for(g, g, T_TXT, 2)
    lats, ctxs, sx = [], [], []
    for k, seed in enumerate((142, 143)):
        r, l0 = _request(scfg, seed, g)
        c = probe_condition(spipe, sampler, stxt, None, rope, l0, r,
                            f"11b step1x request {k}", span=5 + 4 * k)
        lats.append(l0)
        ctxs.append(_ctx(stxt, None, c, rope))
        sx.append({"lat0": l0.cpu(), "txt": stxt.cpu(), "cond": c})
    inputs["step1x"] = sx
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    souts, sstats = spipe.edit_latents_batch(lats, ctxs, g, g)
    torch.cuda.synchronize()
    refs["step1x"] = ([o.cpu().numpy() for o in souts], sstats,
                      time.perf_counter() - t, read_counts())
    whole_cache = kv_cache.cache_bytes(scfg, 4, 2 * g * g)
    torch.save(inputs, work / "inputs.pt")
    log(f"11: unsharded references and requests in "
        f"{time.perf_counter() - t_phase:.1f}s; launching {SHARD_WORLD} "
        f"gloo ranks on the one card")
    t_ranks = time.monotonic()
    procs = _launch_ranks(work, SHARD_WORLD)
    try:
        # 11c while the ranks run: NCCL at world size 1, in this process
        dist.init_process_group("nccl", init_method=f"file://{work}/nccl",
                                rank=0, world_size=1)
        try:
            want = timed_edit(spipe, lats[0], ctxs[0], g)
            shard_params(smodel, make_mesh(device_type="cuda"))
            got = timed_edit(spipe, lats[0], ctxs[0], g)
        finally:
            dist.destroy_process_group()
    finally:
        problem = _wait_ranks(procs, t_ranks + SHARD_LIMIT_S)
    ranks_s = time.monotonic() - t_ranks
    for r in range(SHARD_WORLD):
        text = (work / f"rank{r}.log").read_text(errors="replace")
        for line in text.splitlines()[-40 if problem else -6:]:
            log(f"  rank {r}: {line}")
    if problem:
        fail(f"11: {problem}")
    same = np.array_equal(want[0], got[0]) and \
        _plan(want[1]) == _plan(got[1])
    log(f"11c nccl world 1, shard_params at tp 1, step1x RegionE edit: "
        f"{'bit-equal to' if same else 'DIFFERS FROM'} the unsharded edit "
        f"(edited_tokens {got[1].edited_tokens}, {got[2]:.3f} s against "
        f"{want[2]:.3f} s, while the gloo ranks ran), launches {got[3]}")
    problems = [] if same else ["11c differs from the unsharded edit"]
    if not 0 < refs["qwen"][1].edited_tokens < qwen_grid ** 2:
        problems.append("11a: the partition is not partial")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(SHARD_WORLD)]
    for name, label in (("qwen_dense", "11a qwen dense, tp 4"),
                        ("qwen", "11a qwen RegionE int8 cache, tp 4"),
                        ("qwen_int4", "11a qwen int4 weights RegionE, "
                                      "(dp 2, tp 2)")):
        ref, ref_st, ref_s, _, _ = refs[name]
        for r, res in enumerate(ranks):
            out, st, sec, counts, peak = res[name]
            p = psnr(ref, out)
            want_st = ref_st and _plan(ref_st)
            log(f"{label} rank {r}: latent PSNR {p:.2f} dB against the "
                f"unsharded edit, plan {st} (unsharded {want_st}), "
                f"{sec:.3f} s (unsharded {ref_s:.3f} s; gloo through the "
                f"host on one card), peak {peak:.2f} GiB, launches "
                f"K1 {counts['attention']} K2q "
                f"{counts['attention_rows2_quant']} K3 "
                f"{counts['fused_partition']} (all {counts})")
            if not p >= SHARD_PSNR_MIN or st != want_st:
                problems.append(f"{label} rank {r}: PSNR {p:.2f} or plan")
            if not qwen_launches_ok(name, counts):
                problems.append(f"{label} rank {r}: launches {counts}")
    ref_outs, ref_stats, ref_s, ref_counts = refs["step1x"]
    edited = [st.edited_tokens for st in ref_stats]
    if not (all(0 < e < step1x_grid ** 2 for e in edited)
            and edited[0] != edited[1]):
        problems.append(f"11b: partitions {edited} not partial or equal")
    for r, res in enumerate(ranks):
        outs, stats, sec, counts = res["step1x"]
        ps = [psnr(a, b) for a, b in zip(ref_outs, outs)]
        want_st = [_plan(s) for s in ref_stats]
        shapes, cache_bytes = res["step1x_cache"]
        log(f"11b step1x edit_latents_batch of 2 on (dp 2, tp 2) rank {r}: "
            f"PSNR {', '.join(f'{p:.2f}' for p in ps)} dB against the "
            f"unsharded group, plans {stats} (unsharded {want_st}), "
            f"{sec:.3f} s (unsharded {ref_s:.3f} s; gloo through the host "
            f"on one card), launches {counts}; its cache set {shapes['dk']} "
            f"and beside it: {cache_bytes} B against the whole group's "
            f"{whole_cache} B")
        caps = {s["capacity"] for s in stats}
        if not all(p >= SHARD_PSNR_MIN for p in ps) or stats != want_st \
                or len(caps) != 1:
            problems.append(f"11b rank {r}: PSNR {ps} or plans {stats}")
        if shapes["dk"][1:3] != (2, scfg.heads // 2) or \
                cache_bytes * 4 != whole_cache:
            problems.append(f"11b rank {r}: cache {shapes} {cache_bytes}")
        if counts["fused_partition"] != 1 or counts["attention_rows2"] < 1 \
                or not fused_ok(counts):
            problems.append(f"11b rank {r}: launches {counts}")
        for label in ("qwen", "qwen_int4", "step1x"):
            have, plan, read = res[label + "_bytes"]
            log(f"11 {label} rank {r}: weights {have} B on the card, "
                f"memplan.plan(tp=) {plan} B, read from the file {read} B, "
                f"loaded in {res[label + '_load_s']:.2f} s")
            if have != plan:
                problems.append(f"11 {label} rank {r}: {have} != {plan} B")
    log(f"11: the ranks ran {ranks_s:.1f} s (gloo through the host on one "
        f"card: not a measure of tensor-parallel speed)")
    del smodel, spipe
    release()
    for naming in ("step1x", "qwen"):          # phase 9 reads root / "vl"
        shutil.rmtree(root / naming, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    if problems:
        fail("11: " + "; ".join(problems))
    return {"sharded_" + k: ranks[0][k][3]
            for k in ("qwen", "qwen_int4", "step1x")}


def qwen_launches_ok(name, counts) -> bool:
    """A sharded Qwen edit's launches: K1 and K7-K9 always; a RegionE
    edit K3 once and K2q (its cache is quantized) but no K2."""
    if counts["attention"] <= 0 or not fused_ok(counts):
        return False
    if name == "qwen_dense":
        return counts["fused_partition"] == 0
    return (counts["fused_partition"] == 1
            and counts["attention_rows2_quant"] > 0
            and counts["attention_rows2"] == 0)



SRC = "regione_tpu_torch/csrc/attention_tma.cu"
JAX_FA = "regione_tpu/ops/flash_attention.py"
FUSED_SRC = "regione_tpu_torch/csrc/fused_block.cu"
# K7-K9 replace no Pallas kernel: XLA's fusions of these chains inside the
# jitted sampler phases
FUSED_REPLACES = ("regione_tpu/core/sampler.py:140 (XLA fusion of "
                  "regione_tpu/models/mmdit.py:140-143, 171-172, 202-208, "
                  "238, 260-264, 286, 558)")
# K11 replaces nothing of the JAX package, which has no FLUX.2 backbone
SWIGLU_REPLACES = "none (the JAX package has no SwiGLU MLP)"
KV_QUANT_SRC = "regione_tpu_torch/csrc/kv_quant.cu"
# K10 replaces no Pallas kernel: XLA's fusion of the cache quantizer in the
# jitted write phase
KV_QUANT_REPLACES = ("regione_tpu/models/mmdit.py:189, 275 (XLA fusion of "
                     "regione_tpu/ops/quant.py:296 quantize_kv_heads, :336 "
                     "quantize_kv_heads4)")
# record key -> (name, source, TPU kernel replaced, the path whose launch
# count the record carries, the counter)
KERNELS = {
    "attention": ("K1 attention", SRC, f"{JAX_FA}:69", "flux_image",
                  "attention"),
    "attention_rows2": ("K2 attention_rows2 (bf16 cache)", SRC,
                        f"{JAX_FA}:357", "flux_image", "attention_rows2"),
    "rows2_int8": ("K2q attention_rows2_quant (int8 cache)", SRC,
                   f"{JAX_FA}:357", "qwen_int8", "attention_rows2_quant"),
    "rows2_int4": ("K2q attention_rows2_quant (int4 cache)", SRC,
                   f"{JAX_FA}:357", "qwen_int4", "attention_rows2_quant"),
    "fused_partition": ("K3 fused_partition",
                        "regione_tpu_torch/csrc/partition.cu",
                        "regione_tpu/ops/partition_kernel.py:30", "flux_image",
                        "fused_partition"),
    "fused_partition_batched": ("K3 fused_partition, a group of 3 requests "
                                "in one launch",
                                "regione_tpu_torch/csrc/partition.cu",
                                "regione_tpu/ops/partition_kernel.py:30",
                                "serve_latent", "fused_partition"),
    "attention_long": ("K5 attention past 12,288 keys", SRC,
                       f"{JAX_FA}:157", "plus", "attention_long"),
    "attention_quant_int8": ("K6 attention_quant (int8)", SRC,
                             f"{JAX_FA}:133", "quant_int8",
                             "attention_quant"),
    "attention_quant_int4": ("K6 attention_quant (int4)", SRC,
                             f"{JAX_FA}:133", "quant_int4",
                             "attention_quant"),
    "headline_attention": ("K1 attention, the headline (step1x-edit:dev, "
                           "grid 64): launches per RegionE edit", SRC,
                           f"{JAX_FA}:69", "headline_edit", "attention"),
    "headline_rows2": ("K2 attention_rows2 (bf16 cache), the headline: "
                       "launches per RegionE edit", SRC, f"{JAX_FA}:357",
                       "headline_edit", "attention_rows2"),
    "tp4_attention": ("K1 attention at a Qwen tp 4 rank's shape "
                      "[2,6,8704,128] (exec_full_qwen60, grid 64, t_txt "
                      "512): launches of 13b's edit, as many as each tp 4 "
                      "rank makes", SRC, f"{JAX_FA}:69", "exec60",
                      "attention"),
    "tp4_rows2_int8": ("K2q attention_rows2_quant (int8 cache) at a Qwen "
                       "tp 4 rank's shape (6 heads, 512 + 13b's capacity "
                       "rows over 8192): launches of 13b's edit, as many as "
                       "each tp 4 rank makes", SRC, f"{JAX_FA}:357",
                       "exec60", "attention_rows2_quant"),
    "tp2_attention": ("K1 attention at Step1X tp 2's per-rank shape "
                      "[2,12,2176,128]: launches per rank of 11b", SRC,
                      f"{JAX_FA}:69", "sharded_step1x", "attention"),
    "tp2_rows2": ("K2 attention_rows2 (bf16 cache) at Step1X tp 2's "
                  "per-rank shape (12 heads, 128 + 384 rows over 2048): "
                  "launches per rank of 11b", SRC, f"{JAX_FA}:357",
                  "sharded_step1x", "attention_rows2"),
    "fused_adaln": ("K7 adaln (AdaLN), headline shape [2,8320,1536]: "
                    "launches per headline RegionE edit", FUSED_SRC,
                    FUSED_REPLACES, "headline_edit", "adaln"),
    "fused_residual_adaln": ("K7 residual_adaln (gated residual + AdaLN), "
                             "headline shape: launches per headline "
                             "RegionE edit", FUSED_SRC, FUSED_REPLACES,
                             "headline_edit", "residual_adaln"),
    "fused_gated_residual": ("K7 gated_residual (residual-only mode), "
                             "headline shape: launches per headline "
                             "RegionE edit", FUSED_SRC, FUSED_REPLACES,
                             "headline_edit", "gated_residual"),
    "fused_qk_norm_rope": ("K8 qk_norm_rope (qk-RMSNorm + RoPE + head "
                           "packing; v's packing counted too), q of the "
                           "headline single block's linear1 split: "
                           "launches per headline RegionE edit", FUSED_SRC,
                           FUSED_REPLACES, "headline_edit", "qk_norm_rope"),
    "fused_gelu_pack": ("K9 gelu_pack ([attn ‖ gelu_tanh(mlp_h)]; the "
                        "double block's GELU-only mode counted too), "
                        "headline single block: launches per headline "
                        "RegionE edit", FUSED_SRC, FUSED_REPLACES,
                        "headline_edit", "gelu_pack"),
    "fused_flux2_adaln": ("K7 adaln at FLUX.2's [1,8704,6144] (the "
                          "24-chunk instantiation): launches per RegionE "
                          "edit of phase 4's small FLUX.2 topology",
                          FUSED_SRC, FUSED_REPLACES, "flux2_small", "adaln"),
    "fused_swiglu_pack": ("K11 swiglu_pack ([attn ‖ silu(a) * b]; the double"
                          " block's gate-only mode counted too), FLUX.2's "
                          "single block [1,8704,6144] ‖ the gate of "
                          "[1,8704,36864]: launches per RegionE edit of "
                          "phase 4's small FLUX.2 topology", FUSED_SRC,
                          SWIGLU_REPLACES, "flux2_small", "swiglu_pack"),
    "kv_quant_int8": ("K10 store_quantized (int8 cache), Qwen's write "
                      "[2,24,8192,128] at row 1392: launches per Qwen grid-64 "
                      "RegionE edit", KV_QUANT_SRC, KV_QUANT_REPLACES,
                      "qwen_int8", "store_quantized"),
    "kv_quant_int4": ("K10 store_quantized (int4 cache), Qwen's write: "
                      "launches per Qwen grid-64 RegionE edit", KV_QUANT_SRC,
                      KV_QUANT_REPLACES, "qwen_int4", "store_quantized"),
}
RECORD_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "library")


def main():
    t = time.perf_counter()
    card = phase_environment()
    log(f"phase environment done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_build()
    log(f"phase build done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    grid, qwen_grid = 32, 64
    checks = phase_kernels(grid, qwen_grid)
    log(f"phase kernels done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    checks.update(phase_fused())
    log(f"phase 3f (the fused block kernels K7-K9, K11) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    checks.update(phase_kv_quant())
    log(f"phase 3c (the cache quantizer K10) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths = phase_small_reference()
    log(f"phase small reference done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths.update(phase_small_quantized())
    log(f"phase 4q (quantized weights, small, card vs CPU) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["large_grid"] = phase_large_grid()
    log(f"phase large grid (grid 160) done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_vae_card_vs_cpu()
    log(f"phase 6d (VAEs, card vs CPU) done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["step1x"], (pipe, ctx, lat0), probe5 = phase_slice(grid)
    phase_profile("step1x", pipe, ctx, lat0, grid)
    log(f"phase slice (step1x-edit) done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["serve_latent"], checks["serve_rows2"] = phase_serve_latent(
        pipe, ctx, grid)
    log(f"phase serve (a) (step1x-edit, a group of 3) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    te = vl_checkpoint()
    paths["thinker"] = phase_thinker(pipe, te)
    log(f"phase 10a (the v1.2 thinker, step1x at full width) done in "
        f"{time.perf_counter() - t:.1f}s")
    del pipe, ctx, lat0         # 24.6 GB of Step1X weights leave the card
    release()
    t = time.perf_counter()
    paths["headline_edit"], bench_checks = phase_bench()
    checks.update(bench_checks)
    log(f"phase 12 (the measuring entry points, the headline workload) done "
        f"in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["exec60"], script_checks = phase_ported_scripts(te)
    checks.update(script_checks)
    release()
    log(f"phase 13 (encoder placement, exec_full_qwen60, profile_rags, "
        f"fidelity_int8, the minibench chain) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    qwen, model, qwen_checks, qwen_request, probe5b = phase_qwen_slice(
        qwen_grid)
    paths.update({f"qwen_{k}": v for k, v in qwen.items()})
    checks.update(qwen_checks)
    release()
    log(f"phase slice (qwen-image-edit) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["qwen_image"] = phase_qwen_image(model)
    log(f"phase 6b (qwen-image-edit __call__) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["qwen_int4_weights"] = phase_qwen_int4(model, qwen_request,
                                                 qwen_grid)
    del model, qwen_request     # the Qwen weights leave the card
    release()
    log(f"phase 8b (qwen-image-edit, int4 weights and cache) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_pixelprobe([
        ("phase 5 step1x request 1, 512x512", *probe5, grid, "flux"),
        (f"phase 5b qwen int8 cache, {16 * qwen_grid}x{16 * qwen_grid}",
         *probe5b, qwen_grid, "wan")])
    log(f"phase 10d (pixel probe, both decoder families) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    flux_paths, flux_checks, flux_out = phase_flux_image(te=te)
    paths.update(flux_paths)
    checks.update(flux_checks)
    release()
    log(f"phase 6a/serve (b)/6c/10b (flux-kontext image path, EditService, "
        f"CLI, eval chain) done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_lpips()
    log(f"phase 10c (LPIPS, card vs CPU) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["flux_w8a8"] = phase_flux_w8a8(flux_out)
    log(f"phase 8a (flux-kontext, W8A8 and the int8 cache) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_checkpoints()
    log(f"phase 7 (checkpoint loading at full width) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths.update(phase_sharded())
    log(f"phase 11 (the sharded port, gloo through the host on one card) "
        f"done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["encoder"] = phase_encoder(te=te)
    log(f"phase 9 (the real prompt encoder on the card) done in "
        f"{time.perf_counter() - t:.1f}s")

    import torch
    record = []
    for key, (label, src, replaces, path, counter) in KERNELS.items():
        record.append({"name": label, "route": "cuda", "source": src,
                       "replaces": replaces,
                       "launches": paths[path][counter],
                       **{k: checks[key][k] for k in RECORD_KEYS}})
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
