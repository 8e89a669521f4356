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
  4. small head_dim-128 models: the card's path against the port's CPU
     path on the same weights and inputs: Step1X topology (bf16 cache),
     Qwen topology with the int8 and the int4 cache, Qwen-Image-Edit-Plus
     with two 64 x 64 references (dense S past 12,288: K5), and
     `sdpa_cached` over a quantized cache alone (K6); then, on the card
     alone, the Step1X topology with 64 in / out channels at grid 160
     (S 25,600, a 2560 x 2560 image): a dense and a RegionE edit, K3 once,
     a partial partition, latent PSNR against dense;
  5. the Step1X-Edit slice at full published width and depth with random
     bf16 weights: a dense 28-step edit and the RegionE edit of two
     requests through `Step1XEditPipeline.edit_latents`, with the kernels'
     launch counts, the plan statistics, the timings and the latent PSNR of
     RegionE against dense; then its device time by kernel group
     (torch.profiler) and the device's idle share;
  7. serving (a), on phase 5's weights: three requests with partial
     partitions of different sizes, each through `edit_latents`, then as
     one group through `edit_latents_batch` (one K3 launch, one capacity):
     per-image counts, latent PSNR of batched against single >= 40 dB,
     seconds per image and images/s both ways, peaks, the group's profile,
     `memplan.plan` beside the card's bytes, K2 at the group's shape;
  5b. the Qwen-Image-Edit slice at full published width and depth (60
     double blocks, 20.4 B parameters, random bf16 weights) at its native
     1024 x 1024 (grid 64): one request, its dense edit, the int8-cache
     RegionE edit twice (warm, then timed), then the int4- and the
     bf16-cache RegionE edits on the same weights; the profiles of the
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
     7b. serving (b), on 6a's pipeline: `EditService.run` and
         `run_batched(max_batch=2)` over two 900 x 900 requests and one
         1200 x 800 (two geometry groups): uint8 outputs at the input
         geometry, pixel PSNR of batched against single >= 40 dB, and
         `run` against 6a's `pipe(image, prompt, seed=3)`;
     6c. the CLI's `run_demo` on that pipeline, writing demo_0.png.
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
# phases 4-6: the small reference, the slice, the profile
# ---------------------------------------------------------------------------

T_TXT = 128
PSNR_MIN = 30.0


def psnr(a, b) -> float:
    """Latent PSNR of b against a, peak = a's range (as bench.py)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    peak = float(max(a.max() - a.min(), 1e-9))
    return 10.0 * np.log10(peak * peak / mse)


def reset_counts():
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import partition_kernel as pk
    fa.reset_launches()
    pk.fused_partition.launches = 0


def read_counts():
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import partition_kernel as pk
    return {"attention": fa.attention.launches,
            "attention_long": fa.attention.long_launches,
            "attention_rows2": fa.attention_rows2.launches,
            "attention_rows2_quant": fa.attention_rows2_quant.launches,
            "attention_quant": fa.attention_quant.launches,
            "fused_partition": pk.fused_partition.launches}


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
                cond_grids=None):
    """One forced-mask edit of a small model on the CPU in fp32 (the plain
    versions, held against the JAX package by the CPU tests) and on the
    card in bf16 (the kernels), same weights and inputs: equal stats,
    latent PSNR >= 30 dB.  Returns the card run's launch counts."""
    import torch
    from regione_tpu_torch.models.mmdit import MMDiT
    from regione_tpu_torch.weights.from_jax import init_params
    card_cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    if cfg.connector is not None:
        card_cfg = dataclasses.replace(card_cfg, connector=dataclasses.replace(
            cfg.connector, dtype=torch.bfloat16))
    ref_model = init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    card_model = MMDiT(card_cfg, torch.device(DEVICE)).eval()
    card_model.load_state_dict(ref_model.state_dict())
    s = grid * grid
    s_cond = sum(h * w for h, w in cond_grids) if cond_grids else s
    txt_dim = cfg.connector.in_dim if cfg.connector else cfg.txt_in_dim
    rng = np.random.default_rng(5)
    txt = rng.standard_normal((2, t_txt, txt_dim)).astype(np.float32)
    cond = 0.5 * rng.standard_normal((1, s_cond, cfg.in_channels)).astype(
        np.float32)
    lat0 = rng.standard_normal((1, s, cfg.in_channels)).astype(np.float32)
    outs = []
    for model in (ref_model, card_model):
        pipe = pipe_cls(model, re)
        dev = pipe.device
        ctx = _ctx(torch.from_numpy(txt).to(dev, model.cfg.dtype), None, cond,
                   pipe.build_rope(grid, grid, t_txt, cond_grids))
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
    past the resident budget (K5).  Then `sdpa_cached` over a quantized
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
        cfg = dataclasses.replace(qwen, **{f"cache_int{bits}": True})
        c = card_vs_cpu(f"qwen topology, int{bits} cache", cfg,
                        QwenImageEditPipeline, re, 8, 16, forced)
        if not (c["attention_rows2_quant"] > 0 and c["attention_rows2"] == 0
                and c["attention"] > 0):
            fail(f"qwen int{bits} small reference: launch counts {c}")
    # (c) Plus: noise 64 x 64 and two 64 x 64 references: dense S = 16 +
    # 12,288 keys; one attention head keeps the CPU reference short
    forced = np.zeros((64, 64), bool)
    forced[8:24, 10:30] = True
    c = card_vs_cpu("qwen-image-edit-plus, two 64x64 references, int8 "
                    "cache", dataclasses.replace(qwen, heads=1,
                                                 cache_int8=True),
                    QwenImageEditPlusPipeline,
                    RegionEParams(capacity_granularity=64), 64, 16, forced,
                    cond_grids=[(64, 64), (64, 64)])
    if not (c["attention_long"] > 0 and c["attention_rows2_quant"] > 0):
        fail(f"plus small reference: no launch past {RESIDENT_KEYS} keys "
             f"({c})")
    counts["plus"] = c
    counts.update(check_sdpa_cached_alone())
    return counts


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


def structured_condition(pipe, sampler, re, grid, txt, pooled, rope, lat0,
                         r, label, span=7):
    """bench.py's probe: the x0 estimate at the partition step with a block
    replaced by noise, so the adaptive partition is partial with random
    weights (the block, grid/16 to span * grid/16 on each axis, dilated
    5x5: ~20% of the grid at span 7).  Returns the condition latent (numpy
    [1, S, C])."""
    import torch
    from regione_tpu_torch.core.partition import select_edited_mask
    s, c_in = grid * grid, pipe.cfg.in_channels
    warm = sampler.plan[: re.warmup_step - 1]
    part = sampler.plan[re.warmup_step - 1]

    @torch.inference_mode()
    def x0_probe(ctx):
        """x0 estimate at the partition step (the sampler's math)."""
        ctx = dataclasses.replace(ctx, s_noise=s)
        lat = sampler._dense_steps(lat0.float(), warm, ctx)
        v, _ = pipe.dense_forward(lat, part.sigma, None, ctx, False)
        return lat + part.dt_final * v

    b0, b1 = grid // 16, grid * span // 16
    block = np.zeros((grid, grid), bool)
    block[b0:b1, b0:b1] = True
    target = block.reshape(-1)
    noise_block = r.standard_normal((int(target.sum()), c_in))
    cond = r.standard_normal((1, s, c_in))
    for it in range(3):
        t = time.perf_counter()
        x0 = x0_probe(_ctx(txt, pooled, cond, rope))
        cond = x0.cpu().numpy().copy()
        cond[0, target] = noise_block
        mask = select_edited_mask(
            x0, torch.as_tensor(cond, dtype=torch.float32, device=x0.device),
            re.threshold, grid_h=grid, grid_w=grid,
            erosion_dilation=re.erosion_dilation)
        frac = float(mask.float().mean())
        log(f"{label}: probe {it}: edited fraction {frac:.3f} "
            f"({time.perf_counter() - t:.1f}s)")
        if 0.18 <= frac <= 0.35 and it >= 1:
            break
    return cond


def timed_edit(pipe, lat0, ctx, grid, dense_only=False):
    """One edit, host wall time ended by a synchronize, launch counts set to
    0 just before and read just after, peak device memory of the edit.
    Returns (latents numpy, stats, seconds, counts, peak GiB)."""
    import torch
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out, stats = pipe.edit_latents(lat0, ctx, grid, grid,
                                   dense_only=dense_only)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    return out.cpu().numpy(), stats, sec, counts, peak


def check_edit(label, out, stats, counts, dense, shape, cache):
    """The RegionE edit's checks: finite latents of the right shape, a
    partial partition with RAGS steps, PSNR against dense, and the launch
    counts of its cache format (K2 for bf16, K2q for int8 / int4; K1 > 0,
    K3 == 1).  Returns the PSNR."""
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
            and counts[other] == 0 and counts["fused_partition"] == 1):
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
    in the timed RegionE edit (the second request)."""
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
        cond = structured_condition(pipe, sampler, re, grid, txt, pooled,
                                    rope, lat0, r, label)
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
    return runs[-1], (pipe, ctx, lat0)


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
    cond = structured_condition(pipe, sampler, re, grid, txt, None, rope,
                                lat0, r, label)
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
    its dense edit, the int8-cache RegionE edit twice (warm, then timed),
    then the int4- and the bf16-cache RegionE edits on the same weights and
    request (only the config's cache flags change); the profiles of the
    dense and the int8 RegionE edit, and of the bf16 RegionE edit (the
    control for the quantized formats); then the RAGS kernels at this
    path's shape.  Returns {cache format: launch counts}, the model (int8
    cache) and the kernels' records at this path's shape."""
    import torch
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.weights.from_jax import init_params

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(get_config(preset), cache_int8=True)
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
    cond = structured_condition(pipe, sampler, re, grid, txt, None, rope,
                                lat0, r, label)
    ctx = _ctx(txt, None, cond, rope)
    dense, _, dense_s, dense_counts, dense_peak = timed_edit(
        pipe, lat0, ctx, grid, dense_only=True)
    log(f"{label}: dense_s {dense_s:.3f}, launches {dense_counts}, peak "
        f"device memory {dense_peak:.1f} GiB")
    formats = (("int8 warm", {}), ("int8", {}),
               ("int4", dict(cache_int8=False, cache_int4=True)),
               ("bf16", dict(cache_int8=False)))
    counts, outs, secs = {}, {}, {}
    for name, flags in formats:
        model.cfg = dataclasses.replace(cfg, **flags)
        out, stats, sec, c, peak = timed_edit(
            QwenImageEditPipeline(model, re), lat0, ctx, grid)
        fmt = name.split()[0]
        log(f"{label}, {name} cache: launches {c}")
        log(f"{label}, {name} cache: regione_s {sec:.3f} speedup "
            f"{dense_s / sec:.3f}x, K2q launches "
            f"{c['attention_rows2_quant']}, K2 launches "
            f"{c['attention_rows2']}, peak device memory {peak:.1f} GiB")
        check_edit(f"{label}, {name} cache", out, stats, c, dense, shape, fmt)
        counts[fmt], outs[fmt], secs[name] = c, out, sec
    model.cfg = cfg
    log(f"{label}: regione_s by cache format: " + ", ".join(
        f"{n} {sec:.3f}" for n, sec in secs.items())
        + f"; int8 - bf16 {secs['int8'] - secs['bf16']:+.3f} s, int4 - bf16 "
        f"{secs['int4'] - secs['bf16']:+.3f} s")
    log(f"{label}, cache formats against the bf16 cache: int8 "
        f"{psnr(outs['bf16'], outs['int8']):.2f} dB, int4 "
        f"{psnr(outs['bf16'], outs['int4']):.2f} dB latent PSNR")
    phase_profile(f"{label} int8", pipe, ctx, lat0, grid)
    model.cfg = dataclasses.replace(cfg, cache_int8=False)
    phase_profile(f"{label} bf16", QwenImageEditPipeline(model, re), ctx,
                  lat0, grid, modes=(False,))
    model.cfg = cfg
    del pipe, ctx, lat0
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
    return counts, model, checks


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "attention_tma_kernel" in n:
        return "attention K1/K2/K2q"
    if "partition_kernel" in n:
        return "partition K3"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return "GEMM (cuBLAS)"
    return "other (norms, RoPE, elementwise, copies)"


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
    from regione_tpu_torch.models.mmdit import init_cache
    from regione_tpu_torch.utils import memplan
    re, cfg = pipe.re, pipe.cfg
    s = grid * grid
    sampler = pipe.sampler_for(grid, grid, T_TXT, 2)
    rope = (ctx0.rope_img, ctx0.rope_txt)
    lats, ctxs, seq = [], [], []
    for k, seed in enumerate(seeds):
        label = f"serve (a) request {seed}"
        r, lat0 = _request(cfg, seed, grid)
        cond = structured_condition(pipe, sampler, re, grid, ctx0.txt,
                                    ctx0.pooled, rope, lat0, r, label,
                                    span=5 + 2 * k)
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
            and counts["attention_rows2_quant"] == 0):
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
    cache = init_cache(cfg, 2 * n, 2 * s, torch.device(DEVICE))
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
            counts["attention_rows2"] > 0):
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
            and counts[rags] > 0 and counts[other] == 0):
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


def phase_flux_image(preset="flux-kontext", vae_cfg=None, size=900):
    """6a, serve (b) and 6c: FLUX.1 Kontext at full width through the
    image-level entry points.  The CLI's `build_pipeline` builds the
    backbone (random bf16 weights from --seed); 6a edits with it through a
    `FluxKontextPipeline` holding the published-size AutoencoderKL, and
    serve (b) serves three requests on that pipeline
    (`phase_serve_images`); 6c runs the CLI's `run_demo` on the CLI's own
    pipeline.  Returns the launch counts of the timed RegionE call, of
    serve (b)'s `run_batched` and of the CLI edit, and the kernel checks at
    this path's shapes."""
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
    return paths, checks


SRC = "regione_tpu_torch/csrc/attention_tma.cu"
JAX_FA = "regione_tpu/ops/flash_attention.py"
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
    paths = phase_small_reference()
    log(f"phase small reference done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["large_grid"] = phase_large_grid()
    log(f"phase large grid (grid 160) done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_vae_card_vs_cpu()
    log(f"phase 6d (VAEs, card vs CPU) done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["step1x"], (pipe, ctx, lat0) = phase_slice(grid)
    phase_profile("step1x", pipe, ctx, lat0, grid)
    log(f"phase slice (step1x-edit) done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["serve_latent"], checks["serve_rows2"] = phase_serve_latent(
        pipe, ctx, grid)
    del pipe, ctx, lat0         # 24.6 GB of Step1X weights leave the card
    release()
    log(f"phase serve (a) (step1x-edit, a group of 3) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    qwen, model, qwen_checks = phase_qwen_slice(qwen_grid)
    paths.update({f"qwen_{k}": v for k, v in qwen.items()})
    checks.update(qwen_checks)
    release()
    log(f"phase slice (qwen-image-edit) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths["qwen_image"] = phase_qwen_image(model)
    del model           # 38.1 GiB of Qwen weights leave the card
    release()
    log(f"phase 6b (qwen-image-edit __call__) done in "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    flux_paths, flux_checks = phase_flux_image()
    paths.update(flux_paths)
    checks.update(flux_checks)
    release()
    log(f"phase 6a/serve (b)/6c (flux-kontext image path, EditService, CLI) "
        f"done in {time.perf_counter() - t:.1f}s")

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
