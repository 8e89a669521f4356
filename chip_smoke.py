"""Drive the PyTorch port of RegionE end to end on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card and nvcc; no arguments

Phases, each printing its lines and seconds; any failure exits non-zero:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build the hand-written kernels from regione_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version at the slice's shapes,
     with its error bound, and both times (CUDA events);
  4. a small head_dim-128 model: the card's path against the port's CPU
     path on the same weights and inputs;
  5. the slice: Step1X-Edit at full published width and depth with random
     bf16 weights, a dense 28-step edit and the RegionE edit of two
     requests through `Step1XEditPipeline.edit_latents`, with the kernels'
     launch counts, the plan statistics, the timings and the latent PSNR of
     RegionE against dense;
  6. device time of one dense and one RegionE edit by kernel group
     (torch.profiler), and the device's idle share.
The line before the last is the kernels' JSON record, the last line the
device record.  Imports no JAX: the port and the numpy-only
`regione_tpu.core.{config,schedule,gamma}` modules only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

T0 = time.perf_counter()


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


def _heads_view(rng, b, h, t, d, device):
    """[B, H, T, D] bf16 as the model makes it: a head-split view of a
    [B, T, H*D] tensor (non-contiguous, as `split_heads` returns)."""
    import torch
    x = torch.from_numpy(rng.standard_normal((b, t, h * d), np.float32))
    x = x.to(device=device, dtype=torch.bfloat16)
    return x.view(b, t, h, d).transpose(1, 2)


def check_attention(rng, b, h, t, s, with_bias, iters):
    """K1 at [b, h, t, d] over s keys; the plain version runs in head chunks
    (its fp32 logits at s = 8320 would be ~13 GB in one piece)."""
    import torch
    from regione_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
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
    chunk = max(1, min(h, int(2e9 // (4 * b * t * s))))

    def plain():
        outs = []
        for h0 in range(0, h, chunk):
            sl = slice(h0, h0 + chunk)
            outs.append(fa.attention_reference(q[:, sl], k[:, sl], v[:, sl],
                                               bias))
        return torch.cat(outs, dim=-1)

    got = fa.attention(q, k, v, bias)
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    max_abs = float(err.max())
    ok = bool(torch.isfinite(got).all()) and max_abs <= ATTN_REL_BOUND * scale
    ms = cuda_ms(lambda: fa.attention(q, k, v, bias), iters)
    pms = cuda_ms(plain, max(1, iters // 2))
    log(f"K1 attention [{b},{h},{t},{d}] x S={s} bias={with_bias}: "
        f"max_abs {max_abs:.3e} max_rel {max_abs / scale:.3e} "
        f"(bound {ATTN_REL_BOUND:.0e} x {scale:.3e}) "
        f"kernel {ms:.3f} ms plain {pms:.3f} ms {'ok' if ok else 'FAIL'}")
    return ok, max_abs, ms, pms


def check_rows2(rng, b, h, t_txt, cap, s_cache, iters):
    """K2: q over [fresh txt+cap rows ‖ cache] with a RAGS-style bias (pad
    slots and stale cache rows at -1e30)."""
    import torch
    from regione_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    d = 128
    t1 = t_txt + cap
    q = _heads_view(rng, b, h, t1, d, dev)
    k1 = _heads_view(rng, b, h, t1, d, dev).contiguous()
    v1 = _heads_view(rng, b, h, t1, d, dev).contiguous()
    kc = _heads_view(rng, b, h, s_cache, d, dev).contiguous()
    vc = _heads_view(rng, b, h, s_cache, d, dev).contiguous()
    bn = np.zeros((b, t1 + s_cache), np.float32)
    n_pad = cap // 8
    bn[:, t1 - n_pad:t1] = -1e30                         # pad slots
    stale = rng.choice(s_cache // 2, cap - n_pad, replace=False)
    bn[:, t1 + stale] = -1e30                            # stale cache rows
    bias = torch.from_numpy(bn).to(dev)

    def plain():
        return fa.attention_rows2_reference(q, k1, v1, kc, vc, bias)

    got = fa.attention_rows2(q, k1, v1, kc, vc, bias)
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    max_abs = float(err.max())
    ok = bool(torch.isfinite(got).all()) and max_abs <= ATTN_REL_BOUND * scale
    ms = cuda_ms(lambda: fa.attention_rows2(q, k1, v1, kc, vc, bias), iters)
    pms = cuda_ms(plain, iters)
    log(f"K2 rows2 [{b},{h},{t1},{d}] x ({t1} fresh + {s_cache} cache): "
        f"max_abs {max_abs:.3e} max_rel {max_abs / scale:.3e} "
        f"(bound {ATTN_REL_BOUND:.0e} x {scale:.3e}) "
        f"kernel {ms:.3f} ms plain {pms:.3f} ms {'ok' if ok else 'FAIL'}")
    return ok, max_abs, ms, pms


def check_partition(rng, grid, d, iters):
    """K3 on a [grid, grid, d] fp32 pair.  Masks must agree except at
    tokens whose fp64 similarity lies within 1e-5 of the threshold; with
    morphology, the plain morphology over the kernel's own threshold
    decisions must equal the kernel exactly."""
    import torch
    from regione_tpu_torch.ops import partition_kernel as pk
    dev = torch.device("cuda")
    s = grid * grid
    thr = 0.88
    x0 = rng.standard_normal((s, d)).astype(np.float32)
    cond = x0 + 0.35 * rng.standard_normal((s, d)).astype(np.float32)
    blk = np.zeros((grid, grid), bool)
    blk[grid // 8: grid // 2, grid // 8: grid // 2] = True
    cond[blk.reshape(-1)] = rng.standard_normal(
        (int(blk.sum()), d)).astype(np.float32)
    x0_t = torch.from_numpy(x0).to(dev)
    cond_t = torch.from_numpy(cond).to(dev)
    x64, c64 = x0.astype(np.float64), cond.astype(np.float64)
    sim = (x64 * c64).sum(-1) / np.sqrt((x64 * x64).sum(-1)
                                        * (c64 * c64).sum(-1) + 1e-12)
    near = np.abs(sim - thr) < 1e-5
    raw = pk.fused_partition(x0_t, cond_t, thr, grid, grid, False)
    full = pk.fused_partition(x0_t, cond_t, thr, grid, grid, True)
    torch.cuda.synchronize()
    raw_ref = pk.partition_reference(x0_t, cond_t, thr, grid, grid, False)
    diff = (raw != raw_ref).cpu().numpy()
    ok = not (diff & ~near).any()
    morph = pk.remove_scattered_points(raw.reshape(grid, grid)).reshape(-1)
    ok = ok and bool((morph == full).all())
    full_ref = pk.partition_reference(x0_t, cond_t, thr, grid, grid, True)
    n_diff = int((full_ref != full).sum())
    ok = ok and (n_diff == 0 or bool(near.any()))
    ms = cuda_ms(lambda: pk.fused_partition(x0_t, cond_t, thr, grid, grid,
                                            True), iters)
    pms = cuda_ms(lambda: pk.partition_reference(x0_t, cond_t, thr, grid,
                                                 grid, True), iters)
    edited = int(full.sum())
    log(f"K3 partition {grid}x{grid}x{d}: edited {edited}/{s}, raw-mask "
        f"differences {int(diff.sum())}, tokens within 1e-5 of the "
        f"threshold {int(near.sum())}, final-mask differences {n_diff}; "
        f"kernel {ms:.4f} ms plain {pms:.4f} ms {'ok' if ok else 'FAIL'}")
    # max |plain - kernel| over the 0/1 final masks
    return ok, float(n_diff > 0), ms, pms


def phase_kernels(grid):
    """Each kernel at the slice's shapes; returns the record of each kernel
    at the shape the main path gives it (grid `grid`, t_txt 128)."""
    rng = np.random.default_rng(0)
    s_main = 128 + 2 * grid * grid
    results, ok = {}, True
    for t, bias in ((s_main, False), (s_main, True), (8320, False),
                    (8320, True)):
        r = check_attention(rng, 2, 24, t, t, bias, iters=5)
        ok &= r[0]
        if t == s_main and not bias:
            results["attention"] = r
    r = check_attention(rng, 2, 28, 128, 128, False, iters=20)  # connector
    ok &= r[0]
    for t_txt, cap, s_cache in ((128, 1024, 8192),
                                (128, grid * grid // 4, 2 * grid * grid)):
        r = check_rows2(rng, 2, 24, t_txt, cap, s_cache, iters=10)
        ok &= r[0]
        if s_cache == 2 * grid * grid:
            results["attention_rows2"] = r
    for g in (64, 32):
        r = check_partition(rng, g, 64, iters=20)
        ok &= r[0]
        if g == grid:
            results["fused_partition"] = r
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
    fa.attention.launches = 0
    fa.attention_rows2.launches = 0
    pk.fused_partition.launches = 0


def read_counts():
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import partition_kernel as pk
    return {"attention": fa.attention.launches,
            "attention_rows2": fa.attention_rows2.launches,
            "fused_partition": pk.fused_partition.launches}


def _ctx(txt, pooled, cond, rope):
    import torch
    from regione_tpu_torch.pipelines.base import EditInputs
    return EditInputs(txt=txt, cond_latent=torch.as_tensor(
        cond, dtype=torch.float32, device=txt.device), rope_img=rope[0],
        rope_txt=rope[1], pooled=pooled)


def phase_small_reference():
    """The card's path (kernels, bf16) against the port's CPU path (plain
    versions, fp32, held against the JAX package by the CPU tests) on a
    small Step1X-topology model with head_dim 128 and a forced partition:
    equal stats, latent PSNR >= 30 dB."""
    import dataclasses

    import torch
    from regione_tpu.core.config import RegionEParams
    from regione_tpu_torch.models.connector import ConnectorConfig
    from regione_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.weights.from_jax import init_params
    conn = ConnectorConfig(in_dim=64, hidden=256, heads=2, depth=1,
                           pooled_dim=32, time_embed_dim=64,
                           dtype=torch.float32)
    cfg = MMDiTConfig(hidden=256, heads=2, head_dim=128, depth_double=2,
                      depth_single=2, txt_in_dim=256, pooled_dim=32,
                      time_embed_dim=64, mlp_ratio=2.0, in_channels=16,
                      out_channels=16, dtype=torch.float32, connector=conn)
    card_cfg = dataclasses.replace(
        cfg, dtype=torch.bfloat16,
        connector=dataclasses.replace(conn, dtype=torch.bfloat16))
    grid, t_txt = 8, 16
    ref_model = init_params(cfg, torch.Generator().manual_seed(1))
    card_model = MMDiT(card_cfg, torch.device("cuda")).eval()
    card_model.load_state_dict(ref_model.state_dict())
    re = RegionEParams(capacity_granularity=16)
    rng = np.random.default_rng(5)
    txt = rng.standard_normal((2, t_txt, 64)).astype(np.float32)
    cond = 0.5 * rng.standard_normal((1, grid * grid, 16)).astype(np.float32)
    lat0 = rng.standard_normal((1, grid * grid, 16)).astype(np.float32)
    forced = np.zeros((grid, grid), bool)
    forced[1:5, 2:7] = True
    outs = []
    for model in (ref_model, card_model):
        pipe = Step1XEditPipeline(model, re)
        dev = pipe.device
        ctx = _ctx(torch.from_numpy(txt).to(dev, model.cfg.dtype), None, cond,
                   pipe.build_rope(grid, grid, t_txt))
        out, stats = pipe.edit_latents(
            torch.from_numpy(lat0).to(dev), ctx, grid, grid,
            forced_mask=torch.from_numpy(forced.reshape(-1)).to(dev))
        outs.append((out.float().cpu().numpy(), stats))
    (ref, s_ref), (got, s_got) = outs
    p = psnr(ref, got)
    ok = s_ref == s_got and bool(np.isfinite(got).all()) and p >= PSNR_MIN
    log(f"small reference (head_dim 128, grid {grid}, forced mask): "
        f"card bf16 vs CPU fp32 latent PSNR {p:.2f} dB (min {PSNR_MIN}), "
        f"stats {'equal' if s_ref == s_got else f'{s_ref} vs {s_got}'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the card's path disagrees with the CPU reference")


def phase_slice(grid):
    """Step1X-Edit at full width and depth on the card: the dense edit and
    the RegionE edit of two requests.  Returns the kernels' launch counts
    in the timed RegionE edit (the second request)."""
    import torch
    from regione_tpu.core.config import RegionEParams
    from regione_tpu_torch.core.partition import select_edited_mask
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
    from regione_tpu_torch.weights.from_jax import init_params

    dev = torch.device("cuda")
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
    s = grid * grid
    rng = np.random.default_rng(110)
    rope = pipe.build_rope(grid, grid, T_TXT)
    txt = torch.from_numpy(rng.standard_normal(
        (2, T_TXT, cfg.txt_in_dim), np.float32)).to(dev, cfg.dtype)
    pooled = torch.from_numpy(rng.standard_normal(
        (2, cfg.pooled_dim), np.float32)).to(dev, cfg.dtype)
    sampler = pipe.sampler_for(grid, grid, T_TXT, 2)
    warm = sampler.plan[: re.warmup_step - 1]
    part = sampler.plan[re.warmup_step - 1]

    @torch.inference_mode()
    def x0_probe(lat, ctx):
        """x0 estimate at the partition step (the sampler's math)."""
        import dataclasses
        ctx = dataclasses.replace(ctx, s_noise=s)
        lat = sampler._dense_steps(lat.float(), warm, ctx)
        v, _ = pipe.dense_forward(lat, part.sigma, None, ctx, False)
        return lat + part.dt_final * v

    # structured condition latent (bench.py's probe): the x0 estimate with
    # a block replaced by noise, so the adaptive partition is partial with
    # random weights; the block's 5x5 dilation covers ~25% of the grid
    b0, b1 = grid // 16, grid * 7 // 16
    block = np.zeros((grid, grid), bool)
    block[b0:b1, b0:b1] = True
    target = block.reshape(-1)

    runs = []
    for req, seed in enumerate((110, 111)):
        r = np.random.default_rng(seed)
        lat0 = torch.from_numpy(r.standard_normal(
            (1, s, cfg.in_channels), np.float32)).to(dev)
        noise_block = r.standard_normal((int(target.sum()), cfg.in_channels))
        cond = r.standard_normal((1, s, cfg.in_channels))
        for it in range(3):
            t = time.perf_counter()
            x0 = x0_probe(lat0, _ctx(txt, pooled, cond, rope))
            cond = x0.cpu().numpy().copy()
            cond[0, target] = noise_block
            mask = select_edited_mask(
                x0, torch.as_tensor(cond, dtype=torch.float32, device=dev),
                re.threshold, grid_h=grid, grid_w=grid,
                erosion_dilation=re.erosion_dilation)
            frac = float(mask.float().mean())
            log(f"request {req}: probe {it}: edited fraction {frac:.3f} "
                f"({time.perf_counter() - t:.1f}s)")
            if 0.18 <= frac <= 0.35 and it >= 1:
                break
        ctx = _ctx(txt, pooled, cond, rope)

        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        dense, _ = pipe.edit_latents(lat0, ctx, grid, grid, dense_only=True)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t
        dense_counts = read_counts()

        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, stats = pipe.edit_latents(lat0, ctx, grid, grid)
        torch.cuda.synchronize()
        regione_s = time.perf_counter() - t
        counts = read_counts()

        dense_np = dense.cpu().numpy()
        out_np = out.cpu().numpy()
        p = psnr(dense_np, out_np)
        finite = bool(np.isfinite(dense_np).all() and np.isfinite(out_np).all())
        log(f"request {req}: dense launches {dense_counts}")
        log(f"request {req}: RegionE launches {counts}")
        log(f"request {req}: edited_tokens {stats.edited_tokens} capacity "
            f"{stats.capacity} seq_len {stats.seq_len} dense_steps "
            f"{stats.dense_steps} rags_steps {stats.rags_steps} reuse_steps "
            f"{stats.reuse_steps}")
        log(f"request {req}: dense_s {dense_s:.3f} regione_s {regione_s:.3f} "
            f"speedup {dense_s / regione_s:.3f}x psnr_latent_vs_dense "
            f"{p:.2f} dB, finite {finite}, shape {tuple(out.shape)}")
        problems = []
        if not (counts["attention"] > 0 and counts["attention_rows2"] > 0
                and counts["fused_partition"] == 1):
            problems.append(f"launch counts {counts}")
        if not 0 < stats.edited_tokens < stats.seq_len:
            problems.append(f"partition not partial ({stats.edited_tokens})")
        if stats.rags_steps <= 0:
            problems.append("no RAGS steps")
        if not finite or tuple(out.shape) != (1, s, cfg.out_channels):
            problems.append("latents not finite or of the wrong shape")
        if not p >= PSNR_MIN:
            problems.append(f"PSNR {p:.2f} < {PSNR_MIN}")
        if problems:
            fail(f"request {req}: " + "; ".join(problems))
        runs.append(counts)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        "GiB")
    return runs[-1], (pipe, ctx, lat0)


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "attention_kernel" in n:
        return "attention K1/K2"
    if "partition_kernel" in n:
        return "partition K3"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return "GEMM (cuBLAS)"
    return "other (norms, RoPE, elementwise, copies)"


def phase_profile(pipe, ctx, lat0, grid):
    """Device time by kernel group over one dense and one RegionE edit
    (torch.profiler's CUDA trace), and the device's idle share: 1 - kernel
    time / host wall time of the edit (one stream, kernels never overlap)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from regione_tpu_torch.ops._build import BUILD_DIR
    trace_dir = BUILD_DIR.parent / "profile"     # inside the checkout
    trace_dir.mkdir(parents=True, exist_ok=True)
    for dense_only in (True, False):
        label = "dense" if dense_only else "RegionE"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            pipe.edit_latents(lat0, ctx, grid, grid, dense_only=dense_only)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        path = str(trace_dir / f"trace_{label}.json")
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
        log(f"profile {label} edit: wall {wall:.3f}s (profiled), kernel time "
            f"{busy:.3f}s, device idle share {1 - busy / wall:.3f}")
        for g, sec in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"  {g}: {sec:.3f}s ({sec / busy:.3f} of kernel time)")
        for n, sec in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
            log(f"    {sec:.3f}s {n}")


KERNELS = {
    "attention": ("K1 attention", "regione_tpu_torch/csrc/attention.cu",
                  "regione_tpu/ops/flash_attention.py:69"),
    "attention_rows2": ("K2 attention_rows2",
                        "regione_tpu_torch/csrc/attention.cu",
                        "regione_tpu/ops/flash_attention.py:357"),
    "fused_partition": ("K3 fused_partition",
                        "regione_tpu_torch/csrc/partition.cu",
                        "regione_tpu/ops/partition_kernel.py:30"),
}


def main():
    t = time.perf_counter()
    card = phase_environment()
    log(f"phase environment done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_build()
    log(f"phase build done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    grid = 32
    checks = phase_kernels(grid)
    log(f"phase kernels done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_small_reference()
    log(f"phase small reference done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    launches, (pipe, ctx, lat0) = phase_slice(grid)
    log(f"phase slice done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_profile(pipe, ctx, lat0, grid)
    log(f"phase profile done in {time.perf_counter() - t:.1f}s")

    import torch
    record = []
    for name, (label, src, replaces) in KERNELS.items():
        ok, err, ms, pms = checks[name]
        record.append({"name": label, "route": "cuda", "source": src,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
