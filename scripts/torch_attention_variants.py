"""Time the port's attention kernel against variants of its own source, on
one NVIDIA GPU, in one process (so every number comes from the same card).

    python3 scripts/torch_attention_variants.py [--shapes rags|table]
        [--variants kernel,no_dequant,...] [--parent DIR] [--library]
        [--out FILE]

Each variant is a copy of `regione_tpu_torch/csrc/*.cu` under
`build/variants/<name>/` with text edits applied to `attention_tma.cu`,
built by `ops/_build.py` into its own library; the wrappers of
`ops/flash_attention.py` then launch it.  The edited variants only measure
where the time goes: their outputs are wrong and are not checked.

  kernel            the source as it is;
  no_dequant        the quantized modes' producers skip the dequant (they
                    still wait for the codes and arrive on every barrier);
  no_consumer_math  the consumers skip both products and the softmax (they
                    still wait for every stage and release it);
  ping_pong         bf16: FA3's explicit ping-pong, named barriers that make
                    the two consumer warpgroups issue their products in turn
                    (each gives the turn on after issuing S_j and P_{j-1}V);
  parent            (with --parent DIR, a checkout such as an earlier
                    commit unpacked by `git archive`) DIR's attention_tma.cu
                    in place of the kernel's, launched through this
                    checkout's wrappers (the C entry is unchanged): its
                    output is held to the kernel's bit for bit.

Shapes: `rags` (the default) K2q over 1152 fresh + 8192 cache rows, K2
(bf16 cache) on the same rows, batch 2, 24 heads, a RAGS-style bias, and
K6 [2,24,2176,128]; `table` every K1 / K2 / K2q / K5 / K6 shape of
PERF.md's kernel table.  The variants are timed in turns (each variant,
then each again in reverse order; CUDA events, ms per launch), beside the
least time the card could take (`chip_smoke.bound`) and, with
`--library`, the fastest PyTorch SDPA backend as a yardstick.  Prints the
card's name and power limit, each variant's ptxas lines for the attention
kernel (registers, spills, serialized wgmma), and the SM clock and power
draw `nvidia-smi` reads while each shape is timed.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# text edits (old, new) of attention_tma.cu; each `old` occurs once
_QK = ("    wgmma_ss(s, smem_desc(qa + off, 16, 1024), smem_desc(kt + off, "
       "16, 1024),\n             kk > 0);")
_PV = ("    wgmma_rs(o, pa[kk], smem_desc(vt + kk * 2048, kHalfBytes, "
       "1024));")
_SOFTMAX = "  float mx0 = -INFINITY, mx1 = -INFINITY;\n"
_TURN = ("__device__ __forceinline__ void turn_sync(int id) {\n"
         "  asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(id)"
         " : \"memory\");\n}\n"
         "__device__ __forceinline__ void turn_arrive(int id) {\n"
         "  asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(id)"
         " : \"memory\");\n}\n")
_FENCE = ("// keep the compiler from moving accumulator reads or writes "
          "across the\n")
_LOAD_Q = "        load_tile(sq, &tq, bar_q, q0, h, b, ctid == 0);\n"
_ROUND0 = ("      mbar_wait(bar_k, 0);\n      wg_fence();\n"
           "      issue_qk(sacc, qa, sk);\n")
_ROUND = ("        wg_fence();\n"
          "        issue_qk(sacc, qa, sk + s * kTileBytes);\n"
          "        mbar_wait(bar_v + 8 * sp, pparity);\n"
          "        issue_pv(o, pa, sv + sp * kTileBytes);\n")
_LAST = ("      wg_fence();\n      issue_pv(o, pa, sv + sp * kTileBytes);\n"
         "      wg_wait<0>();\n")
VARIANTS = {
    "kernel": [],
    "no_dequant": [("          dequant_tile<Mode>(",
                    "          if (false) dequant_tile<Mode>(")],
    "no_consumer_math": [
        (_QK, "if (off == 0xffffffffu) " + _QK),
        (_PV, "if (kk < 0) " + _PV),
        (_SOFTMAX, "  a0 = a1 = 1.f;\n  if (scale2 != 12345.f) return;\n"
         + _SOFTMAX)],
    "ping_pong": [
        (_FENCE, _TURN + _FENCE),
        ("      if (wg == 1) {\n" + _LOAD_Q,
         "      const int turn = 2 + wg, next = 2 + (wg ^ 1);\n"
         "      if (wg == 1) {\n        turn_arrive(next);\n" + _LOAD_Q),
        (_ROUND0, "      mbar_wait(bar_k, 0);\n      turn_sync(turn);\n"
         "      wg_fence();\n      issue_qk(sacc, qa, sk);\n"
         "      turn_arrive(next);\n"),
        (_ROUND, "        turn_sync(turn);\n" + _ROUND
         + "        turn_arrive(next);\n"),
        (_LAST, "      turn_sync(turn);\n      wg_fence();\n"
         "      issue_pv(o, pa, sv + sp * kTileBytes);\n"
         "      if (wg == 0) turn_arrive(next);\n      wg_wait<0>();\n")],
}
TARGET = "attention_tma.cu"
ITERS = 10  # launches a timing


def build_variant(name, edits, sources):
    """Copy the kernel sources `sources` under build/variants/<name>/csrc,
    apply the text edits (old, new) to TARGET, and build and load that copy
    through `ops/_build.py`.  Returns (library, compiler log: `ptxas -v`)."""
    from regione_tpu_torch.ops import _build
    root = REPO / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    for f in sources:
        shutil.copy(f, root / "csrc" / f.name)
    path = root / "csrc" / TARGET
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            sys.exit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    _build.CSRC, _build.BUILD_DIR = root / "csrc", root / "kernels"
    _build._lib = None
    _, log = _build.build()
    return _build.load(), log


def ptxas_lines(log):
    """The log's lines about the attention kernel's instantiations:
    registers, spills, and any wgmma that ptxas serialized."""
    keep, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            inside = "attention_tma_kernel" in line
        if inside or "serialized" in line:
            keep.append(line.strip())
    return keep


class PowerLog:
    """`nvidia-smi` sampled every 100 ms in the background: (time, SM
    clock MHz, power draw W)."""

    def __init__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                clock, power = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.monotonic(), clock, power))

    def window(self, t0, t1):
        """Median SM clock and power draw, and the clock's range, between
        t0 and t1 (None where no sample fell there)."""
        got = [(c, p) for t, c, p in self.samples if t0 <= t <= t1]
        if not got:
            return None
        clocks, powers = zip(*got)
        return dict(sm_mhz=statistics.median(clocks), sm_min=min(clocks),
                    sm_max=max(clocks), power_w=statistics.median(powers),
                    samples=len(got))

    def stop(self):
        self.proc.terminate()
        self.proc.wait()


def cases(kind):
    """(label, builder) pairs; a builder takes (rng, device) and returns
    (call, (flops, bytes), library args (q, k, v, bias) or None)."""
    import chip_smoke as cs

    def k1(b, h, t, with_bias):
        def make(rng, dev):
            from regione_tpu_torch.ops import flash_attention as fa
            q, k, v = (cs._heads_view(rng, b, h, t, 128, dev)
                       for _ in range(3))
            bias = None
            if with_bias:
                import torch
                bn = np.zeros((b, t), np.float32)
                bn[:, 100:128] = -1e9                 # padded text columns
                bn[:, rng.random(t) < 0.05] = -1e30   # masked rows
                bias = torch.from_numpy(bn).to(dev)
            return (lambda: fa.attention(q, k, v, bias),
                    cs.attention_work(b, h, t, t, bias=with_bias),
                    (q, k, v, bias))
        return make

    def rows2(b, h, t_txt, cap, s_cache, bits=16):
        def make(rng, dev):
            import torch
            from regione_tpu_torch.ops import flash_attention as fa
            from regione_tpu_torch.ops import quant
            t1 = t_txt + cap
            q = cs._heads_view(rng, b, h, t1, 128, dev)
            k1, v1, kc, vc = (cs._heads_view(rng, b, h, n, 128, dev)
                              .contiguous() for n in (t1, t1, s_cache,
                                                      s_cache))
            bias = cs._rags_bias(rng, b, t1, cap, s_cache)
            work = cs.attention_work(b, h, t1, t1, s_cache, bits / 8,
                                     scales=bits != 16)
            if bits == 16:
                return (lambda: fa.attention_rows2(q, k1, v1, kc, vc, bias),
                        work, (q, torch.cat([k1, kc], 2),
                               torch.cat([v1, vc], 2), bias))
            qz = quant.quantize_kv_heads if bits == 8 else \
                quant.quantize_kv_heads4
            (kq, ks), (vq, vs) = qz(kc), qz(vc)
            deq = (torch.cat([k1, quant.dequantize_cache(kq, ks, q.dtype)], 2),
                   torch.cat([v1, quant.dequantize_cache(vq, vs, q.dtype)], 2))
            return (lambda: fa.attention_rows2(q, k1, v1, kq, vq, bias,
                                               k_scale=ks, v_scale=vs),
                    work, (q, *deq, bias))
        return make

    def k6(b, h, t, s, bits):
        def make(rng, dev):
            from regione_tpu_torch.ops import flash_attention as fa
            from regione_tpu_torch.ops import quant
            q = cs._heads_view(rng, b, h, t, 128, dev)
            qz = quant.quantize_kv_heads if bits == 8 else \
                quant.quantize_kv_heads4
            kq, ks = qz(cs._heads_view(rng, b, h, s, 128, dev))
            vq, vs = qz(cs._heads_view(rng, b, h, s, 128, dev))
            return (lambda: fa.attention(q, kq, vq, k_scale=ks, v_scale=vs),
                    cs.attention_work(b, h, t, 0, s, bits / 8, bias=False,
                                      scales=True),
                    (q, quant.dequantize_cache(kq, ks, q.dtype),
                     quant.dequantize_cache(vq, vs, q.dtype), None))
        return make

    rags = [
        ("K2q int8 1152 + 8192", rows2(2, 24, 128, 1024, 8192, 8)),
        ("K2q int4 1152 + 8192", rows2(2, 24, 128, 1024, 8192, 4)),
        ("K2 bf16 1152 + 8192", rows2(2, 24, 128, 1024, 8192)),
        ("K6 int8 [2,24,2176,128]", k6(2, 24, 2176, 2176, 8)),
        ("K6 int4 [2,24,2176,128]", k6(2, 24, 2176, 2176, 4)),
    ]
    if kind == "rags":
        return rags
    return [
        ("K1 [1,24,8704,128] bias (FLUX 1024^2 dense)", k1(1, 24, 8704, True)),
        ("K1 [2,24,8320,128] bias (Step1X 1024^2 dense, CFG batch 2)",
         k1(2, 24, 8320, True)),
        ("K1 [2,24,2176,128]", k1(2, 24, 2176, False)),
        ("K1 [1,24,8320,128] bias", k1(1, 24, 8320, True)),
        ("K1 [2,12,8320,128] (headline)", k1(2, 12, 8320, False)),
        ("K1 [2,28,128,128] (connector)", k1(2, 28, 128, False)),
        ("K1 [2,6,8704,128] (Qwen tp 4 rank)", k1(2, 6, 8704, False)),
        ("K1 [2,12,2176,128] (Step1X tp 2 rank)", k1(2, 12, 2176, False)),
        ("K2 384 + 2048", rows2(2, 24, 128, 256, 2048)),
        *rags[2:3],
        ("K2 896 + 8192 (Qwen grid 64)", rows2(2, 24, 128, 768, 8192)),
        ("K2 1 x 4224 + 8192 (FLUX)", rows2(1, 24, 128, 4096, 8192)),
        ("K2 2 x 1152 + 8192, 12 heads (headline)",
         rows2(2, 12, 128, 1024, 8192)),
        ("K2 6 x 512 + 2048 (served group of 3)",
         rows2(6, 24, 128, 384, 2048)),
        ("K2 12 heads, 512 + 2048 (Step1X tp 2 rank)",
         rows2(2, 12, 128, 384, 2048)),
        *rags[:2],
        ("K2q int8 896 + 8192 (Qwen grid 64)",
         rows2(2, 24, 128, 768, 8192, 8)),
        ("K2q int4 896 + 8192 (Qwen grid 64)",
         rows2(2, 24, 128, 768, 8192, 4)),
        ("K2q int8 6 heads, 2336 + 8192 (Qwen tp 4 rank)",
         rows2(2, 6, 512, 1824, 8192, 8)),
        ("K5 [2,24,12416,128]", k1(2, 24, 12416, False)),
        *rags[3:],
    ]


def main():
    import torch

    import chip_smoke as cs
    from regione_tpu_torch.ops import _build
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", choices=("rags", "table"), default="rags")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose attention_tma.cu is compared "
                         "with the kernel's, bits and time")
    ap.add_argument("--library", action="store_true",
                    help="also time the fastest PyTorch SDPA backend")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    own = _build.sources()
    builds = {}
    for name in args.variants.split(","):
        builds[name] = build_variant(name, VARIANTS[name], own)
    if args.parent is not None:
        csrc = args.parent / "regione_tpu_torch" / "csrc"
        other = [csrc / TARGET if f.name == TARGET else f for f in own]
        builds["parent"] = build_variant("parent", [], other)
    for name, (_, log) in builds.items():
        for line in ptxas_lines(log):
            print(f"{name}: {line}", flush=True)
    names = list(builds)
    order = names + names[::-1]
    power = PowerLog()
    dev = torch.device("cuda")
    records = []
    for i, (label, make) in enumerate(cases(args.shapes)):
        rng = np.random.default_rng(i)
        call, work, lib_args = make(rng, dev)
        outs, ms = {}, {n: [] for n in names}
        t0 = time.monotonic()
        for name in order:
            _build._lib = builds[name][0]
            if name not in outs:
                outs[name] = call()
            ms[name].append(cs.cuda_ms(call, ITERS, warmup=2))
        t1 = time.monotonic()
        bound_ms, bound_by = cs.bound(*work)
        rec = dict(case=label, bound_ms=bound_ms, bound_by=bound_by,
                   ms=ms, clocks=power.window(t0, t1))
        if "parent" in outs and "kernel" in outs:
            rec["bits_equal"] = bool(torch.equal(outs["kernel"],
                                                 outs["parent"]))
            if not rec["bits_equal"]:
                diff = (outs["kernel"].float() - outs["parent"].float()).abs()
                rec["max_abs_diff"] = float(diff.max())
                rec["rows_differing"] = int((diff.amax(-1) > 0).sum())
        if args.library:
            rec["library_ms"], rec["library"] = cs.library_ms(*lib_args,
                                                              ITERS)
        records.append(rec)
        del outs, call, lib_args
        torch.cuda.empty_cache()
        line = ", ".join(
            f"{n} {statistics.mean(v):.4f} ms ({v[0]:.4f}/{v[1]:.4f}, "
            f"{100 * bound_ms / statistics.mean(v):.1f}% of bound)"
            for n, v in ms.items())
        extra = "".join(f" {k} {rec[k]}" for k in (
            "bits_equal", "max_abs_diff", "rows_differing", "library_ms",
            "library") if k in rec)
        print(f"{label}: bound {bound_ms:.4f} ms by {bound_by}; {line};"
              f"{extra}; clocks {rec['clocks']}", flush=True)
    power.stop()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=smi.stdout.strip(),
                                            cases=records), indent=1))


if __name__ == "__main__":
    main()
