"""Time the port's attention kernel against variants of its own source, on
one NVIDIA GPU, in one process (so every number comes from the same card).

    python3 scripts/torch_attention_variants.py

Each variant is a copy of `regione_tpu_torch/csrc/*.cu` under
`build/variants/<name>/` with one text edit applied to `attention_tma.cu`,
built by `ops/_build.py` into its own library; the wrappers of
`ops/flash_attention.py` then launch it.  The variants only measure where
the time goes: their outputs are wrong and are not checked.

  kernel            the source as it is;
  no_dequant        the quantized modes' producers skip the dequant (they
                    still wait for the codes and arrive on every barrier);
  no_consumer_math  the consumers skip both products and the softmax (they
                    still wait for every stage and release it).

Shapes: K2q over 1152 fresh + 8192 cache rows and K2 (bf16 cache) on the
same rows, batch 2, 24 heads, a RAGS-style bias; K6 [2,24,2176,128].
Prints the card's name and power limit, each variant's ptxas spill lines
and its times (CUDA events, ms per launch).  Imports no JAX.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

VARIANTS = {
    "kernel": [],
    "no_dequant": [("          dequant_tile<Mode>(gbase",
                    "          if (false) dequant_tile<Mode>(gbase")],
    "no_consumer_math": [(
        "      mbar_wait(bar_k + 8 * s, parity);\n      wg_fence();",
        "      mbar_wait(bar_k + 8 * s, parity);\n"
        "      mbar_wait(bar_b + 8 * s, parity);\n"
        "      mbar_wait(bar_v + 8 * s, parity);\n"
        "      mbar_arrive(bar_e + 8 * s);\n"
        "      if (it >= 0) continue;\n"
        "      wg_fence();")],
}


def build_variant(name, edits, target, sources):
    """Copy the kernel sources `sources` under build/variants/<name>/csrc,
    apply the text edits (old, new) to the file named `target`, and build
    and load that copy through `ops/_build.py`, whose wrappers then launch
    it.  Returns the compiler's log (`ptxas -v`)."""
    from regione_tpu_torch.ops import _build
    root = REPO / "build" / "variants" / name
    (root / "csrc").mkdir(parents=True, exist_ok=True)
    for f in sources:
        shutil.copy(f, root / "csrc" / f.name)
    path = root / "csrc" / target
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            sys.exit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    _build.CSRC, _build.BUILD_DIR = root / "csrc", root / "kernels"
    _build._lib = None
    _, log = _build.build()
    _build.load()
    return log


def main():
    import torch

    import chip_smoke as cs
    from regione_tpu_torch.ops import _build
    from regione_tpu_torch.ops import flash_attention as fa
    from regione_tpu_torch.ops import quant
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    b, h, t1, s2 = 2, 24, 1152, 8192
    q = cs._heads_view(rng, b, h, t1, 128, dev)
    k1 = cs._heads_view(rng, b, h, t1, 128, dev).contiguous()
    kc = cs._heads_view(rng, b, h, s2, 128, dev).contiguous()
    bias = cs._rags_bias(rng, b, t1, 1024, s2)
    q6 = cs._heads_view(rng, b, h, 2176, 128, dev)
    kv6 = cs._heads_view(rng, b, h, 2176, 128, dev)
    qz = {8: quant.quantize_kv_heads, 4: quant.quantize_kv_heads4}
    caches = {bits: qz[bits](kc) for bits in (8, 4)}
    caches6 = {bits: qz[bits](kv6) for bits in (8, 4)}
    own = _build.sources()
    for name, edits in VARIANTS.items():
        log = build_variant(name, edits, "attention_tma.cu", own)
        spills = [line.split(":", 1)[-1].strip()
                  for line in log.splitlines() if "spill" in line]
        ms = {}
        for bits, (kq, ks) in caches.items():
            ms[f"K2q int{bits}"] = cs.cuda_ms(lambda: fa.attention_rows2(
                q, k1, k1, kq, kq, bias, k_scale=ks, v_scale=ks), 10)
        ms["K2 bf16"] = cs.cuda_ms(
            lambda: fa.attention_rows2(q, k1, k1, kc, kc, bias), 10)
        for bits, (kq, ks) in caches6.items():
            ms[f"K6 int{bits}"] = cs.cuda_ms(lambda: fa.attention(
                q6, kq, kq, k_scale=ks, v_scale=ks), 10)
        print(f"{name}: " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in ms.items()), flush=True)
        print(f"{name}: ptxas {spills}", flush=True)


if __name__ == "__main__":
    main()
