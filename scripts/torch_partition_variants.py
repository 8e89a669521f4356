"""Time the port's partition kernel K3 against variants of its own source
and, given an earlier checkout, against that checkout's kernel, on one
NVIDIA GPU, in one process (so every number comes from the same card).

    python3 scripts/torch_partition_variants.py [--parent DIR]

Each variant is a copy of `regione_tpu_torch/csrc/*.cu` under
`build/variants/<name>/` with text edits applied to `partition.cu`, built by
`ops/_build.py` into its own library (`build_variant` of
`torch_attention_variants.py`) and launched through
`ops/partition_kernel.fused_partition`:

  kernel       the source as it is (8 x 8 tiles up to two CTAs on each of
               132 SMs, 16 x 16 past that; 4 tokens a lane group loads at
               once; 512 threads, two CTAs an SM);
  tiles_8x8, tiles_16x16   one tile size at every grid;
  large_16x32  16 x 32 tiles where the source takes 16 x 16;
  batch_2, batch_8   2 or 8 tokens a group loads before it reduces;
  threads_256  256 threads a CTA;
  one_block   `__launch_bounds__(512)`: no register cap (86 registers on
               the float4 path, one CTA an SM).

Every variant must give the source's masks bit for bit (a token's
arithmetic does not depend on the tile).  With `--parent DIR` (a checkout
of an earlier commit, e.g. unpacked by `git archive`), DIR's `csrc/` is
built as "parent" and launched through DIR's own wrapper, timed first and
last (parent, kernel, variants, kernel, parent); where that wrapper refuses
a grid, its error is printed.  The parent's library is bound with the
parent's own C signatures (its `ops/_build.py`).

Shapes: fp32 [grid, 64] pairs with morphology at grids 32, 64, 96, 128,
160, 256, 48 x 80, 37 x 53 and 173 x 181.  Per variant and shape: `call`
(CUDA events over 50 back-to-back calls from Python, as `chip_smoke.py`
times K3) and `graph` (the same 50 calls captured in one CUDA graph and
replayed: device time per launch, without the host).  Beside them the
launch floor both ways (`chip_smoke.launch_floor_ms`):
`torch.zeros(1).zero_()` per call, one `zero_()` of a 1-element tensor per
graph node.  Prints the card's name and power limit first.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SHAPES = ((32, 32), (64, 64), (96, 96), (128, 128), (160, 160), (256, 256),
          (48, 80), (37, 53), (173, 181))
CALLS = 50


def _const(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


VARIANTS = {
    "kernel": [],
    "tiles_8x8": [("kOneWave = 2 * 132;", "kOneWave = 1LL << 40;")],
    "tiles_16x16": [("kOneWave = 2 * 132;", "kOneWave = -1;")],
    "large_16x32": [("launch<16, 16>(", "launch<16, 32>(")],
    "batch_2": [_const("kBatch", 4, 2)],
    "batch_8": [_const("kBatch", 4, 8)],
    "threads_256": [_const("kThreads", 512, 256)],
    "one_block": [("__launch_bounds__(kThreads, 2)",
                   "__launch_bounds__(kThreads)")],
}


def partition_ptxas(log):
    """The `ptxas -v` register and spill lines of the partition kernel's
    instantiations in a build's log."""
    found, ours = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            ours = "partition_kernel" in line
        elif ours and ("registers" in line or "spill" in line):
            found.append(line.split(":", 1)[-1].strip())
    return found


def main():
    import torch

    import chip_smoke as cs
    from regione_tpu_torch.ops import _build
    from regione_tpu_torch.ops import partition_kernel as pk
    from torch_attention_variants import build_variant
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    inputs = {}
    for gh, gw in SHAPES:
        s = gh * gw
        x0 = rng.standard_normal((s, 64)).astype(np.float32)
        cond = x0 + 0.35 * rng.standard_normal((s, 64)).astype(np.float32)
        cond[: s // 4] = rng.standard_normal((s // 4, 64)).astype(np.float32)
        inputs[gh, gw] = (torch.from_numpy(x0).to(dev),
                          torch.from_numpy(cond).to(dev))
    floor_call, floor_graph = cs.launch_floor_ms(CALLS)
    print(f"launch floor: call {floor_call:.4f} ms, graph {floor_graph:.4f} "
          "ms", flush=True)

    own = _build.sources()
    order = list(VARIANTS) + ["kernel"]
    wrapper, signatures = {}, {}
    if args.parent is not None:
        order = ["parent"] + order + ["parent"]
        spec = importlib.util.spec_from_file_location(
            "parent_partition_kernel",
            args.parent / "regione_tpu_torch" / "ops" / "partition_kernel.py")
        wrapper["parent"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(wrapper["parent"])
        spec = importlib.util.spec_from_file_location(
            "parent_build",
            args.parent / "regione_tpu_torch" / "ops" / "_build.py")
        parent_build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent_build)
        signatures["parent"] = parent_build._SIGNATURES
    own_signatures = _build._SIGNATURES
    want = {}
    for name in order:
        _build._SIGNATURES = signatures.get(name, own_signatures)
        if name == "parent":
            log = build_variant(name, [], "partition.cu", sorted(
                (args.parent / "regione_tpu_torch" / "csrc").glob("*.cu")))
        else:
            log = build_variant(name, VARIANTS[name], "partition.cu", own)
        ptxas = partition_ptxas(log)
        fused = wrapper.get(name, pk).fused_partition
        print(f"{name}: ptxas {ptxas}", flush=True)
        for (gh, gw), (x0, cond) in inputs.items():
            def call():
                return fused(x0, cond, 0.88, gh, gw, True)
            try:
                got = call()
            except ValueError as e:      # the parent's grid limit
                print(f"{name} {gh}x{gw}: raises ValueError: {e}", flush=True)
                continue
            raw = fused(x0, cond, 0.88, gh, gw, False)
            plain = pk.partition_reference(x0, cond, 0.88, gh, gw, True)
            n_plain = int((got != plain).sum())
            same = True
            if name != "parent":         # variants: the source's masks
                want.setdefault((gh, gw), (got, raw))
                same = (torch.equal(got, want[gh, gw][0])
                        and torch.equal(raw, want[gh, gw][1]))
            ms = cs.cuda_ms(call, CALLS)
            gms = cs.graph_ms(call, CALLS)
            print(f"{name} {gh}x{gw}: call {ms:.4f} ms graph {gms:.4f} ms, "
                  f"{n_plain} tokens off the plain version, masks "
                  f"{'equal' if same else 'DIFFER'}", flush=True)
            if not same:
                sys.exit(f"{name}: masks differ from the source's at "
                         f"{gh}x{gw}")


if __name__ == "__main__":
    main()
