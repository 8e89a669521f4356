"""Run phase 11 of `chip_smoke.py` (the sharded port) without the rest,
on one NVIDIA GPU:

    python3 scripts/torch_sharded_phase.py

Phases 1 (environment), 2 (build the kernels), 7 (write the full-width
Step1X and Qwen checkpoints under build/ckpt/, which phase 11 reads) and
11 (4 gloo ranks on the card: 11a, 11b, and 11c with NCCL at world size
1), each with its checks; exits non-zero if one fails.  About 2 minutes
of command time.  Imports no JAX.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main():
    card = cs.phase_environment()
    cs.phase_build()
    t = time.perf_counter()
    cs.phase_checkpoints()
    cs.log(f"phase 7 done in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    print(cs.phase_sharded())
    cs.log(f"phase 11 done in {time.perf_counter() - t:.1f}s")
    print(card)


if __name__ == "__main__":
    main()
