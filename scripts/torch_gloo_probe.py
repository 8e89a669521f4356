"""Check that gloo takes CUDA tensors, on one NVIDIA GPU: 4 ranks of one
card (NCCL refuses two ranks on one device), then NCCL at world size 1.

    python3 scripts/torch_gloo_probe.py

Each rank builds a (dp, tp) `DeviceMesh` over its process group (file
store, the group's backend for the subgroups), then on CUDA tensors:
all_reduce (fp32, bf16, int32 sums, an fp32 MAX), all_gather, broadcast,
an all_reduce under `torch.inference_mode`, and the time of five fp32
all_reduces of a 2304 x 3072 tensor (28 MB).  Prints one line a rank and
each group's exit codes.  Imports no JAX.
"""

import inspect
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh


def run(rank, world, path, backend):
    try:
        dist.init_process_group(backend, init_method=f"file://{path}",
                                rank=rank, world_size=world)
        kw = {}
        if "backend_override" in inspect.signature(
                DeviceMesh.__init__).parameters:
            kw["backend_override"] = ((backend, None),) * 2
        t = time.time()
        dp = 2 if world == 4 else 1
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(dp, world // dp),
                          mesh_dim_names=("dp", "tp"), **kw)
        tp, dpg = mesh.get_group("tp"), mesh.get_group("dp")
        out = [f"rank {rank} mesh {time.time() - t:.2f}s override "
               f"{bool(kw)} tp-backend {dist.get_backend(tp)} dev "
               f"{torch.cuda.current_device()}"]
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            x = torch.full((4, 5), rank + 1, dtype=dt, device="cuda")
            dist.all_reduce(x, group=tp)
            out.append(f"allreduce {dt} {x[0, 0].item()}")
        y = torch.full((3,), float(rank), device="cuda")
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=tp)
        out.append(f"max {y[0].item()}")
        g = [torch.empty(2, 3, device="cuda", dtype=torch.bfloat16)
             for _ in range(mesh.size(1))]
        dist.all_gather(g, torch.full((2, 3), float(rank), device="cuda",
                                      dtype=torch.bfloat16), group=tp)
        out.append(f"gather {[t[0, 0].item() for t in g]}")
        c = [torch.empty(2, dtype=torch.int64, device="cuda")
             for _ in range(mesh.size(0))]
        dist.all_gather(c, torch.full((2,), rank, dtype=torch.int64,
                                      device="cuda"), group=dpg)
        out.append(f"dp gather {[t[0].item() for t in c]}")
        m = torch.full((7,), rank, dtype=torch.uint8, device="cuda")
        dist.broadcast(m, src=dist.get_global_rank(tp, 0), group=tp)
        out.append(f"bcast {m[0].item()}")
        with torch.inference_mode():
            z = torch.ones(3, device="cuda") * rank
            dist.all_reduce(z, group=tp)
            out.append(f"inference_mode allreduce {z[0].item()}")
        a = torch.randn(2 * 1152, 3072, device="cuda").float()
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(5):
            dist.all_reduce(a, group=tp)
        torch.cuda.synchronize()
        out.append(f"allreduce fp32 2304x3072 "
                   f"{(time.time() - t) / 5 * 1e3:.1f} ms")
        print(" | ".join(out), flush=True)
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.exit(3)


def main():
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for backend, world in (("gloo", 4), ("nccl", 1)):
        d = tempfile.mkdtemp()
        t = time.time()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=run, args=(r, world,
                                               os.path.join(d, "store"),
                                               backend))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        print(backend, world, "exitcodes", [p.exitcode for p in procs],
              f"{time.time() - t:.1f}s", flush=True)


if __name__ == "__main__":
    main()
