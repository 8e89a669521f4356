"""One rank of the port's sharded CPU tests (tests/test_torch_parallel_mesh.py).

    python -m tests.torch_parallel_worker <dir> <rank> <world> <dp>

joins a gloo group through the file store <dir>/store, builds a (dp, tp)
mesh, runs every case of <dir>/inputs.pt on it and writes what it got to
<dir>/rank<rank>.pt (a traceback to <dir>/rank<rank>.err and exit 1 on a
failure).  Imports no JAX: the parent holds the JAX side and compares.
"""

import dataclasses
import os
import sys
import traceback

import torch
import torch.distributed as dist

from regione_tpu_torch.core.config import RegionEParams
from regione_tpu_torch.core.gamma import gamma_for
from regione_tpu_torch.core.schedule import FLUX_SHIFT
from regione_tpu_torch.models import layers
from regione_tpu_torch.models.mmdit import MMDiT
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.ops import quant
from regione_tpu_torch.parallel.sharding import (_int4_row_layout, _ranges,
                                                 make_mesh, shard_params,
                                                 shard_plan, shard_tensor,
                                                 tp_group)
from regione_tpu_torch.pipelines.base import EditInputs, EditPipelineBase
from regione_tpu_torch.pipelines.qwen_image_edit import QwenImageEditPipeline
from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
from regione_tpu_torch.utils import memplan
from regione_tpu_torch.weights import checkpoint

PIPES = {"step1x": Step1XEditPipeline, "qwen": QwenImageEditPipeline}
# the parent holds these loops to the JAX package's, which runs FLUX.1's
# schedule for Qwen too: what `torch_cpu.jax_schedule` does in a test
QwenImageEditPipeline.flow_shift = FLUX_SHIFT


def _model(case, **flags):
    cfg = dataclasses.replace(get_config(case["preset"]), **flags)
    model = MMDiT(cfg, torch.device("cpu"))
    quant.quantized_shells(model, case["state"])
    model.load_state_dict(case["state"], strict=True)
    return model.eval()


def _ctx(pipe, x, grid):
    rope_img, rope_txt = pipe.build_rope(grid, grid, x["txt"].shape[1])
    return EditInputs(txt=x["txt"], cond_latent=x["cond"], rope_img=rope_img,
                      rope_txt=rope_txt, pooled=x.get("pooled"))


def _local_shapes(model, sampler):
    cache = sampler.init_cache()
    names = ("double_blocks.0.img_attn.q.weight",
             "double_blocks.0.img_attn.out.weight",
             "double_blocks.0.img_mod.weight")
    if model.cfg.depth_single:
        names += ("single_blocks.0.linear1.weight",
                  "single_blocks.0.linear2.weight")
    params = dict(model.named_parameters())
    return {"cache": {k: tuple(v.shape) for k, v in cache.items()},
            **{n: tuple(params[n].shape) for n in names}}


def run_dense(case, mesh):
    model = shard_params(_model(case), mesh)
    pipe = Step1XEditPipeline(model, RegionEParams(), true_cfg_scale=4.0)
    x = case["x"]
    with torch.inference_mode():
        v, _ = pipe.dense_forward(x["lat"], 0.9, None,
                                  _ctx(pipe, x, case["grid"]), False)
    return {"v": v}


def run_loop(case, mesh):
    model = shard_params(_model(case, **case["flags"]), mesh)
    pipe = PIPES[case["pipe"]](model, RegionEParams(**case["re"]),
                               true_cfg_scale=4.0)
    x, grid = case["x"], case["grid"]
    out, stats = pipe.edit_latents(x["lat0"], _ctx(pipe, x, grid), grid,
                                   grid)
    sampler = next(iter(pipe._samplers.values()))
    return {"out": out, "stats": dataclasses.asdict(stats),
            "shapes": _local_shapes(model, sampler)}


def run_batch(case, mesh):
    """The group on the mesh; with `whole`, the same group on the whole
    model without a mesh beside it."""
    res = {}
    for name in ("whole", "mesh") if case.get("whole") else ("mesh",):
        model = _model(case)
        if name == "mesh":
            shard_params(model, mesh)
        pipe = EditPipelineBase(model, RegionEParams(**case["re"]),
                                gamma=gamma_for("step1x-edit"))
        grid = case["grid"]
        outs, stats = pipe.edit_latents_batch(
            [x["lat0"] for x in case["xs"]],
            [_ctx(pipe, x, grid) for x in case["xs"]], grid, grid,
            mesh=mesh if name == "mesh" else None)
        res[name] = outs
        res[name + "_stats"] = [dataclasses.asdict(s) for s in stats]
    sampler = next(iter(pipe._samplers.values()))
    return {"outs": res["mesh"], "stats": res["mesh_stats"],
            "whole": res.get("whole"), "whole_stats": res.get("whole_stats"),
            "shapes": _local_shapes(model, sampler)}


def run_layers(case, mesh):
    """Row-parallel W8A8 and int4 linears against the whole layer, and
    each rank's dequantized int4 slice against the whole weight's."""
    tp = tp_group(mesh)
    gen = torch.Generator().manual_seed(case["seed"])
    out = {}
    for d_in, bits in ((256, 8), (384, 4), (1024, 4), (64, 8)):
        w = torch.rand(24, d_in, generator=gen) - 0.5
        b = torch.rand(24, generator=gen)
        x = torch.randn(3, 5, d_in, generator=gen)
        full = (layers.Int4Linear(**quant.quantize_linear4(w, b)) if bits == 4
                else layers.Int8Linear(**quant.quantize_linear(w, b)))
        kind = "int4" if bits == 4 else "int8"
        specs = {"w_qp" if bits == 4 else "w_q": (None, "tp"),
                 "scale4" if bits == 4 else "scale": (), "bias": ()}
        plan = layers.LinearShard(kind, layers.ROLE_ROW, specs,
                                  out_ranges=[(0, 24)],
                                  in_ranges=_ranges([d_in], tp.rank, tp.size,
                                                    "x"))
        if bits == 4:
            plan.scale_groups = _int4_row_layout(plan.in_ranges, d_in,
                                                 full.scale4.shape[1])
        plans = {"lin": plan}
        tensors = {leaf: shard_tensor(plans, f"lin.{leaf}", t.detach())
                   .clone() for leaf, t in full.named_parameters()}
        lin = layers.ShardedLinear(plan, tensors, tp)
        x_local = layers.take(x, -1, plan.in_ranges)
        with layers.act_int8(bits == 8):
            got, want = lin(x_local), full(x)
        key = f"{kind}_{d_in}"
        out[key] = {"got": got, "want": want}
        if bits == 4:
            deq = quant.dequantize_weight4(
                {"w_qp": lin.w_qp, "scale4": lin._scale4()}, torch.float32)
            whole = quant.dequantize_weight4(
                {"w_qp": full.w_qp, "scale4": full.scale4}, torch.float32)
            out[key]["deq_equal"] = torch.equal(
                deq, layers.take(whole, 1, plan.in_ranges))
    return out


def run_quantized(case, mesh):
    """The dense forward of a quantized tiny-tp (int8 W8A8, int4) sharded
    against the same model whole, and each rank's weight bytes against
    memplan.plan(tp=)."""
    quant._INT4_MIN_IN = 0
    cfg_flags = {"act_int8": case["bits"] == 8}
    whole = _model(case, **cfg_flags)
    quant.quantize_params(whole, bits=case["bits"])
    sharded = _model(case, **cfg_flags)
    quant.quantize_params(sharded, bits=case["bits"])
    shard_params(sharded, mesh)
    x = case["x"]
    res = {}
    for name, model in (("whole", whole), ("sharded", sharded)):
        pipe = Step1XEditPipeline(model, RegionEParams(), true_cfg_scale=4.0)
        with torch.inference_mode():
            res[name], _ = pipe.dense_forward(
                x["lat"], 0.9, None, _ctx(pipe, x, case["grid"]), False)
    plan = memplan.plan(sharded.cfg, tp=mesh.size(1), int8=True,
                        bits=case["bits"])
    res["weight_bytes"] = quant.quantized_bytes(sharded)
    res["plan_bytes"] = plan.param_bytes
    return res


def run_checkpoint(case, mesh):
    """The rank's shard read from a quantized checkpoint file: its dense
    forward against the whole model read from the same file."""
    whole = checkpoint.mmdit_from_checkpoint(case["path"],
                                             get_config(case["preset"]),
                                             "cpu")
    model = checkpoint.mmdit_from_checkpoint(case["path"],
                                             get_config(case["preset"]),
                                             "cpu", mesh=mesh)
    tp = tp_group(mesh)
    plans = shard_plan(whole, tp.rank, tp.size)
    want_bytes = sum(shard_tensor(plans, n, t).numel() * t.element_size()
                     for n, t in whole.state_dict().items())
    x = case["x"]
    res = {"loaded_bytes": model.loaded_bytes, "want_bytes": want_bytes,
           "whole_bytes": quant.quantized_bytes(whole)}
    for name, m in (("whole", whole), ("sharded", model)):
        pipe = Step1XEditPipeline(m, RegionEParams(), true_cfg_scale=4.0)
        with torch.inference_mode():
            res[name], _ = pipe.dense_forward(
                x["lat"], 0.9, None, _ctx(pipe, x, case["grid"]), False)
    return res


RUNNERS = {"dense": run_dense, "loop": run_loop, "batch": run_batch,
           "layers": run_layers, "quantized": run_quantized,
           "checkpoint": run_checkpoint}


def main(argv):
    work, rank, world, dp = argv[0], *map(int, argv[1:4])
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{work}/store",
                                rank=rank, world_size=world)
        mesh = make_mesh(dp=dp, device_type="cpu")
        cases = torch.load(f"{work}/inputs.pt", weights_only=False)
        results = {name: RUNNERS[case["kind"]](case, mesh)
                   for name, case in cases.items()}
        torch.save(results, f"{work}/rank{rank}.pt")
        dist.destroy_process_group()
    except Exception:
        with open(f"{work}/rank{rank}.err", "w") as fh:
            fh.write(traceback.format_exc())
        sys.stderr.write(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
