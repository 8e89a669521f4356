"""Multi-card sharding: the (dp, tp) device mesh and the parameter
partition of the MMDiT, on `torch.distributed`.

Counterpart of `regione_tpu/parallel/sharding.py`.  The JAX package states
its Megatron-style tensor parallelism as GSPMD specs and XLA inserts the
collectives; PyTorch has no counterpart, so the port applies the same
specs and writes the collectives out (`models.layers.ShardedLinear`):

  * qkv / mlp-in / fused linear1 : column-parallel (output features split)
    -> each rank holds heads / tp heads and mlp_hidden / tp MLP features;
  * attn-out / mlp-out / linear2 : row-parallel (input features split)
    -> all_reduce of the partial outputs, then the bias;
  * modulations                  : column-parallel, all-gathered before
    they are chunked (their outputs are tiny [B, n*h] vectors);
  * norms, embedders             : replicated.
KV caches hold each rank's heads; the request axis goes over "dp"
(`pipelines.base.EditPipelineBase.edit_latents_batch(mesh=)`).

The rules (`_RULES`, `_spec_for`) are the JAX module's, applied to each
port parameter's JAX pytree path (`ops.quant.jax_path`); `param_specs`
returns them in the port's layout (a linear's weight is [out, in], the
transpose of JAX's).  The fused single-block `linear1` is split per part:
each rank keeps its slice of q, k, v and the MLP, and `linear2` its slice
of [attn ‖ mlp] input rows (a contiguous slice would give rank 0 the q
columns of every head).  A row-parallel int4 weight is repacked into the
rank's own S-halves layout (`ops.quant`: byte i holds local columns i and
i + in_l/2); its `scale4` stays whole, as the JAX rules keep it.

The mesh is built over a process group the caller initialised
(`torch.distributed.init_process_group`, backend of the caller's choice:
NCCL with one rank per card, gloo to run several ranks on one card or on
the CPU).  On the CPU:

    torchrun --nproc-per-node 4 my_script.py     # init_process_group("gloo")
    mesh = make_mesh(dp=2, device_type="cpu")
    shard_params(model, mesh)
"""

from __future__ import annotations

import inspect
import math
import re

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from regione_tpu_torch.models.layers import (ROLE_COLUMN, ROLE_GATHER,
                                             ROLE_ROW, Int4Linear,
                                             Int8Linear, LinearShard,
                                             ShardedLinear, TPGroup, take)
from regione_tpu_torch.ops.quant import jax_path, pack_int4, unpack_int4


def P(*axes) -> tuple:
    """A partition spec: one mesh axis name (or None) per tensor axis; ()
    is replicated."""
    return tuple(axes)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              device_type: str = "cuda"):
    """A `DeviceMesh` with dims ("dp", "tp") over the ranks of the
    initialised default process group (its backend for the subgroups, too:
    the mesh never picks another).  n_devices: the world size (checked);
    dp defaults to 1 (editing is batch-1/2 work; tp is where the win is)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed."
                           "init_process_group first")
    world = dist.get_world_size()
    n = n_devices or world
    dp = dp or 1
    if n != world:
        raise ValueError(f"make_mesh: {n} devices, but the process group "
                         f"has {world} ranks")
    if n % dp:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    kw = {}
    if "backend_override" in inspect.signature(DeviceMesh.__init__).parameters:
        kw["backend_override"] = ((dist.get_backend(), None),) * 2
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, n // dp),
                      mesh_dim_names=("dp", "tp"), **kw)


def tp_group(mesh) -> TPGroup:
    return TPGroup(mesh.get_group("tp"), mesh.get_local_rank("tp"),
                   mesh.size(1))


# (regex over '/'-joined JAX param path) -> PartitionSpec for stacked
# [L, i, o] or flat [i, o] weights, in the JAX layout.  First match wins;
# default replicated.  `w_q`/`scale` are the int8 forms (ops.quant): w_q
# has the same [.., i, o] layout as w; scale is per-output-channel
# [.., 1, o], so it shards with the OUTPUT axis for column-parallel layers
# and stays replicated for row-parallel ones (their outputs are full-width
# partial sums).
#
# `w_qp`/`scale4` are the nibble-packed int4 forms (ops.quant): w_qp is
# [.., in/2, out] and scale4 [.., G, out].  Column-parallel layers shard
# both on the OUT axis (same as w_q/scale).  Row-parallel layers shard
# only w_qp on the packed-row axis; scale4 stays replicated because its
# group axis follows WHOLE-TENSOR group order (the first G/2 groups scale
# the lo-nibble input half, the last G/2 the hi half — ops.quant
# quantize_linear4), so a packed-row shard boundary does not land on a
# whole-group boundary in that order; and at ~w/128 bytes the leaf is too
# small to matter.
_RULES: list[tuple[str, tuple]] = [
    # column-parallel (shard output features)
    (r"(img_attn|txt_attn)/(q|k|v)/(w|w_q|scale|w_qp|scale4)$",
     P(None, None, "tp")),
    (r"(img_mlp|txt_mlp)/in/(w|w_q|scale|w_qp|scale4)$", P(None, None, "tp")),
    (r"linear1/(w|w_q|scale|w_qp|scale4)$", P(None, None, "tp")),
    (r"(img_attn|txt_attn)/(q|k|v)/b$", P(None, "tp")),
    (r"(img_mlp|txt_mlp)/in/b$", P(None, "tp")),
    (r"linear1/b$", P(None, "tp")),
    # row-parallel (shard input features; the partial outputs are summed)
    (r"(img_attn|txt_attn)/out/(w|w_q|w_qp)$", P(None, "tp", None)),
    (r"(img_mlp|txt_mlp)/out/(w|w_q|w_qp)$", P(None, "tp", None)),
    (r"linear2/(w|w_q|w_qp)$", P(None, "tp", None)),
    # connector (Step1X): its blocks use the same col/row split
    (r"connector/.*/(q|k|v)/(w|w_q|scale)$", P(None, None, "tp")),
    (r"connector/.*/mlp/in/(w|w_q|scale)$", P(None, None, "tp")),
    (r"connector/.*/(q|k|v|mlp/in)/b$", P(None, "tp")),
    (r"connector/.*/(out|mlp/out)/(w|w_q)$", P(None, "tp", None)),
    # modulation projections: h -> 6h (double) / 3h (single).  The WEIGHT is
    # among the largest leaves of the model (6.3 GiB per Qwen mod stack in
    # bf16) but the OUTPUT is a tiny per-image vector [B, 6h], so column-
    # parallel sharding costs one negligible all-gather per block and must
    # not be left replicated.
    (r"(img_mod|txt_mod|mod)/(w|w_q|scale)$", P(None, None, "tp")),
    (r"(img_mod|txt_mod|mod)/b$", P(None, "tp")),
]


def _spec_for(path: str, ndim: int) -> tuple:
    for pat, spec in _RULES:
        if re.search(pat, path):
            if len(spec) == ndim:
                return spec
            if len(spec) == ndim + 1:  # unstacked variant of a stacked rule
                return P(*spec[1:])
    return P()  # replicated


# the port's leaf names -> the JAX package's
_JAX_LEAF = {"weight": "w", "bias": "b"}
# leaves stored [in, out] (or [G, out]) in JAX and [out, in] here
_TRANSPOSED = ("w", "w_q", "w_qp", "scale4")
# module prefixes of the blocks the JAX pytree stacks on a layer axis
_STACKED = ("double_blocks.", "single_blocks.", "connector.blocks.")


def jax_leaf(name: str) -> tuple[str, bool, str]:
    """A port parameter name -> (its JAX path, stacked, the JAX leaf)."""
    module, _, leaf = name.rpartition(".")
    jleaf = _JAX_LEAF.get(leaf, leaf)
    return (jax_path(module).lstrip("/") + "/" + jleaf,
            name.startswith(_STACKED), jleaf)


def _port_spec(name: str, ndim: int) -> tuple:
    """The JAX rule's spec of a port parameter of `ndim` axes, in the
    port's layout (no layer axis; a transposed leaf's axes reversed)."""
    path, stacked, jleaf = jax_leaf(name)
    spec = _spec_for(path, ndim + stacked)
    if not spec:
        return P()
    if stacked:
        spec = spec[1:]
    if jleaf in _TRANSPOSED or (jleaf == "scale" and ndim == 2):
        spec = spec[::-1]
    return tuple(spec)


def param_specs(model) -> dict[str, tuple]:
    """{parameter name: spec in the port's layout} (the JAX module's
    `param_specs`, leaf for leaf)."""
    return {n: _port_spec(n, p.dim()) for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# one rank's slices
# ---------------------------------------------------------------------------

class RowCat:
    """A tensor to be made of `parts` concatenated along axis 0, kept as
    its parts so a rank can take its rows without the whole being built
    (`weights.convert`: the fused linear1, final_mod's swapped halves)."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.shape = torch.Size([sum(p.shape[0] for p in self.parts),
                                 *self.parts[0].shape[1:]])
        self.dtype = self.parts[0].dtype

    def rows(self, ranges):
        """The row ranges [(lo, hi), ...] of the concatenation."""
        out, bounds, offset = [], [], 0
        for p in self.parts:
            bounds.append((offset, offset + p.shape[0], p))
            offset += p.shape[0]
        for lo, hi in ranges:
            for a, b, p in bounds:
                s, e = max(lo, a), min(hi, b)
                if s < e:
                    out.append(p[s - a:e - a])
        return out[0] if len(out) == 1 else torch.cat(out)

    def whole(self):
        return torch.cat(self.parts)


def _ranges(sizes, rank: int, size: int, what: str):
    """Rank `rank`'s slice of each part of `sizes`, as absolute ranges."""
    out, offset = [], 0
    for n in sizes:
        if n % size:
            raise ValueError(f"{what}: {n} features not divisible by "
                             f"tp={size}")
        k = n // size
        out.append((offset + rank * k, offset + (rank + 1) * k))
        offset += n
    return out


# row-parallel layers whose input arrives whole: the JAX rule for the
# connector's row-parallel projections also matches its t_embed / c_embed
# output linears, which follow a replicated one
_WHOLE_INPUT = re.compile(r"connector/(t_embed|c_embed)/out$")


def _kind(lin) -> str:
    if isinstance(lin, Int8Linear):
        return "int8"
    if isinstance(lin, Int4Linear):
        return "int4"
    return "linear"


def _int4_row_layout(in_ranges, d_in: int, groups: int):
    """A row-parallel int4 rank's scale groups: for each of its local
    groups, the global group whose scale it takes.  The local group size is
    the largest that divides the global group size and the local half and
    keeps each local group inside one global group."""
    cols = np.concatenate([np.arange(lo, hi) for lo, hi in in_ranges])
    gs = d_in // groups
    gg = cols // gs
    base = math.gcd(gs, len(cols) // 2)
    for g in range(base, 0, -1):
        if base % g == 0 and (gg.reshape(-1, g) == gg[::g, None]).all():
            return gg[::g].tolist()


def shard_plan(model, rank: int, size: int) -> dict[str, LinearShard]:
    """{module name: LinearShard} of every linear of `model` that the rules
    split at tp `size` (none at size 1)."""
    if size == 1:
        return {}
    cfg = model.cfg
    plans = {}
    for mname, lin in model.named_modules():
        if not isinstance(lin, (nn.Linear, Int8Linear, Int4Linear)):
            continue
        path = jax_path(mname).lstrip("/")
        role_spec = _spec_for(path + "/w", 2)
        if not role_spec:
            continue
        role = ROLE_ROW if role_spec[0] == "tp" else ROLE_COLUMN
        if role == ROLE_COLUMN and path.endswith("mod"):
            role = ROLE_GATHER
        specs = {leaf: _port_spec(f"{mname}.{leaf}", t.dim())
                 for leaf, t in lin.named_parameters(recurse=False)}
        w = next(t for leaf, t in lin.named_parameters(recurse=False)
                 if leaf in ("weight", "w_q", "w_qp"))
        d_out = w.shape[0]
        d_in = w.shape[1] * (2 if isinstance(lin, Int4Linear) else 1)
        out_sizes, in_sizes = [d_out], [d_in]
        if mname.startswith("single_blocks.") and mname.endswith("linear1"):
            out_sizes = [cfg.inner] * 3 + [cfg.mlp_hidden]
        if mname.startswith("single_blocks.") and mname.endswith("linear2"):
            in_sizes = [cfg.inner, cfg.mlp_hidden]
        plan = LinearShard(
            kind=_kind(lin), role=role, specs=specs,
            out_ranges=_ranges(out_sizes, rank, size, mname),
            in_ranges=_ranges(in_sizes, rank, size, mname),
            local_input=not _WHOLE_INPUT.search(path))
        if plan.kind == "int4" and role == ROLE_ROW and plan.split:
            plan.scale_groups = _int4_row_layout(plan.in_ranges, d_in,
                                                 lin.scale4.shape[1])
        plans[mname] = plan
    return plans


def _int4_rows(w_qp, in_ranges):
    """A row-parallel rank's int4 codes: the nibbles of its input columns
    (column c < in/2 is the low nibble of byte c, the others the high
    nibble of byte c - in/2), repacked into its own S-halves layout."""
    half = w_qp.shape[1]
    pieces = []
    for lo, hi in in_ranges:
        for a, b, nib in ((lo, min(hi, half), 0),
                          (max(lo, half), hi, 1)):
            if a < b:
                off = half * nib
                pieces.append(unpack_int4(w_qp[:, a - off:b - off])[nib])
    codes = torch.cat(pieces, dim=1)
    half_l = codes.shape[1] // 2
    return pack_int4(codes[:, :half_l], codes[:, half_l:])


def shard_tensor(plans: dict, name: str, t):
    """The rank's part of the parameter `name` of the whole tensor `t` (a
    tensor or a `RowCat`): its slice where the rules split it, else `t`.
    Slices of a tensor are views where one range suffices (a mapped file's
    tensor is then read only there)."""
    module, _, leaf = name.rpartition(".")
    plan = plans.get(module)
    spec = plan.specs.get(leaf, P()) if plan else P()
    if "tp" not in spec:
        return t.whole() if isinstance(t, RowCat) else t
    if spec[0] == "tp":
        if isinstance(t, RowCat):
            return t.rows(plan.out_ranges)
        return take(t, 0, plan.out_ranges)
    if isinstance(t, RowCat):
        t = t.whole()
    if leaf == "w_qp":
        return _int4_rows(t, plan.in_ranges)
    return take(t, 1, plan.in_ranges)


def _replace(model, name: str, new: nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, child, new)


def _localize_heads(model, size: int) -> None:
    """Each rank's head counts and split sizes: heads / tp."""
    from regione_tpu_torch.models.connector import ConnectorBlock
    from regione_tpu_torch.models.mmdit import Attention, SingleBlock
    for mod in model.modules():
        if isinstance(mod, (Attention, SingleBlock, ConnectorBlock)):
            if mod.heads % size:
                raise ValueError(f"{mod.heads} heads not divisible by "
                                 f"tp={size}")
            mod.heads //= size
        if isinstance(mod, SingleBlock):
            mod.inner //= size
            mod.mlp_hidden //= size


def shard_params(model, mesh, plans: dict | None = None):
    """Shard `model` (an `MMDiT`, quantized or not) in place over the mesh's
    "tp" axis: each linear the rules split becomes a `ShardedLinear` holding
    this rank's slices (copies, so the whole tensors are freed with the
    module they leave), head counts become the rank's, and `model.tp` /
    `model.mesh` are set.  At tp 1 no layer changes.  `plans`: the
    `shard_plan` of the unsharded model, when the caller made it already.
    Returns `model`."""
    if model.tp is not None:
        raise ValueError("shard_params: the model is sharded already")
    tp = tp_group(mesh)
    if plans is None:
        plans = shard_plan(model, tp.rank, tp.size)
    for mname, plan in plans.items():
        lin = model.get_submodule(mname)
        tensors = {}
        for leaf, t in lin.named_parameters(recurse=False):
            local = shard_tensor(plans, f"{mname}.{leaf}", t.detach())
            if local is not t:
                local = local.clone(memory_format=torch.contiguous_format)
            tensors[leaf] = local
        _replace(model, mname, ShardedLinear(plan, tensors, tp))
        del lin
    if tp.size > 1:
        _localize_heads(model, tp.size)
    model.tp, model.mesh = tp, mesh
    return model


def load_shards(model, mesh, make_state):
    """This rank's shard of `model` (unsharded, on the meta device) from a
    checkpoint: `make_state(shard)` returns the state dict, each whole
    tensor (a mapped file's view, or a `RowCat`) passed through `shard`
    (name, tensor) -> the rank's part on its way to the device; the model
    is sharded (`shard_params`) and takes the tensors as its own.  Sets
    `model.loaded_bytes`, the bytes cut out of the source.  Returns
    `model`."""
    tp = tp_group(mesh)
    plans = shard_plan(model, tp.rank, tp.size)
    read = 0

    def shard(name, t):
        nonlocal read
        part = shard_tensor(plans, name, t)
        read += part.numel() * part.element_size()
        return part

    state = make_state(shard)
    shard_params(model, mesh, plans)
    model.load_state_dict(state, strict=True, assign=True)
    model.loaded_bytes = read
    return model.eval()


# ---------------------------------------------------------------------------
# caches, latents, and the collectives of the sampler
# ---------------------------------------------------------------------------

def cache_specs(cache, dp: int | None = None) -> dict[str, tuple]:
    """Head-major KV caches: [L, B, H, S, dh] K/V shard the head axis on
    tp and batch on dp; [L, B, H, S] scale leaves likewise.  A batch axis
    that dp cannot divide stays replicated: batch 1 always, and any other
    indivisible batch when the mesh's dp size is passed."""
    def spec(x):
        b_sz = x.shape[1]
        b = "dp" if b_sz > 1 and (dp is None or b_sz % dp == 0) else None
        return (P(None, b, "tp", None, None) if x.dim() == 5
                else P(None, b, "tp", None))
    return {k: spec(v) for k, v in cache.items()}


def latent_spec() -> tuple:
    return P("dp", None, None)


def tp_broadcast(mesh, t):
    """`t` as tp rank 0 holds it, on every rank of the tp group.  Bool
    tensors travel as uint8."""
    group = mesh.get_group("tp")
    buf = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(t.dtype) if t.dtype == torch.bool else buf


def dp_all_gather(mesh, t):
    """The dp ranks' tensors concatenated along axis 0, in dp order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(0))]
    dist.all_gather(parts, t, group=mesh.get_group("dp"))
    return torch.cat(parts)
