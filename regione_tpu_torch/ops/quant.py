"""The quantized weight and KV-cache formats, in PyTorch.

Counterpart of `regione_tpu/ops/quant.py`, bit for bit, so that what the JAX
package quantizes serves as test vectors here.

Weights (the DiT's linears; a linear's weight is torch's [out, in], the
transpose of the JAX package's [in, out], and its codes and scales are
JAX's transposed):

  * int8: per-output-channel symmetric over the reduction axis, scale =
    amax / 127 + 1e-12 ([out, 1] fp32), codes round(w / scale) clipped to
    [-127, 127] (`quantize_linear`); run weight-only, or as W8A8 with the
    activations quantized per row (`models.layers.Int8Linear`);
  * int4: group-128 scales over the reduction axis (`_int4_group_size`),
    amax / 7, codes in [-7, 7], nibble-packed along the reduction axis in
    split halves: byte (o, i) holds input column i in its low nibble and
    column i + in/2 in its high nibble (`quantize_linear4`,
    `models.layers.Int4Linear`);
  * `quantize_params` replaces the eligible `nn.Linear`s of a model in
    place, under the JAX package's rules on its pytree paths.

KV cache:

  * int8: per-row symmetric, scale = amax / 127 + 1e-12 over head_dim, codes
    round(x / scale) clipped to [-127, 127];
  * int4: the same with amax / 7 and [-7, 7], nibble-packed along S in split
    halves: byte (s, d) holds row s in its low nibble and row s + S/2 in its
    high nibble, so a packed cache has S/2 rows at full head_dim (S even).

Both divide by the scale (as JAX does; a multiply by the reciprocal rounds
differently) and round half to even (`torch.round`, like `jnp.round`).
Nibbles are packed and unpacked through int32 shifts, never by shifting an
int8 tensor left.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def pack_int4(lo, hi):
    """Two int8 tensors of int4-range values -> one packed int8 tensor
    (low nibble `lo`, high nibble `hi`)."""
    packed = (hi.to(torch.int32) << 4) | (lo.to(torch.int32) & 0x0F)
    return packed.to(torch.int8)     # in [-128, 127]: exact


def unpack_int4(packed):
    """packed int8 -> (lo, hi) int8 tensors of sign-extended int4 values
    (int8 -> int32 sign extension makes the arithmetic right shifts return
    signed nibbles)."""
    p32 = packed.to(torch.int32)
    lo = (p32 << 28) >> 28
    hi = p32 >> 4
    return lo.to(torch.int8), hi.to(torch.int8)


def _quantize(x, qmax: float):
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / qmax + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_kv_heads(x):
    """Head-major K/V [..., S, dh] -> (int8 [..., S, dh], fp32 scales
    [..., S])."""
    return _quantize(x, 127.0)


def dequantize_kv_heads(rows_q, scales, dtype=torch.bfloat16):
    """(int8 [..., S, dh], fp32 [..., S]) -> [..., S, dh] in `dtype`."""
    return (rows_q.float() * scales[..., None]).to(dtype)


def quantize_kv_heads4(x):
    """Head-major K/V [..., S, dh] -> (packed int8 [..., S/2, dh], fp32
    scales [..., S]); low nibble = rows [:S/2], high nibble = rows [S/2:]."""
    s = x.shape[-2]
    if s % 2:
        raise ValueError(f"int4 KV packing needs an even row count, got {s}")
    q, scale = _quantize(x, 7.0)
    half = s // 2
    return pack_int4(q[..., :half, :], q[..., half:, :]), scale


def dequantize_kv_heads4(rows_qp, scales, dtype=torch.bfloat16):
    """(packed int8 [..., S/2, dh], fp32 [..., S]) -> [..., S, dh]."""
    lo, hi = unpack_int4(rows_qp)
    rows = torch.cat([lo, hi], dim=-2).float()
    return (rows * scales[..., None]).to(dtype)


def dequantize_cache(rows, scales, dtype):
    """int8 or packed int4 cache rows -> [..., S, dh] in `dtype`.  An int4
    cache holds half as many rows as it has scales (the JAX package's test
    in `sdpa_cached`)."""
    packed = rows.shape[-2] * 2 == scales.shape[-1]
    deq = dequantize_kv_heads4 if packed else dequantize_kv_heads
    return deq(rows, scales, dtype)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

# JAX pytree paths whose linears stay in the model dtype (small, or
# numerically sensitive embeds and modulations)
_SKIP_SUBSTRINGS = ("norm", "mod", "time_in", "vector_in", "guidance_in",
                    "final_mod")
_INT4_GROUP = 128
# int4 takes only the big projections: narrow-reduction linears (the
# embedders) gain little memory and lose the averaging that keeps
# group-int4 error small
_INT4_MIN_IN = 512


def quantize_linear(weight, bias):
    """nn.Linear weight [out, in] -> {"w_q": int8 [out, in], "scale": fp32
    [out, 1], "b": bias}: symmetric per output channel over the reduction
    axis."""
    w = weight.float()
    scale = w.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale, "b": bias}


def dequantize_weight(p, dtype=torch.bfloat16):
    """{"w_q", "scale"} -> the [out, in] weight in `dtype`."""
    return (p["w_q"].float() * p["scale"]).to(dtype)


def _int4_group_size(half: int) -> int:
    """Reduction-group size per packed half (groups must tile each half)."""
    return _INT4_GROUP if half % _INT4_GROUP == 0 else half


def quantize_linear4(weight, bias):
    """nn.Linear weight [out, in] -> {"w_qp": packed int8 [out, in/2],
    "scale4": fp32 [out, G], "b": bias}; needs an even `in`, each half tiled
    by the group size."""
    w = weight.float()
    d_out, d_in = w.shape
    if d_in % 2:
        raise ValueError(f"int4 packing needs an even reduction axis, got "
                         f"{d_in}")
    half = d_in // 2
    gs = _int4_group_size(half)
    wg = w.reshape(d_out, d_in // gs, gs)
    scale = wg.abs().amax(dim=-1, keepdim=True) / 7.0 + 1e-12
    w4 = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    w4 = w4.reshape(d_out, d_in)
    return {"w_qp": pack_int4(w4[:, :half], w4[:, half:]),
            "scale4": scale.reshape(d_out, -1), "b": bias}


def dequantize_weight4(p, dtype=torch.bfloat16):
    """{"w_qp", "scale4"} -> the [out, in] weight in `dtype`."""
    lo, hi = unpack_int4(p["w_qp"])
    w4 = torch.cat([lo, hi], dim=-1).float()
    d_out, d_in = w4.shape
    g = p["scale4"].shape[-1]
    w = w4.reshape(d_out, g, d_in // g) * p["scale4"][..., None]
    return w.reshape(d_out, d_in).to(dtype)


def jax_path(name: str) -> str:
    """A port module name -> its JAX pytree path (the block index of a
    stacked subtree dropped): `double_blocks.3.img_attn.q` ->
    `/double/img_attn/q`, `connector.blocks.0.mlp.in_` ->
    `/connector/blocks/mlp/in`."""
    rename = {"double_blocks": "double", "single_blocks": "single",
              "in_": "in"}
    return "".join("/" + rename.get(part, part) for part in name.split(".")
                   if not part.isdigit())


def _linear_names(model) -> list[str]:
    return [n for n, m in model.named_modules() if type(m) is nn.Linear]


def _replace(model, name: str, new: nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, child, new)


def quantize_params(model, skip_substrings=_SKIP_SUBSTRINGS,
                    quantize_mods: bool = False, bits: int = 8,
                    int4_mods: bool = False):
    """Replace every eligible `nn.Linear` of `model` in place by its int8
    (`models.layers.Int8Linear`) or int4 (`Int4Linear`) form, one at a
    time, so each bf16 weight is freed as its codes are made.  The rules
    are the JAX package's, on the JAX pytree path of each linear
    (`jax_path`): a path holding a skip substring stays in the model dtype;
    quantize_mods also takes the per-block modulations (`final_mod` stays);
    bits=4 packs a linear to int4 when its reduction axis is even and at
    least _INT4_MIN_IN wide and it is no modulation (int4_mods: the
    modulations too), and the rest to int8.  Returns `model`."""
    from regione_tpu_torch.models.layers import Int4Linear, Int8Linear
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if quantize_mods:
        skip_substrings = tuple(s for s in skip_substrings if s != "mod")
        if "final_mod" not in skip_substrings:
            skip_substrings += ("final_mod",)
    for name in _linear_names(model):
        path = jax_path(name)
        if any(s in path for s in skip_substrings):
            continue
        lin = model.get_submodule(name)
        d_in = lin.in_features
        with torch.no_grad():
            if (bits == 4 and ("mod" not in path or int4_mods)
                    and d_in >= _INT4_MIN_IN and d_in % 2 == 0):
                new = Int4Linear(**quantize_linear4(lin.weight, lin.bias))
            else:
                new = Int8Linear(**quantize_linear(lin.weight, lin.bias))
        _replace(model, name, new)
        del lin
    return model


def quantized_shells(model, state) -> None:
    """Replace each `nn.Linear` of `model` whose name carries quantized
    codes in `state` ("<name>.w_q" / "<name>.w_qp") by an uninitialised
    quantized linear of those shapes, on the linear's device, so `state`
    loads into the model strictly."""
    from regione_tpu_torch.models.layers import Int4Linear, Int8Linear
    for name in _linear_names(model):
        lin = model.get_submodule(name)
        dev, dt = lin.weight.device, lin.weight.dtype
        d_out, d_in = lin.out_features, lin.in_features
        bias = torch.empty(d_out, device=dev, dtype=dt)
        if f"{name}.w_q" in state:
            new = Int8Linear(
                torch.empty(d_out, d_in, dtype=torch.int8, device=dev),
                torch.empty(d_out, 1, device=dev), bias)
        elif f"{name}.w_qp" in state:
            g = state[f"{name}.scale4"].shape[-1]
            new = Int4Linear(
                torch.empty(d_out, d_in // 2, dtype=torch.int8, device=dev),
                torch.empty(d_out, g, device=dev), bias)
        else:
            continue
        _replace(model, name, new)


def quantized_bytes(model) -> int:
    """Bytes of a model's tensors (codes, scales and full-precision
    leaves)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


@torch.no_grad()
def init_quantized(cfg, generator: torch.Generator, device="cuda",
                   quantize_mods: bool = True, bits: int = 8,
                   int4_mods: bool = False):
    """A quantized MMDiT with random values drawn directly in its quantized
    form, never the bf16 one (the 12 B Step1X's bf16 init alone is ~24
    GiB): the structure of `quantize_params(MMDiT(cfg), ...)`, built on the
    meta device and materialised on `device`, and the distributions of the
    JAX package's `_gen_like` (not its bits): int8 codes uniform in
    [-127, 127] with scale lim / 127, int4 codes uniform in [-7, 7] with
    scale lim / 7 (lim = 1 / sqrt(in)), full-precision weights uniform in
    [-lim, lim], biases zeros, leaves named "scale" ones and every other
    leaf (the connector's scale_factor, norm biases) zeros."""
    from regione_tpu_torch.models.layers import Int4Linear, Int8Linear
    from regione_tpu_torch.models.mmdit import MMDiT
    model = MMDiT(cfg, torch.device("meta"))
    quantize_params(model, quantize_mods=quantize_mods, bits=bits,
                    int4_mods=int4_mods)
    model.to_empty(device=device)
    done = set()
    for mod in model.modules():
        if isinstance(mod, Int8Linear):
            lim = 1.0 / math.sqrt(mod.w_q.shape[1])
            mod.w_q.copy_(torch.randint(-127, 128, mod.w_q.shape,
                                        generator=generator, device=device,
                                        dtype=torch.int8))
            mod.scale.fill_(lim / 127.0)
        elif isinstance(mod, Int4Linear):
            lim = 1.0 / math.sqrt(2 * mod.w_qp.shape[1])
            lo, hi = (torch.randint(-7, 8, mod.w_qp.shape,
                                    generator=generator, device=device,
                                    dtype=torch.int8) for _ in range(2))
            mod.w_qp.copy_(pack_int4(lo, hi))
            mod.scale4.fill_(lim / 7.0)
        elif type(mod) is nn.Linear:
            lim = 1.0 / math.sqrt(mod.in_features)
            mod.weight.uniform_(-lim, lim, generator=generator)
        else:
            continue
        mod.bias.zero_()
        done.update(id(t) for t in mod.parameters())
    for name, t in model.named_parameters():
        if id(t) not in done:
            t.fill_(1.0 if name.rsplit(".", 1)[-1] == "scale" else 0.0)
    return model.eval()
