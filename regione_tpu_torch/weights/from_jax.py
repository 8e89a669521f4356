"""Parameters for the port: from a `regione_tpu` param pytree, or drawn anew.

`mmdit_from_jax(params, cfg, device)` turns the JAX package's param pytree
(numpy or jax leaves, or `jax.ShapeDtypeStruct`s for a shape-only check on
the meta device) into the port's `MMDiT`:
  * a linear's "w" [in, out] becomes `weight` [out, in] (transposed), "b"
    becomes `bias`;
  * block params stacked on a leading layer axis ("double", "single",
    "connector.blocks") are unstacked into the `ModuleList` entries
    (`double_blocks`, `single_blocks`, `connector.blocks`);
  * the key "in" becomes `in_`;
  * a tree with no "single" (Qwen, depth_single = 0) has no single blocks,
    and "txt_norm.scale" (Qwen's text RMSNorm) maps by name.
Every leaf is consumed exactly once: the converted names must be exactly the
module's parameters (a strict load), and `convert_params` reports each
consumed leaf path.  A tree quantized by the JAX package's
`quantize_params` loads into the port's quantized linears (`ops.quant`).

`vae_from_jax(params, cfg, device)` does the same for a VAE param tree
({"encoder": ..., "decoder": ...}) of either family (`models.vae_module`):
a conv "w" [kh, kw, cin, cout] becomes `weight` [cout, cin, kh, kw], a
linear "w" (the attention's q/k/v/out, Wan's qkv/proj) is transposed, and
list entries ("down", "up", "resnets") become `ModuleList` indices.

`init_params(cfg, generator, device)` and `init_vae_params(cfg, generator,
device)` draw the distributions of the JAX package's `init_mmdit` /
`init_connector` (uniform +-1/sqrt(d_in) weights, zero biases, norm scales
1 (`txt_norm` included), connector `scale_factor` -0.91) and `init_vae` /
`init_wan_vae` (conv weights uniform +-1/sqrt(kh * kw * cin), attention
weights +-1/sqrt(C), zero biases, norm scales 1) with a torch generator:
the same distributions, not the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from regione_tpu_torch.models.layers import AffineNorm, Scale
from regione_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from regione_tpu_torch.models.vae import GroupNorm, vae_module
from regione_tpu_torch.models.vae_wan import RMSNorm
from regione_tpu_torch.ops.quant import quantized_shells

# pytree subtrees whose leaves carry a leading layer axis -> ModuleList name
STACKED = {"double": "double_blocks", "single": "single_blocks",
           "connector.blocks": "connector.blocks"}


def _to_torch(leaf, device):
    """numpy / jax array -> torch tensor on `device`; a shape-only leaf
    (no data, e.g. jax.ShapeDtypeStruct) -> an fp32 meta tensor."""
    if not hasattr(leaf, "__array__"):
        return torch.empty(tuple(leaf.shape), device="meta")
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def _torch_name(path: list[str]) -> str:
    out = []
    for key in path:
        out.append({"w": "weight", "b": "bias", "in": "in_"}.get(key, key))
    return ".".join(out)


def _walk(tree, prefix=()):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        path = prefix + (str(key),)
        if isinstance(val, (dict, list, tuple)):
            yield from _walk(val, path)
        else:
            yield path, val


# leaves stored [in, out] (or [G, out]) in JAX and [out, in] here: the
# weight, the int8 / int4 codes and the int4 group scales
_TRANSPOSED = ("w", "w_q", "w_qp", "scale4")


def convert_params(params, device="cuda"):
    """JAX param pytree -> ({torch param name: tensor}, consumed leaf paths
    in pytree order).  A quantized tree's leaves (`ops.quant`) keep their
    names: "w_q" / "w_qp" / "scale4" are transposed, and so is an int8
    linear's "scale" ([1, out] -> [out, 1]; a norm's "scale" is 1-D)."""
    state, consumed = {}, []
    for path, leaf in _walk(params):
        t = _to_torch(leaf, device)
        dotted = ".".join(path)
        stack = next((s for s in STACKED if dotted.startswith(s + ".")), None)
        if path[-1] in _TRANSPOSED or (
                path[-1] == "scale" and t.dim() == 2 + (stack is not None)):
            t = t.transpose(-1, -2)
        if stack is None:
            names = {_torch_name(list(path)): t}
        else:
            rest = list(path[len(stack.split(".")):])
            names = {f"{STACKED[stack]}.{i}." + _torch_name(rest): t[i]
                     for i in range(t.shape[0])}
        for name, val in names.items():
            if name in state:
                raise ValueError(f"{name} produced twice")
            state[name] = val
        consumed.append(dotted)
    return state, consumed


def mmdit_from_jax(params, cfg: MMDiTConfig, device="cuda") -> MMDiT:
    """The port's backbone holding a JAX param pytree's values, quantized
    linears (`ops.quant.quantize_params`' trees) included: each tensor is
    copied into its parameter's dtype (the model dtype; codes int8, scales
    fp32)."""
    model = MMDiT(cfg, device)
    state, _ = convert_params(params, device)
    quantized_shells(model, state)
    model.load_state_dict(state, strict=True)
    return model.eval()


def vae_from_jax(params, cfg, device="cuda") -> nn.Module:
    """The port's VAE (`AutoencoderKL` or `WanVAE`, by the config's type)
    holding a JAX VAE param tree's values; a strict load, every leaf
    consumed once."""
    vae = vae_module(cfg)(cfg, device)
    state = {}
    for path, leaf in _walk(params):
        t = _to_torch(leaf, device)
        if path[-1] == "w":
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.transpose(0, 1)
        name = _torch_name(list(path))
        if name in state:
            raise ValueError(f"{name} produced twice")
        state[name] = t.to(cfg.dtype)
    vae.load_state_dict(state, strict=True)
    return vae.eval()


@torch.no_grad()
def init_vae_params(cfg, generator: torch.Generator,
                    device="cuda") -> nn.Module:
    """A VAE of `cfg`'s family with random weights drawn on `device` from
    `generator`."""
    vae = vae_module(cfg)(cfg, device)
    for mod in vae.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            lim = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.uniform_(-lim, lim, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, GroupNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.gamma.fill_(1.0)
    return vae.eval()


@torch.no_grad()
def init_params(cfg: MMDiTConfig, generator: torch.Generator,
                device="cuda") -> MMDiT:
    """A backbone with random weights drawn on `device` from `generator`."""
    model = MMDiT(cfg, device)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            lim = 1.0 / math.sqrt(mod.in_features)
            mod.weight.uniform_(-lim, lim, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, (Scale, AffineNorm)):
            mod.scale.fill_(1.0)
            if isinstance(mod, AffineNorm):
                mod.bias.zero_()
    if cfg.connector is not None:
        model.connector.scale_factor.fill_(-0.91)
    return model.eval()
