"""The MMDiT blocks' elementwise chains: AdaLN with the gated residual (K7),
qk-RMSNorm + RoPE + head-major packing (K8), GELU + concatenation (K9),
the SwiGLU gate + concatenation (K11).

Every wrapper runs one hand-written CUDA kernel of `csrc/fused_block.cu`.
None replaces a Pallas kernel: the JAX package jits each sampler phase
(`regione_tpu/core/sampler.py:140-151`) and XLA fuses these chains into one
pass over the rows; eager PyTorch would run each op as its own launch.

  * `adaln(x, shift, scale)` (K7): layernorm(x) * (1 + scale) + shift;
  * `residual_adaln(x, gate, y, shift, scale)` (K7): x + gate * y, and the
    AdaLN of that, in one pass;
  * `gated_residual(x, gate, y)` (K7's residual-only mode): x + gate * y;
  * `qk_norm_rope(x, heads, scale, rope, out, row0)` (K8): RMSNorm, RoPE,
    and the head-major layout [B, H, S, dh], written into `out` at row
    `row0` (v: no scale, no rope, the packing alone);
  * `gelu_pack(attn, h)` (K9): [attn ‖ gelu_tanh(h)], or gelu_tanh(h);
  * `swiglu_pack(attn, h)` (K11): [attn ‖ silu(a) * b] of h = [a ‖ b], or
    silu(a) * b (FLUX.2's MLP).

The residual modes write the new x to a new tensor: the port never updates
a block's input in place.

The plain versions are the eager expressions of the JAX package's blocks,
over `models.layers`' `layernorm`, `rmsnorm` and `apply_rope`.  On a CPU
tensor a wrapper computes its plain version; on a CUDA tensor it launches
the kernel or raises (`ops.launch`, with the kernels' limits: bf16, any
batch and row strides with a dense last dim and 16-byte aligned rows; fp32
RoPE tables [S, 128] or [B, S, 128]; K8's head_dim 128).  They round to
bf16 where the plain version does, so the two differ only by the order of
fp32 sums (about one bf16 ulp at most).

Launch counters (`ops.launch.launch`): `adaln.launches`,
`residual_adaln.launches`, `gated_residual.launches` (K7),
`qk_norm_rope.launches` (K8), `gelu_pack.launches` (K9),
`swiglu_pack.launches` (K11), each with `.host_ns` and `.launch_ns`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from regione_tpu_torch.models.layers import (apply_rope, layernorm, rmsnorm,
                                             split_heads)
from regione_tpu_torch.ops import launch
from regione_tpu_torch.ops.launch import HEAD_DIM
from regione_tpu_torch.utils import telemetry

ADALN_MAX_H = 6144      # K7 holds a row in registers: 24 chunks a lane


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def adaln_reference(x, shift, scale):
    """Plain K7: layernorm(x) * (1 + scale) + shift."""
    return layernorm(x) * (1 + scale) + shift


def gated_residual_reference(x, gate, y):
    """Plain K7, residual-only mode: x + gate * y."""
    return x + gate * y


def qk_norm_rope_reference(x, heads, scale=None, rope=None):
    """Plain K8 without the packing: [B, S, H*dh] -> [B, H, S, dh] (a
    `split_heads` layout), RMSNorm'd where `scale` is given, rotated where
    `rope` is."""
    x = split_heads(x, heads)
    if scale is not None:
        x = rmsnorm(x, scale)
    if rope is not None:
        x = apply_rope(x, rope)
    return x


def gelu_pack_reference(attn, h):
    """Plain K9: [attn ‖ gelu_tanh(h)] on the last dim (attn None: the
    GELU alone)."""
    g = gelu_tanh(h)
    return g if attn is None else torch.cat([attn, g], dim=-1)


def swiglu_pack_reference(attn, h):
    """Plain K11: [attn ‖ silu(a) * b] on the last dim, h = [a ‖ b] (attn
    None: the gate alone); in bf16 silu(a) is rounded, then the product."""
    a, b = h.chunk(2, dim=-1)
    g = F.silu(a) * b
    return g if attn is None else torch.cat([attn, g], dim=-1)


def _check_mod(name, m, x):
    """A modulation vector [B or 1, 1, h] for x [B, S, h]; returns its
    batch stride."""
    b, _, h = x.shape
    sb = launch.check(name, m, x.device, (None, 1, h))[0]
    if m.shape[0] not in (1, b):
        raise ValueError(f"{name}: batch {m.shape[0]} for x's {b}")
    return sb


# ---------------------------------------------------------------------------
# K7: AdaLN and the gated residual
# ---------------------------------------------------------------------------

def _launch_adaln(counter, t0, x, gate, y, shift, scale):
    """One K7 launch, counted on `counter` from `t0` (none for an empty
    batch): returns (x + gate * y or None, the AdaLN output or
    None), each a new dense [B, S, h] tensor."""
    dev = x.device
    strides = launch.check("x", x, dev, (None, None, None))
    b, s, h = x.shape
    if h > ADALN_MAX_H:
        raise ValueError(f"the adaln kernel takes h <= {ADALN_MAX_H}, "
                         f"got {h}")
    x_out = out = None
    if y is not None:
        strides += launch.check("y", y, dev, (b, s, h))
        strides.append(_check_mod("gate", gate, x))
        x_out = torch.empty((b, s, h), dtype=x.dtype, device=dev)
    else:
        strides += (0, 0, 0)
    if shift is not None:
        strides += (_check_mod("shift", shift, x),
                    _check_mod("scale", scale, x))
        out = torch.empty((b, s, h), dtype=x.dtype, device=dev)
    else:
        strides += (0, 0)
    if b * s == 0:
        return x_out, out
    strides = (ctypes.c_longlong * 7)(*strides)
    launch.launch(counter, t0, "regione_adaln_fwd", dev, x.data_ptr(),
                  *map(launch.ptr, (y, gate, shift, scale, x_out, out)),
                  strides, b, s, h)
    return x_out, out


def adaln(x, shift, scale):
    """K7: layernorm(x) * (1 + scale) + shift; x [B, S, h] (any row
    stride), shift / scale [B, 1, h] (views of `_modulation`'s chunk).
    CPU: plain version.  CUDA: the kernel, or raises."""
    t0 = telemetry.clock()
    if not launch.on_card(x, "adaln"):
        return adaln_reference(x, shift, scale)
    return _launch_adaln(adaln, t0, x, None, None, shift, scale)[1]


def residual_adaln(x, gate, y, shift, scale):
    """K7, residual mode: x' = x + gate * y, then (x', layernorm(x') *
    (1 + scale) + shift) from one pass; x' is a new tensor."""
    t0 = telemetry.clock()
    if not launch.on_card(x, "adaln"):
        x = gated_residual_reference(x, gate, y)
        return x, adaln_reference(x, shift, scale)
    return _launch_adaln(residual_adaln, t0, x, gate, y, shift, scale)


def gated_residual(x, gate, y):
    """K7, residual-only mode: x + gate * y into a new tensor."""
    t0 = telemetry.clock()
    if not launch.on_card(x, "adaln"):
        return gated_residual_reference(x, gate, y)
    return _launch_adaln(gated_residual, t0, x, gate, y, None, None)[0]


# ---------------------------------------------------------------------------
# K8: qk-RMSNorm + RoPE + head-major packing
# ---------------------------------------------------------------------------

def qk_norm_rope(x, heads: int, scale=None, rope=None, out=None,
                 row0: int = 0):
    """K8: x [B, S, H*dh] (any row stride: a projection's output or a
    column slice of the fused `linear1`) -> heads [B, H, S, dh] with the
    RMSNorm (`scale` [dh]) and the interleaved RoPE (`rope` (cos, sin),
    fp32 [S, dh] or [B, S, dh]) applied where given.  With `out` [B, H,
    S_total, dh] the heads are written into its rows row0 .. row0 + S and
    `out` is returned; without, a new tensor (on the CPU the plain
    version's `split_heads` layout).  CPU: plain version.  CUDA: the
    kernel, or raises."""
    t0 = telemetry.clock()
    if not launch.on_card(x, "qk_norm_rope"):
        ref = qk_norm_rope_reference(x, heads, scale, rope)
        if out is None:
            return ref
        out[:, :, row0:row0 + x.shape[1]].copy_(ref)
        return out
    dev = x.device
    b, s, hd = x.shape
    if hd != heads * HEAD_DIM:
        raise ValueError(f"qk_norm_rope takes head_dim {HEAD_DIM}: "
                         f"{hd} columns for {heads} heads")
    strides = launch.check("x", x, dev, (b, s, hd))
    if out is None:
        out = torch.empty((b, heads, s, HEAD_DIM), dtype=x.dtype,
                          device=dev)
    launch.check("out", out, dev, (b, heads, None, HEAD_DIM))
    if not 0 <= row0 <= out.shape[2] - s:
        raise ValueError(f"rows {row0}..{row0 + s} outside out's "
                         f"{out.shape[2]}")
    if scale is not None:
        launch.check("scale", scale, dev, (HEAD_DIM,))
    cos = sin = None
    if rope is not None:
        cos, sin = rope
        shape = (b, s, HEAD_DIM) if cos.dim() == 3 else (s, HEAD_DIM)
        lead = launch.check("cos", cos, dev, shape, torch.float32)
        if launch.check("sin", sin, dev, shape, torch.float32) != lead:
            raise ValueError("cos and sin differ in strides")
        strides += lead if cos.dim() == 3 else [0] + lead
    else:
        strides += (0, 0)
    if b * s == 0:
        return out
    dst = out.narrow(2, row0, s)
    strides = (ctypes.c_longlong * 7)(*strides, *dst.stride()[:3])
    launch.launch(qk_norm_rope, t0, "regione_qk_norm_rope_fwd", dev,
                  x.data_ptr(), *map(launch.ptr, (scale, cos, sin)),
                  dst.data_ptr(), strides, b, s, heads)
    return out


# ---------------------------------------------------------------------------
# K9: GELU + concatenation
# ---------------------------------------------------------------------------

def gelu_pack(attn, h):
    """K9: [attn ‖ gelu_tanh(h)] on the last dim, attn [B, S, inner], h
    [B, S, mlp] (any row stride: the MLP half of `linear1`'s output);
    attn None: gelu_tanh(h) alone.  A new dense tensor.  CPU: plain
    version.  CUDA: the kernel, or raises."""
    t0 = telemetry.clock()
    if not launch.on_card(h, "gelu_pack"):
        return gelu_pack_reference(attn, h)
    dev = h.device
    h_strides = launch.check("h", h, dev, (None, None, None))
    b, s, mlp = h.shape
    inner, strides = 0, [0, 0]
    if attn is not None:
        strides = launch.check("attn", attn, dev, (b, s, None))
        inner = attn.shape[2]
    out = torch.empty((b, s, inner + mlp), dtype=h.dtype, device=dev)
    if b * s == 0:
        return out
    strides = (ctypes.c_longlong * 4)(*strides, *h_strides)
    launch.launch(gelu_pack, t0, "regione_gelu_pack_fwd", dev,
                  launch.ptr(attn), h.data_ptr(), out.data_ptr(), strides, b,
                  s, inner, mlp)
    return out


# ---------------------------------------------------------------------------
# K11: the SwiGLU gate + concatenation
# ---------------------------------------------------------------------------

def swiglu_pack(attn, h):
    """K11: [attn ‖ silu(a) * b] on the last dim, h = [a ‖ b] [B, S, 2 *
    mlp] (any row stride: the MLP part of FLUX.2's `linear1`, or a double
    block's MLP input projection), attn [B, S, inner]; attn None: silu(a)
    * b alone.  A new dense tensor.  CPU: plain version.  CUDA: the
    kernel, or raises."""
    t0 = telemetry.clock()
    if not launch.on_card(h, "swiglu_pack"):
        return swiglu_pack_reference(attn, h)
    dev = h.device
    h_strides = launch.check("h", h, dev, (None, None, None))
    b, s, two_mlp = h.shape
    if two_mlp % 16:
        raise ValueError(f"swiglu_pack: h's {two_mlp} columns are not two "
                         f"halves of a multiple of 8")
    mlp = two_mlp // 2
    inner, strides = 0, [0, 0]
    if attn is not None:
        strides = launch.check("attn", attn, dev, (b, s, None))
        inner = attn.shape[2]
    out = torch.empty((b, s, inner + mlp), dtype=h.dtype, device=dev)
    if b * s == 0:
        return out
    strides = (ctypes.c_longlong * 4)(*strides, *h_strides)
    launch.launch(swiglu_pack, t0, "regione_swiglu_pack_fwd", dev,
                  launch.ptr(attn), h.data_ptr(), out.data_ptr(), strides, b,
                  s, inner, mlp)
    return out


def reset_launches():
    """Set every fused-kernel launch counter, and its host times, to 0."""
    telemetry.reset_counters(__name__)


telemetry.register_counters(adaln, residual_adaln, gated_residual,
                            qk_norm_rope, gelu_pack, swiglu_pack)
