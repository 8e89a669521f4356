"""The quantized Region-Instruction KV cache formats, in PyTorch.

Counterpart of the KV-cache half of `regione_tpu/ops/quant.py`, bit for bit,
so that caches the JAX package quantizes serve as test vectors here:

  * int8: per-row symmetric, scale = amax / 127 + 1e-12 over head_dim, codes
    round(x / scale) clipped to [-127, 127];
  * int4: the same with amax / 7 and [-7, 7], nibble-packed along S in split
    halves: byte (s, d) holds row s in its low nibble and row s + S/2 in its
    high nibble, so a packed cache has S/2 rows at full head_dim (S even).

Both divide by the scale (as JAX does; a multiply by the reciprocal rounds
differently) and round half to even (`torch.round`, like `jnp.round`).
Nibbles are packed and unpacked through int32 shifts, never by shifting an
int8 tensor left.  The weight formats of the JAX module are not ported.
"""

from __future__ import annotations

import torch


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
