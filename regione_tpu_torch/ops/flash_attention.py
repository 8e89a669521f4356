"""Attention for the RegionE shapes: dense (K1, K5), RAGS (K2, K2q) and a
quantized K/V alone (K6).

Every wrapper runs one hand-written CUDA kernel, `csrc/attention_tma.cu`
(`regione_attention_tma_fwd`: TMA ring, wgmma, two consumer warpgroups),
instantiated for how the second K/V segment is stored: bf16 (`attention`,
`attention_rows2`), or an int8 / int4 cache (`attention_rows2_quant`,
`attention_quant`), whose codes a producer warpgroup dequantizes into the
same bf16 stage.  It replaces these Pallas TPU
kernels of `regione_tpu/ops/flash_attention.py`:

  * `attention`  <- `_kv_resident_kernel` (K1, via `flash_attention`) and,
    past `RESIDENT_KEYS` keys, `_flash_kernel` (K5): q [B, H, T, D] over
    k, v [B, H, S, D];
  * `attention_rows2`  <- `_rows2_resident_kernel`, bf16 cache (K2, via
    `flash_attention_rows2`): q over [fresh rows ‖ frozen cache], one
    softmax, the cache read in place with no concatenation;
  * `attention_rows2_quant`  <- the same kernel with an int8 or int4 cache
    (K2q: `_dequant_into`, `_unpack4_f32`), dequantized in shared memory;
  * `attention_quant`  <- `_kv_resident_q8_kernel` (K6, via
    `flash_attention(k_scale=...)`): q over a quantized K/V alone.
    `attention` and `attention_rows2` hand a call with scales to these two.

A quantized K/V is (rows, fp32 scales [B, H, S]): int8 rows [B, H, S, D],
or int4 rows packed in S-halves [B, H, S/2, D] (`ops.quant`), told apart by
the row count as the JAX package does.

Contract of all (the JAX `sdpa` contract): logits and softmax in fp32, an
optional additive fp32 key-column bias [B, S_total], output [B, T, H*D] in
q's dtype.  On a CPU tensor the wrapper computes the plain PyTorch version
(`*_reference`: dequantize with `ops.quant`, concatenate, attend, as the
JAX fallback does); on a CUDA tensor it launches the kernel or raises
(`ops.launch`).  The kernel takes `launch.check`'s bf16 q/k/v rows (so
`split_heads` views need no copy) with D = `HEAD_DIM`, int8 cache rows,
row-dense fp32 scales and a dense fp32 bias.

Bound against the plain version on the card: the kernel keeps an online
softmax and casts the unnormalised P to bf16, the plain version casts the
normalised P; both round the output to bf16.  The difference is a few bf16
ulps of the output scale (`chip_smoke.py` states and checks the bound).  The
dequantized K/V are bit-equal in both.

Launch counters (`ops.launch.launch`): `attention.launches` (every K1
launch) and `attention.long_launches` (those past `RESIDENT_KEYS`, the K5
regime), `attention_rows2.launches` (K2), `attention_rows2_quant.launches`
(K2q), `attention_quant.launches` (K6), each with `.host_ns` and
`.launch_ns`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from regione_tpu_torch.ops import launch
from regione_tpu_torch.ops.launch import HEAD_DIM
from regione_tpu_torch.ops.quant import dequantize_cache
from regione_tpu_torch.utils import telemetry

# the JAX package's resident budget at its default block_q = 128
# (4 * 128 * S <= 6 MiB of logits): past it `flash_attention` runs K5
RESIDENT_KEYS = 12288
# storage modes of the kernel's second segment (csrc/attention_tma.cu)
MODE_BF16, MODE_INT8, MODE_INT4 = 0, 1, 2


def attention_reference(q, k, v, bias=None):
    """Plain version of K1/K5 (the JAX `sdpa` math path): q [B, H, T, D],
    k/v [B, H, S, D], bias [B, S] or None -> [B, T, H*D]."""
    b, h, t, d = q.shape
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * (1.0 / math.sqrt(d))
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    return out.transpose(1, 2).reshape(b, t, h * d)


def attention_rows2_reference(q, k1, v1, k2, v2, bias=None):
    """Plain version of K2: concatenate [fresh ‖ cache] and attend
    (the JAX `sdpa_cached` fallback).  bias [B, S1 + S2] or None."""
    k = torch.cat([k1.to(k2.dtype), k2], dim=2)
    v = torch.cat([v1.to(v2.dtype), v2], dim=2)
    return attention_reference(q, k, v, bias)


def attention_quant_reference(q, k, v, k_scale, v_scale, bias=None):
    """Plain version of K6: dequantize to q's dtype, then K1's."""
    return attention_reference(q, dequantize_cache(k, k_scale, q.dtype),
                               dequantize_cache(v, v_scale, q.dtype), bias)


def attention_rows2_quant_reference(q, k1, v1, k2, v2, k_scale, v_scale,
                                    bias=None):
    """Plain version of K2q: dequantize the cache to q's dtype, then K2's."""
    return attention_rows2_reference(
        q, k1, v1, dequantize_cache(k2, k_scale, q.dtype),
        dequantize_cache(v2, v_scale, q.dtype), bias)


def _segment(names, k, v, device, rows, dtype=torch.bfloat16):
    """A K/V segment's rows [B, H, S, D] (`rows`: its shape, S None) ->
    (S, the leading strides of k and v)."""
    strides = (launch.check(names[0], k, device, rows, dtype)
               + launch.check(names[1], v, device, rows, dtype))
    if v.shape[2] != k.shape[2]:
        raise ValueError(f"{names[0]} and {names[1]} differ in rows")
    return k.shape[2], strides


def _check_quant(q, k, v, k_scale, v_scale):
    """int8 or packed int4 K/V rows and their scales -> (S, mode, the
    leading strides of k and v, those of the two scales)."""
    b, h, _, d = q.shape
    if v_scale is None:
        raise ValueError("k_scale given without v_scale")
    rows, strides = _segment(("k", "v"), k, v, q.device, (b, h, None, d),
                             torch.int8)
    s, sc_strides = k_scale.shape[-1], []
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (sc.device != q.device or sc.dtype != torch.float32
                or tuple(sc.shape) != (b, h, s)):
            raise ValueError(
                f"{name} must be fp32 [{b}, {h}, {s}] on {q.device}, got "
                f"{sc.dtype} {tuple(sc.shape)} on {sc.device}")
        if s > 1 and sc.stride(2) != 1:
            raise ValueError(f"{name}: each (b, h) row of scales must be "
                             f"contiguous (strides {sc.stride()})")
        sc_strides += launch.lead_strides(sc, 2)
    if rows == s:
        return s, MODE_INT8, strides, sc_strides
    if rows * 2 == s:
        return s, MODE_INT4, strides, sc_strides
    raise ValueError(
        f"{rows} cache rows for {s} scales: neither int8 (rows == S) nor "
        "int4 S-halves packing (rows == S / 2, S even)")


def _launch(q, k1, v1, k2, v2, bias, k_scale=None, v_scale=None,
            counter=None, t0=0):
    """One launch over [k1/v1 rows ‖ k2/v2 rows], counted on `counter`
    from `t0` (`launch.launch`); either segment may be None.  With scales,
    k2/v2 are a quantized cache (int8 or packed int4)."""
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the attention kernel takes D = {HEAD_DIM}, got {d}")
    dev, rows = q.device, (b, h, None, d)
    q_strides = launch.check("q", q, dev, rows)
    s1 = s2 = 0
    mode, seg1, seg2, sc_strides = MODE_BF16, None, None, (0, 0, 0, 0)
    if k1 is not None:
        s1, seg1 = _segment(("k1", "v1"), k1, v1, dev, rows)
    if k2 is not None and k_scale is not None:
        s2, mode, seg2, sc_strides = _check_quant(q, k2, v2, k_scale,
                                                  v_scale)
    elif k2 is not None:
        s2, seg2 = _segment(("k2", "v2"), k2, v2, dev, rows)
    if t == 0 or s1 + s2 == 0:
        raise ValueError("empty attention")
    if bias is not None:
        if (bias.device != dev or bias.dtype != torch.float32
                or tuple(bias.shape) != (b, s1 + s2)
                or not bias.is_contiguous()):
            raise ValueError(
                f"bias must be a dense fp32 [{b}, {s1 + s2}] tensor on "
                f"{dev}, got {bias.dtype} {tuple(bias.shape)}")
    out = torch.empty((b, t, h * d), dtype=q.dtype, device=dev)
    # an absent segment's pointers and strides are never read (S = 0)
    k1_, v1_, seg1 = (k1, v1, seg1) if k1 is not None else (k2, v2, seg2)
    k2_, v2_, seg2 = (k2, v2, seg2) if k2 is not None else (k1, v1, seg1)
    scales = (k_scale, v_scale) if mode != MODE_BF16 else (None, None)
    strides = (ctypes.c_longlong * 19)(*q_strides, *seg1, *seg2,
                                       *sc_strides)
    # one entry for every storage mode: `mode` picks the instantiation
    launch.launch(counter, t0, "regione_attention_tma_fwd", dev,
                  q.data_ptr(), k1_.data_ptr(), v1_.data_ptr(),
                  k2_.data_ptr(), v2_.data_ptr(), *map(launch.ptr, scales),
                  launch.ptr(bias), out.data_ptr(), strides, b, h, t, s1, s2,
                  mode, 1.0 / math.sqrt(d))
    return out


def attention(q, k, v, bias=None, k_scale=None, v_scale=None):
    """K1/K5: q [B, H, T, D], k/v [B, H, S, D], bias [B, S] fp32 or None
    -> [B, T, H*D].  With scales, k/v are quantized: `attention_quant`
    (K6).  CPU: plain version.  CUDA: the kernel, or raises."""
    t0 = telemetry.clock()
    if k_scale is not None:
        return attention_quant(q, k, v, k_scale, v_scale, bias)
    if not launch.on_card(q, "attention"):
        return attention_reference(q, k, v, bias)
    out = _launch(q, k, v, None, None, bias, counter=attention, t0=t0)
    if k.shape[2] > RESIDENT_KEYS:
        attention.long_launches += 1
    return out


def attention_rows2(q, k1, v1, k2, v2, bias=None, k_scale=None,
                    v_scale=None):
    """K2: q [B, H, T, D] over fresh rows k1/v1 [B, H, S1, D] followed by
    the frozen cache k2/v2 [B, H, S2, D] in one softmax; bias
    [B, S1 + S2] fp32 or None -> [B, T, H*D].  With scales, the cache is
    quantized: `attention_rows2_quant` (K2q).  CPU: plain version.  CUDA:
    the kernel, or raises."""
    t0 = telemetry.clock()
    if k_scale is not None:
        return attention_rows2_quant(q, k1, v1, k2, v2, k_scale, v_scale,
                                     bias)
    if not launch.on_card(q, "attention"):
        return attention_rows2_reference(q, k1, v1, k2, v2, bias)
    return _launch(q, k1, v1, k2, v2, bias, counter=attention_rows2, t0=t0)


def attention_rows2_quant(q, k1, v1, k2, v2, k_scale, v_scale, bias=None):
    """K2q: K2 with the cache as int8 rows [B, H, S, D] or packed int4 rows
    [B, H, S/2, D] and fp32 row scales [B, H, S]; bias [B, S1 + S]."""
    t0 = telemetry.clock()
    if not launch.on_card(q, "attention"):
        return attention_rows2_quant_reference(q, k1, v1, k2, v2, k_scale,
                                               v_scale, bias)
    return _launch(q, k1, v1, k2, v2, bias, k_scale, v_scale,
                   counter=attention_rows2_quant, t0=t0)


def attention_quant(q, k, v, k_scale, v_scale, bias=None):
    """K6: q over a quantized K/V alone (int8 [B, H, S, D] or packed int4
    [B, H, S/2, D] rows, fp32 scales [B, H, S]); bias [B, S]."""
    t0 = telemetry.clock()
    if not launch.on_card(q, "attention"):
        return attention_quant_reference(q, k, v, k_scale, v_scale, bias)
    return _launch(q, None, None, k, v, bias, k_scale, v_scale,
                   counter=attention_quant, t0=t0)


def reset_launches():
    """Set every attention launch counter, and its host times, to 0."""
    telemetry.reset_counters(__name__)
    attention.long_launches = 0


telemetry.register_counters(attention, attention_rows2,
                            attention_rows2_quant, attention_quant)
attention.long_launches = 0
