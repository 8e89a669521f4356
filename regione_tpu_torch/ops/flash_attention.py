"""Attention for the RegionE shapes: K1 (dense) and K2 (RAGS, two segments).

Both wrappers run one hand-written CUDA kernel (`csrc/attention.cu`,
`regione_attention_fwd`) that replaces two Pallas TPU kernels of
`regione_tpu/ops/flash_attention.py`:

  * `attention`        <- `_kv_resident_kernel` (via `flash_attention`):
    q [B, H, T, D] over k, v [B, H, S, D];
  * `attention_rows2`  <- `_rows2_resident_kernel`, bf16 cache (via
    `flash_attention_rows2`): q over [fresh rows ‖ frozen cache], one
    softmax, the cache read in place with no concatenation.

Contract of both (the JAX `sdpa` contract): logits and softmax in fp32, an
optional additive fp32 key-column bias [B, S_total], output [B, T, H*D] in
the input dtype.  On a CPU tensor the wrapper computes the plain PyTorch
version (`attention_reference`, `attention_rows2_reference`); on a CUDA
tensor it launches the kernel or raises.  The kernel takes bf16 q/k/v with
D = 128, any (b, h, row) strides with a dense last dim and 16-byte aligned
rows (so `split_heads` views need no copy), and a dense fp32 bias.

Bound against the plain version on the card: the kernel keeps an online
softmax and casts the unnormalised P to bf16, the plain version casts the
normalised P; both round the output to bf16.  The difference is a few bf16
ulps of the output scale (`chip_smoke.py` states and checks the bound).

`attention.launches` / `attention_rows2.launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

HEAD_DIM = 128


def attention_reference(q, k, v, bias=None):
    """Plain version of K1 (the JAX `sdpa` math path): q [B, H, T, D],
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


def _strides(x):
    """(b, h, row) element strides; a size-1 dim is never stepped over, so
    its stride (which torch leaves arbitrary) is taken as 0."""
    return [0 if x.shape[i] == 1 else x.stride(i) for i in range(3)]


def _check_qkv(name, x, b, h, d, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[0] != b or x.shape[1] != h or x.shape[3] != d:
        raise ValueError(f"{name}: shape {tuple(x.shape)} is not "
                         f"[{b}, {h}, rows, {d}]")
    if x.stride(3) != 1:
        raise ValueError(f"{name}: the last dim must be dense")
    if x.data_ptr() % 16 or any(s % 8 for s in _strides(x)):
        raise ValueError(f"{name}: rows must be 16-byte aligned "
                         f"(strides {x.stride()})")


def _launch(q, k1, v1, k2, v2, bias):
    from regione_tpu_torch.ops import _build
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the attention kernel takes D = {HEAD_DIM}, got {d}")
    _check_qkv("q", q, b, h, d, q.device)
    for name, x in (("k1", k1), ("v1", v1)):
        _check_qkv(name, x, b, h, d, q.device)
    s1 = k1.shape[2]
    s2 = 0
    if k2 is not None:
        for name, x in (("k2", k2), ("v2", v2)):
            _check_qkv(name, x, b, h, d, q.device)
        s2 = k2.shape[2]
        if v2.shape[2] != s2:
            raise ValueError("k2 and v2 differ in rows")
    if v1.shape[2] != s1:
        raise ValueError("k1 and v1 differ in rows")
    if t == 0 or s1 + s2 == 0:
        raise ValueError("empty attention")
    if bias is not None:
        if (bias.device != q.device or bias.dtype != torch.float32
                or tuple(bias.shape) != (b, s1 + s2)
                or not bias.is_contiguous()):
            raise ValueError(
                f"bias must be a dense fp32 [{b}, {s1 + s2}] tensor on "
                f"{q.device}, got {bias.dtype} {tuple(bias.shape)}")
    out = torch.empty((b, t, h * d), dtype=q.dtype, device=q.device)
    k2_, v2_ = (k2, v2) if k2 is not None else (k1, v1)
    strides = (ctypes.c_longlong * 15)(
        *(s for x in (q, k1, v1, k2_, v2_) for s in _strides(x)))
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.regione_attention_fwd(
            q.data_ptr(), k1.data_ptr(), v1.data_ptr(), k2_.data_ptr(),
            v2_.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), strides, b, h, t, s1, s2,
            1.0 / math.sqrt(d), stream)
    _build.check(code, "regione_attention_fwd")
    return out


def attention(q, k, v, bias=None):
    """K1: q [B, H, T, D], k/v [B, H, S, D], bias [B, S] fp32 or None
    -> [B, T, H*D].  CPU: plain version.  CUDA: the kernel, or raises."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    out = _launch(q, k, v, None, None, bias)
    attention.launches += 1
    return out


def attention_rows2(q, k1, v1, k2, v2, bias=None):
    """K2: q [B, H, T, D] over fresh rows k1/v1 [B, H, S1, D] followed by
    the frozen cache k2/v2 [B, H, S2, D] in one softmax; bias
    [B, S1 + S2] fp32 or None -> [B, T, H*D].  CPU: plain version.  CUDA:
    the kernel, or raises."""
    if q.device.type == "cpu":
        return attention_rows2_reference(q, k1, v1, k2, v2, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    out = _launch(q, k1, v1, k2, v2, bias)
    attention_rows2.launches += 1
    return out


attention.launches = 0
attention_rows2.launches = 0
