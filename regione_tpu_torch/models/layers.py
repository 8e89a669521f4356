"""Building blocks of the flow-matching DiT backbone, in PyTorch.

Counterpart of `regione_tpu/models/layers.py`, with its conventions:
  * norms and the RoPE rotation compute in fp32 and cast back;
  * RoPE is the diffusers Flux convention: consecutive-pair rotation with
    cos/sin interleave-repeated to head_dim;
  * attention takes q/k/v head-major [B, H, T, D] and returns [B, T, H*D];
    its bias is an additive key-column row [B, 1, 1, S].
A linear's weight is torch's [out, in] (the JAX package stores [in, out]).
Attention goes through the port's kernels (`regione_tpu_torch.ops`), which
take the plain PyTorch path for CPU tensors.

Quantized linears (`ops.quant.quantize_params` puts them in place of
`nn.Linear`s) keep the JAX package's operation order:
  * `Int8Linear`, weight-only: dequantize to x's dtype, one matmul, + b;
  * `Int8Linear` under `act_int8()` (W8A8, `MMDiTConfig.act_int8`): the
    rows of x quantized to int8 (`quantize_rows`), an exact int8 x int8 ->
    int32 product (`int_mm`), then in the output dtype x row scale,
    x channel scale, + b;
  * `Int4Linear`: two matmuls over the input halves (the packed byte holds
    column i and i + in/2), summed in x's dtype, + b.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from regione_tpu_torch.ops.flash_attention import attention, attention_rows2
from regione_tpu_torch.ops.quant import unpack_int4


# ---------------------------------------------------------------------------
# parameter holders (names mirror the JAX param pytree)
# ---------------------------------------------------------------------------

def make_linear(d_in: int, d_out: int, device, dtype) -> nn.Linear:
    """An nn.Linear whose storage is left uninitialised: weights come from
    `weights.from_jax` or `weights.init_params`."""
    return nn.utils.skip_init(nn.Linear, d_in, d_out, device=device,
                              dtype=dtype)


class Scale(nn.Module):
    """RMSNorm scale ({"scale": [dim]})."""

    def __init__(self, dim: int, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))


class AffineNorm(nn.Module):
    """LayerNorm affine pair ({"scale": [dim], "bias": [dim]})."""

    def __init__(self, dim: int, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))

    def forward(self, x):
        return layernorm(x, scale=self.scale, bias=self.bias)


class MLP(nn.Module):
    """Two linears ({"in", "out"}); the caller applies the activation.
    JAX's "in" key is `in_` here."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, device, dtype):
        super().__init__()
        self.in_ = make_linear(d_in, d_hidden, device, dtype)
        self.out = make_linear(d_hidden, d_out, device, dtype)


def mlp_embed_module(d_in: int, d_hidden: int, device, dtype) -> MLP:
    """Time/vector embed MLP: d_in -> d_hidden -> d_hidden."""
    return MLP(d_in, d_hidden, d_hidden, device, dtype)


# ---------------------------------------------------------------------------
# quantized linears
# ---------------------------------------------------------------------------

# W8A8 switch, set per forward from MMDiTConfig.act_int8 (`MMDiT.forward`);
# thread-local, so a request prepared on another thread cannot change it
_ACT_INT8 = threading.local()


@contextlib.contextmanager
def act_int8(enabled: bool = True):
    prev = act_int8_active()
    _ACT_INT8.on = enabled
    try:
        yield
    finally:
        _ACT_INT8.on = prev


def act_int8_active() -> bool:
    return getattr(_ACT_INT8, "on", False)


def quantize_rows(x):
    """Dynamic per-row symmetric int8: x [..., K] -> (int8 [..., K], fp32
    row scales [..., 1])."""
    xf = x.float()
    s_a = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    x8 = torch.clamp(torch.round(xf / s_a), -127, 127).to(torch.int8)
    return x8, s_a


# torch._int_mm on a CUDA tensor takes more than 16 rows and K, N multiples
# of 8
_INT_MM_MIN_ROWS = 17


def int_mm(x8, w_q):
    """Exact int8 x int8 -> int32 product x8 [..., K] @ w_q[N, K]^T (cuBLAS
    on the card, PyTorch's CPU kernel on the CPU; never a float matmul,
    whose 24-bit mantissa a 3072-deep sum of int8 products exceeds).  On
    the card fewer than 17 rows are padded with zero rows (rows are
    independent, so the product's rows are unchanged)."""
    lead, k = x8.shape[:-1], x8.shape[-1]
    a = x8.reshape(-1, k)
    m = a.shape[0]
    if a.is_cuda:
        if k % 8 or w_q.shape[0] % 8:
            raise ValueError(f"int_mm on the card needs K and N multiples "
                             f"of 8, got K {k}, N {w_q.shape[0]}")
        if m < _INT_MM_MIN_ROWS:
            a = torch.cat([a, a.new_zeros(_INT_MM_MIN_ROWS - m, k)])
    return torch._int_mm(a, w_q.t())[:m].reshape(*lead, w_q.shape[0])


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


class Int8Linear(nn.Module):
    """An int8 linear ({"w_q": [out, in], "scale": [out, 1], "b"}, JAX's
    "w_q" / "scale" transposed)."""

    def __init__(self, w_q, scale, b):
        super().__init__()
        self.w_q, self.scale, self.bias = _frozen(w_q), _frozen(scale), \
            _frozen(b)

    def forward(self, x):
        if act_int8_active():
            return self.from_rows(*quantize_rows(x), x.dtype)
        w = (self.w_q.float() * self.scale).to(x.dtype)
        return F.linear(x, w) + self.bias

    def from_rows(self, x8, s_a, out_dtype):
        """W8A8 over pre-quantized rows (`quantize_rows`): the int32
        product cast to `out_dtype`, x row scale, x channel scale, + b."""
        out = int_mm(x8, self.w_q).to(out_dtype) * s_a.to(out_dtype)
        return out * self.scale.view(-1).to(out_dtype) + self.bias


class Int4Linear(nn.Module):
    """A nibble-packed int4 linear ({"w_qp": [out, in/2], "scale4":
    [out, G], "b"}, JAX's transposed)."""

    def __init__(self, w_qp, scale4, b):
        super().__init__()
        self.w_qp, self.scale4, self.bias = _frozen(w_qp), _frozen(scale4), \
            _frozen(b)

    def forward(self, x):
        d_out, half = self.w_qp.shape
        g2 = self.scale4.shape[1] // 2
        lo, hi = unpack_int4(self.w_qp)

        def dq(w4, sc):
            wg = w4.float().reshape(d_out, g2, half // g2) * sc[..., None]
            return wg.reshape(d_out, half).to(x.dtype)

        acc = (F.linear(x[..., :half], dq(lo, self.scale4[:, :g2]))
               + F.linear(x[..., half:], dq(hi, self.scale4[:, g2:])))
        return acc + self.bias


def project_rows(x, linears):
    """Several linears over one input (`row_projector`): under W8A8 with
    int8 weights x is quantized once and every projection reads that copy;
    otherwise each applies to x."""
    if act_int8_active() and isinstance(linears[0], Int8Linear):
        x8, s_a = quantize_rows(x)
        return [lin.from_rows(x8, s_a, x.dtype) for lin in linears]
    return [lin(x) for lin in linears]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None):
    """x @ weight.T + bias in x's dtype; weight is [out, in]."""
    return F.linear(x, weight, bias)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMS norm over the last dim in fp32, cast back."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x, eps: float = 1e-6, scale=None, bias=None):
    """LayerNorm in fp32, cast back; AdaLN uses the affine-free form."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def timestep_embedding(t, dim: int, max_period: float = 10000.0,
                       time_factor: float = 1000.0):
    """Sinusoidal embedding [cos ‖ sin] of t * 1000 (Flux convention; fp32)."""
    t = t.float() * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[..., None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp_embed(mod: MLP, x):
    """Two-layer SiLU MLP used for time/vector embeds."""
    return mod.out(F.silu(mod.in_(x)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_table(ids, axes_dims: Sequence[int], theta: float = 10000.0):
    """ids [S, A] -> (cos, sin), each [S, head_dim] fp32, frequencies
    interleave-repeated x2."""
    cos_parts, sin_parts = [], []
    for a, d in enumerate(axes_dims):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                              device=ids.device) * 2.0 / d))
        angles = ids[:, a].float()[:, None] * freqs[None]
        angles = torch.repeat_interleave(angles, 2, dim=-1)
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def _rotate_pairs(x):
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1)
    return rot.reshape(x.shape)


def apply_rope(x, rope):
    """x [B, H, S, D]; rope (cos, sin) each [S, D] (shared) or [B, S, D]
    (one table per batch row, broadcast over the heads).  fp32 rotation."""
    cos, sin = rope
    if cos.dim() == 3:
        cos, sin = cos[:, None], sin[:, None]
    xf = x.float()
    return (xf * cos + _rotate_pairs(xf) * sin).to(x.dtype)


def concat_rope(a, b):
    """Tables of [a's rows ‖ b's rows]; a shared [T, D] table `a` (text) is
    broadcast to the batch of a per-row [B, S, D] table `b` (image)."""
    def cat(x, y):
        if x.dim() < y.dim():
            x = x.expand(y.shape[0], -1, -1)
        return torch.cat([x, y], -2)
    return cat(a[0], b[0]), cat(a[1], b[1])


def gather_rope(rope, ids):
    """Rope rows by padded ids [K] -> [K, D], or per-row ids [B, K] ->
    [B, K, D]; ids >= S read zeros (the JAX `mode='fill'` gather) through a
    zero sink row appended at index S."""
    cos, sin = rope
    s = cos.shape[0]
    idx = torch.clamp(ids, max=s).long()
    zero = cos.new_zeros((1, cos.shape[1]))
    return torch.cat([cos, zero], 0)[idx], torch.cat([sin, zero], 0)[idx]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def split_heads(x, heads: int):
    """[B, S, H*d] -> [B, H, S, d] (a transposed view, no copy)."""
    b, s, hd = x.shape
    return x.view(b, s, heads, hd // heads).transpose(1, 2)


def _bias_row(bias):
    return None if bias is None else bias.reshape(bias.shape[0],
                                                  bias.shape[-1])


def sdpa(q, k, v, bias=None):
    """q [B, H, T, d], k/v [B, H, S, d], bias [B, 1, 1, S] or None
    -> [B, T, H*d] (kernel K1)."""
    return attention(q, k, v, _bias_row(bias))


def sdpa_cached(q, txt_kv, k_cache, v_cache, bias=None):
    """RAGS attention against the head-major cache [B, H, S, d], read in
    place: q over [fresh rows ‖ cache] in one softmax (kernel K2, or K2q for
    a quantized cache).
    txt_kv: (k, v) [B, H, T1, d] fresh rows, or None: q over the cache
        alone (kernel K1, or K6 for a quantized cache).
    k_cache/v_cache: [B, H, S, d], or (int8 rows, fp32 scales [B, H, S])
        when the cache is quantized; int4 rows hold S/2 packed rows
        (`ops.quant`), told by the row count.
    bias: [B, 1, 1, T1 + S] or None.
    On the CPU the wrappers dequantize, concatenate and attend (the JAX
    fallback); there is no VMEM gate on the card."""
    scales = {}
    if isinstance(k_cache, tuple):
        (k_cache, k_s), (v_cache, v_s) = k_cache, v_cache
        scales = dict(k_scale=k_s, v_scale=v_s)
    if txt_kv is None:
        return attention(q, k_cache, v_cache, _bias_row(bias), **scales)
    return attention_rows2(q, txt_kv[0], txt_kv[1], k_cache, v_cache,
                           _bias_row(bias), **scales)
