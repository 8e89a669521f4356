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

Tensor parallelism (`parallel.sharding.shard_params` puts a
`ShardedLinear` in place of each linear that the sharding rules split):
  * column-parallel: the rank's output features, as the unsharded layer
    computes them;
  * row-parallel: the rank's input features; the partial products are
    summed by an `all_reduce` over the tp group and the bias is added once,
    after it.  Under W8A8 the row amax is all-reduced (MAX) first, so the
    codes are the unsharded ones, and the exact int32 products are summed;
  * a modulation is column-parallel and all-gathers its small [B, n*h]
    output before it is chunked.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from regione_tpu_torch.models import kv_cache
from regione_tpu_torch.ops.flash_attention import attention, attention_rows2
from regione_tpu_torch.ops.quant import unpack_int4


# ---------------------------------------------------------------------------
# parameter holders (names mirror the JAX param pytree)
# ---------------------------------------------------------------------------

def make_linear(d_in: int, d_out: int, device, dtype,
                bias: bool = True) -> nn.Linear:
    """An nn.Linear whose storage is left uninitialised: weights come from
    `weights.from_jax` or `weights.init_params`.  `bias` False: no bias
    (FLUX.2's linears)."""
    return nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias,
                              device=device, dtype=dtype)


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
    JAX's "in" key is `in_` here.  `gated`: `in_` gives both halves of a
    gated activation, 2 x d_hidden wide (SwiGLU)."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, device, dtype,
                 bias: bool = True, gated: bool = False):
        super().__init__()
        self.in_ = make_linear(d_in, (2 if gated else 1) * d_hidden, device,
                               dtype, bias)
        self.out = make_linear(d_hidden, d_out, device, dtype, bias)


def mlp_embed_module(d_in: int, d_hidden: int, device, dtype,
                     bias: bool = True) -> MLP:
    """Time/vector embed MLP: d_in -> d_hidden -> d_hidden."""
    return MLP(d_in, d_hidden, d_hidden, device, dtype, bias)


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


def quantize_rows(x, tp: "TPGroup | None" = None):
    """Dynamic per-row symmetric int8: x [..., K] -> (int8 [..., K], fp32
    row scales [..., 1]).  With `tp`, x holds this rank's columns of the
    rows and the amax is all-reduced over the group, so the scales (and
    the codes) are those of the whole rows."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if tp is not None:
        tp.all_reduce(amax, dist.ReduceOp.MAX)
    s_a = amax / 127.0 + 1e-12
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


def int8_product(x, w_q, scale):
    """Weight-only int8: x @ (w_q * scale)^T in x's dtype, no bias."""
    return F.linear(x, (w_q.float() * scale).to(x.dtype))


def int8_epilogue(acc, s_a, scale, out_dtype):
    """W8A8: the int32 product cast to `out_dtype`, x row scale, x channel
    scale (no bias)."""
    out = acc.to(out_dtype) * s_a.to(out_dtype)
    return out * scale.view(-1).to(out_dtype)


def int4_product(x, w_qp, scale4):
    """Int4: two matmuls over the input halves (`Int4Linear`), each half's
    codes times its groups' scales, summed in x's dtype; no bias."""
    d_out, half = w_qp.shape
    g2 = scale4.shape[1] // 2
    lo, hi = unpack_int4(w_qp)

    def dq(w4, sc):
        wg = w4.float().reshape(d_out, g2, half // g2) * sc[..., None]
        return wg.reshape(d_out, half).to(x.dtype)

    return (F.linear(x[..., :half], dq(lo, scale4[:, :g2]))
            + F.linear(x[..., half:], dq(hi, scale4[:, g2:])))


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
        return int8_product(x, self.w_q, self.scale) + self.bias

    def from_rows(self, x8, s_a, out_dtype):
        """W8A8 over pre-quantized rows (`quantize_rows`): the int32
        product cast to `out_dtype`, x row scale, x channel scale, + b."""
        return int8_epilogue(int_mm(x8, self.w_q), s_a, self.scale,
                             out_dtype) + self.bias


class Int4Linear(nn.Module):
    """A nibble-packed int4 linear ({"w_qp": [out, in/2], "scale4":
    [out, G], "b"}, JAX's transposed)."""

    def __init__(self, w_qp, scale4, b):
        super().__init__()
        self.w_qp, self.scale4, self.bias = _frozen(w_qp), _frozen(scale4), \
            _frozen(b)

    def forward(self, x):
        return int4_product(x, self.w_qp, self.scale4) + self.bias


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPGroup:
    """This rank's tensor-parallel group: the process group, the rank's
    index in it and its size."""
    group: Any
    rank: int
    size: int

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """In place, and returned."""
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t):
        """The ranks' tensors concatenated along the last axis, in rank
        order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=-1)


def take(t, dim: int, ranges):
    """The index ranges [(lo, hi), ...] of `t` along `dim`, concatenated
    (a view for one range)."""
    parts = [t.narrow(dim, lo, hi - lo) for lo, hi in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


ROLE_COLUMN, ROLE_ROW, ROLE_GATHER = "column", "row", "gather"


@dataclasses.dataclass
class LinearShard:
    """How one linear splits on a tp rank (`parallel.sharding.shard_plan`).

    kind: "linear" (`nn.Linear`), "int8" or "int4" (the quantized linears).
    role: ROLE_COLUMN (output features split), ROLE_ROW (input features
        split: partial products all-reduced, then + bias) or ROLE_GATHER
        (a modulation: column-parallel, then all-gathered).
    specs: each leaf's partition spec in the port's layout.  The JAX rules
        leave some int4 weights whole (the connector's, int4 modulations):
        such a layer computes the whole product and keeps its output
        columns (`out_ranges`, for its split bias), or, row-parallel,
        gathers its input columns first.
    in_ranges: a row-parallel layer's input columns; `local_input` False
        when its input arrives whole (the connector's embedders), which
        the layer then slices itself.
    scale_groups: int4 row-parallel: the global scale group of each local
        group (`scale4` stays whole, as the JAX rules keep it).
    """
    kind: str
    role: str
    specs: dict
    out_ranges: list
    in_ranges: list
    local_input: bool = True
    scale_groups: list | None = None

    @property
    def split(self) -> bool:
        """The weight leaves are sliced."""
        return any("tp" in s for leaf, s in self.specs.items()
                   if leaf in ("weight", "w_q", "w_qp"))


class ShardedLinear(nn.Module):
    """One rank's shard of a linear on a tp group (`plan`), holding the
    leaves of the linear it replaces under their names ("weight" / "w_q" /
    "w_qp", "scale" / "scale4", "bias"): the rank's slices where the
    sharding rules split them, whole where they do not."""

    def __init__(self, plan: LinearShard, tensors: dict, tp: TPGroup):
        super().__init__()
        self.plan, self.kind, self.tp = plan, plan.kind, tp
        self._group_index = None
        for name, t in tensors.items():
            setattr(self, name, _frozen(t))

    def _scale4(self):
        """The int4 scales of this rank's groups."""
        g = self.plan.scale_groups
        if g is None:
            return self.scale4
        if g == list(range(g[0], g[0] + len(g))):
            return self.scale4[:, g[0]:g[0] + len(g)]
        if self._group_index is None or \
                self._group_index.device != self.scale4.device:
            self._group_index = torch.tensor(g, device=self.scale4.device)
        return self.scale4[:, self._group_index]

    def _product(self, x):
        """The layer's product over its leaves, no bias."""
        if self.kind == "linear":
            return F.linear(x, self.weight)
        if self.kind == "int8":
            if act_int8_active():
                x8, s_a = quantize_rows(x)
                return int8_epilogue(int_mm(x8, self.w_q), s_a, self.scale,
                                     x.dtype)
            return int8_product(x, self.w_q, self.scale)
        return int4_product(x, self.w_qp, self._scale4())

    def _full(self, x):
        """The unsharded layer's forward over its leaves."""
        if self.kind == "linear":
            return F.linear(x, self.weight, self.bias)
        return self._product(x) + self.bias

    def forward(self, x):
        tp, plan = self.tp, self.plan
        if plan.role == ROLE_ROW:
            if not plan.split:
                return self._full(tp.all_gather(x) if plan.local_input
                                  else x)
            if not plan.local_input:
                x = take(x, -1, plan.in_ranges)
            if self.kind == "int8" and act_int8_active():
                x8, s_a = quantize_rows(x, tp)
                acc = tp.all_reduce(int_mm(x8, self.w_q))
                return int8_epilogue(acc, s_a, self.scale, x.dtype) + \
                    self.bias
            return tp.all_reduce(self._product(x)) + self.bias
        if plan.split:
            y = self._full(x)
        else:
            y = take(self._product(x), -1, plan.out_ranges) + self.bias
        return tp.all_gather(y) if plan.role == ROLE_GATHER else y

    def from_rows(self, x8, s_a, out_dtype):
        """Column-parallel W8A8 over rows quantized once for several
        projections (`project_rows`)."""
        return int8_epilogue(int_mm(x8, self.w_q), s_a, self.scale,
                             out_dtype) + self.bias


def _is_int8(lin) -> bool:
    return isinstance(lin, Int8Linear) or (
        isinstance(lin, ShardedLinear) and lin.kind == "int8"
        and lin.plan.role == ROLE_COLUMN)


def project_rows(x, linears):
    """Several linears over one input (`row_projector`): under W8A8 with
    int8 weights x is quantized once and every projection reads that copy;
    otherwise each applies to x."""
    if act_int8_active() and _is_int8(linears[0]):
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
    k_cache/v_cache: a layer's entries (`kv_cache.layer_kv`): [B, H, S, d],
        or (int8 rows, fp32 scales [B, H, S]) when quantized (int4: S/2
        packed rows).
    bias: [B, 1, 1, T1 + S] or None.
    On the CPU the wrappers dequantize, concatenate and attend (the JAX
    fallback); there is no VMEM gate on the card."""
    k, v, scales = kv_cache.attention_args(k_cache, v_cache)
    if txt_kv is None:
        return attention(q, k, v, _bias_row(bias), **scales)
    return attention_rows2(q, *txt_kv, k, v, _bias_row(bias), **scales)
