"""The port's quantized KV-cache formats against `regione_tpu.ops.quant`.

Same numpy inputs through both, on the CPU.  The int8 / int4 codes may
differ by one step where x / scale lies within an fp32 ulp of .5 (the two
frameworks may round the quotient's last bit apart): at most one step on at
most 0.1% of the codes.  Scales agree to 1e-7 relative, the nibble packing
and the dequantization of the same codes bit for bit, so a cache the JAX
package quantized reads back the same in the port.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.ops import quant as jq
from regione_tpu_torch.ops import quant as tq

MAX_FLIPS = 1e-3          # share of codes allowed one step apart


def _rows(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.uniform(0.05, 20.0, shape[:-1] + (1,))).astype(np.float32)
    if dtype == "bfloat16":       # values a bf16 cache row really holds
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _to_torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _code_flips(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    n = int((diff > 0).sum())
    assert diff.max(initial=0) <= 1, diff.max()
    assert n <= MAX_FLIPS * diff.size, f"{n} of {diff.size} codes differ"
    return n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_heads_matches_jax(bits, dtype):
    x = _rows((2, 3, 64, 128), 0, dtype)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jfn, tfn = ((jq.quantize_kv_heads, tq.quantize_kv_heads) if bits == 8
                else (jq.quantize_kv_heads4, tq.quantize_kv_heads4))
    jcodes, jscale = (np.asarray(a) for a in jfn(jx))
    tcodes, tscale = tfn(_to_torch(x, dtype))
    assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
    assert tcodes.shape == jcodes.shape and tscale.shape == jscale.shape
    np.testing.assert_allclose(tscale.numpy(), jscale, rtol=1e-7, atol=0)
    if bits == 8:
        _code_flips(tcodes.numpy(), jcodes)
    else:
        # compare the unpacked nibbles: a flipped code changes one nibble
        for g, w in zip(tq.unpack_int4(tcodes), jq.unpack_int4(jcodes)):
            _code_flips(g.numpy(), np.asarray(w))


def test_pack_unpack_int4_bit_equal():
    rng = np.random.default_rng(1)
    lo = rng.integers(-8, 8, (5, 33)).astype(np.int8)
    hi = rng.integers(-8, 8, (5, 33)).astype(np.int8)
    want = np.asarray(jq.pack_int4(jnp.asarray(lo), jnp.asarray(hi)))
    got = tq.pack_int4(torch.from_numpy(lo), torch.from_numpy(hi))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    everything = np.arange(-128, 128, dtype=np.int8)
    for g, w in zip(tq.unpack_int4(torch.from_numpy(everything)),
                    jq.unpack_int4(jnp.asarray(everything))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tq.unpack_int4(got)[0].numpy(), lo)
    np.testing.assert_array_equal(tq.unpack_int4(got)[1].numpy(), hi)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_jax_quantized_cache_reads_back_the_same(bits, dtype):
    """JAX codes and scales, dequantized by both: equal bit for bit."""
    x = _rows((2, 2, 48, 128), 2, "float32")
    jfn, jdeq, tdeq = ((jq.quantize_kv_heads, jq.dequantize_kv_heads,
                        tq.dequantize_kv_heads) if bits == 8 else
                       (jq.quantize_kv_heads4, jq.dequantize_kv_heads4,
                        tq.dequantize_kv_heads4))
    codes, scale = jfn(jnp.asarray(x))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jdeq(codes, scale, jdt).astype(jnp.float32))
    tc = torch.from_numpy(np.array(codes))
    ts = torch.from_numpy(np.array(scale))
    got = tdeq(tc, ts, tdt)
    assert got.shape == (2, 2, 48, 128) and got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        tq.dequantize_cache(tc, ts, tdt).float().numpy(), want)


def test_int4_needs_an_even_row_count():
    with pytest.raises(ValueError, match="even row count"):
        tq.quantize_kv_heads4(torch.zeros((1, 1, 5, 8)))


def test_round_trip_error_bounds():
    """Symmetric quantization: |x - deq(q(x))| <= scale / 2 per element."""
    x = torch.from_numpy(_rows((2, 3, 32, 64), 3, "float32"))
    amax = x.abs().amax(-1, keepdim=True)
    for fn, deq, qmax in ((tq.quantize_kv_heads, tq.dequantize_kv_heads, 127),
                          (tq.quantize_kv_heads4, tq.dequantize_kv_heads4,
                           7)):
        back = deq(*fn(x), torch.float32)
        assert ((back - x).abs() <= amax / (2 * qmax) * (1 + 1e-5)).all()
