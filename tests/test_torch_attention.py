"""The port's attention (K1/K5, K2, K2q, K6) against the JAX package's.

On the CPU the port's wrappers take their plain versions (`*_reference`);
these are held against the Pallas kernels in interpret mode
(`flash_attention`, `flash_attention_rows2`, run as
tests/test_flash_attention.py, tests/test_rows_attention.py and
tests/test_cache_int4.py run them) and against `layers.sdpa`'s math path,
at D = 128 and small T/S, in fp32.  Tolerance 2e-5: fp32 softmax and
matmuls in another order (the JAX package's own kernel-vs-sdpa bound).

The quantized caches (K2q, K6) are quantized by the JAX package.  The
Pallas kernels for them dequantize into a bf16 scratch and so cast P to
bf16 whatever q's dtype: against them the bound is the JAX package's own
for these kernels, 2e-2 (tests/test_cache_int8.py, test_cache_int4.py).
Against the JAX math path they stand for (`layers.sdpa_cached` on the CPU:
dequantize, concatenate, `sdpa`) the bound is 2e-5.
K5 is `flash_attention(block_q=1024)` at
S = 2048, past the resident budget, so the JAX side runs `_flash_kernel`.
The CUDA kernels themselves are checked against the same plain versions
by the `cuda`-marked tests, which run only where a card is present: every
storage mode goes to the one Hopper kernel (`regione_attention_tma_fwd`,
TMA + wgmma; a quantized cache dequantized by its producer warps).  On the
CPU a fake library records which C entry each wrapper calls and with
what.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.models.layers import sdpa as j_sdpa
from regione_tpu.models.layers import sdpa_cached as j_sdpa_cached
from regione_tpu.ops import flash_attention as jfa
from regione_tpu.ops import quant as jq
from regione_tpu_torch.ops import flash_attention as fa
from regione_tpu_torch.ops import quant as tq
from torch_cpu import fake_lib  # noqa: F401 (fixture)

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_QKERNEL = dict(rtol=2e-2, atol=2e-2)
B, H, D = 2, 2, 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bias(b, s, seed):
    rng = np.random.default_rng(seed)
    bias = np.where(rng.random((b, s)) < 0.15, -1e9, 0.0).astype(np.float32)
    bias[:, -3:] = -1e30
    return bias


@pytest.mark.parametrize("t,s,with_bias", [(40, 72, False), (40, 72, True),
                                           (8, 256, True)])
def test_attention_reference_matches_jax(t, s, with_bias):
    q, k, v = _rand((B, H, t, D), 0), _rand((B, H, s, D), 1), \
        _rand((B, H, s, D), 2)
    bias = _bias(B, s, 3) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    want_kernel = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jb, interpret=True)
    want_math = j_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       None if jb is None else jb[:, None, None, :])
    tb = None if bias is None else torch.from_numpy(bias)
    got = fa.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), tb)
    assert got.shape == (B, t, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_math), **TOL)


@pytest.mark.parametrize("t,with_bias", [(48, False), (48, True), (13, True)])
def test_attention_rows2_reference_matches_jax(t, with_bias):
    t1, s = 40, 256
    q = _rand((B, H, t, D), 4)
    kt, vt = _rand((B, H, t1, D), 5), _rand((B, H, t1, D), 6)
    kc, vc = _rand((B, H, s, D), 7), _rand((B, H, s, D), 8)
    bias = _bias(B, t1 + s, 9) if with_bias else None
    want = jfa.flash_attention_rows2(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(kc),
        jnp.asarray(vc), None if bias is None else jnp.asarray(bias),
        interpret=True)
    got = fa.attention_rows2(
        *(torch.from_numpy(a) for a in (q, kt, vt, kc, vc)),
        None if bias is None else torch.from_numpy(bias))
    assert got.shape == (B, t, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _quant_cache(s, seed, bits):
    """Cache rows [B, H, S, D] quantized by the JAX package: (codes, fp32
    scales [B, H, S]) as numpy."""
    x = _rand((B, H, s, D), seed)
    quant = jq.quantize_kv_heads if bits == 8 else jq.quantize_kv_heads4
    return tuple(np.array(a) for a in quant(jnp.asarray(x, jnp.float32)))


def _jax_and_port(q, fresh, kc, vc, bias, kernel):
    """(JAX interpret-mode kernel, JAX math path, port) outputs as numpy."""
    jfresh = None if fresh is None else tuple(map(jnp.asarray, fresh))
    jb = None if bias is None else jnp.asarray(bias)
    jk = tuple(map(jnp.asarray, kc))
    jv = tuple(map(jnp.asarray, vc))
    want_kernel = kernel(jnp.asarray(q), jfresh, jk, jv, jb)
    want_math = j_sdpa_cached(jnp.asarray(q), jfresh, jk, jv,
                              None if jb is None else jb[:, None, None, :])
    tb = None if bias is None else torch.from_numpy(bias)
    tk = tuple(map(torch.from_numpy, kc))
    tv = tuple(map(torch.from_numpy, vc))
    if fresh is None:
        got = fa.attention(torch.from_numpy(q), tk[0], tv[0], tb,
                           k_scale=tk[1], v_scale=tv[1])
    else:
        got = fa.attention_rows2(torch.from_numpy(q),
                                 *map(torch.from_numpy, fresh), tk[0], tv[0],
                                 tb, k_scale=tk[1], v_scale=tv[1])
    return np.asarray(want_kernel), np.asarray(want_math), got.numpy()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("t1,with_bias", [(40, False), (40, True), (13, True)])
def test_attention_rows2_quant_reference_matches_jax(bits, t1, with_bias):
    """K2q: fresh rows (T1 unaligned to the JAX tile at 13) over an int8 or
    int4 cache of 256 rows."""
    t, s = 24, 256
    q = _rand((B, H, t, D), 20)
    fresh = (_rand((B, H, t1, D), 21), _rand((B, H, t1, D), 22))
    bias = _bias(B, t1 + s, 25) if with_bias else None

    def kernel(q, fresh, k, v, bias):
        return jfa.flash_attention_rows2(q, *fresh, k[0], v[0], bias,
                                         k_scale=k[1], v_scale=v[1],
                                         interpret=True)

    want_kernel, want_math, got = _jax_and_port(
        q, fresh, _quant_cache(s, 23, bits), _quant_cache(s, 24, bits), bias,
        kernel)
    assert got.shape == (B, t, H * D)
    np.testing.assert_allclose(got, want_math, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL_QKERNEL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("s,with_bias", [(256, False), (256, True),
                                         (200, True)])
def test_attention_quant_reference_matches_jax(bits, s, with_bias):
    """K6: q over a quantized K/V alone (`flash_attention(k_scale=...)`);
    S = 200 is padded by the JAX wrapper (int8) or dequantized up front
    (int4, S % 256 != 0)."""
    t = 40
    q = _rand((B, H, t, D), 30)
    bias = _bias(B, s, 33) if with_bias else None

    def kernel(q, fresh, k, v, bias):
        return jfa.flash_attention(q, k[0], v[0], bias, k_scale=k[1],
                                   v_scale=v[1], interpret=True)

    want_kernel, want_math, got = _jax_and_port(
        q, None, _quant_cache(s, 31, bits), _quant_cache(s, 32, bits), bias,
        kernel)
    assert got.shape == (B, t, H * D)
    np.testing.assert_allclose(got, want_math, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL_QKERNEL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_past_the_resident_budget_matches_jax(with_bias):
    """K5: at block_q 1024 and S = 2048 the logits row is past the resident
    budget, so `flash_attention` runs the online-softmax `_flash_kernel`."""
    b, h, t, s = 1, 1, 1024, 2048
    assert 4 * 1024 * s > jfa._RESIDENT_LOGITS_BUDGET
    q, k, v = _rand((b, h, t, D), 40), _rand((b, h, s, D), 41), \
        _rand((b, h, s, D), 42)
    bias = _bias(b, s, 43) if with_bias else None
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), block_q=1024,
        block_k=512, interpret=True)
    got = fa.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v),
                       None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_launch_refuses_what_the_kernel_does_not_take():
    """The kernel path checks dtype, head dim, shapes and the bias before it
    builds or launches anything."""
    q = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D = 128"):
        fa._launch(q[..., :64], q[..., :64], q[..., :64], None, None, None)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._launch(q.float(), q.float(), q.float(), None, None, None)
    with pytest.raises(ValueError, match="shape"):
        fa._launch(q, q[:, :1], q[:, :1], None, None, None)
    with pytest.raises(ValueError, match="bias"):
        fa._launch(q, q, q, None, None, torch.zeros((1, 9)))
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.zeros((1, 2, 9 * 128 + 1), dtype=torch.bfloat16)
        fa._launch(q, q, odd[..., 1:].view(1, 2, 9, 128), None, None, None)


def test_quant_launch_refuses_what_the_kernel_does_not_take():
    """The quantized segment: int8 rows, fp32 [B, H, S] scales with dense
    rows, and a row count that is S (int8) or S / 2 (int4, S even)."""
    q = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16)
    rows = torch.zeros((1, 2, 6, 128), dtype=torch.int8)
    sc = torch.ones((1, 2, 12))
    with pytest.raises(TypeError, match="int8"):
        fa._launch(q, q, q, rows.float(), rows.float(), None, sc, sc)
    with pytest.raises(ValueError, match="fp32"):
        fa._launch(q, q, q, rows, rows, None, sc[:, :1], sc[:, :1])
    with pytest.raises(ValueError, match="fp32"):
        fa._launch(q, q, q, rows, rows, None, sc.double(), sc.double())
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.ones((1, 2, 24))
        fa._launch(q, q, q, rows, rows, None, wide[..., ::2], wide[..., ::2])
    with pytest.raises(ValueError, match="S even"):
        fa._launch(q, q, q, rows, rows, None, sc[..., :11], sc[..., :11])
    with pytest.raises(ValueError, match="v_scale"):
        fa._launch(q, None, None, rows, rows, None, sc, None)
    with pytest.raises(ValueError, match="bias"):
        fa._launch(q, q, q, rows, rows, torch.zeros((1, 14)), sc, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,with_bias", [(70, 150, True), (13, 128, False),
                                           (128, 384, True),
                                           (193, 256, False)])
def test_kernel_matches_plain_on_the_card(cuda_device, t, s, with_bias):
    """K1 over S keys and K2 over S + 256 on the card against their plain
    versions (bf16; the bound chip_smoke.py states: 2e-2 of the output's
    scale).  Walks of 1 to 5 key tiles; T = 13 leaves the second consumer
    warpgroup every row past T, T = 128 none, T = 193 one."""
    rng = np.random.default_rng(t + s)

    def heads(t):
        x = torch.from_numpy(rng.standard_normal((B, t, H * D), np.float32))
        return x.to(cuda_device, torch.bfloat16).view(B, t, H, D).transpose(
            1, 2)

    q, k, v, kc, vc = heads(t), heads(s), heads(s), heads(256), heads(256)
    bias = torch.from_numpy(_bias(B, s + 256, 1)).to(cuda_device) \
        if with_bias else None
    b1 = bias[:, :s].contiguous() if with_bias else None
    for got, want in (
            (fa.attention(q, k, v, b1), fa.attention_reference(q, k, v, b1)),
            (fa.attention_rows2(q, k, v, kc, vc, bias),
             fa.attention_rows2_reference(q, k, v, kc, vc, bias))):
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max()


def _card_heads(rng, t, device):
    x = torch.from_numpy(rng.standard_normal((B, t, H * D), np.float32))
    return x.to(device, torch.bfloat16).view(B, t, H, D).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_kernels_match_plain_on_the_card(cuda_device, bits):
    """K2q (a fresh segment of 70 rows, so tiles straddle both segments and,
    under int4, the S/2 seam) and K6 against their plain versions."""
    rng = np.random.default_rng(1)
    q, kt, vt = (_card_heads(rng, t, cuda_device) for t in (70, 70, 70))
    quant = tq.quantize_kv_heads if bits == 8 else tq.quantize_kv_heads4
    kc, ks = quant(_card_heads(rng, 200, cuda_device))
    vc, vs = quant(_card_heads(rng, 200, cuda_device))
    bias = torch.from_numpy(_bias(B, 70 + 200, 2)).to(cuda_device)
    for got, want in (
            (fa.attention_rows2(q, kt, vt, kc, vc, bias, k_scale=ks,
                                v_scale=vs),
             fa.attention_rows2_quant_reference(q, kt, vt, kc, vc, ks, vs,
                                                bias)),
            (fa.attention(q, kc, vc, bias[:, 70:].contiguous(), k_scale=ks,
                          v_scale=vs),
             fa.attention_quant_reference(q, kc, vc, ks, vs,
                                          bias[:, 70:]))):
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max()


@pytest.mark.cuda
def test_long_s_matches_plain_on_the_card(cuda_device):
    """K5: the K1 kernel past the resident budget (S = 12,416)."""
    rng = np.random.default_rng(2)
    q = _card_heads(rng, 64, cuda_device)
    k, v = (_card_heads(rng, 12416, cuda_device) for _ in range(2))
    before = fa.attention.long_launches
    got = fa.attention(q, k, v)
    assert fa.attention.long_launches == before + 1
    want = fa.attention_reference(q, k, v)
    err = (got.float() - want.float()).abs().max()
    assert err <= 2e-2 * want.float().abs().max()


def _bf16_heads(b, t, h=H):
    """A head-split [B, H, T, D] view of a [B, T, H*D] bf16 tensor."""
    x = torch.zeros((b, t, h * D), dtype=torch.bfloat16)
    return x.view(b, t, h, D).transpose(1, 2)


# positions in the C argument list (csrc/attention*.cu)
_STRIDES, _B, _H, _T, _S1, _S2, _MODE = 9, 10, 11, 12, 13, 14, 15


@pytest.mark.parametrize("b", [1, 2])
def test_bf16_goes_to_the_hopper_kernel(fake_lib, b):
    """K1/K5 and K2 with bf16 K/V call `regione_attention_tma_fwd`, with
    the head-split view's strides (a size-1 dim's stride as 0) and the
    segment lengths; the launch counters count them as before."""
    fa.reset_launches()
    q, k = _bf16_heads(b, 70), _bf16_heads(b, 131)
    kc = torch.zeros((b, H, 200, D), dtype=torch.bfloat16)
    fa.attention(q, k, k, torch.zeros((b, 131)))
    fa.attention_rows2(q, k, k, kc, kc)
    fa.attention_rows2(q, k[:, :, :0], k[:, :, :0], kc, kc)
    names = [name for name, _ in fake_lib.calls]
    assert names == ["regione_attention_tma_fwd"] * 3
    (_, a1), (_, a2), (_, a3) = fake_lib.calls
    assert [a1[i] for i in (_B, _H, _T, _S1, _S2, _MODE)] == [b, H, 70, 131,
                                                              0, 0]
    assert (a2[_S1], a2[_S2], a3[_S1], a3[_S2]) == (131, 200, 0, 200)
    b_stride = 0 if b == 1 else 70 * H * D
    assert list(a1[_STRIDES])[:3] == [b_stride, D, H * D]
    assert list(a2[_STRIDES])[9:12] == [0 if b == 1 else H * 200 * D,
                                        200 * D, D]
    assert (fa.attention.launches, fa.attention_rows2.launches) == (1, 2)


@pytest.mark.parametrize("quant", [tq.quantize_kv_heads,
                                   tq.quantize_kv_heads4])
def test_quantized_cache_goes_to_the_dequantizing_kernel(fake_lib, quant):
    """K2q and K6 (int8 or int4 cache) call `regione_attention_tma_fwd`
    with mode2 1 / 2, the logical S2 (the scales' count, twice the packed
    int4 rows), the codes' strides in bytes and the scales' (b, h)
    strides."""
    fa.reset_launches()
    q = _bf16_heads(2, 40)
    rows, sc = quant(torch.zeros((2, H, 64, D)))
    fa.attention_rows2(q, q, q, rows, rows, k_scale=sc, v_scale=sc)
    fa.attention(q, rows, rows, k_scale=sc, v_scale=sc)
    mode = fa.MODE_INT8 if rows.shape[2] == 64 else fa.MODE_INT4
    assert [(name, args[_S1], args[_S2], args[_MODE])
            for name, args in fake_lib.calls] == [
        ("regione_attention_tma_fwd", 40, 64, mode),
        ("regione_attention_tma_fwd", 0, 64, mode)]
    n = rows.shape[2]
    for _, args in fake_lib.calls:
        st = list(args[_STRIDES])
        assert st[9:15] == [H * n * D, n * D, D] * 2
        assert st[15:] == [H * 64, 64, H * 64, 64]
        assert args[5] is not None and args[6] is not None
    assert (fa.attention_rows2_quant.launches,
            fa.attention_quant.launches) == (1, 1)


def test_refused_arguments_raise_before_any_launch(fake_lib):
    """A wrong dtype, a misaligned row or a bias of the wrong shape raises
    in the wrapper: no C entry is called."""
    q = _bf16_heads(1, 8)
    odd = torch.zeros((1, 2, 9 * 128 + 1), dtype=torch.bfloat16)
    mis = odd[..., 1:].view(1, 2, 9, 128)
    for call in (lambda: fa.attention(q.float(), q.float(), q.float()),
                 lambda: fa.attention(q, mis, mis),
                 lambda: fa.attention_rows2(q, q, q, mis, mis),
                 lambda: fa.attention(q, q, q, torch.zeros((1, 9))),
                 lambda: fa.attention_rows2(q, q, q, q.half(), q.half())):
        with pytest.raises((TypeError, ValueError)):
            call()
    assert fake_lib.calls == []


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("t,s1,s2,with_bias", [
    (267, 5, 0, True), (267, 131, 0, True), (267, 0, 200, True),
    (267, 5, 200, True), (267, 131, 200, True),
    (13, 128, 0, False), (192, 256, 0, True), (193, 300, 0, False),
    (256, 300, 200, True), (13, 5, 200, False)])
def test_hopper_kernel_matches_plain_on_the_card(cuda_device, b, t, s1, s2,
                                                 with_bias):
    """`regione_attention_tma_fwd` against its plain versions: ragged T
    (267: two full 128-row blocks and a partial one; 13 and 192: the last
    block's second consumer warpgroup has every row past T; 193: one row;
    256: none), S1 and S2 off the 128-key tile, walks of 1, 2, 3 and 5
    tiles (the three-stage ring wraps), the segment seam at tile 1, 2 or 3,
    with a bias (a whole key tile masked at -1e30, pad columns at -1e9) and
    without, head-split q/k/v views.  Tolerance 2e-2 of the output's scale
    (the bound chip_smoke.py states: bf16 output, P rounded to bf16 before
    normalisation in the kernel, after it in the plain version)."""
    rng = np.random.default_rng(10 * s1 + s2 + b + 1000 * t)

    def heads(rows):
        x = torch.from_numpy(rng.standard_normal((b, rows, H * D),
                                                 np.float32))
        return x.to(cuda_device, torch.bfloat16).view(b, rows, H, D) \
            .transpose(1, 2)

    q, k1, v1, k2, v2 = heads(t), heads(s1), heads(s1), heads(s2), heads(s2)
    bias = None
    if with_bias:
        bias = _bias(b, s1 + s2, 3)
        lo, hi = (s1, s1 + 128) if s2 else (0, min(s1, 128))
        bias[:, lo:hi] = -1e30      # a whole tile (at S1 = 5: every key)
        bias = torch.from_numpy(bias).to(cuda_device)
    if s2 == 0:
        got = fa.attention(q, k1, v1, bias)
        want = fa.attention_reference(q, k1, v1, bias)
    else:
        got = fa.attention_rows2(q, k1, v1, k2, v2, bias)
        want = fa.attention_rows2_reference(q, k1, v1, k2, v2, bias)
    assert got.shape == (b, t, H * D) and bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max()
    assert err <= 2e-2 * want.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("t,s1,s2,with_bias", [
    (267, 0, 2176, True), (267, 131, 2176, True), (267, 131, 200, True),
    (267, 0, 258, True), (267, 128, 8064, True),
    (13, 0, 128, False), (192, 128, 256, True), (256, 0, 384, False),
    (193, 5, 200, True)])
def test_hopper_quant_kernel_matches_plain_on_the_card(cuda_device, bits, b,
                                                       t, s1, s2, with_bias):
    """K2q (S1 > 0) and K6 (S1 = 0) on the Hopper kernel against their
    plain versions: S1 off the 128-key tile, S2 / 2 off it too (int4 at
    S2 2176: each nibble half ends mid-tile), walks of 1 to 4 quantized
    tiles and the seam at tile 1 or 2, T ragged (267; 13 and 192 leave the
    last block's second consumer warpgroup every row past T, 193 one row,
    256 none), with a bias (the cache's first key tile whole at -1e30, pad
    columns at -1e9) and without, head-split q and fresh K/V views, B 1
    and 2.  Tolerance 2e-2 of the output's scale (the bound chip_smoke.py
    states)."""
    rng = np.random.default_rng(100 * bits + 10 * b + s1 + s2 + 1000 * t)

    def heads(rows):
        x = torch.from_numpy(rng.standard_normal((b, rows, H * D),
                                                 np.float32))
        return x.to(cuda_device, torch.bfloat16).view(b, rows, H, D) \
            .transpose(1, 2)

    quant = tq.quantize_kv_heads if bits == 8 else tq.quantize_kv_heads4
    q, k1, v1 = heads(t), heads(s1), heads(s1)
    kc, ks = quant(heads(s2))
    vc, vs = quant(heads(s2))
    bias = None
    if with_bias:
        bias = _bias(b, s1 + s2, 4)
        # the cache's first key tile, whole (at S1 = 0 the first of all)
        bias[:, s1:s1 + min(128, s2 // 2 if bits == 4 else s2)] = -1e30
        bias = torch.from_numpy(bias).to(cuda_device)
    if s1 == 0:
        got = fa.attention(q, kc, vc, bias, k_scale=ks, v_scale=vs)
        want = fa.attention_quant_reference(q, kc, vc, ks, vs, bias)
    else:
        got = fa.attention_rows2(q, k1, v1, kc, vc, bias, k_scale=ks,
                                 v_scale=vs)
        want = fa.attention_rows2_quant_reference(q, k1, v1, kc, vc, ks, vs,
                                                  bias)
    assert got.shape == (b, t, H * D) and bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max()
    assert err <= 2e-2 * want.float().abs().max()
