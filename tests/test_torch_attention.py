"""The port's attention (K1, K2) against the JAX package's.

On the CPU the port's wrappers take their plain versions
(`attention_reference`, `attention_rows2_reference`); these are held against
the Pallas kernels in interpret mode (`flash_attention`,
`flash_attention_rows2`, run as tests/test_flash_attention.py and
tests/test_rows_attention.py run them) and against `layers.sdpa`'s math
path, at D = 128 and small T/S, in fp32.  Tolerance 2e-5: fp32 softmax and
matmuls in another order (the JAX package's own kernel-vs-sdpa bound).
The CUDA kernel itself is checked against the same plain versions by the
`cuda`-marked test, which runs only where a card is present.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.models.layers import sdpa as j_sdpa
from regione_tpu.ops import flash_attention as jfa
from regione_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(cuda_device):
    """K1 and K2 on the card against their plain versions (bf16; the bound
    chip_smoke.py states: 2e-2 of the output's scale)."""
    rng = np.random.default_rng(0)

    def heads(t):
        x = torch.from_numpy(rng.standard_normal((B, t, H * D), np.float32))
        return x.to(cuda_device, torch.bfloat16).view(B, t, H, D).transpose(
            1, 2)

    q, k, v, kc, vc = heads(70), heads(150), heads(150), heads(256), \
        heads(256)
    bias = torch.from_numpy(_bias(B, 150 + 256, 1)).to(cuda_device)
    for got, want in (
            (fa.attention(q, k, v, bias[:, :150].contiguous()),
             fa.attention_reference(q, k, v, bias[:, :150])),
            (fa.attention_rows2(q, k, v, kc, vc, bias),
             fa.attention_rows2_reference(q, k, v, kc, vc, bias))):
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max()
