"""The port's partition (K3) and masking against the JAX package's.

`partition_reference` (the plain version the port's `fused_partition` takes
on the CPU) is held bit-equal to the Pallas kernel `fused_partition` in
interpret mode, as tests/test_partition_kernel.py runs it, with and without
morphology.  `select_edited_mask` is held against the JAX one (its XLA path
on the CPU, which normalises before the dot) with inputs kept at least 1e-4
away from the threshold, so the two cosine formulas cannot flip a token.
Masks compare exactly; similarities to 1e-5 (fp32 reductions in another
order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from regione_tpu.core import masking as jmask
from regione_tpu.core import partition as jpart
from regione_tpu.ops.partition_kernel import fused_partition as j_fused
from regione_tpu_torch.core import masking as tmask
from regione_tpu_torch.core import partition as tpart
from regione_tpu_torch.ops import partition_kernel as pk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _pair(s, d, seed, noise=0.3):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((s, d)).astype(np.float32)
    cond = x0 + noise * rng.standard_normal((s, d)).astype(np.float32)
    cond[: s // 3] = rng.standard_normal((s // 3, d)).astype(np.float32)
    return x0, cond


def _cos64(x0, cond):
    x, c = x0.astype(np.float64), cond.astype(np.float64)
    return (x * c).sum(-1) / np.sqrt((x * x).sum(-1) * (c * c).sum(-1))


def _keep_away(x0, cond, threshold):
    """cond with each token whose cosine lies within 1e-4 of the threshold
    set equal to x0 (cosine 1)."""
    near = np.abs(_cos64(x0, cond) - threshold) <= 1e-4
    cond = cond.copy()
    cond[near] = x0[near]
    return cond


def _hw(grid):
    return grid if isinstance(grid, tuple) else (grid, grid)


@pytest.mark.parametrize("erosion_dilation", [False, True])
@pytest.mark.parametrize("grid,d", [(16, 64), (12, 16),
                                    pytest.param((24, 40), 64, id="24x40-64")])
def test_partition_reference_equals_pallas_kernel(erosion_dilation, grid, d):
    gh, gw = _hw(grid)
    x0, cond = _pair(gh * gw, d, 0)
    want = np.asarray(j_fused(jnp.asarray(x0), jnp.asarray(cond), 0.9, gh,
                              gw, erosion_dilation, interpret=True))
    got = pk.fused_partition(torch.from_numpy(x0), torch.from_numpy(cond),
                             0.9, gh, gw, erosion_dilation)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < gh * gw


@pytest.mark.parametrize("kind", ["cosine", "dot", "euclidean", "mse",
                                  "diff_std"])
def test_token_similarity_matches_jax(kind):
    x0, cond = _pair(64, 16, 1)
    want = jpart.token_similarity(jnp.asarray(x0[None]),
                                  jnp.asarray(cond[None]), kind)
    got = tpart.token_similarity(torch.from_numpy(x0[None]),
                                 torch.from_numpy(cond[None]), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind,threshold,grid", [
    pytest.param("cosine", 0.9, 16, id="cosine-0.9"),
    pytest.param("dot", 40.0, 16, id="dot-40.0"),
    # past the 24,576 tokens the kernel once held in one CTA
    pytest.param("cosine", 0.9, 160, id="cosine-0.9-160x160"),
    pytest.param("cosine", 0.9, (37, 53), id="cosine-0.9-37x53")])
@pytest.mark.parametrize("erosion_dilation", [False, True])
def test_select_edited_mask_matches_jax(kind, threshold, grid,
                                        erosion_dilation):
    gh, gw = _hw(grid)
    x0, cond = _pair(gh * gw, 64, 2)
    if kind == "cosine":
        cond = _keep_away(x0, cond, threshold)
    sim = _cos64(x0, cond) if kind == "cosine" else \
        (x0.astype(np.float64) * cond).sum(-1)
    assert np.abs(sim - threshold).min() > 1e-4, "inputs too near threshold"
    kw = dict(grid_h=gh, grid_w=gw, erosion_dilation=erosion_dilation,
              similarity_type=kind)
    want = np.asarray(jpart.select_edited_mask(
        jnp.asarray(x0[None]), jnp.asarray(cond[None]), threshold, **kw))
    got = tpart.select_edited_mask(torch.from_numpy(x0[None]),
                                   torch.from_numpy(cond[None]), threshold,
                                   **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < gh * gw


def test_morphology_matches_jax():
    """The port's shifted min/max morphology equals JAX's conv form."""
    rng = np.random.default_rng(3)
    m = rng.random((12, 10)) < 0.6
    want = np.asarray(jpart.remove_scattered_points(jnp.asarray(m)))
    got = tpart.remove_scattered_points(torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), want)


def test_masking_matches_jax_with_sentinel_ids():
    rng = np.random.default_rng(4)
    s, cap = 10, 6
    mask = np.zeros(s, bool)
    mask[[1, 4, 7]] = True
    ids = tmask.mask_to_padded_ids(mask, cap)
    np.testing.assert_array_equal(ids, jmask.mask_to_padded_ids(mask, cap))
    assert ids.tolist() == [1, 4, 7, s, s, s]
    x = rng.standard_normal((2, s, 3)).astype(np.float32)
    vals = rng.standard_normal((2, cap, 3)).astype(np.float32)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    np.testing.assert_array_equal(
        tmask.gather_rows(torch.from_numpy(x), tids).numpy(),
        np.asarray(jmask.gather_rows(jnp.asarray(x), jids)))
    np.testing.assert_array_equal(
        tmask.scatter_rows(torch.from_numpy(x), tids,
                           torch.from_numpy(vals)).numpy(),
        np.asarray(jmask.scatter_rows(jnp.asarray(x), jids,
                                      jnp.asarray(vals))))
    y = rng.standard_normal((2, s, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tmask.where_rows(torch.from_numpy(mask), torch.from_numpy(x),
                         torch.from_numpy(y)).numpy(),
        np.asarray(jmask.where_rows(jnp.asarray(mask), jnp.asarray(x),
                                    jnp.asarray(y))))


def _held_on_the_card(xs, cs, sim64, thr, gh, gw):
    """K3 on the card's xs, cs against its plain version: threshold maps
    equal except at tokens whose fp64 similarity `sim64` lies within 1e-5
    of the threshold (rsqrt and the reduction order may differ by a few
    ulps); the kernel's morphology equals the plain morphology over its own
    threshold map.  Returns the kernel's final mask."""
    near = np.abs(sim64 - thr) < 1e-5
    raw = pk.fused_partition(xs, cs, thr, gh, gw, False)
    full = pk.fused_partition(xs, cs, thr, gh, gw, True)
    diff = (raw != pk.partition_reference(xs, cs, thr, gh, gw, False))
    assert not (diff.cpu().numpy() & ~near).any()
    assert torch.equal(full, pk.remove_scattered_points(
        raw.reshape(gh, gw)).reshape(-1))
    return full


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [32, 64, 160, 256, (48, 80), (37, 53),
                                  (2, 3), (173, 181)], ids=str)
def test_kernel_matches_plain_on_the_card(cuda_device, grid):
    gh, gw = _hw(grid)
    x0, cond = _pair(gh * gw, 64, 5)
    sim64 = _cos64(x0, cond)
    full = _held_on_the_card(torch.from_numpy(x0).to(cuda_device),
                             torch.from_numpy(cond).to(cuda_device), sim64,
                             0.9, gh, gw)
    if not (np.abs(sim64 - 0.9) < 1e-5).any():
        want = pk.partition_reference(torch.from_numpy(x0),
                                      torch.from_numpy(cond), 0.9, gh, gw)
        assert torch.equal(full.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["d13", "unaligned"])
def test_kernel_scalar_loads_match_plain_on_the_card(cuda_device, layout):
    """Rows the kernel cannot read as float4: d % 4 != 0, or inputs that
    start 4 bytes past a 16-byte boundary."""
    gh, gw = 37, 53
    d = 13 if layout == "d13" else 64
    x0, cond = _pair(gh * gw, d, 6)
    start = 1 if layout == "unaligned" else 0
    xs, cs = (torch.zeros(start + a.size, device=cuda_device)
              for a in (x0, cond))
    for buf, a in ((xs, x0), (cs, cond)):
        buf[start:] = torch.from_numpy(a.reshape(-1))
    xs, cs = (buf[start:].view(gh * gw, d) for buf in (xs, cs))
    assert (xs.data_ptr() % 16 != 0) == (layout == "unaligned")
    _held_on_the_card(xs, cs, _cos64(x0, cond), 0.9, gh, gw)
