"""The port's partition (K3) and masking against the JAX package's.

`partition_reference` (the plain version the port's `fused_partition` takes
on the CPU) is held bit-equal to the Pallas kernel `fused_partition` in
interpret mode, as tests/test_partition_kernel.py runs it, with and without
morphology.  `select_edited_mask` is held against the JAX one (its XLA path
on the CPU, which normalises before the dot) with inputs kept at least 1e-4
away from the threshold, so the two cosine formulas cannot flip a token.
Masks compare exactly; similarities to 1e-5 (fp32 reductions in another
order).  The batched forms (a group of requests, one partition each, as
the JAX package runs them under `vmap`) are held image by image against
the JAX functions of one image.
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


def _batch(gh, gw, d, seed, n=3):
    """n images' (x0, cond) pairs [n, S, d], each with its own edited
    share (the first third, half, two thirds of its tokens re-drawn)."""
    rng = np.random.default_rng(seed)
    s = gh * gw
    x0 = rng.standard_normal((n, s, d)).astype(np.float32)
    cond = x0 + 0.3 * rng.standard_normal((n, s, d)).astype(np.float32)
    for i in range(n):
        k = s * (i + 1) // (n + 1)
        cond[i, :k] = rng.standard_normal((k, d)).astype(np.float32)
    return x0, cond


@pytest.mark.parametrize("kind,threshold", [("cosine", 0.9),
                                            ("euclidean", 0.5)])
@pytest.mark.parametrize("grid", [8, (5, 7)], ids=str)
@pytest.mark.parametrize("erosion_dilation", [False, True])
def test_batched_masks_match_jax_per_image(kind, threshold, grid,
                                           erosion_dilation):
    """`select_edited_masks` over B = 3 images equals the JAX package's
    `select_edited_mask` of each image alone (the euclidean rescale by the
    image's own min and max, as under `vmap`); for cosine, the batched
    plain K3 equals the Pallas kernel (interpret mode) per image."""
    gh, gw = _hw(grid)
    x0, cond = _batch(gh, gw, 16, 7)
    if kind == "cosine":
        cond = np.stack([_keep_away(a, c, threshold)
                         for a, c in zip(x0, cond)])
    kw = dict(grid_h=gh, grid_w=gw, erosion_dilation=erosion_dilation,
              similarity_type=kind)
    got = tpart.select_edited_masks(torch.from_numpy(x0),
                                    torch.from_numpy(cond), threshold, **kw)
    assert got.shape == (3, gh * gw) and got.dtype == torch.bool
    counts = got.sum(-1).tolist()
    assert len(set(counts)) > 1, counts
    for i in range(3):
        want = np.asarray(jpart.select_edited_mask(
            jnp.asarray(x0[i:i + 1]), jnp.asarray(cond[i:i + 1]), threshold,
            **kw))
        np.testing.assert_array_equal(got[i].numpy(), want,
                                      err_msg=f"image {i}")
    if kind == "cosine":
        plain = pk.partition_reference(torch.from_numpy(x0),
                                       torch.from_numpy(cond), threshold,
                                       gh, gw, erosion_dilation)
        for i in range(3):
            want = np.asarray(j_fused(jnp.asarray(x0[i]),
                                      jnp.asarray(cond[i]), threshold, gh,
                                      gw, erosion_dilation, interpret=True))
            np.testing.assert_array_equal(plain[i].numpy(), want)


def test_euclidean_rescales_each_image_by_its_own_range():
    """An image's euclidean similarities do not move when another image of
    the batch has a wider range (the JAX function sees one image at a
    time)."""
    x0, cond = _batch(8, 8, 16, 8, n=2)
    cond[1] *= 10.0
    both = tpart.token_similarity(torch.from_numpy(x0),
                                  torch.from_numpy(cond), "euclidean")
    alone = tpart.token_similarity(torch.from_numpy(x0[:1]),
                                   torch.from_numpy(cond[:1]), "euclidean")
    torch.testing.assert_close(both[:1], alone)


def test_batched_masking_matches_jax_per_image():
    """gather / scatter / where over per-image ids [B, K] and masks [B, S]
    equal the JAX functions of each image's own ids (pads read 0, dropped)."""
    rng = np.random.default_rng(9)
    s, cap = 10, 6
    masks = np.zeros((3, s), bool)
    masks[0, [1, 4, 7]] = True
    masks[1, [0, 2, 3, 5, 8, 9]] = True
    ids = np.stack([tmask.mask_to_padded_ids(m, cap) for m in masks])
    x = rng.standard_normal((3, s, 4)).astype(np.float32)
    y = rng.standard_normal((3, s, 4)).astype(np.float32)
    vals = rng.standard_normal((3, cap, 4)).astype(np.float32)
    tids = torch.from_numpy(ids)
    gathered = tmask.gather_rows(torch.from_numpy(x), tids)
    scattered = tmask.scatter_rows(torch.from_numpy(x), tids,
                                   torch.from_numpy(vals))
    picked = tmask.where_rows(torch.from_numpy(masks), torch.from_numpy(x),
                              torch.from_numpy(y))
    for i in range(3):
        jids = jnp.asarray(ids[i])
        np.testing.assert_array_equal(
            gathered[i:i + 1].numpy(),
            np.asarray(jmask.gather_rows(jnp.asarray(x[i:i + 1]), jids)))
        np.testing.assert_array_equal(
            scattered[i:i + 1].numpy(),
            np.asarray(jmask.scatter_rows(jnp.asarray(x[i:i + 1]), jids,
                                          jnp.asarray(vals[i:i + 1]))))
        np.testing.assert_array_equal(
            picked[i:i + 1].numpy(),
            np.asarray(jmask.where_rows(jnp.asarray(masks[i]),
                                        jnp.asarray(x[i:i + 1]),
                                        jnp.asarray(y[i:i + 1]))))
    assert not gathered[2].any()          # image 2: no edited token


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


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 4])
def test_batched_kernel_matches_plain_on_the_card(cuda_device, batch):
    """One launch for B images at 64 x 64 x 64 (B = 4 fills the one-wave
    budget of 8 x 8 tiles; B = 5 would take 16 x 16): each image's mask
    equals its own B = 1 launch bit for bit, and the plain version's."""
    x0, cond = _batch(64, 64, 64, 10, n=batch)
    xs = torch.from_numpy(x0).to(cuda_device)
    cs = torch.from_numpy(cond).to(cuda_device)
    pk.fused_partition.launches = 0
    got = pk.fused_partition(xs, cs, 0.9, 64, 64, True)
    assert pk.fused_partition.launches == 1 and got.shape == (batch, 4096)
    for i in range(batch):
        alone = _held_on_the_card(xs[i], cs[i], _cos64(x0[i], cond[i]), 0.9,
                                  64, 64)
        assert torch.equal(got[i], alone), f"image {i}"
    # past the one-wave budget (16 x 16 tiles); a ragged grid
    for (gh, gw), b in (((64, 64), 5), ((37, 53), 2)):
        x0, cond = _batch(gh, gw, 64, 11, n=b)
        xs = torch.from_numpy(x0).to(cuda_device)
        cs = torch.from_numpy(cond).to(cuda_device)
        got = pk.fused_partition(xs, cs, 0.9, gh, gw, True)
        for i in range(b):
            assert torch.equal(got[i], pk.fused_partition(xs[i], cs[i], 0.9,
                                                          gh, gw, True))
