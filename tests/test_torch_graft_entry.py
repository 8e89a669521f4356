"""The port's flagship step and dry run (`regione_tpu_torch.graft_entry`)
against the JAX package's `__graft_entry__.py`.

  * `_build` draws `__graft_entry__._build`'s inputs (equal) and rope
    tables (within 1e-6);
  * `entry()`'s step at `tiny`, on the JAX params (through
    `weights.from_jax`), equals the JAX step: the dense forward, the CFG
    combine and the Euler update, within 2e-4 (the tolerance of the JAX
    package's dense forward tests, fp32);
  * `dryrun_multichip(8, device="cpu")` on 8 CPU ranks (gloo, a (dp 2,
    tp 4) mesh) with the port's own init passes its asserts (RAGS steps, a
    partial partition) for both topologies; with the JAX params carried
    across it reproduces the plan statistics of JAX's dryrun on its 8
    virtual devices.  The ranks are killed after
    `graft_entry.DRYRUN_LIMIT_S`;
  * on the card (the default device) it takes one card per rank and
    refuses fewer cards, or the CPU topologies' `params=`; `cuda`: one
    NCCL rank per card this process sees (a (dp 2, tp n/2) mesh for an
    even count), the head_dim-128 topologies, the same asserts.
"""

import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from regione_tpu_torch import graft_entry
from regione_tpu_torch.weights import from_jax
from torch_cpu import jax_schedule  # noqa: F401 (fixture)
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

PRESETS = ("tiny-tp", "tiny-qwen-tp")


def _np(x):
    return np.asarray(x.detach() if hasattr(x, "detach") else x)


def test_build_draws_the_jax_inputs():
    _, _, _, jctx, jlat0 = jentry._build("tiny", grid=8, t_txt=4, seed=3)
    _, _, _, ctx, lat0 = graft_entry._build("tiny", 8, 4, seed=3,
                                            device="cpu")
    for got, want in ((lat0, jlat0), (ctx.txt, jctx.txt),
                      (ctx.cond_latent, jctx.cond_latent),
                      (ctx.pooled, jctx.pooled)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    for got, want in zip((*ctx.rope_img, *ctx.rope_txt),
                         (*jctx.rope_img, *jctx.rope_txt)):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    assert ctx.s_noise == 64


def test_entry_step_matches_the_jax_step(monkeypatch):
    jcfg, jparams, jpipe, jctx, jlat0 = jentry._build("tiny", grid=8,
                                                      t_txt=4)
    params = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(from_jax, "init_params",
                        lambda cfg, gen, dev: from_jax.mmdit_from_jax(
                            params, cfg, dev))
    step_fn, (lat0, sigma, ctx) = graft_entry.entry("tiny", 8, 4,
                                                    device="cpu")
    assert sigma == 0.9 and tuple(lat0.shape) == jlat0.shape

    @jax.jit
    def j_step(lat, sigma, ctx):       # __graft_entry__.entry's step_fn
        v, _ = jpipe.dense_forward(lat, sigma, None, ctx, False)
        return lat + (-0.03) * v.astype(jnp.float32)

    want = j_step(jlat0, jnp.float32(0.9), jctx)
    got = step_fn(lat0, sigma, ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_dryrun_multichip_with_the_port_init(capsys):
    stats = graft_entry.dryrun_multichip(8, device="cpu")
    assert sorted(stats) == sorted(PRESETS)
    for st in stats.values():
        assert st["rags_steps"] > 0
        assert 0 < st["edited_tokens"] < st["seq_len"] == 64
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip OK") == 2 and "mesh=(2, 4)" in out


def _jax_dryrun_stats(capsys):
    """JAX's dryrun on the 8 virtual devices, its printed statistics (the
    port's lines, which print its mesh as a tuple, skipped)."""
    jentry._dryrun_multichip_impl(8)
    stats = {}
    for line in capsys.readouterr().out.splitlines():
        m = "mesh=(" not in line and re.search(
            r"OK \[(\S+)\].* dense=(\d+) rags=(\d+) reuse=(\d+) "
            r"edited=(\d+)/(\d+)", line)
        if m:
            stats[m.group(1)] = dict(zip(
                ("dense_steps", "rags_steps", "reuse_steps", "edited_tokens",
                 "seq_len"), map(int, m.groups()[1:])))
    return stats


@pytest.mark.usefixtures("jax_schedule")
def test_dryrun_multichip_with_the_jax_params_matches_jax(capsys):
    params = {}
    for preset, (seed, _) in graft_entry.JAX_PAIRS.items():
        jparams = jentry._build(preset, grid=8, t_txt=8, seed=seed)[1]
        params[preset] = from_jax.convert_params(
            jax.tree.map(np.asarray, jparams), "cpu")[0]
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(graft_entry.dryrun_multichip, 8, params, "cpu")
        want = _jax_dryrun_stats(capsys)
        got = fut.result()
    assert sorted(want) == sorted(got) == sorted(PRESETS)
    for preset in PRESETS:
        for key, value in want[preset].items():
            assert got[preset][key] == value, (preset, key)



def test_dryrun_multichip_on_the_card_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 ranks need 4 CUDA cards"):
        graft_entry.dryrun_multichip(4)
    with pytest.raises(ValueError, match="pass device='cpu'"):
        graft_entry.dryrun_multichip(2, params={})


@pytest.mark.cuda
def test_dryrun_multichip_on_the_cards(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    n = min(torch.cuda.device_count(), 8)
    stats = graft_entry.dryrun_multichip(n)
    assert sorted(stats) == sorted(PRESETS)
    for st in stats.values():
        assert st["rags_steps"] > 0
        assert 0 < st["edited_tokens"] < st["seq_len"] == 64
    out = capsys.readouterr().out
    mesh = (2, n // 2) if n % 2 == 0 and n > 1 else (1, n)
    assert out.count("dryrun_multichip OK") == 2
    assert f"mesh={mesh}" in out and "device=cuda" in out
