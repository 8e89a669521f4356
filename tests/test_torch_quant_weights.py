"""The port's quantized weights (`ops.quant`, `models.layers`) against the
JAX package's, on the CPU in fp32.

  * codes and scales bit-equal to `regione_tpu.ops.quant`'s after the
    [out, in] transpose (int8, int4 split-halves packing with group scales),
    for every quantize_params flag set;
  * the quantized set: the linears the port quantizes are those JAX
    quantizes, named through `weights.from_jax`, at the tiny and the
    full-width presets (shapes only);
  * the three linear forms (weight-only int8, W8A8, int4) within 1e-5 of
    `regione_tpu.models.layers.linear`, and `quantize_rows` bit-equal;
  * `edit_latents` under int8, W8A8 and int4 weights against JAX's;
  * `init_quantized`: the structure of `quantize_params` and `_gen_like`'s
    distributions; `memplan` weight bytes equal to JAX's;
  * on the card (`cuda`): `int_mm` exact against the CPU's int32 product at
    the W8A8 shapes of the full-width path (the two-row modulation padded),
    and each quantized linear in bf16 against its fp32 CPU result.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import regione_tpu.ops.quant as jquant
import regione_tpu_torch.ops.quant as tquant
from regione_tpu.core.config import RegionEParams
from regione_tpu.models import layers as jlayers
from regione_tpu.models.mmdit import init_mmdit
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.pipelines.base import EditInputs as JEditInputs
from regione_tpu.pipelines.step1x_edit import (
    Step1XEditPipeline as JStep1XEditPipeline)
from regione_tpu.utils import memplan as jmemplan
from regione_tpu_torch.models import layers as tlayers
from regione_tpu_torch.models.mmdit import MMDiT
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.pipelines.base import EditInputs
from regione_tpu_torch.pipelines.step1x_edit import Step1XEditPipeline
from regione_tpu_torch.utils import memplan
from regione_tpu_torch.weights.from_jax import convert_params, mmdit_from_jax
# by module name (pytest puts tests/ on the path): on a machine where an
# installed package named `tests` shadows this directory, the `cuda` tests
# below still import
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

# quantize_params flag sets: int8 weight-only, int8 with the modulations
# (the W8A8 default), int4 with int8 modulations, int4 with int4 ones
FORMATS = {
    "int8": dict(),
    "int8_mods": dict(quantize_mods=True),
    "int4": dict(quantize_mods=True, bits=4),
    "int4_mods": dict(quantize_mods=True, bits=4, int4_mods=True),
}


@pytest.fixture
def int4_everywhere(monkeypatch):
    """The tiny presets' linears are narrower than _INT4_MIN_IN: let int4
    take them in both packages (as tests/test_quant.py does for JAX)."""
    monkeypatch.setattr(jquant, "_INT4_MIN_IN", 0)
    monkeypatch.setattr(tquant, "_INT4_MIN_IN", 0)


@functools.lru_cache(maxsize=None)
def _params(preset, seed=0):
    return jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(seed),
                                               j_get_config(preset)))


def _quantized_names(model):
    return {n for n, m in model.named_modules()
            if isinstance(m, (tlayers.Int8Linear, tlayers.Int4Linear))}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("preset", ["tiny", "tiny-step1x", "tiny-qwen"])
def test_codes_and_scales_bit_equal_to_jax(preset, fmt, int4_everywhere):
    flags = FORMATS[fmt]
    jq = jax.tree.map(np.asarray,
                      jquant.quantize_params(_params(preset), **flags))
    want = mmdit_from_jax(jq, get_config(preset), device="cpu").state_dict()
    model = mmdit_from_jax(_params(preset), get_config(preset), device="cpu")
    got = tquant.quantize_params(model, **flags).state_dict()
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == want[name].dtype, name
        assert torch.equal(t, want[name]), name
    names = _quantized_names(model)
    assert names and all(
        isinstance(model.get_submodule(n),
                   tlayers.Int4Linear if flags.get("bits") == 4
                   and ("mod" not in n or flags.get("int4_mods"))
                   else tlayers.Int8Linear) for n in names)


@functools.lru_cache(maxsize=None)
def _jax_shapes(preset, fmt):
    """JAX's quantized tree of `preset`, shapes only (jax.eval_shape)."""
    return jax.eval_shape(lambda k: jquant.quantize_params(
        init_mmdit(k, j_get_config(preset)), **FORMATS[fmt]),
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("preset", ["tiny-step1x", "step1x-edit",
                                    "flux-kontext", "qwen-image-edit"])
def test_quantized_set_equals_jax(preset, fmt):
    """Shapes only (jax.eval_shape; the port on the meta device): the names
    of JAX's "w_q" / "w_qp" leaves, mapped by `convert_params`, are the
    port's quantized linears, with the same code and scale shapes."""
    flags = FORMATS[fmt]
    jstate, _ = convert_params(_jax_shapes(preset, fmt), device="meta")
    model = tquant.quantize_params(MMDiT(get_config(preset),
                                         torch.device("meta")), **flags)
    want = {k.rsplit(".", 1)[0]: k.rsplit(".", 1)[1] for k in jstate
            if k.endswith((".w_q", ".w_qp"))}
    got = {n: "w_qp" if isinstance(model.get_submodule(n),
                                   tlayers.Int4Linear) else "w_q"
           for n in _quantized_names(model)}
    assert got == want
    tstate = model.state_dict()
    assert sorted(tstate) == sorted(jstate)
    for k, t in tstate.items():
        assert tuple(t.shape) == tuple(jstate[k].shape), k
    # what stays in the model dtype: final_mod always, the modulations
    # unless quantize_mods, the embedders of the timestep / vector /
    # guidance always
    assert not any(n.startswith(("final_mod", "time_in", "vector_in",
                                 "guidance_in")) for n in got)


def _linear_case(seed, d_in=256, d_out=48, rows=(2, 9)):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d_in, d_out)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(d_out) * 0.01).astype(np.float32)
    x = rng.standard_normal(rows + (d_in,)).astype(np.float32)
    return {"w": w, "b": b}, x


def _port_linear(p):
    lin = torch.nn.Linear(*p["w"].shape)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p["w"].T))
        lin.bias.copy_(torch.from_numpy(p["b"]))
    return lin


@pytest.mark.parametrize("rows", [(2, 9), (1, 2), (3, 130)])
@pytest.mark.parametrize("form", ["int8", "w8a8", "int4"])
def test_linear_forms_match_jax(form, rows):
    p, x = _linear_case(1, rows=rows)
    lin = _port_linear(p)
    if form == "int4":
        jp = jquant.quantize_linear4(p)
        mod = tlayers.Int4Linear(**tquant.quantize_linear4(lin.weight,
                                                           lin.bias))
    else:
        jp = jquant.quantize_linear(p)
        mod = tlayers.Int8Linear(**tquant.quantize_linear(lin.weight,
                                                          lin.bias))
    with jlayers.act_int8(form == "w8a8"), tlayers.act_int8(form == "w8a8"):
        want = np.asarray(jlayers.linear(jp, jnp.asarray(x)))
        got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # quantized, not the float linear
    full = lin(torch.from_numpy(x)).detach().numpy()
    assert not np.allclose(got, full, atol=1e-7)


def test_quantize_rows_and_dequantize_match_jax():
    p, x = _linear_case(2, d_in=512, d_out=24)
    x8, s_a = jlayers.quantize_rows(jnp.asarray(x))
    t8, ts = tlayers.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s_a))
    w = torch.from_numpy(p["w"].T.copy())
    b = torch.from_numpy(p["b"])
    for jq, tq, jdeq, tdeq in (
            (jquant.quantize_linear(p), tquant.quantize_linear(w, b),
             jquant.dequantize_weight, tquant.dequantize_weight),
            (jquant.quantize_linear4(p), tquant.quantize_linear4(w, b),
             jquant.dequantize_weight4, tquant.dequantize_weight4)):
        np.testing.assert_array_equal(
            tdeq(tq, torch.float32).numpy(),
            np.asarray(jdeq(jq, jnp.float32)).T)
    # the split halves: input column i in the low nibble, i + in/2 high
    lo, hi = tquant.unpack_int4(tquant.quantize_linear4(w, b)["w_qp"])
    assert lo.shape == hi.shape == (24, 256)
    assert int(lo.abs().max()) <= 7 and int(hi.abs().max()) <= 7


def test_int_mm_is_the_exact_int32_product():
    """On the CPU `int_mm` is the int32 product at any shape (the rows of a
    modulation included); a float matmul of 3072-deep int8 codes would not
    be."""
    rng = np.random.default_rng(3)
    for m, k, n in ((2, 3072, 64), (17, 64, 40), (5, 12, 7)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), np.int8))
        got = tlayers.int_mm(a, w)
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), a.long() @ w.long().t())


GRID, T_TXT, S = 8, 4, 64
# fp32 on both sides over 28 Euler steps with CFG 6 (tests/
# test_torch_pipeline.py's 5e-4).  W8A8 adds the activation grid: a
# summation-order difference that moves x / s_a across a rounding boundary
# changes that code by one step, 1/127 of its row's amax, and CFG 6 carries
# such flips through the steps: bounded at 2e-2 absolute (0.6% of the
# latents' scale of ~3.4) and 60 dB latent PSNR (each linear alone agrees
# to 1e-5, test_linear_forms_match_jax)
EDIT_TOL = {"int8": 5e-4, "w8a8": 2e-2, "int4": 5e-4}


@pytest.mark.parametrize("form", ["int8", "w8a8", "int4"])
def test_edit_latents_quantized_match_jax(form, int4_everywhere):
    flags = (dict(quantize_mods=True, bits=4) if form == "int4" else
             dict(quantize_mods=form == "w8a8"))
    jcfg = dataclasses.replace(j_get_config("tiny-step1x"),
                               act_int8=form == "w8a8")
    tcfg = dataclasses.replace(get_config("tiny-step1x"),
                               act_int8=form == "w8a8")
    jq = jax.tree.map(np.asarray, jquant.quantize_params(
        _params("tiny-step1x"), **flags))
    re = RegionEParams(threshold=0.2, cache_threshold=0.05,
                       capacity_granularity=8)
    jpipe = JStep1XEditPipeline(jcfg, jq, re)
    model = tquant.quantize_params(
        mmdit_from_jax(_params("tiny-step1x"), tcfg, device="cpu"), **flags)
    tpipe = Step1XEditPipeline(model, re)
    rng = np.random.default_rng(1)
    txt = rng.standard_normal((2, T_TXT, tcfg.connector.in_dim)).astype(
        np.float32)
    cond = (0.5 * rng.standard_normal((1, S, tcfg.in_channels))).astype(
        np.float32)
    lat0 = rng.standard_normal((1, S, tcfg.in_channels)).astype(np.float32)
    rope = jpipe.build_rope(GRID, GRID, T_TXT)
    want, jstats = jpipe.edit_latents(
        jnp.asarray(lat0), JEditInputs(txt=jnp.asarray(txt),
                                       cond_latent=jnp.asarray(cond),
                                       rope_img=rope[0], rope_txt=rope[1]),
        GRID, GRID)
    rope = tpipe.build_rope(GRID, GRID, T_TXT)
    got, tstats = tpipe.edit_latents(
        torch.from_numpy(lat0), EditInputs(txt=torch.from_numpy(txt),
                                           cond_latent=torch.from_numpy(cond),
                                           rope_img=rope[0],
                                           rope_txt=rope[1]), GRID, GRID)
    assert 0 < tstats.edited_tokens < S and tstats.rags_steps > 0
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=EDIT_TOL[form],
                               atol=EDIT_TOL[form])
    peak = float(want.max() - want.min())
    assert 10 * np.log10(peak ** 2 / np.mean((got - want) ** 2)) >= 60


@pytest.mark.parametrize("fmt", ["int8_mods", "int4_mods"])
def test_init_quantized_structure_and_distributions(fmt, int4_everywhere):
    flags = FORMATS[fmt]
    cfg = get_config("tiny-step1x")
    got = tquant.init_quantized(cfg, torch.Generator().manual_seed(0),
                                device="cpu", **flags)
    ref = tquant.quantize_params(MMDiT(cfg, torch.device("meta")), **flags)
    gs, rs = got.state_dict(), ref.state_dict()
    assert sorted(gs) == sorted(rs)
    for k in gs:
        assert gs[k].shape == rs[k].shape and gs[k].dtype == rs[k].dtype, k
    # the JAX package's init_quantized has the same leaves
    jshapes = jax.eval_shape(lambda k: jquant.init_quantized(
        k, j_get_config("tiny-step1x"), **flags), jax.random.PRNGKey(0))
    assert sorted(convert_params(jshapes, device="meta")[0]) == sorted(gs)
    for name, mod in got.named_modules():
        if isinstance(mod, tlayers.Int8Linear):
            lim = 1.0 / np.sqrt(mod.w_q.shape[1])
            assert int(mod.w_q.abs().max()) <= 127
            assert torch.all(mod.scale == torch.tensor(lim / 127.0))
        elif isinstance(mod, tlayers.Int4Linear):
            lim = 1.0 / np.sqrt(2 * mod.w_qp.shape[1])
            lo, hi = tquant.unpack_int4(mod.w_qp)
            assert max(int(lo.abs().max()), int(hi.abs().max())) <= 7
            assert torch.all(mod.scale4 == torch.tensor(lim / 7.0))
        elif type(mod) is torch.nn.Linear:
            lim = 1.0 / np.sqrt(mod.in_features)
            assert float(mod.weight.detach().abs().max()) <= lim
        else:
            continue
        assert not mod.bias.any(), name
    assert torch.all(got.double_blocks[0].img_attn.norm_q.scale == 1)
    assert not got.connector.scale_factor.any()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("preset", ["tiny", "tiny-step1x", "tiny-qwen",
                                    "step1x-edit", "flux-kontext",
                                    "qwen-image-edit"])
def test_memplan_weight_bytes_equal_jax(preset, fmt):
    """memplan's quantized weight bytes and parameter count are the JAX
    memplan's (at tp 1: the bytes of the quantized tree's leaves, a packed
    int4 byte counting two parameters), and below the bf16 bytes."""
    leaves = jax.tree_util.tree_flatten_with_path(_jax_shapes(preset, fmt))[0]
    got = memplan.plan(preset, grid=16, t_txt=32, int8=True, **FORMATS[fmt])
    assert got.param_bytes == sum(
        int(np.prod(x.shape)) * x.dtype.itemsize for _, x in leaves)
    assert got.params_total == sum(
        int(np.prod(x.shape)) * (2 if path[-1].key == "w_qp" else 1)
        for path, x in leaves)
    assert got.param_bytes < memplan.plan(preset, grid=16,
                                          t_txt=32).param_bytes


@pytest.mark.parametrize("preset,fmt", [
    ("step1x-edit", "int8_mods"), ("flux-kontext", "int8_mods"),
    ("qwen-image-edit", "int4_mods")])
def test_memplan_equals_the_jax_memplan(preset, fmt):
    """The JAX package's `memplan.plan` itself, for the formats of its
    full-size records."""
    flags = FORMATS[fmt]
    want = jmemplan.plan(preset, grid=16, t_txt=32, int8=True, **flags)
    got = memplan.plan(preset, grid=16, t_txt=32, int8=True, **flags)
    assert got.param_bytes == want.param_bytes_per_device
    assert got.params_total == want.params_total


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch._int_mm's cuBLAS path and "
                    "the bf16 card linears run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_int_mm_on_the_card_is_exact(cuda_device):
    """The W8A8 shapes of the full-width path: the modulation on 2 rows
    (padded to 17 on the card), x_embedder's K = 64, final_proj's N = 64,
    a RAGS row count, the MLP out projection's K = 12,288."""
    rng = np.random.default_rng(4)
    for m, k, n in ((2, 3072, 18432), (1, 3072, 9216), (16, 3072, 3072),
                    (8192, 64, 3072), (4096, 3072, 64), (1152, 3072, 3072),
                    (4224, 12288, 3072)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), np.int8))
        got = tlayers.int_mm(a.to(cuda_device), w.to(cuda_device)).cpu()
        assert torch.equal(got, tlayers.int_mm(a, w)), (m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int8", "w8a8", "int4"])
def test_quantized_linears_card_vs_cpu(form, cuda_device):
    """The same codes on the card in bf16 and on the CPU in fp32, within
    2e-2 of the output's scale (the port's bound for bf16 outputs, PERF.md
    §2): the bf16 rounding of the activations and the output, and under
    W8A8 an activation code that bf16 rounding moves by one step."""
    p, x = _linear_case(5, d_in=3072, d_out=256, rows=(2, 300))
    lin = _port_linear(p)
    qz = tquant.quantize_linear4 if form == "int4" else tquant.quantize_linear
    cls = tlayers.Int4Linear if form == "int4" else tlayers.Int8Linear
    cpu = cls(**qz(lin.weight.detach(), lin.bias.detach()))
    card = copy.deepcopy(cpu).to(cuda_device)
    card.bias.data = card.bias.data.bfloat16()
    with tlayers.act_int8(form == "w8a8"):
        want = cpu(torch.from_numpy(x))
        got = card(torch.from_numpy(x).to(cuda_device, torch.bfloat16))
    err = float((got.float().cpu() - want).abs().max() / want.abs().max())
    assert err <= 2e-2, err
