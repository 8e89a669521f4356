"""The port's `parallel.sharding` in one process, against the JAX package's.

  * the `tiny-tp` / `tiny-qwen-tp` presets are the JAX package's;
  * `param_specs` equals JAX's `param_specs` leaf for leaf (each JAX leaf
    in the port's layout: the layer axis dropped, a transposed leaf's axes
    reversed) on the tiny presets, the connector's, int8 and int4 trees,
    and at full width (shapes only); `cache_specs` as JAX's;
  * `memplan.plan(tp=2, 4)` equals JAX's `memplan.plan(tp=)` byte for byte
    (weights, cache, activations, split leaves, big replicated leaves) for
    every full-width preset, bf16, int8 and int4;
  * the fused linear1 / linear2 split per part, and a row-parallel int4
    weight repacked per rank: each rank's dequantized weight is its slice
    of the whole one bit for bit, the fused [attn ‖ mlp] input rows of
    linear2 crossing the packed halves' boundary included;
  * the loaders (`load_converted(mesh=)`, `mmdit_from_checkpoint(mesh=)`)
    give each rank exactly `shard_params`' slices of the whole model and
    cut only those out of the mapped files (a stand-in mesh names the
    rank: loading runs no collective);
  * a one-rank gloo mesh: `make_mesh`'s dims, and `shard_params` at tp 1
    changes no layer and no number.
The sharded numerics on a real (dp 2, tp 4) group are
tests/test_torch_parallel_mesh.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import regione_tpu.ops.quant as jquant
from regione_tpu.models.mmdit import init_cache as j_init_cache
from regione_tpu.models.mmdit import init_mmdit
from regione_tpu.models.presets import get_config as j_get_config
from regione_tpu.parallel import sharding as jsharding
from regione_tpu.utils import memplan as jmemplan
from regione_tpu_torch.models import layers
from regione_tpu_torch.models.kv_cache import init_cache
from regione_tpu_torch.models.mmdit import MMDiT
from regione_tpu_torch.models.presets import PRESETS, get_config
from regione_tpu_torch.ops import quant as tquant
from regione_tpu_torch.parallel import sharding
from regione_tpu_torch.utils import memplan as tmemplan
from regione_tpu_torch.weights import checkpoint
from regione_tpu_torch.weights import convert as tconvert
from regione_tpu_torch.weights.from_jax import STACKED, _walk, mmdit_from_jax
from tests.test_torch_convert import _diffusers_state, _kl_vae, _write_shards
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

FULL_WIDTH = ["step1x-edit", "step1x-edit-v1p2", "flux-kontext",
              "qwen-image-edit", "qwen-image-edit-plus"]
WEIGHTS = {"bf16": {}, "int8": dict(int8=True),
           "int4": dict(int8=True, bits=4)}


@pytest.fixture
def int4_everywhere(monkeypatch):
    """int4 for every reduction width, in both packages (the tiny presets
    are narrower than _INT4_MIN_IN)."""
    monkeypatch.setattr(jquant, "_INT4_MIN_IN", 0)
    monkeypatch.setattr(tquant, "_INT4_MIN_IN", 0)


@pytest.mark.parametrize("name", ["tiny-tp", "tiny-qwen-tp"])
def test_tp_presets_match_jax(name):
    j, t = j_get_config(name), get_config(name)
    for f in ("hidden", "heads", "head_dim", "depth_double", "depth_single",
              "txt_in_dim", "pooled_dim", "guidance_embed", "axes_dims",
              "time_embed_dim", "mlp_ratio", "in_channels", "out_channels",
              "txt_norm"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.connector is None and j.connector is None
    assert t.heads % 4 == 0 and t.mlp_hidden % 4 == 0 and name in PRESETS


def _jax_specs_in_port_layout(params):
    """JAX's param_specs of `params`, keyed by the port's parameter names
    and laid out as the port's tensors."""
    specs = jsharding.param_specs(params)
    out = {}
    for path, leaf in _walk(params):
        spec = specs
        for key in path:
            spec = spec[key]
        spec = tuple(spec)
        dotted = ".".join(path)
        stack = next((s for s in STACKED if dotted.startswith(s + ".")),
                     None)
        ndim = len(leaf.shape) - (stack is not None)
        if spec:
            if stack is not None:
                spec = spec[1:]
            if path[-1] in ("w", "w_q", "w_qp", "scale4") or (
                    path[-1] == "scale" and ndim == 2):
                spec = spec[::-1]
        rest = path if stack is None else path[len(stack.split(".")):]
        tail = ".".join({"w": "weight", "b": "bias", "in": "in_"}.get(k, k)
                        for k in rest)
        if stack is None:
            out[tail] = spec
        else:
            for i in range(leaf.shape[0]):
                out[f"{STACKED[stack]}.{i}.{tail}"] = spec
    return out


@pytest.mark.parametrize("preset,quant", [
    ("tiny", None), ("tiny-tp", None), ("tiny-tp", 8), ("tiny-tp", 4),
    ("tiny-step1x", None), ("tiny-step1x", 4), ("tiny-qwen-tp", 8),
    ("step1x-edit", 4), ("qwen-image-edit", 8)])
def test_param_specs_match_jax(preset, quant, monkeypatch):
    """Leaf for leaf; the full-width presets as shapes only (meta), with
    the published int4 rule; the tiny ones with int4 at every width."""
    jcfg = j_get_config(preset)
    full = preset in FULL_WIDTH
    if not full:
        monkeypatch.setattr(jquant, "_INT4_MIN_IN", 0)
        monkeypatch.setattr(tquant, "_INT4_MIN_IN", 0)

    def build(key):
        p = init_mmdit(key, jcfg)
        return p if quant is None else jquant.quantize_params(
            p, bits=quant, quantize_mods=True)

    if full:
        params = jax.eval_shape(build, jax.random.PRNGKey(0))
    else:
        params = jax.tree.map(np.asarray, build(jax.random.PRNGKey(0)))
    model = mmdit_from_jax(params, get_config(preset),
                           device="meta" if full else "cpu")
    got = sharding.param_specs(model)
    want = _jax_specs_in_port_layout(params)
    assert got == want
    assert any("tp" in s for s in got.values())


def test_mesh_and_param_specs(tmp_path):
    """The JAX test's spot checks in the port's layout, and a one-rank
    gloo mesh with dims (dp, tp)."""
    specs = sharding.param_specs(MMDiT(get_config("tiny"), "meta"))
    assert specs["double_blocks.0.img_attn.q.weight"] == ("tp", None)
    assert specs["double_blocks.0.img_attn.q.bias"] == ("tp",)
    assert specs["double_blocks.0.img_attn.out.weight"] == (None, "tp")
    assert specs["single_blocks.0.linear1.weight"] == ("tp", None)
    assert specs["single_blocks.0.linear2.weight"] == (None, "tp")
    assert specs["x_embedder.weight"] == ()
    assert specs["double_blocks.0.img_mod.weight"] == ("tp", None)
    assert specs["single_blocks.0.mod.weight"] == ("tp", None)
    with pytest.raises(RuntimeError, match="init_process_group"):
        sharding.make_mesh(device_type="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("dp", "tp")
        assert (mesh.size(0), mesh.size(1)) == (1, 1)
        with pytest.raises(ValueError, match="ranks"):
            sharding.make_mesh(8, dp=2, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_cache_specs_shapes():
    cfg = get_config("tiny")
    specs = sharding.cache_specs(init_cache(cfg, 2, 32, "cpu"))
    jspecs = jsharding.cache_specs(j_init_cache(j_get_config("tiny"), 2, 32,
                                                4))
    assert specs["dk"] == (None, "dp", "tp", None, None)
    assert {k: tuple(v) for k, v in jspecs.items()} == specs
    q = init_cache(dataclasses.replace(cfg, cache_int8=True), 1, 32, "cpu")
    assert sharding.cache_specs(q)["dk_s"] == (None, None, "tp", None)
    assert sharding.latent_spec() == ("dp", None, None)


@pytest.mark.parametrize("fmt", list(WEIGHTS))
@pytest.mark.parametrize("preset", FULL_WIDTH)
def test_memplan_per_card_matches_jax(preset, fmt):
    for tp in (2, 4):
        want = jmemplan.plan(preset, grid=32, t_txt=128, tp=tp,
                             cache_dtype=jnp.int8, **WEIGHTS[fmt])
        got = tmemplan.plan(preset, grid=32, t_txt=128, tp=tp,
                            cache="int8", **WEIGHTS[fmt])
        assert got.param_bytes == want.param_bytes_per_device
        assert got.cache_bytes == want.cache_bytes_per_device
        assert got.activation_bytes_est == want.activation_bytes_est
        assert got.total_bytes == want.total_bytes_per_device
        assert got.params_total == want.params_total
        assert got.sharded_leaves == want.sharded_leaves
        assert sorted(map(tuple, got.replicated_big_leaves)) == \
            sorted(map(tuple, want.replicated_big_leaves))


def test_linear1_and_linear2_split_per_part():
    """Rank r keeps the r-th slice of q, k, v and the MLP in linear1's
    output, and of [attn ‖ mlp] in linear2's input."""
    cfg = get_config("tiny-tp")
    model = MMDiT(cfg, "meta")
    inner, mh = cfg.inner, cfg.mlp_hidden
    for r in range(4):
        plans = sharding.shard_plan(model, r, 4)
        l1 = plans["single_blocks.0.linear1"]
        q = inner // 4
        assert l1.out_ranges == [(k * inner + r * q, k * inner + (r + 1) * q)
                                 for k in range(3)] + [
            (3 * inner + r * mh // 4, 3 * inner + (r + 1) * mh // 4)]
        l2 = plans["single_blocks.0.linear2"]
        assert l2.in_ranges == [(r * q, (r + 1) * q),
                                (inner + r * mh // 4,
                                 inner + (r + 1) * mh // 4)]
        assert plans["double_blocks.0.img_mod"].role == layers.ROLE_GATHER
        assert plans["double_blocks.0.txt_attn.out"].role == layers.ROLE_ROW
        assert "x_embedder" not in plans and "final_mod" in plans
    assert sharding.shard_plan(model, 0, 1) == {}
    with pytest.raises(ValueError, match="divisible"):
        sharding.shard_plan(model, 0, 3)


@pytest.mark.parametrize("tp", [2, 4])
def test_int4_row_shards_dequantize_to_the_slice(tp):
    """A linear2-like int4 weight ([attn 256 ‖ mlp 1024] inputs, group 128,
    packed halves of 640): each rank's repacked codes and scale groups
    dequantize to its columns of the whole weight, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    w = torch.rand(48, 1280, generator=gen) - 0.5
    full = tquant.quantize_linear4(w, torch.zeros(48))
    whole = tquant.dequantize_weight4(full, torch.float32)
    for r in range(tp):
        plan = layers.LinearShard(
            "int4", layers.ROLE_ROW,
            {"w_qp": (None, "tp"), "scale4": (), "bias": ()},
            out_ranges=[(0, 48)],
            in_ranges=sharding._ranges([256, 1024], r, tp, "linear2"))
        plan.scale_groups = sharding._int4_row_layout(plan.in_ranges, 1280,
                                                      full["scale4"].shape[1])
        plans = {"l": plan}
        tensors = {k: sharding.shard_tensor(plans, f"l.{k}", v)
                   for k, v in (("w_qp", full["w_qp"]),
                                ("scale4", full["scale4"]),
                                ("bias", full["b"]))}
        lin = layers.ShardedLinear(plan, tensors, layers.TPGroup(None, r, tp))
        assert lin.w_qp.shape == (48, 1280 // tp // 2)
        assert lin.scale4.shape == full["scale4"].shape   # whole, as JAX's
        got = tquant.dequantize_weight4(
            {"w_qp": lin.w_qp, "scale4": lin._scale4()}, torch.float32)
        assert torch.equal(got, layers.take(whole, 1, plan.in_ranges))


class _RankOf:
    """A stand-in for a (1, tp) mesh as seen by rank `rank` of the tp axis:
    the loaders read the rank and the size, and run no collective."""

    def __init__(self, rank, tp):
        self.rank, self.tp = rank, tp

    def get_group(self, dim):
        return None

    def get_local_rank(self, dim):
        return self.rank if dim == "tp" else 0

    def size(self, dim):
        return (1, self.tp)[dim]


def _state_of_shard(model, rank, tp):
    return sharding.shard_params(model, _RankOf(rank, tp)).state_dict()


@pytest.mark.parametrize("preset,naming,tp", [
    ("tiny-tp", "flux", 4), ("tiny-step1x", "step1x", 2),
    ("tiny-qwen-tp", "qwen", 2)])
def test_load_converted_reads_each_ranks_slices(preset, naming, tp,
                                                tmp_path):
    """Each rank's load of a diffusers directory (fp32 shards) equals the
    slices `shard_params` cuts from the whole loaded model, and reads
    their bytes only: less than the whole, all ranks together the whole
    plus the replicated leaves once per rank."""
    _write_shards(tmp_path / "transformer", _diffusers_state(preset, naming))
    _kl_vae(tmp_path)
    cfg = get_config(preset)
    whole = tconvert.load_converted(tmp_path, cfg, device="cpu")[0]
    whole_bytes = sum(t.numel() * 4 for t in whole.state_dict().values())
    specs = sharding.param_specs(whole)
    replicated = sum(t.numel() * 4 for n, t in whole.state_dict().items()
                     if "tp" not in specs[n])
    total = 0
    for r in range(tp):
        model = tconvert.load_converted(tmp_path, cfg, device="cpu",
                                        mesh=_RankOf(r, tp))[0]
        got = model.state_dict()
        want = _state_of_shard(
            tconvert.load_converted(tmp_path, cfg, device="cpu")[0], r, tp)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.shape == want[k].shape and torch.equal(t, want[k]), k
        assert model.loaded_bytes == sum(t.numel() * 4 for t in got.values())
        assert model.loaded_bytes < whole_bytes
        total += model.loaded_bytes
    assert total == whole_bytes + (tp - 1) * replicated


@pytest.mark.parametrize("bits", [8, 4])
def test_checkpoint_load_reads_each_ranks_slices(bits, tmp_path,
                                                 int4_everywhere):
    """The port's quantized checkpoint (int8 / int4, modulations too):
    each rank's shard equals `shard_params`' slices of the whole, and its
    loaded bytes are theirs (an int4 row-parallel rank reads the packed
    bytes holding its nibbles, so its codes are repacked, not sliced)."""
    cfg = get_config("tiny-tp")
    params = jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(0),
                                                 j_get_config("tiny-tp")))
    model = tquant.quantize_params(mmdit_from_jax(params, cfg, "cpu"),
                                   bits=bits, quantize_mods=True)
    path = tmp_path / "m.safetensors"
    checkpoint.save(path, model.state_dict())
    for r in range(4):
        got = checkpoint.mmdit_from_checkpoint(path, cfg, "cpu",
                                               mesh=_RankOf(r, 4))
        want = _state_of_shard(checkpoint.mmdit_from_checkpoint(
            path, cfg, "cpu"), r, 4)
        state = got.state_dict()
        assert sorted(state) == sorted(want)
        for k, t in state.items():
            assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k
        assert got.loaded_bytes == tquant.quantized_bytes(got)
        assert isinstance(got.double_blocks[0].img_attn.out,
                          layers.ShardedLinear)


def test_shard_params_at_tp1_changes_nothing(tmp_path):
    """A one-rank mesh: no layer is replaced, the heads stay, and the
    forward is bit-equal."""
    cfg = get_config("tiny-tp")
    params = jax.tree.map(np.asarray, init_mmdit(jax.random.PRNGKey(0),
                                                 j_get_config("tiny-tp")))
    ref = mmdit_from_jax(params, cfg, "cpu")
    model = mmdit_from_jax(params, cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    img, txt = torch.randn(2, 16, 8, generator=gen), torch.randn(
        2, 4, 16, generator=gen)
    rope = layers.rope_table(torch.zeros(16, 3), cfg.axes_dims)
    rope_t = layers.rope_table(torch.zeros(4, 3), cfg.axes_dims)
    pooled = torch.randn(2, 8, generator=gen)
    t = torch.full((2,), 0.5)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        sharding.shard_params(model, sharding.make_mesh(device_type="cpu"))
        assert model.tp_size == 1 and model.mesh is not None
        assert not any(isinstance(m, layers.ShardedLinear)
                       for m in model.modules())
        assert model.double_blocks[0].img_attn.heads == cfg.heads
        with torch.inference_mode():
            got, _ = model(img, txt, t, rope, rope_t, pooled=pooled)
            want, _ = ref(img, txt, t, rope, rope_t, pooled=pooled)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="sharded already"):
            sharding.shard_params(model, model.mesh)
    finally:
        dist.destroy_process_group()
