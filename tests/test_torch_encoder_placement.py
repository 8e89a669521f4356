"""Where the port's fp32 prompt encoder lives (`utils.memplan`,
`models.text_encoders`, `weights.convert.load_converted`, the pipelines'
`prepare_inputs` and `EditService.run`).

  * `memplan.plan(encoder=)` counts the encoder's fp32 bytes as a
    meta-device build gives them: Qwen2.5-VL-7B's 8,292,166,656 parameters
    (its published count) and its rotary buffers; T5-XXL's encoder and
    CLIP-L's text tower; a checkpoint's text_encoder/ (the synthetic
    `tiny_vl`) exactly as many bytes as the loaded encoder holds; the plan
    without an encoder is unchanged (the JAX memplan's);
  * `choose_placement` follows memplan for a card size given as an
    argument: "card" when the whole plan fits, "offload" when the weights
    and the encoder do, else "host"; the published Qwen at grid 64, t_txt
    512 on an H100 (79.19 GiB) offloads;
  * `load_converted` decides from memplan before it reads a tensor, and
    logs the choice on a line of its own;
  * on `tiny_vl` the embeddings and masks are the same under every
    placement (on the CPU each is the host's); `prepare_inputs` brings an
    offloaded encoder to the device once for both CFG encodes; with an
    offloaded encoder `EditService.run` prepares no request while another
    denoises;
  * `cuda`: on the card, the offloaded and the resident encoder against
    the fp32 CPU encoder within 1e-4 of the scale (PERF.md section 2), the
    offloaded one off the card after its encode; and the edit's peak with
    the offloaded encoder under the resident one's.
"""

import contextlib
import inspect
import time

import numpy as np
import pytest
import torch

from regione_tpu_torch.models import text_encoders as tte
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.utils import memplan
from regione_tpu_torch.weights import tiny_vl
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")

GIB = 2 ** 30
H100 = 85_031_518_208          # torch.cuda.get_device_properties(0)
IMG = (np.random.default_rng(7).random((64, 64, 3)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("vl")
    tiny_vl.build_checkpoint(str(root), hidden=16)
    return root


def test_encoder_bytes_are_the_meta_builds():
    qwen = memplan.encoder_bytes("qwen2.5-vl-7b")
    # 8,292,166,656 fp32 parameters and the rotary inv_freq buffers
    assert 4 * 8_292_166_656 < qwen < 4 * 8_292_166_656 + 2 ** 20
    flux = memplan.encoder_bytes("t5-xxl+clip-l")
    assert 4 * (4_762_310_656 + 123_060_480) <= flux < \
        4 * (4_762_310_656 + 123_060_480) + 2 ** 20
    bare = memplan.plan("qwen-image-edit", grid=64, t_txt=512)
    p = memplan.plan("qwen-image-edit", grid=64, t_txt=512,
                     encoder="qwen2.5-vl-7b")
    assert bare.encoder is None and bare.encoder_bytes == 0
    assert p.encoder_bytes == qwen
    assert p.total_bytes == bare.total_bytes + qwen
    assert (p.param_bytes, p.cache_bytes) == (bare.param_bytes,
                                              bare.cache_bytes)


def test_checkpoint_encoder_bytes_equal_the_loaded_model(ckpt):
    te = ckpt / "text_encoder"
    assert memplan.checkpoint_encoder(ckpt, "qwen-image-edit") == str(te)
    assert memplan.checkpoint_encoder(ckpt, "flux-kontext") is None
    enc = tte.QwenVLPromptEncoder(str(te), template=tte.QWEN_EDIT_TEMPLATE,
                                  device="cpu")
    held = sum(t.numel() * t.element_size()
               for t in (*enc.model.parameters(), *enc.model.buffers()))
    assert memplan.encoder_bytes(str(te)) == held


@pytest.mark.parametrize("preset", ["qwen-image-edit", "step1x-edit",
                                    "flux-kontext"])
def test_placement_follows_memplan_for_the_card_given(preset):
    cfg = get_config(preset)
    enc = memplan.ENCODER_OF[preset]
    bcfg = 1 if preset == "flux-kontext" else 2
    _, p = memplan.choose_placement(cfg, enc, H100, batch_cfg=bcfg)
    for hbm, want in ((p.total_bytes / 0.92 + 1, "card"),
                      (p.total_bytes / 0.92 - 1, "offload"),
                      ((p.param_bytes + p.encoder_bytes) / 0.92 + 1,
                       "offload"),
                      ((p.param_bytes + p.encoder_bytes) / 0.92 - 1,
                       "host")):
        assert memplan.choose_placement(cfg, enc, int(hbm),
                                        batch_cfg=bcfg)[0] == want, hbm
    if preset == "qwen-image-edit":
        # the fault: 38.06 GiB bf16 + 11.25 cache + 30.89 encoder > 79.19
        assert memplan.choose_placement(cfg, enc, H100)[0] == "offload"
        assert p.total_bytes > H100 > p.param_bytes + p.encoder_bytes


def test_load_converted_plans_before_it_loads(ckpt, monkeypatch, capsys):
    from regione_tpu_torch.weights import convert

    class Card:
        total_memory = 6 * GIB

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Card())
    order = []

    class Loading(Exception):
        pass

    def load(path):
        order.append("load")
        raise Loading(path)

    monkeypatch.setattr(convert, "_load_torch_state", load)
    real = memplan.choose_placement

    def spy(*a, **kw):
        order.append("plan")
        return real(*a, **kw)

    monkeypatch.setattr(memplan, "choose_placement", spy)
    cfg = get_config("qwen-image-edit")
    # 38 GiB of bf16 weights on a 6 GiB card: neither fits with the encoder
    with pytest.raises(Loading):
        convert.load_converted(ckpt, cfg, backend="qwen-image-edit",
                               device="cuda:0")
    assert order == ["plan", "load"]
    line, = [x for x in capsys.readouterr().err.splitlines()
             if "placement" in x]
    assert line.startswith("[load] prompt encoder placement: host ")
    assert convert.auto_placement(ckpt, cfg, "qwen-image-edit",
                                  "cpu") == "card"


def test_embeddings_equal_under_every_placement(ckpt):
    te = str(ckpt / "text_encoder")
    outs = []
    for placement in tte.PLACEMENTS:
        enc = tte.QwenVLPromptEncoder(te, template=tte.QWEN_EDIT_TEMPLATE,
                                      device="cpu", placement=placement)
        assert enc.placement == "host" and enc.device.type == "cpu"
        outs.append(enc.encode("add a bird", image=[IMG]))
    for emb, _, mask in outs[1:]:
        np.testing.assert_array_equal(emb, outs[0][0])
        np.testing.assert_array_equal(mask, outs[0][2])
    with pytest.raises(ValueError, match="placement"):
        tte.QwenVLPromptEncoder(te, template=tte.QWEN_EDIT_TEMPLATE,
                                device="cpu", placement="gpu")


class _Offloaded:
    """A stand-in encoder with the offload interface: counts its copies to
    the device and the encodes inside them; records its busy intervals."""
    placement = "offload"

    def __init__(self, dim):
        self.mock = tte.MockTextEncoder(dim, max_length=8)
        self.entries, self.inside, self.depth = 0, 0, 0
        self.busy = []

    @contextlib.contextmanager
    def on_device(self):
        self.entries += self.depth == 0
        self.depth += 1
        t = time.perf_counter()
        try:
            yield
        finally:
            self.depth -= 1
            self.busy.append((t, time.perf_counter()))

    def encode(self, prompt, image=None):
        with self.on_device():
            self.inside += self.depth > 1
            time.sleep(0.02)
            return self.mock.encode(prompt, image)


def _qwen_pipe():
    from regione_tpu_torch.core.config import RegionEParams
    from regione_tpu_torch.models.vae import VAEConfig
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.weights.from_jax import (init_params,
                                                    init_vae_params)
    cfg = get_config("tiny-qwen")
    pipe = QwenImageEditPipeline(
        init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
        RegionEParams(threshold=0.0, capacity_granularity=8))
    pipe.attach_vae(init_vae_params(
        VAEConfig(block_out_channels=(8, 16), latent_channels=2,
                  norm_num_groups=4, layers_per_block=1),
        torch.Generator().manual_seed(1), "cpu"))
    return pipe.attach_text_encoder(_Offloaded(cfg.txt_in_dim))


def test_offloaded_encoder_is_brought_once_and_never_beside_a_denoise():
    from regione_tpu_torch.pipelines.serve import EditRequest, EditService
    pipe = _qwen_pipe()
    enc = pipe.text_encoder
    pipe.prepare_inputs(IMG[:32, :32], "add a bird", width=32, height=32)
    assert pipe.do_cfg and enc.entries == 1 and enc.inside == 2
    denoise = []
    edit = pipe.edit_latents

    def timed_edit(*a, **kw):
        t = time.perf_counter()
        out = edit(*a, **kw)
        denoise.append((t, time.perf_counter()))
        return out

    pipe.edit_latents = timed_edit
    enc.busy.clear()
    EditService(pipe).run([EditRequest(image=IMG[:32, :32], prompt=f"p{i}",
                                       width=32, height=32, seed=i)
                           for i in range(3)])
    assert len(denoise) == 3
    for a0, a1 in enc.busy:
        for b0, b1 in denoise:
            assert a1 <= b0 or b1 <= a0, "an encode overlapped a denoise"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the placements move the encoder "
                    "to and from the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_placements_on_the_card(ckpt, card):
    """Offloaded and resident against the fp32 CPU encoder (TF32 off), the
    offloaded one off the card after its encode; each encode's peak."""
    te = str(ckpt / "text_encoder")
    want = tte.QwenVLPromptEncoder(te, template=tte.QWEN_EDIT_TEMPLATE,
                                   device="cpu").encode("add a bird",
                                                        image=[IMG])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    peaks = {}
    try:
        for placement in ("offload", "card"):
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(card)
            enc = tte.QwenVLPromptEncoder(
                te, template=tte.QWEN_EDIT_TEMPLATE, device=card,
                placement=placement)
            resident = torch.cuda.memory_allocated(card) - base
            got = enc.encode("add a bird", image=[IMG])
            err = np.abs(got[0] - want[0]).max() / np.abs(want[0]).max()
            assert err <= 1e-4
            np.testing.assert_array_equal(got[2], want[2])
            devs = {t.device.type for t in enc.model.parameters()}
            assert devs == ({"cpu"} if placement == "offload" else {"cuda"})
            assert (resident == 0) == (placement == "offload")
            assert placement == "card" or enc.copy_s > 0
            peaks[placement] = resident
            del enc
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert peaks["offload"] < peaks["card"]


def test_placements_default_to_the_card_for_a_direct_build():
    for fn in (tte.QwenVLPromptEncoder.__init__,
               tte.FluxPromptEncoder.__init__, tte.encoder_from_checkpoint):
        assert inspect.signature(fn).parameters["placement"].default == \
            "card"
