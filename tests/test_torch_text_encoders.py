"""The port's prompt encoders (`models.text_encoders`, `weights.tiny_vl`)
against the JAX package's, on the CPU.

Both run `transformers` in PyTorch, so the results are exact: the
templates, the prefix-drop index and `drop_and_repad` equal JAX's, and
`QwenVLPromptEncoder` on one synthetic Qwen2.5-VL checkpoint (the port's
`tiny_vl`, the same bits as the JAX package's for the same seed) gives
JAX's embeddings and masks, alone, through `encoder_from_checkpoint` and
through `load_converted` with a text_encoder/ beside the weights.  The
port's encoders default to `cuda`.
"""

import inspect

import numpy as np
import pytest
import torch

import regione_tpu.models.text_encoders as jte
import regione_tpu_torch.models.text_encoders as tte
from regione_tpu.weights import tiny_vl as j_tiny_vl
from regione_tpu_torch.weights import tiny_vl
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")

HIDDEN = 16     # the tiny presets' txt_in_dim
IMG = (np.random.default_rng(7).random((64, 64, 3)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("vl")
    tiny_vl.build_checkpoint(str(root), hidden=HIDDEN)
    return root


def test_templates_and_constants_equal_jax():
    for name in ("QWEN_EDIT_SYSTEM", "QWEN_EDIT_TEMPLATE",
                 "QWEN_EDIT_PLUS_IMG", "QWEN_EDIT_PLUS_TEMPLATE",
                 "QWEN_EDIT_DROP_IDX", "_USER_TURN_MARKER"):
        assert getattr(tte, name) == getattr(jte, name), name
    assert tiny_vl.SPECIAL_TOKENS == j_tiny_vl.SPECIAL_TOKENS
    assert tiny_vl._CORPUS == j_tiny_vl._CORPUS


@pytest.mark.parametrize("drop", [0, 3, 5, 20])
def test_drop_and_repad_equals_jax(drop):
    rng = np.random.default_rng(drop)
    hidden = rng.standard_normal((3, 16, 4)).astype(np.float32)
    mask = np.zeros((3, 16), np.int64)
    for b, n in enumerate((12, 9, 16)):
        mask[b, :n] = 1
    got, got_mask = tte.drop_and_repad(hidden, mask, drop)
    want, want_mask = jte.drop_and_repad(hidden, mask, drop)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)


def test_drop_idx_derivation_equals_jax(ckpt):
    tok = tte.load_vl_processor(str(ckpt / "text_encoder")).tokenizer
    for template in (tte.QWEN_EDIT_TEMPLATE, tte.QWEN_EDIT_PLUS_TEMPLATE):
        assert tte._derive_drop_idx(tok, template) == \
            jte._derive_drop_idx(tok, template)
    with pytest.raises(ValueError, match="user turn marker"):
        tte._derive_drop_idx(tok, "no marker {}")


def test_tiny_vl_checkpoint_equals_jax(ckpt, tmp_path):
    """Same seed, same bits: the port's `build_checkpoint` writes the
    model the JAX package's writes."""
    from transformers import Qwen2_5_VLForConditionalGeneration as VL
    j_tiny_vl.build_checkpoint(str(tmp_path), hidden=HIDDEN)
    a = VL.from_pretrained(str(ckpt / "text_encoder")).state_dict()
    b = VL.from_pretrained(str(tmp_path / "text_encoder")).state_dict()
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("variant,images", [
    ("qwen-image-edit", []), ("qwen-image-edit", [IMG]),
    ("qwen-image-edit-plus", [IMG, 255 - IMG]), ("step1x-edit", [IMG])])
def test_qwen_vl_encoder_equals_jax(ckpt, variant, images):
    te = str(ckpt / "text_encoder")
    template = (tte.QWEN_EDIT_PLUS_TEMPLATE
                if variant == "qwen-image-edit-plus"
                else tte.QWEN_EDIT_TEMPLATE)
    port = tte.QwenVLPromptEncoder(te, variant=variant, template=template,
                                   device="cpu")
    ref = jte.QwenVLPromptEncoder(te, variant=variant, template=template)
    assert port.drop_idx == ref.drop_idx
    prompt = "turn the summer day into a winter scene"
    got = port.encode(prompt, image=images or None)
    want = ref.encode(prompt, image=images or None)
    assert got[1] is None and want[1] is None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape[2] == HIDDEN and got[0].dtype == np.float32


def test_encoder_from_checkpoint_and_load_converted_equal_jax(ckpt,
                                                              tmp_path):
    """The `--model_path` layout: text_encoder/ beside transformer/ and
    vae/; `load_converted(backend=...)` builds the backend's recipe."""
    from tests.test_torch_convert import _diffusers_state, _kl_vae, \
        _write_shards
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.weights.convert import load_converted

    port = tte.encoder_from_checkpoint(ckpt, "qwen-image-edit", device="cpu")
    ref = jte.encoder_from_checkpoint(ckpt, "qwen-image-edit")
    got, want = port.encode("add a bird", IMG), ref.encode("add a bird", IMG)
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(KeyError):
        tte.encoder_from_checkpoint(ckpt, "nope", device="cpu")
    with pytest.raises(FileNotFoundError, match="text_encoder_2"):
        tte.encoder_from_checkpoint(ckpt, "flux-kontext", device="cpu")

    root = tmp_path / "ck"
    _write_shards(root / "transformer", _diffusers_state("tiny-qwen",
                                                         "qwen"))
    _kl_vae(root)
    (root / "text_encoder").symlink_to(ckpt / "text_encoder")
    *_, enc = load_converted(root, get_config("tiny-qwen"),
                             backend="qwen-image-edit", device="cpu")
    assert isinstance(enc, tte.QwenVLPromptEncoder)
    np.testing.assert_array_equal(enc.encode("add a bird", IMG)[0], want[0])


def test_hf_text_encoder_equals_jax(ckpt):
    te = str(ckpt / "text_encoder")
    got = tte.HFTextEncoder(te, max_length=24, device="cpu").encode("a bird")
    want = jte.HFTextEncoder(te, max_length=24).encode("a bird")
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def test_real_encoders_default_to_the_card():
    for fn in (tte.QwenVLPromptEncoder.__init__,
               tte.FluxPromptEncoder.__init__, tte.HFTextEncoder.__init__,
               tte.encoder_from_checkpoint):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(KeyError):
        tte.encoder_for_backend("nope")
