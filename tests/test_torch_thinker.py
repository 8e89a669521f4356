"""The port's v1.2 thinker (`regione_tpu_torch.pipelines.thinker`) against
the JAX package's (`regione_tpu.pipelines.thinker`).

  * `_lenient_scores` and `VLMThinker.reflect` over a corpus of prose,
    JSON and tagged replies: equal results entry by entry;
  * `edit_with_reflection` with a scripted VLM (a fixed list of replies) on
    the tiny Step1X v1.2 pipelines of both packages with the same numpy
    params and noise (tests/test_torch_image_pipeline.py's `make_pair`):
    the same try count, prompts, success flags and `best_info` exactly,
    the images within that file's bound (1e-3 in [0, 1]: one uint8 level);
  * the local Qwen2.5-VL thinker and judge on the CPU over the synthetic
    `weights.tiny_vl` checkpoint (as tests/test_encoder_vl_real.py): the
    port's greedy replies equal the JAX package's judge's;
  * on the card (`cuda`): the same local judge and thinker with the VLM on
    the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regione_tpu.eval import viescore as jvie
from regione_tpu.pipelines import thinker as jth
from regione_tpu_torch.eval import viescore as tvie
from regione_tpu_torch.pipelines import thinker as tth
from test_torch_image_pipeline import IMG, make_pair
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPLIES = [
    "I'd rate 8 and 9, nice work",
    "On a scale of 0 to 10: 7.5 then 6",
    "on a scale of 0-10 it is hard to say",
    "9/10 and 8/10",
    "Scores: 10. 4.",
    "v1.2 looks 3 and 11 and 5",
    "I'd rate 8 and 9. Looks faithful and clean.",
    '{"score": [8, 9]} <#Failure> <#Prompt> try harder',
    '{"score": [3, 4]} <#Failure> <#Prompt> add a LARGE red hat',
    '{"score": [8, 9]} <#Success>',
    '{"score": [6, 6]}',
    '{"score": [7, 7]} <#Prompt>   ',
    "nothing useful",
    "",
    "<#Success> but no scores",
]


def test_lenient_scores_and_reflect_match_the_jax_package():
    for reply in REPLIES:
        assert tth._lenient_scores(reply) == jth._lenient_scores(reply), reply
        got = tth.VLMThinker(lambda im, t: reply).reflect(None, None, "hat")
        want = jth.VLMThinker(lambda im, t: reply).reflect(None, None, "hat")
        assert got == want, reply
    assert tth._lenient_scores("I'd rate 8 and 9, nice work") == [8.0, 9.0]
    assert tth.VLMThinker(lambda im, t: "  ").think(None, "hat") == "hat"


def test_echo_thinker_and_try_info():
    e = tth.EchoThinker()
    assert e.think(None, "p") == "p"
    assert e.reflect(None, None, "p") == jth.EchoThinker().reflect(
        None, None, "p")
    t = tth.TryInfo(None, "p", False, [3.0, 9.0], [4.0])
    assert t.score == jth.TryInfo(None, "p", False, [3.0, 9.0], [4.0]).score
    assert t.score == 12.0 and tth.TryInfo(None, "p", True, [], [1.0]).score \
        == 0.0


SCRIPTS = {
    # think, then three failed reflections: the best-scored try wins
    "best_of_three": ["rewritten: add a red hat",
                      '{"score": [3, 4]} <#Failure> <#Prompt> add a LARGE '
                      'red hat',
                      "I'd rate 6 and 9. <#Failure> <#Prompt> a huge hat",
                      '{"score": [5, 5]} <#Failure>'],
    # no thinking; the second try succeeds
    "success_second": ['{"score": [2, 9]} <#Failure> <#Prompt> make it blue',
                       '{"score": [8, 9]} <#Success>'],
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_edit_with_reflection_matches_jax(script, monkeypatch):
    jpipe, tpipe, _ = make_pair("step1x-edit-v1p2")

    def jax_noise(seed, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jnp.float32)))
    monkeypatch.setattr(tpipe, "initial_latents", jax_noise)
    runs = {}
    for name, mod, pipe in (("jax", jth, jpipe), ("port", tth, tpipe)):
        replies = iter(SCRIPTS[script])
        calls = []

        def pipeline(image, prompt, **kw):
            calls.append((prompt, kw["seed"]))
            return pipe(image, prompt, **kw)

        best, info = mod.edit_with_reflection(
            pipeline, IMG, "add a hat",
            thinker=mod.VLMThinker(lambda images, text: next(replies)),
            enable_thinking=script == "best_of_three", max_try_cnt=3,
            seed=5, width=32, height=32)
        runs[name] = (best, info, calls)
    (jbest, jinfo, jcalls), (tbest, tinfo, tcalls) = runs["jax"], runs["port"]
    assert tcalls == jcalls and len(tcalls) == len(tinfo["images"])
    assert tinfo["best_info"] == jinfo["best_info"]
    assert tinfo["reformat_prompt"] == jinfo["reformat_prompt"]
    assert tinfo["think_info"] == jinfo["think_info"]
    assert tbest.dtype == np.uint8 and tbest.shape == (32, 32, 3)
    for got, want in zip(tinfo["images"] + [tbest],
                         jinfo["images"] + [jbest]):
        assert int(np.abs(got.astype(int) - np.asarray(want).astype(int))
                   .max()) <= 1
    if script == "best_of_three":
        assert [c[0] for c in tcalls] == ["rewritten: add a red hat",
                                          "add a LARGE red hat", "a huge hat"]
        assert tinfo["best_info"] == {"prompt": "add a LARGE red hat",
                                      "success": False, "score": 54.0}
    else:
        assert [c[1] for c in tcalls] == [5, 6]
        assert tinfo["best_info"]["success"] and len(tinfo["images"]) == 2


def test_reflection_off_is_one_plain_call():
    _, tpipe, _ = make_pair("step1x-edit-v1p2")
    best, info = tth.edit_with_reflection(
        tpipe, IMG, "add a hat", enable_thinking=False,
        enable_reflection=False, seed=2, width=32, height=32)
    plain, _ = tpipe(IMG, "add a hat", seed=2, width=32, height=32,
                     output_type="uint8")
    assert np.array_equal(best, plain) and len(info["images"]) == 1
    assert info["best_info"] == {"prompt": "add a hat", "success": True,
                                 "score": 100.0}


@pytest.fixture(scope="module")
def te_dir(tmp_path_factory):
    pytest.importorskip("transformers")
    from regione_tpu_torch.weights.tiny_vl import build_checkpoint
    return build_checkpoint(str(tmp_path_factory.mktemp("vl_ckpt")),
                            hidden=16)


VL_IMG = (np.random.default_rng(7).random((64, 64, 3)) * 255).astype(np.uint8)


def test_local_judge_matches_the_jax_package_s(te_dir):
    """The port's LocalVLMBackbone (the Qwen2.5-VL class, fp32) and the JAX
    package's (AutoModelForVision2Seq) on the same checkpoint: the same
    greedy reply; VIEScore's give-up path on the tiny model's garbage."""
    tb = tvie.LocalVLMBackbone(te_dir, device="cpu", max_new_tokens=8)
    jb = jvie.LocalVLMBackbone(te_dir, max_new_tokens=8)
    assert type(tb.model).__name__ == "Qwen2_5_VLForConditionalGeneration"
    assert tb.model.dtype == torch.float32
    prompt = tvie._SC_PROMPT.format(instruction="make it winter")
    got = tb.get_parsed_output(prompt, [VL_IMG, 255 - VL_IMG])
    assert got == jb.get_parsed_output(prompt, [VL_IMG, 255 - VL_IMG])
    res = tvie.VIEScore(tb).evaluate([VL_IMG, 255 - VL_IMG],
                                     "make it winter", give_up_parsing=True)
    assert set(res) >= {"sc", "pq", "o", "guessed"}
    assert 0.0 <= res["o"] <= 10.0


def test_local_vlm_thinker_reflection_loop(te_dir):
    """edit_with_reflection with the tiny Qwen2.5-VL behind VLMThinker on
    the CPU: think -> edit -> reflect -> select."""
    _, tpipe, _ = make_pair("step1x-edit-v1p2")
    thinker = tth.local_vlm_thinker(te_dir, device="cpu", max_new_tokens=8)
    best, info = tth.edit_with_reflection(
        tpipe, IMG, "add snow", thinker=thinker, max_try_cnt=2, seed=3,
        width=32, height=32)
    assert best.shape == (32, 32, 3) and best.dtype == np.uint8
    assert info["reformat_prompt"]
    assert 1 <= len(info["images"]) <= 2
    assert "score" in info["best_info"]


def test_local_vlm_defaults_to_the_card(te_dir, monkeypatch):
    """With no card the default device raises before the model loads."""
    import inspect
    assert inspect.signature(tth.local_vlm_thinker).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tth.local_vlm_thinker(te_dir)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tvie.make_backbone("qwen25vl", vlm_path=te_dir)


@pytest.mark.cuda
def test_local_judge_and_thinker_on_the_card(te_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the VLM on the card")
    bb = tvie.LocalVLMBackbone(te_dir, max_new_tokens=8)
    assert bb.model.device.type == "cuda"
    res = tvie.VIEScore(bb).evaluate([VL_IMG, 255 - VL_IMG], "make it winter",
                                     give_up_parsing=True)
    assert 0.0 <= res["o"] <= 10.0
    thinker = tth.local_vlm_thinker(te_dir, max_new_tokens=8)
    calls = []

    def pipeline(image, prompt, seed, output_type, **kw):
        calls.append(seed)
        return 255 - image, None

    best, info = tth.edit_with_reflection(pipeline, VL_IMG, "add snow",
                                          thinker=thinker, max_try_cnt=2)
    assert 1 <= len(info["images"]) == len(calls) <= 2
    assert best.shape == VL_IMG.shape
