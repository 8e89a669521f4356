"""Thinker / reflection outer loop (Step1X-Edit v1.2).

The port of `regione_tpu/pipelines/thinker.py`, the reference's optional
VLM-driven orchestration (RegionE/Step1XEditV1P2/inplace.py:195-212,
470-543):

  1. `think`   — rewrite the raw instruction into an executable edit prompt
                 before generation;
  2. generate  — run the (RegionE-accelerated) pipeline;
  3. `reflect` — judge the result; on failure produce a refined prompt and
                 retry, up to `max_try_cnt` times;
  4. select    — best try by `min(score1) * min(score2)`, success-flag
                 tiebreak (inplace.py:470-543).

Host-side Python around the pipeline call, as in the reference (the
thinker lives outside the denoise loop).  The VLM backend is pluggable;
`EchoThinker` is the no-VLM fallback (reference CLI hardcodes
thinking/reflection off, src/Step1X-Edit-v1p2/main.py:42-43);
`local_vlm_thinker` runs a local Qwen2.5-VL on the card by default.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable


@dataclasses.dataclass
class TryInfo:
    image: Any
    prompt: str
    success: bool
    score1: list[float]
    score2: list[float]

    @property
    def score(self) -> float:
        s1 = min(self.score1) if self.score1 else 0.0
        s2 = min(self.score2) if self.score2 else 0.0
        return s1 * s2


class EchoThinker:
    """No-op thinker: passes the prompt through and accepts every result."""

    def think(self, image, prompt: str) -> str:
        return prompt

    def reflect(self, image, edited, prompt: str):
        return True, prompt, [10.0], [10.0]


def _lenient_scores(reply: str) -> list[float] | None:
    """Fallback score extraction for prose VLM replies ("I'd rate 8 and 9"):
    first two standalone 0-10 numbers, with scale mentions ("0 to 10",
    "0-10") stripped first so they can't parse as scores.  The benchmark
    judge (eval/viescore.py) deliberately has NO such fallback; here a wrong
    score only reorders retry candidates, so leniency beats a 0.0 demotion."""
    txt = re.sub(r"\b0\s*(?:-|to)\s*10\b", "", reply)
    # "N/10" fractions: keep the numerator, drop the denominator so
    # "9/10 and 8/10" parses as [9, 8], not [9, 10]
    txt = re.sub(r"(?<=\d)\s*/\s*10\b", "", txt)
    # standalone numbers: not part of a word/decimal on the left, not
    # followed by more digits (a sentence-ending "9." still counts)
    nums = [float(m) for m in
            re.findall(r"(?<![\w.])(\d{1,2}(?:\.\d+)?)(?!\d)", txt)]
    nums = [n for n in nums if 0.0 <= n <= 10.0]
    return nums[:2] if len(nums) >= 2 else None


class VLMThinker:
    """Thinker backed by a callable VLM: fn(images, text) -> text.
    Prompt recipes follow the reference flow: rewrite, then judge+refine."""

    def __init__(self, vlm: Callable):
        self.vlm = vlm

    def think(self, image, prompt: str) -> str:
        out = self.vlm(
            [image],
            "Rewrite this image-editing instruction so it is precise and "
            f"directly executable, keeping its intent: {prompt}").strip()
        # a VLM that replies with nothing must not blank the edit prompt
        return out or prompt

    def reflect(self, image, edited, prompt: str):
        from regione_tpu_torch.eval.viescore import parse_scores
        reply = self.vlm(
            [image, edited],
            "The second image was produced from the first by the "
            f"instruction: {prompt}\n"
            "Rate instruction-following and preservation 0-10 each as "
            "JSON {\"score\": [a, b]}, state <#Success> or <#Failure>, and "
            "if failed, give a refined instruction after <#Prompt>.")
        scores = (parse_scores(reply) or _lenient_scores(reply)
                  or [0.0, 0.0])
        # an explicit failure tag overrides the score heuristic
        success = "<#Success>" in reply or (
            "<#Failure>" not in reply and min(scores) >= 7.0)
        new_prompt = prompt
        if "<#Prompt>" in reply:
            new_prompt = reply.split("<#Prompt>", 1)[1].strip() or prompt
        return success, new_prompt, scores[:1] or [0.0], scores[1:] or [0.0]


def local_vlm_thinker(model_path: str, device: str = "cuda",
                      max_new_tokens: int = 400) -> VLMThinker:
    """VLMThinker backed by a local Qwen2.5-VL checkpoint — the model
    family the reference's thinker loads (RegionE/Step1XEditV1P2/
    inplace.py:195-212) — via the same generation backbone the VIEScore
    judge uses, on `device` (the card by default)."""
    from regione_tpu_torch.eval.viescore import LocalVLMBackbone
    bb = LocalVLMBackbone(model_path, device=device,
                          max_new_tokens=max_new_tokens)
    return VLMThinker(lambda images, text: bb.get_parsed_output(text, images))


def edit_with_reflection(pipeline, image, prompt: str, *, thinker=None,
                         enable_thinking: bool = True,
                         enable_reflection: bool = True,
                         max_try_cnt: int = 3, seed: int = 0, **call_kw):
    """Full v1.2 outer loop around `pipeline(image, prompt, seed=,
    output_type="uint8", **call_kw)`.  Returns (best_image, info dict)
    where info mirrors the reference's images/final_images/
    reformat_prompt/think_info/best_info outputs (inplace.py:470-543)."""
    thinker = thinker or EchoThinker()
    reformat = thinker.think(image, prompt) if enable_thinking else prompt

    tries: list[TryInfo] = []
    cur_prompt = reformat
    for attempt in range(max(1, max_try_cnt)):
        out, _stats = pipeline(image, cur_prompt, seed=seed + attempt,
                               output_type="uint8", **call_kw)
        if not enable_reflection:
            tries.append(TryInfo(out, cur_prompt, True, [10.0], [10.0]))
            break
        ok, refined, s1, s2 = thinker.reflect(image, out, cur_prompt)
        tries.append(TryInfo(out, cur_prompt, ok, s1, s2))
        if ok:
            break
        cur_prompt = refined

    # best by min(score1)*min(score2), success tiebreak (reference :520-543)
    best = max(tries, key=lambda t: (t.score, t.success))
    info = {
        "images": [t.image for t in tries],
        "final_images": [best.image],
        "reformat_prompt": reformat,
        "think_info": [dataclasses.asdict(t) | {"image": None} for t in tries],
        "best_info": {"prompt": best.prompt, "success": best.success,
                      "score": best.score},
    }
    return best.image, info
