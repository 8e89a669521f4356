"""VIEScore semantic evaluation harness (GPT-4.1 / local VLM backbones).

The port's copy of `regione_tpu/eval/viescore.py` (the reference's
evaluation/GEdit-Bench stack):
  * SC (semantic consistency) + PQ (perceptual quality) prompting and the
    overall score O = sqrt(min(SC) * min(PQ))   (viescore/__init__.py:91-95)
  * threaded runner with linear-backoff retry    (run_gedit_score.py:24-61)
  * per-task CSV with resume-by-existing-file    (run_gedit_score.py:109-115)
  * statistics aggregator                        (calculate_statistics.py:11-72)

Prompts are written to the VIEScore recipe (Ku et al., 2023) rather than
copied verbatim from the reference's vie_prompts.py.  The OpenAI-compatible
client reads keys from a key file and rotates on auth/rate errors
(mllm_tools/openai.py:84-93,159-171).  Without API access,
`DryRunBackbone` returns deterministic pseudo-scores so the plumbing stays
testable.  The local judges (`LocalVLMBackbone`, `MiniCPMVBackbone`) run
on `device`, the card by default; a CUDA device with no card raises.
"""

from __future__ import annotations

import csv
import json
import math
import re
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_SC_PROMPT = (
    "You are a professional digital artist evaluating an AI-edited image.\n"
    "RULES: two images are given — the first is the original, the second is "
    "the edited result. The editing instruction is: {instruction}\n"
    "On a scale of 0 to 10, rate (1) how well the edit follows the "
    "instruction and (2) the degree to which the rest of the image was "
    "preserved (over-editing scores low).\n"
    'Answer with JSON only: {{"score": [score1, score2], "reasoning": "..."}}'
)

_PQ_PROMPT = (
    "You are a professional digital artist judging an AI-generated image.\n"
    "On a scale of 0 to 10, rate (1) how natural the image looks and (2) "
    "how free it is of artifacts (distortions, duplicated or broken "
    "structures, blur, watermarks).\n"
    'Answer with JSON only: {"score": [score1, score2], "reasoning": "..."}'
)  # sent verbatim (no .format pass), so the braces are literal


# Delimiter some judge prompts ask the model to wrap its JSON in
# (reference viescore/utils.py mllm_output_to_dict, :165).
_DELIM = "||V^=^V||"


def _coerce_score_list(raw, n_expected: int | None) -> list[float] | None:
    """Validate a candidate score value: numeric list (or scalar), every
    entry in [0, 10] after clamping, and — when the prompt asked for a known
    number of scores — the right length.  Returns floats or None."""
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        raw = [raw]
    if not isinstance(raw, list) or not raw:
        return None
    out = []
    for x in raw:
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            return None
        if not math.isfinite(x):
            # json.loads accepts NaN/Infinity literals; NaN passes every
            # range comparison and would poison the task means
            return None
        if x < 0 or x > 10:
            # tolerate mild float spill (10.0000001) but reject scale text
            # artifacts like 100; clamp the rest
            if x < -0.5 or x > 10.5:
                return None
            x = min(max(float(x), 0.0), 10.0)
        out.append(float(x))
    if n_expected is not None and len(out) != n_expected:
        return None
    return out


def _fix_json(s: str) -> str:
    """Best-effort repair of near-JSON judge replies: quote bare keys and
    bare string values (reference utils.py fix_json behavior)."""
    s = re.sub(r"([{,]\s*)([A-Za-z_]\w*)\s*:", r'\1"\2":', s)
    s = re.sub(r"(\"\w+\"\s*:\s*)'([^']*)'", r'\1"\2"', s)  # single quotes
    s = re.sub(r"(:\s*)([A-Za-z_][\w .!?'-]*?)(\s*[,}])",   # bare word values
               r'\1"\2"\3', s)
    s = re.sub(r",\s*([}\]])", r"\1", s)                    # trailing commas
    return s


def parse_scores(text: str, n_expected: int | None = None
                 ) -> list[float] | None:
    """Extract a validated score list from a (possibly sloppy) judge reply.

    Matches the reference's mllm_output_to_dict acceptance set
    (evaluation/GEdit-Bench/viescore/utils.py:154-235): delimiter-wrapped or
    bare JSON with a "score" field (with a quote-bare-keys repair pass),
    a bare ``[n, m]`` list, or a bare integer — each validated to numeric
    entries in [0, 10] (and to ``n_expected`` entries when given).  Returns
    None on anything else; notably there is NO grab-any-number fallback, so
    prose like "On a scale of 0 to 10..." does not parse as [0.0, 10.0].
    """
    text = text.strip()
    if text.count(_DELIM) == 2:
        lo = text.find(_DELIM) + len(_DELIM)
        hi = text.rfind(_DELIM)
        text = text[lo:hi].strip()

    # JSON object: first '{' .. last '}'
    lo, hi = text.find("{"), text.rfind("}") + 1
    if lo != -1 and hi > lo:
        blob_str = text[lo:hi].replace("\n", " ")
        for candidate in (blob_str, _fix_json(blob_str)):
            try:
                blob = json.loads(candidate)
            except json.JSONDecodeError:
                continue
            if isinstance(blob, dict):
                got = _coerce_score_list(blob.get("score"), n_expected)
                if got is not None:
                    return got
        return None

    # bare list: first '[' .. last ']'
    lo, hi = text.find("["), text.rfind("]") + 1
    if lo != -1 and hi > lo:
        try:
            return _coerce_score_list(json.loads(text[lo:hi]), n_expected)
        except json.JSONDecodeError:
            return None

    # whole reply is a single number
    try:
        return _coerce_score_list(float(text), n_expected)
    except ValueError:
        return None


class DryRunBackbone:
    """Deterministic pseudo-scorer for plumbing tests / no-API environments."""

    def get_parsed_output(self, prompt: str, images: list) -> str:
        seed = abs(hash(prompt)) % 1000 / 1000
        return json.dumps({"score": [round(5 + 4 * seed, 1),
                                     round(5 + 3 * (1 - seed), 1)],
                           "reasoning": "dry-run"})


class OpenAIBackbone:
    """GPT-4.1 via the OpenAI API with key rotation on failures
    (reference mllm_tools/openai.py)."""

    def __init__(self, key_path: str, model_name: str = "gpt-4.1",
                 base_url: str | None = None):
        keys = [k.strip() for k in open(key_path) if k.strip()]
        assert keys, f"no API keys in {key_path}"
        self.keys = keys
        self.key_idx = 0
        self.model_name = model_name
        self.base_url = base_url

    def _client(self):
        from openai import OpenAI  # optional dep
        return OpenAI(api_key=self.keys[self.key_idx], base_url=self.base_url)

    def get_parsed_output(self, prompt: str, images: list) -> str:
        import base64
        import io
        from PIL import Image
        content = [{"type": "text", "text": prompt}]
        for img in images:
            buf = io.BytesIO()
            Image.fromarray(np.asarray(img)).save(buf, format="PNG")
            b64 = base64.b64encode(buf.getvalue()).decode()
            content.append({"type": "image_url",
                            "image_url": {"url": f"data:image/png;base64,{b64}"}})
        try:
            resp = self._client().chat.completions.create(
                model=self.model_name,
                messages=[{"role": "user", "content": content}],
                max_tokens=400)
            return resp.choices[0].message.content or ""
        except Exception:
            self.key_idx = (self.key_idx + 1) % len(self.keys)  # rotate
            raise


class GeminiBackbone:
    """Gemini judge via the Google AI SDK (reference
    mllm_tools/gemini.py: configures genai from an API key, uploads PIL
    images, prompts with [media..., text]).  The SDK is an optional dep —
    imported lazily so environments without it can still use the other
    backbones."""

    def __init__(self, api_key: str | None = None,
                 model_name: str = "gemini-1.5-pro"):
        import os
        self.api_key = api_key or os.environ.get("GEMINI_API_KEY")
        assert self.api_key, "GeminiBackbone needs an API key " \
            "(arg or $GEMINI_API_KEY)"
        self.model_name = model_name
        self._model = None

    def _get_model(self):
        if self._model is None:
            import google.generativeai as genai  # optional dep
            genai.configure(api_key=self.api_key)
            self._model = genai.GenerativeModel(self.model_name)
        return self._model

    def get_parsed_output(self, prompt: str, images: list) -> str:
        from PIL import Image
        pil = [Image.fromarray(np.asarray(im)) for im in images]
        # the SDK accepts PIL images inline in the content list
        resp = self._get_model().generate_content(pil + [prompt])
        try:
            return resp.text or ""
        except ValueError:
            # .text raises on safety-blocked / empty-candidate responses;
            # surface it as an unparseable reply ("") so the caller's
            # bounded parse-retry + flagged-guess policy applies instead of
            # the infinite transport-retry loop
            return ""


def _vl_model_class(model_path: str):
    """The generation class of a local VLM checkpoint: the Qwen2.5-VL /
    Qwen2-VL classes the port's `QwenVLPromptEncoder` loads, by the
    checkpoint's model_type; any other judge (idefics2, mantis) through
    transformers' image-text-to-text auto class (`AutoModelForVision2Seq`
    before transformers 5)."""
    from transformers import AutoConfig
    model_type = str(getattr(AutoConfig.from_pretrained(model_path),
                             "model_type", ""))
    if model_type in ("qwen2_5_vl", "qwen2_vl"):
        try:
            from transformers import Qwen2_5_VLForConditionalGeneration as VL
        except ImportError:  # older transformers naming
            from transformers import Qwen2VLForConditionalGeneration as VL
        return VL
    try:
        from transformers import AutoModelForImageTextToText as VL
    except ImportError:
        from transformers import AutoModelForVision2Seq as VL
    return VL


class LocalVLMBackbone:
    """Local vision-language judge via transformers on `device` (the card
    by default) — the reference's Qwen2.5-VL scoring path
    (mllm_tools/qwen25vl_eval.py).  Requires a locally available
    checkpoint.  fp32, the reference's choice."""

    def __init__(self, model_path: str, device: str = "cuda",
                 max_new_tokens: int = 400):
        import torch
        # load_vl_processor: AutoProcessor on Qwen2.5-VL checkpoints
        # hard-requires torchvision (video tower); the judge only sends
        # still images, so deployments without torchvision fall back to
        # the assembled image-processor + tokenizer + pad expansion
        from regione_tpu_torch.eval import resolve_device
        from regione_tpu_torch.models.text_encoders import load_vl_processor
        device = resolve_device(device)
        self.torch = torch
        self.processor = load_vl_processor(model_path)
        self.model = _vl_model_class(model_path).from_pretrained(
            model_path, dtype=torch.float32).to(device).eval()
        self.device = device
        self.max_new_tokens = max_new_tokens

    def get_parsed_output(self, prompt: str, images: list) -> str:
        from PIL import Image
        torch = self.torch
        pil = [Image.fromarray(np.asarray(im)) for im in images]
        content = [{"type": "image"} for _ in pil] + [
            {"type": "text", "text": prompt}]
        chat = self.processor.apply_chat_template(
            [{"role": "user", "content": content}],
            add_generation_prompt=True)
        inputs = self.processor(text=chat, images=pil,
                                return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = self.model.generate(**inputs,
                                      max_new_tokens=self.max_new_tokens)
        new_tokens = out[0][inputs["input_ids"].shape[1]:]
        return self.processor.decode(new_tokens, skip_special_tokens=True)


class MiniCPMVBackbone:
    """MiniCPM-V judge via the model's own ``chat`` API (reference
    mllm_tools/minicpmv_eval.py: AutoModel with trust_remote_code +
    ``model.chat(image=None, msgs=..., sampling=False)``).  Differs from
    LocalVLMBackbone because MiniCPM-V does not route through
    AutoModelForVision2Seq/generate."""

    def __init__(self, model_path: str = "openbmb/MiniCPM-Llama3-V-2_5",
                 device: str = "cuda"):
        import torch
        from transformers import AutoModel, AutoTokenizer

        from regione_tpu_torch.eval import resolve_device
        device = resolve_device(device)
        self.model = AutoModel.from_pretrained(
            model_path, trust_remote_code=True,
            dtype=torch.float32).to(device).eval()
        self.tokenizer = AutoTokenizer.from_pretrained(
            model_path, trust_remote_code=True)

    def get_parsed_output(self, prompt: str, images: list) -> str:
        from PIL import Image
        pil = [Image.fromarray(np.asarray(im)) for im in images]
        msgs = [{"role": "user",
                 "content": [{"type": "image"}] * len(pil)
                 + [{"type": "text", "text": prompt}]}]
        return self.model.chat(image=pil[0] if pil else None, msgs=msgs,
                               tokenizer=self.tokenizer, sampling=False)


# Local-judge model zoo: reference backbone name -> default checkpoint id
# (mllm_tools/{idefics2,mantis_idefics2,minicpmv,qwen25vl}_eval.py).  The
# ids are only defaults — the checkpoints are read from local disk, so
# callers pass a local --vlm_path; idefics2/mantis/qwen25vl all speak the
# AutoProcessor + AutoModelForVision2Seq chat-template protocol that
# LocalVLMBackbone implements, minicpmv needs the chat-API variant.
LOCAL_JUDGE_DEFAULTS = {
    "idefics2": "HuggingFaceM4/idefics2-8b",
    "mantis": "TIGER-Lab/Mantis-8B-Idefics2",
    "qwen25vl": "Qwen/Qwen2.5-VL-7B-Instruct",
    "minicpmv": "openbmb/MiniCPM-Llama3-V-2_5",
}


def make_backbone(name: str, key_path: str | None = None,
                  model_name: str | None = None,
                  vlm_path: str | None = None, device: str = "cuda",
                  max_new_tokens: int = 400):
    """Backbone factory matching the reference's dispatch table
    (viescore/__init__.py:18-40): gpt4o/gpt4v (OpenAI), gemini,
    idefics2/mantis/qwen25vl (vision2seq local VLMs), minicpmv (chat-API
    local VLM), plus this repo's dryrun plumbing backbone."""
    if name in ("gpt4o", "gpt4v"):
        assert key_path, f"--key_path required for the {name} backbone"
        default = "gpt-4.1" if name == "gpt4o" else "gpt-4-vision-preview"
        return OpenAIBackbone(key_path, model_name or default)
    if name == "gemini":
        key = open(key_path).read().split()[0] if key_path else None
        # honor ANY explicit --model_name (e.g. "models/gemini-1.5-pro",
        # "tunedModels/..."); never silently substitute the default
        return GeminiBackbone(api_key=key,
                              model_name=model_name or "gemini-1.5-pro")
    if name == "minicpmv":
        return MiniCPMVBackbone(
            vlm_path or LOCAL_JUDGE_DEFAULTS[name], device=device)
    if name in LOCAL_JUDGE_DEFAULTS:
        return LocalVLMBackbone(
            vlm_path or LOCAL_JUDGE_DEFAULTS[name], device=device,
            max_new_tokens=max_new_tokens)
    if name == "dryrun":
        return DryRunBackbone()
    raise ValueError(f"unknown VIEScore backbone: {name}")


class VIEScore:
    """SC/PQ/O scoring of one (source, edited, instruction) triple
    (reference viescore/__init__.py:10-101)."""

    def __init__(self, backbone):
        self.backbone = backbone

    def evaluate(self, images: list, instruction: str,
                 give_up_parsing: bool = False) -> dict:
        """Score one triple.  Raises ValueError on an unparseable judge
        reply so the caller's retry loop re-queries (the reference returns
        False and retries, run_gedit_score.py:133-154); with
        ``give_up_parsing`` a neutral mid-scale guess is substituted instead
        (reference utils.py:186-193 guesses randomly; we use a fixed 5 so
        reruns are reproducible) and flagged in the result."""
        src, edited = images
        sc_raw = self.backbone.get_parsed_output(
            _SC_PROMPT.format(instruction=instruction), [src, edited])
        pq_raw = self.backbone.get_parsed_output(_PQ_PROMPT, [edited])
        sc = parse_scores(sc_raw, n_expected=2)
        pq = parse_scores(pq_raw, n_expected=2)
        guessed = False
        if sc is None or pq is None:
            if not give_up_parsing:
                raise ValueError(
                    f"unparseable judge reply: sc={sc_raw!r} pq={pq_raw!r}")
            sc = sc if sc is not None else [5.0, 5.0]
            pq = pq if pq is not None else [5.0, 5.0]
            guessed = True
        o = math.sqrt(min(sc) * min(pq))
        return {"sc": min(sc), "pq": min(pq), "o": o,
                "sc_raw": sc, "pq_raw": pq, "guessed": guessed}


def process_with_retry(fn, *args, max_tries: int = 10000,
                       backoff: float = 1.0, no_retry: tuple = (), **kw):
    """Linear-backoff retry loop (reference run_gedit_score.py:31-61).
    Exception types in ``no_retry`` propagate immediately so the caller can
    apply a different policy (e.g. re-query on parse failure)."""
    for attempt in range(max_tries):
        try:
            return fn(*args, **kw)
        except (ImportError, KeyboardInterrupt) + tuple(no_retry):
            # a missing optional SDK is not transient — retrying it 10000
            # times just hangs the sweep
            raise
        except Exception:
            if attempt == max_tries - 1:
                raise
            time.sleep(min(backoff * (attempt + 1), 30.0))


def run_task(scorer: VIEScore, task_dir: str, gen_dir: str, out_csv: str,
             workers: int = 6, parse_tries: int = 5) -> list[dict]:
    """Score one task dir; resumes (skips) if out_csv exists
    (reference run_gedit_score.py:109-115, 133-154)."""
    out_path = Path(out_csv)
    if out_path.exists():
        return list(csv.DictReader(open(out_path)))
    from PIL import Image
    from regione_tpu_torch.utils.metadata import item_key, resolve_item
    meta = {}
    for line in open(Path(task_dir) / "metadata.jsonl"):
        item = json.loads(line)
        # schema resolution shared with the CLI (either metadata
        # schema; fails loud on a missing prompt instead of silently
        # scoring against an empty instruction)
        path, prompt = resolve_item(item, img_dir=Path(task_dir) / "img")
        meta[item_key(item, path)] = (item, path, prompt)

    def one(key):
        item, path, prompt = meta[key]
        src = np.asarray(Image.open(path).convert("RGB"))
        edited = np.asarray(Image.open(
            Path(gen_dir) / f"{key}.png").convert("RGB"))
        # parse failures (ValueError) get parse_tries fresh queries then a
        # flagged neutral guess (reference give_up_parsing, utils.py:186-193);
        # transport/API errors keep the long linear-backoff retry
        # (run_gedit_score.py:31-61)
        for _ in range(parse_tries):
            try:
                r = process_with_retry(scorer.evaluate, [src, edited],
                                       prompt, no_retry=(ValueError,))
                break
            except ValueError:
                continue
        else:
            r = process_with_retry(scorer.evaluate, [src, edited],
                                   prompt, give_up_parsing=True)
        return {"key": key, "edited_image": f"{key}.png",
                "instruction": prompt,
                "sementics_score": r["sc"], "quality_score": r["pq"],
                "instruction_language": item.get("instruction_language",
                                                 "en"),
                "sc": r["sc"], "pq": r["pq"], "o": r["o"],
                "guessed": int(r["guessed"])}

    keys = [k for k in meta if (Path(gen_dir) / f"{k}.png").exists()]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        rows = list(ex.map(one, keys))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", newline="") as fh:
        # reference column schema first (run_gedit_score.py:161 — incl.
        # the reference's 'sementics_score' spelling, which
        # calculate_statistics.py:31 indexes verbatim) so the reference
        # stats script runs unchanged on our CSVs; 'o'/'guessed' are our
        # extra columns (ignored by name-based readers)
        w = csv.DictWriter(
            fh, fieldnames=["key", "edited_image", "instruction",
                            "sementics_score", "quality_score",
                            "instruction_language", "o", "guessed"],
            extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)
    return rows


def _row_scores(r: dict) -> tuple[float, float, float]:
    """(sc, pq, o) from a CSV row in either schema: ours (sc/pq/o) or
    the reference's (sementics_score/quality_score,
    run_gedit_score.py:161); o recomputed as sqrt(sc*pq) when absent
    (calculate_statistics.py:39)."""
    sc = r.get("sc", r.get("sementics_score"))
    pq = r.get("pq", r.get("quality_score"))
    if sc is None or pq is None:
        raise ValueError(f"score row has neither sc/pq nor "
                         f"sementics_score/quality_score: {sorted(r)}")
    sc, pq = float(sc), float(pq)
    o = float(r["o"]) if r.get("o") not in (None, "") \
        else math.sqrt(sc * pq)
    return sc, pq, o


def analyze_scores(csv_paths: list[str], language: str | None = "en") -> dict:
    """Per-task and overall SC/PQ/O means
    (reference calculate_statistics.py:11-72).  Reads our CSVs AND
    reference-produced ones (column fallback per ``_row_scores``);
    rows carrying an ``instruction_language`` are filtered to
    ``language`` the way the reference does (calculate_statistics.py:34;
    pass None to keep every row).

    ``overall`` is row-weighted (every image counts equally);
    ``overall_task_mean`` is the reference's headline convention — the
    unweighted mean over task means (calculate_statistics.py:55-71, the
    number written to ``*_voe_score_merged.txt``)."""
    per_task, all_rows = {}, []
    for p in csv_paths:
        rows = list(csv.DictReader(open(p)))
        if language is not None:
            rows = [r for r in rows
                    if r.get("instruction_language") in (None, language)]
        if not rows:
            continue
        scored = [_row_scores(r) for r in rows]
        stats = {k: float(np.mean([s[i] for s in scored]))
                 for i, k in enumerate(("sc", "pq", "o"))}
        per_task[Path(p).parent.name] = {**stats, "n": len(rows)}
        all_rows += scored
    overall = ({k: float(np.mean([s[i] for s in all_rows]))
                for i, k in enumerate(("sc", "pq", "o"))} if all_rows else {})
    task_mean = ({k: float(np.mean([t[k] for t in per_task.values()]))
                  for k in ("sc", "pq", "o")} if per_task else {})
    return {"per_task": per_task, "overall": overall,
            "overall_task_mean": task_mean, "n": len(all_rows)}


def write_score_artifacts(csv_paths: list[str], out_root: str,
                          backbone: str,
                          language: str | None = "en") -> dict:
    """Persist the reference's score artifacts
    (calculate_statistics.py:105-114): per-task
    ``<task>/{backbone}_voe_score_mean.txt`` ("sc, pq, o" to 3 dp) and
    ``{backbone}_voe_score_merged.txt`` at the root ("Average: sc, pq, o"
    over task means).  ``language`` threads to ``analyze_scores`` (pass
    the run's instruction language, or None to keep every row — a "cn"
    sweep scored with the default "en" filter would otherwise silently
    produce empty statistics).  Returns the analyze_scores dict."""
    stats = analyze_scores(csv_paths, language=language)
    for task, t in stats["per_task"].items():
        p = Path(out_root) / task / f"{backbone}_voe_score_mean.txt"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(f"{t['sc']:.3f}, {t['pq']:.3f}, {t['o']:.3f}")
    if stats["overall_task_mean"]:
        m = stats["overall_task_mean"]
        (Path(out_root) / f"{backbone}_voe_score_merged.txt").write_text(
            f"Average: {m['sc']:.3f}, {m['pq']:.3f}, {m['o']:.3f}")
    return stats
