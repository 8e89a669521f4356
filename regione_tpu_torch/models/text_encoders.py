"""Prompt encoders of the port: the port's own copy of
`regione_tpu/models/text_encoders.py`.

The JAX package's encoders already run `transformers` in PyTorch; the port
keeps them as they are, except for where their models live (below):
  * `QwenVLPromptEncoder`: Qwen2.5-VL behind a chat template, the last
    hidden states with the template prefix dropped and each sequence
    re-padded (`drop_and_repad`); Qwen-Image-Edit, its Plus variant and
    Step1X-Edit (whose features then pass through the connector);
  * `FluxPromptEncoder`: T5-XXL sequence features and CLIP-L pooled ones;
  * `HFTextEncoder`: a generic `transformers` encoder;
  * `encoder_for_backend` / `encoder_from_checkpoint`: the backend's recipe
    from paths or from a diffusers-layout checkpoint directory;
  * `MockTextEncoder`: seeded pseudo-features (numpy, no checkpoint), equal
    to the JAX one for the same prompt and image.
The encoders load in fp32, the reference's choice, and each is placed by
`placement` (`PLACEMENTS`): "card" keeps it on `device` (default `cuda`)
for good; "offload" keeps it on the host (in pinned memory) and copies it
to `device` for each encode only, so it is off the card during the
denoise; "host" encodes on the CPU, as the JAX package does.  With a CPU
`device` every placement is "host".  `weights.convert.load_converted`
passes the placement `utils.memplan.choose_placement` picks.
`transformers` is imported only when a real encoder is built.

Interface: encode(prompt, image=None) -> (embeds [1, T, D] fp32, pooled
[1, P] fp32 | None, mask [1, T] bool), all numpy; encoding runs once per
prompt, before the denoise loop.
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import numpy as np

PLACEMENTS = ("card", "offload", "host")


class _Placed:
    """Where an encoder's models live (`placement`) and, under "offload",
    the copies to the card around an encode (`on_device`, re-entrant: the
    two CFG encodes of one `prepare_inputs` share one copy).  `copy_s`: the
    seconds of host -> card copies so far, each ended by a synchronize;
    the way back drops the card's tensors (the host keeps the master), so
    it copies nothing."""

    def _place(self, models, device, placement):
        import torch
        if placement not in PLACEMENTS:
            raise ValueError(f"placement {placement!r}, not one of "
                             f"{PLACEMENTS}")
        device = torch.device(device)
        if device.type == "cpu":
            placement = "host"
        self.placement, self._models = placement, models
        self.device = device if placement == "card" else torch.device("cpu")
        self._card, self._depth, self.copy_s = device, 0, 0.0
        pin = placement == "offload" and torch.cuda.is_available()
        for m in models:
            if placement == "card":
                m.to(device)
            else:
                for t in self._tensors(m):
                    t.data = t.data.to("cpu")
                    if pin:
                        t.data = t.data.pin_memory()
        self._host = [[t.data for t in self._tensors(m)] for m in models]

    @staticmethod
    def _tensors(model):
        return [*model.parameters(), *model.buffers()]

    @contextlib.contextmanager
    def on_device(self):
        """The models on the card for the block (offload), else as they
        are."""
        if self.placement != "offload" or self._depth:
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
            return
        import torch
        t = time.perf_counter()
        for m in self._models:
            for x in self._tensors(m):
                x.data = x.data.to(self._card, non_blocking=True)
        torch.cuda.synchronize(self._card)
        self.copy_s += time.perf_counter() - t
        self.device, self._depth = self._card, 1
        try:
            yield
        finally:
            for m, host in zip(self._models, self._host):
                for x, h in zip(self._tensors(m), host):
                    x.data = h
            self.device, self._depth = torch.device("cpu"), 0


class MockTextEncoder:
    """Deterministic pseudo-embeddings: same prompt -> same features."""

    def __init__(self, dim: int, pooled_dim: int | None = None,
                 max_length: int = 128):
        self.dim = dim
        self.pooled_dim = pooled_dim
        self.max_length = max_length

    def encode(self, prompt: str, image=None):
        h = hashlib.sha256(prompt.encode())
        if image is not None:
            # fold image content into the seed so image-conditioned prompts
            # produce image-dependent features (as the VL encoders do)
            imgs = image if isinstance(image, (list, tuple)) else [image]
            for im in imgs:
                h.update(np.ascontiguousarray(np.asarray(im)).tobytes())
        seed = int.from_bytes(h.digest()[:8], "little")
        rng = np.random.default_rng(seed)
        t = min(self.max_length, max(4, len(prompt.split()) + 2))
        emb = np.zeros((1, self.max_length, self.dim), np.float32)
        emb[:, :t] = rng.standard_normal((1, t, self.dim)).astype(np.float32)
        mask = np.zeros((1, self.max_length), bool)
        mask[:, :t] = True
        pooled = (rng.standard_normal((1, self.pooled_dim)).astype(np.float32)
                  if self.pooled_dim else None)
        return emb, pooled, mask


# ---------------------------------------------------------------------------
# Qwen2.5-VL chat-template recipe (Step1X-Edit, Qwen-Image-Edit, Plus)
# ---------------------------------------------------------------------------

# Templates transcribed from the diffusers pipelines the reference wraps
# (QwenImageEditPipeline.prompt_template_encode and the Plus variant; the
# Step1X-Edit diffusers port uses the same drop-prefix mechanism).  The
# `{}` slot receives the user instruction; `<|image_pad|>` expands to the
# reference image's vision tokens inside the processor.
QWEN_EDIT_SYSTEM = (
    "Describe the key features of the input image (color, shape, size, "
    "texture, objects, background), then explain how the user's text "
    "instruction should alter or modify the image. Generate a new image "
    "that meets the user's requirements while maintaining consistency "
    "with the original input where appropriate."
)
QWEN_EDIT_TEMPLATE = (
    "<|im_start|>system\n" + QWEN_EDIT_SYSTEM + "<|im_end|>\n"
    "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>"
    "{}<|im_end|>\n<|im_start|>assistant\n"
)
# Plus (2509) labels each reference image so multi-image edits can address
# them ("Picture 1 ...", diffusers QwenImageEditPlusPipeline).
QWEN_EDIT_PLUS_IMG = "Picture {i}: <|vision_start|><|image_pad|><|vision_end|>"
QWEN_EDIT_PLUS_TEMPLATE = (
    "<|im_start|>system\n" + QWEN_EDIT_SYSTEM + "<|im_end|>\n"
    "<|im_start|>user\n{imgs}{prompt}<|im_end|>\n<|im_start|>assistant\n"
)
# Number of template-prefix TOKENS to drop from the hidden states (the
# system/preamble region before the instruction content; diffusers
# prompt_template_encode_start_idx).  When a tokenizer is available the
# value is re-derived from the template itself (_derive_drop_idx) and
# asserted against this constant.
QWEN_EDIT_DROP_IDX = 64

# The dropped prefix ends where the user turn opens: everything before
# (and including) this marker is template preamble, everything after is
# user content (vision tokens + instruction).
_USER_TURN_MARKER = "<|im_start|>user\n"


def _derive_drop_idx(tokenizer, template: str) -> int:
    """Token length of the template preamble — the region diffusers drops
    from the hidden states via prompt_template_encode_start_idx.  Derived
    from the template text itself (prefix up to and including the
    `<|im_start|>user\\n` turn opener) so the hardcoded constant is checked
    against the real tokenizer instead of self-certified."""
    if _USER_TURN_MARKER not in template:
        raise ValueError(f"template has no user turn marker: {template!r}")
    prefix = template.split(_USER_TURN_MARKER)[0] + _USER_TURN_MARKER
    ids = tokenizer(prefix, add_special_tokens=False)["input_ids"]
    if ids and isinstance(ids[0], (list, tuple)):  # batched tokenizers
        ids = ids[0]
    return len(ids)


def drop_and_repad(hidden: "np.ndarray", mask: "np.ndarray",
                   drop_idx: int) -> tuple["np.ndarray", "np.ndarray"]:
    """Drop the first `drop_idx` template tokens, trim each sequence to its
    valid length and re-pad to the batch max — the exact post-processing of
    diffusers `_get_qwen_prompt_embeds` (split_hidden_states / attn-mask
    rebuild), as pure numpy so it is unit-testable without checkpoints.

    hidden: [B, T, D] float; mask: [B, T] {0,1}.  Returns ([B, T', D],
    [B, T'] bool) with T' = max valid length after the drop."""
    hidden = np.asarray(hidden)
    mask = np.asarray(mask).astype(bool)
    parts = []
    for b in range(hidden.shape[0]):
        valid = int(mask[b].sum())
        parts.append(hidden[b, drop_idx:valid])
    t_new = max(1, max(p.shape[0] for p in parts))
    out = np.zeros((hidden.shape[0], t_new, hidden.shape[-1]), hidden.dtype)
    out_mask = np.zeros((hidden.shape[0], t_new), bool)
    for b, p in enumerate(parts):
        out[b, : p.shape[0]] = p
        out_mask[b, : p.shape[0]] = True
    return out, out_mask


class _MinimalVLProcessor:
    """Qwen2-VL composite processor WITHOUT the video tower: image
    processor + tokenizer + the `<|image_pad|>` grid expansion of
    transformers' `Qwen2VLProcessor.__call__` (each pad token becomes
    grid_t*grid_h*grid_w / merge_size**2 pads for its image, consumed in
    text order).  Needed because `AutoProcessor` on a Qwen2.5-VL
    checkpoint instantiates a video processor class that hard-requires
    torchvision — edit pipelines never touch video, so checkpoints must
    stay loadable on torchvision-free deployments."""

    image_token = "<|image_pad|>"

    def __init__(self, image_processor, tokenizer):
        self.image_processor = image_processor
        self.tokenizer = tokenizer

    def __call__(self, text, images=None, padding=True,
                 return_tensors="pt"):
        from transformers.feature_extraction_utils import BatchFeature

        feat = {}
        texts = list(text) if isinstance(text, (list, tuple)) else [text]
        if images:
            # two-sided slot/image check (transformers' Qwen2VLProcessor
            # errors on BOTH too few and too many pad tokens; an
            # unexpanded pad would misalign vision features downstream).
            # Text-ONLY calls are exempt like upstream: with images=None
            # the processor tokenizes pad tokens as-is (the Qwen edit
            # template always carries a pad slot, image or not).
            slots = sum(t.count(self.image_token) for t in texts)
            if slots != len(images):
                raise ValueError(
                    f"{len(images)} images but {slots} {self.image_token} "
                    f"slots in the text")
            iv = self.image_processor(images=images,
                                      return_tensors=return_tensors)
            feat.update(dict(iv))
            merge2 = int(getattr(self.image_processor, "merge_size", 2)) ** 2
            counts = [int(np.prod(g)) // merge2
                      for g in iv["image_grid_thw"].tolist()]
            expanded, i = [], 0
            for t in texts:
                while self.image_token in t and i < len(counts):
                    t = t.replace(self.image_token,
                                  "<|vl_expand|>" * counts[i], 1)
                    i += 1
                expanded.append(t.replace("<|vl_expand|>", self.image_token))
            texts = expanded
        feat.update(dict(self.tokenizer(texts, padding=padding,
                                        return_tensors=return_tensors)))
        return BatchFeature(data=feat)

    def apply_chat_template(self, conversation, **kw):
        # processor-class semantics: return the formatted STRING (the
        # tokenizer method defaults to tokenize=True, processors to False)
        kw.setdefault("tokenize", False)
        return self.tokenizer.apply_chat_template(conversation, **kw)

    def decode(self, *a, **kw):
        return self.tokenizer.decode(*a, **kw)


def load_vl_processor(path: str):
    """AutoProcessor with a torchvision-free fallback: when the composite
    Qwen2-VL processor cannot be built (its video-processor attribute
    requires torchvision, absent here), assemble the parts the edit
    pipelines actually use — image processor + tokenizer + pad expansion
    (`_MinimalVLProcessor`).

    The fallback only applies to Qwen2-VL-family checkpoints (the pad
    expansion and Qwen2VLImageProcessor normalization are family-
    specific); for anything else — idefics2/mantis/minicpmv judges go
    through the same loader — the original AutoProcessor error is
    re-raised rather than silently mis-preprocessing."""
    from transformers import AutoProcessor

    try:
        return AutoProcessor.from_pretrained(path)
    except (ImportError, TypeError, ValueError) as e:
        try:
            from transformers import AutoConfig
            model_type = AutoConfig.from_pretrained(path).model_type
        except Exception:
            model_type = ""
        # exact VL-family match: plain qwen2 / qwen2_moe / qwen2_audio
        # checkpoints must re-raise, not get VL image preprocessing
        if str(model_type) not in ("qwen2_vl", "qwen2_5_vl"):
            raise
        from transformers import AutoTokenizer, Qwen2VLImageProcessor
        return _MinimalVLProcessor(
            Qwen2VLImageProcessor.from_pretrained(path),
            AutoTokenizer.from_pretrained(path))


def vl_class():
    """transformers' Qwen2.5-VL conditional-generation class (Qwen2-VL's
    on a transformers that predates it)."""
    try:
        from transformers import Qwen2_5_VLForConditionalGeneration as VL
    except ImportError:  # older transformers naming
        from transformers import Qwen2VLForConditionalGeneration as VL
    return VL


class QwenVLPromptEncoder(_Placed):
    """Qwen2.5-VL prompt encoder: chat template + last-hidden-state +
    prefix drop (diffusers `QwenImageEditPipeline._get_qwen_prompt_embeds`).

    variant: "qwen-image-edit" | "qwen-image-edit-plus" | "step1x-edit".
    Step1X shares the mechanism; its template/drop come from the diffusers
    `step1xedit` port and its hidden states feed the connector."""

    def __init__(self, model_path: str | None,
                 variant: str = "qwen-image-edit", max_length: int = 1024,
                 device: str = "cuda", template: str | None = None,
                 drop_idx: int | None = None,
                 processor_path: str | None = None,
                 placement: str = "card", model=None, processor=None):
        import torch

        self.torch = torch
        self.variant = variant
        # diffusers-layout checkpoints keep the processor/tokenizer config
        # in a sibling subfolder, not next to the model weights
        self.processor = processor or load_vl_processor(
            processor_path or model_path)
        # `model`: a Qwen2.5-VL built already (fp32), in place of a load
        self.model = (model if model is not None else vl_class(
            ).from_pretrained(model_path, dtype=torch.float32)).eval()
        self._place([self.model], device, placement)
        self.max_length = max_length
        self.template = template or (
            QWEN_EDIT_PLUS_TEMPLATE if variant == "qwen-image-edit-plus"
            else QWEN_EDIT_TEMPLATE)
        tok = getattr(self.processor, "tokenizer", None)
        if drop_idx is not None:
            # explicit caller override wins — no derivation check (e.g. a
            # custom template whose drop boundary isn't at the user turn)
            self.drop_idx = drop_idx
        elif template is not None:
            # custom template without an explicit drop: derive from it (the
            # hardcoded constant only describes the default templates)
            if tok is None:
                raise ValueError(
                    "custom template needs an explicit drop_idx when the "
                    "processor has no tokenizer to derive one from")
            self.drop_idx = _derive_drop_idx(tok, self.template)
        else:
            self.drop_idx = QWEN_EDIT_DROP_IDX
            if tok is not None:
                derived = _derive_drop_idx(tok, self.template)
                if derived != self.drop_idx:
                    raise ValueError(
                        f"drop_idx mismatch: template preamble tokenizes to "
                        f"{derived} tokens but drop_idx={self.drop_idx}; the "
                        f"template and the drop constant have diverged")

    def _format(self, prompt: str, n_images: int) -> str:
        if self.variant == "qwen-image-edit-plus":
            imgs = "".join(QWEN_EDIT_PLUS_IMG.format(i=i + 1)
                           for i in range(n_images))
            return self.template.format(imgs=imgs, prompt=prompt)
        return self.template.format(prompt)

    def encode(self, prompt: str, image=None):
        torch = self.torch
        images = (list(image) if isinstance(image, (list, tuple))
                  else ([image] if image is not None else []))
        text = self._format(prompt, len(images))
        kwargs = {"text": [text], "padding": True, "return_tensors": "pt"}
        if images:
            kwargs["images"] = images
        with self.on_device(), torch.no_grad():
            inputs = self.processor(**kwargs).to(self.device)
            out = self.model(**inputs, output_hidden_states=True)
        hidden = out.hidden_states[-1].float().cpu().numpy()
        mask = inputs["attention_mask"].cpu().numpy()
        emb, new_mask = drop_and_repad(hidden, mask, self.drop_idx)
        if emb.shape[1] > self.max_length:
            emb = emb[:, : self.max_length]
            new_mask = new_mask[:, : self.max_length]
        return emb, None, new_mask


# ---------------------------------------------------------------------------
# FLUX.1 Kontext: T5-XXL sequence + CLIP-L pooled
# ---------------------------------------------------------------------------


class FluxPromptEncoder(_Placed):
    """T5-XXL last-hidden-state sequence features + CLIP-L pooled features
    (diffusers `FluxKontextPipeline._get_t5_prompt_embeds` /
    `_get_clip_prompt_embeds`): T5 padded to max_sequence_length=512 with
    all-ones attention downstream (FLUX attends to padding); CLIP truncated
    at 77 tokens, `pooler_output` as the vec conditioning."""

    T5_MAX_LENGTH = 512
    CLIP_MAX_LENGTH = 77

    def __init__(self, t5_path: str, clip_path: str, device: str = "cuda",
                 max_length: int | None = None,
                 t5_tokenizer_path: str | None = None,
                 clip_tokenizer_path: str | None = None,
                 placement: str = "card"):
        import torch
        from transformers import (AutoTokenizer, CLIPTextModel,
                                  T5EncoderModel)

        self.torch = torch
        self.t5_tok = AutoTokenizer.from_pretrained(t5_tokenizer_path or t5_path)
        self.t5 = T5EncoderModel.from_pretrained(
            t5_path, dtype=torch.float32).eval()
        self.clip_tok = AutoTokenizer.from_pretrained(
            clip_tokenizer_path or clip_path)
        self.clip = CLIPTextModel.from_pretrained(
            clip_path, dtype=torch.float32).eval()
        self._place([self.t5, self.clip], device, placement)
        self.max_length = max_length or self.T5_MAX_LENGTH

    def encode(self, prompt: str, image=None):
        torch = self.torch
        with self.on_device(), torch.no_grad():
            t5_in = self.t5_tok(
                prompt, padding="max_length", max_length=self.max_length,
                truncation=True, return_tensors="pt").to(self.device)
            emb = self.t5(t5_in["input_ids"])[0].float().cpu().numpy()
            clip_in = self.clip_tok(
                prompt, padding="max_length",
                max_length=self.CLIP_MAX_LENGTH, truncation=True,
                return_tensors="pt").to(self.device)
            pooled = self.clip(
                clip_in["input_ids"],
                output_hidden_states=False).pooler_output
            pooled = pooled.float().cpu().numpy()
        # FLUX feeds the full padded T5 sequence (no key masking downstream)
        mask = np.ones(emb.shape[:2], bool)
        return emb, pooled, mask


def encoder_for_backend(backend: str, **paths):
    """Build the reference-matching prompt encoder for a backend name.

    paths: model_path= (Qwen-family) or t5_path=/clip_path= (FLUX)."""
    if backend in ("qwen-image-edit", "qwen-image-edit-plus",
                   "step1x-edit", "step1x-edit-v1p2"):
        variant = ("qwen-image-edit-plus" if backend == "qwen-image-edit-plus"
                   else "qwen-image-edit" if backend == "qwen-image-edit"
                   else "step1x-edit")
        return QwenVLPromptEncoder(paths["model_path"], variant=variant,
                                   device=paths.get("device", "cuda"),
                                   placement=paths.get("placement", "card"))
    if backend == "flux-kontext":
        return FluxPromptEncoder(paths["t5_path"], paths["clip_path"],
                                 device=paths.get("device", "cuda"),
                                 t5_tokenizer_path=paths.get("t5_tokenizer_path"),
                                 clip_tokenizer_path=paths.get("clip_tokenizer_path"),
                                 placement=paths.get("placement", "card"))
    raise KeyError(f"no encoder recipe for backend {backend!r}")


def encoder_from_checkpoint(root, backend: str, device: str = "cuda",
                            placement: str = "card"):
    """Reference-matching prompt encoder from a diffusers-layout checkpoint
    directory (the layout `from_pretrained` reads; model_index.json
    subfolders).  This is the loading-path entry used by
    weights.convert.load_converted and the CLI `--model_path` flow.

      Qwen-family / Step1X:  text_encoder/ (Qwen2.5-VL) with the processor
        config in processor/ or tokenizer/ (falling back to text_encoder/).
      FLUX.1 Kontext:        text_encoder/ (CLIP-L) + tokenizer/,
                             text_encoder_2/ (T5-XXL) + tokenizer_2/.

    Raises KeyError for unknown backends and FileNotFoundError when the
    expected subfolders are absent (callers fall back to mock encoders for
    checkpoint-less environments).  `placement`: see the module docstring
    (`weights.convert.load_converted` passes memplan's choice)."""
    from pathlib import Path
    root = Path(root)

    def sub(*names):
        for n in names:
            d = root / n
            if d.is_dir():
                return str(d)
        return None

    if backend == "flux-kontext":
        clip, t5 = sub("text_encoder"), sub("text_encoder_2")
        if not (clip and t5):
            raise FileNotFoundError(
                f"{root}: flux-kontext needs text_encoder/ (CLIP) and "
                f"text_encoder_2/ (T5)")
        return encoder_for_backend(
            backend, t5_path=t5, clip_path=clip, device=device,
            t5_tokenizer_path=sub("tokenizer_2") or t5,
            clip_tokenizer_path=sub("tokenizer") or clip,
            placement=placement)

    te = sub("text_encoder")
    if te is None:
        raise FileNotFoundError(f"{root}: no text_encoder/ subfolder")
    variant = ("qwen-image-edit-plus" if backend == "qwen-image-edit-plus"
               else "qwen-image-edit" if backend == "qwen-image-edit"
               else "step1x-edit")
    if backend not in ("qwen-image-edit", "qwen-image-edit-plus",
                       "step1x-edit", "step1x-edit-v1p2"):
        raise KeyError(f"no encoder recipe for backend {backend!r}")
    # template passed explicitly so drop_idx derives from the CHECKPOINT's
    # tokenizer (what actually strips the preamble) rather than asserting
    # the hardcoded constant: identical on the production tokenizers
    # (derivation == QWEN_EDIT_DROP_IDX, tokenizer-checked in
    # test_text_encoders), and correct for retrained/synthetic tokenizers
    # (weights.tiny_vl dress rehearsals) where the constant would misdrop
    return QwenVLPromptEncoder(
        te, variant=variant, device=device, placement=placement,
        template=(QWEN_EDIT_PLUS_TEMPLATE
                  if variant == "qwen-image-edit-plus"
                  else QWEN_EDIT_TEMPLATE),
        processor_path=sub("processor", "tokenizer") or te)


class HFTextEncoder(_Placed):
    """A generic `transformers` encoder: the last hidden states of the
    prompt padded to `max_length`, and the pooler output where the model
    has one."""

    def __init__(self, model_path: str, kind: str = "auto",
                 max_length: int = 128, device: str = "cuda"):
        import torch
        from transformers import AutoModel, AutoTokenizer

        self.torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.model = AutoModel.from_pretrained(
            model_path, dtype=torch.float32).eval()
        self._place([self.model], device, "card")
        self.max_length = max_length

    def encode(self, prompt: str, image=None):
        torch = self.torch
        with self.on_device(), torch.no_grad():
            toks = self.tokenizer(
                prompt, return_tensors="pt", padding="max_length",
                truncation=True, max_length=self.max_length).to(self.device)
            out = self.model(**toks, output_hidden_states=True)
            emb = out.last_hidden_state.float().cpu().numpy()
            pooled = getattr(out, "pooler_output", None)
            pooled = pooled.float().cpu().numpy() if pooled is not None else None
            mask = toks["attention_mask"].bool().cpu().numpy()
        return emb, pooled, mask
