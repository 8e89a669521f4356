"""A tiny, fully loadable Qwen2.5-VL checkpoint directory, synthesised.

The port's own copy of `regione_tpu/weights/tiny_vl.py`.  Published
Qwen2.5-VL checkpoints are not in the repository, so the real prompt
encoder (`models.text_encoders.QwenVLPromptEncoder`) is driven through a
random-weight but structurally real checkpoint: a `transformers`
Qwen2.5-VL model (vision tower and mrope text decoder), a byte-level BPE
tokenizer trained from scratch that carries the special tokens the chat
templates use, and the Qwen2-VL image processor, in the diffusers
subfolder layout that `weights.convert.load_converted` /
`encoder_from_checkpoint` read.  Everything downstream of the checkpoint
bytes is the real code path; only the weight values are random.  Needs
`transformers` and `tokenizers` (imported when a checkpoint is built).

CLI:  python -m regione_tpu_torch.weights.tiny_vl --out <dir> [--hidden 16]
"""

from __future__ import annotations

import os

# special tokens the QWEN_EDIT templates rely on, in the order their ids
# are referenced by the model config below
SPECIAL_TOKENS = (
    "<|endoftext|>",      # 0: pad
    "<|im_start|>",       # 1
    "<|im_end|>",         # 2: eos
    "<|vision_start|>",   # 3
    "<|vision_end|>",     # 4
    "<|image_pad|>",      # 5
    "<|video_pad|>",      # 6
)

_CORPUS = (
    "Describe the key features of the input image (color, shape, size, "
    "texture, objects, background), then explain how the user's text "
    "instruction should alter or modify the image. Generate a new image "
    "that meets the user's requirements while maintaining consistency "
    "with the original input where appropriate.",
    "system user assistant Picture 1: Picture 2:",
    "change the red balloon to a blue balloon",
    "add a small white bird in the sky",
    "turn the summer day into a winter scene",
    "replace the background with a sunset beach",
)


def build_tokenizer(vocab_size: int = 512):
    """From-scratch byte-level BPE Qwen2 tokenizer (no downloaded vocab):
    trained on template-shaped text so chat templates tokenize compactly,
    with the vision special tokens registered as atomic."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import Qwen2TokenizerFast

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=list(SPECIAL_TOKENS),
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(_CORPUS, trainer)
    t = Qwen2TokenizerFast(
        tokenizer_object=tok, pad_token="<|endoftext|>",
        eos_token="<|im_end|>",
        additional_special_tokens=[t for t in SPECIAL_TOKENS
                                   if t not in ("<|endoftext|>",
                                                "<|im_end|>")])
    # Qwen2-VL-shaped chat template (im_start/im_end turns; image content
    # items expand to the vision-token sandwich), so apply_chat_template
    # works on this checkpoint as on the production one
    t.chat_template = (
        "{% for message in messages %}<|im_start|>{{ message['role'] }}\n"
        "{% if message['content'] is string %}{{ message['content'] }}"
        "{% else %}{% for content in message['content'] %}"
        "{% if content['type'] == 'image' %}"
        "<|vision_start|><|image_pad|><|vision_end|>"
        "{% elif content['type'] == 'text' %}{{ content['text'] }}"
        "{% endif %}{% endfor %}{% endif %}<|im_end|>\n{% endfor %}"
        "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
    return t


def build_checkpoint(out_dir: str, hidden: int = 16, vocab_size: int = 512,
                     seed: int = 0) -> str:
    """Write `<out_dir>/text_encoder/` with a tiny Qwen2.5-VL model +
    tokenizer + image processor (one folder serves as both model and
    processor path).  `hidden` should match the pipeline config's
    txt_in_dim (16 for the tiny presets).  Returns the text_encoder dir."""
    import torch
    from transformers import (Qwen2_5_VLConfig,
                              Qwen2_5_VLForConditionalGeneration,
                              Qwen2VLImageProcessor)

    te = os.path.join(out_dir, "text_encoder")
    os.makedirs(te, exist_ok=True)
    tokenizer = build_tokenizer(vocab_size)
    ids = {t: tokenizer.convert_tokens_to_ids(t) for t in SPECIAL_TOKENS}
    heads = 2
    half_rot = hidden // heads // 2  # mrope sections sum to head_dim/2
    assert half_rot >= 3, f"hidden {hidden} too small for a 3-part mrope"
    mrope = [half_rot - 2, 1, 1]
    # the text model's sizes as `text_config` (the form transformers 4.x
    # and 5.x both read) and at the top level (where 4.x reads them)
    text = dict(
        hidden_size=hidden, intermediate_size=2 * hidden,
        num_hidden_layers=2, num_attention_heads=heads,
        num_key_value_heads=heads, vocab_size=len(tokenizer),
        max_position_embeddings=4096, rope_theta=10000.0,
        rope_scaling={"type": "mrope", "mrope_section": mrope},
        pad_token_id=ids["<|endoftext|>"], eos_token_id=ids["<|im_end|>"],
        tie_word_embeddings=True)
    cfg = Qwen2_5_VLConfig(
        vision_config=dict(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
            patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
            window_size=28, fullatt_block_indexes=[1],
            out_hidden_size=hidden, in_channels=3),
        text_config=dict(text), **text,
        image_token_id=ids["<|image_pad|>"],
        video_token_id=ids["<|video_pad|>"],
        vision_start_token_id=ids["<|vision_start|>"],
        vision_end_token_id=ids["<|vision_end|>"])
    torch.manual_seed(seed)
    model = Qwen2_5_VLForConditionalGeneration(cfg).eval()
    model.save_pretrained(te)
    tokenizer.save_pretrained(te)
    # small pixel budget keeps vision-token counts test-sized (a 64px
    # image -> 4 merged tokens) while exercising the same smart_resize
    # grid math as production
    Qwen2VLImageProcessor(min_pixels=28 * 28 * 4,
                          max_pixels=28 * 28 * 16).save_pretrained(te)
    return te


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--vocab-size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    te = build_checkpoint(a.out, hidden=a.hidden, vocab_size=a.vocab_size,
                          seed=a.seed)
    print(te)


if __name__ == "__main__":
    main()
