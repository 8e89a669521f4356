"""Where the fp32 prompt encoder lives during a Qwen-Image-Edit edit, each
placement measured on the card: the full 60-block bf16 backbone (random
weights, seed 0) with a synthetic Qwen2.5-VL-7B at its published width
(`utils.memplan.ENCODER_CONFIGS["qwen2.5-vl-7b"]`, 8.29 B parameters in
fp32, random weights drawn on the card from seed 0: nothing is read or
downloaded) and, for each placement of `models.text_encoders`:

  host     the JAX package's: the encoder on the CPU, encoding there;
  offload  on the host in pinned memory, copied to the card for the encode
           alone (`copy_s`: the host -> card seconds) and gone during the
           denoise;
  card     resident on the card for the whole edit (the port's placement
           before `memplan` chose one).

Each runs `pipe.prepare_inputs` on a 1024^2 image (`--grid` 64) and an
instruction of `--prompt-tokens` tokens (the two CFG encodes: the encoder
sees the image at the edit's size, 1225 vision tokens, and the embeddings
stop at the encoder's 1024 rows; a small Wan VAE of the production
spatial factor encodes the condition), then the
RegionE `edit_latents` with the bf16 KV cache, and reports the encode
seconds, the whole edit's seconds, the peak device bytes
(`torch.cuda.max_memory_allocated` from before the preparation), the
embeddings' error against the host placement's (TF32 off) and memplan's
plan and choice.  A placement that runs out of device memory is reported
as such (`oom`, where, and the peak so far): that is the measurement; the
loaders never try a placement to see whether it fits, they ask `memplan`.

    python -m regione_tpu_torch.bench.encoder_placement [--grid 64]
        [--prompt-tokens 512] [--placements host,offload,card]

Prints one JSON line.  Needs the card (and `transformers`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from regione_tpu_torch.bench import common

PROMPT_WORDS = ("change the red balloon to a blue balloon and add a small "
                "white bird in the sky then turn the summer day into a "
                "winter scene and replace the background with a sunset beach")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=64,
                    help="the token grid (the image is 16 x grid pixels)")
    ap.add_argument("--prompt-tokens", type=int, default=512,
                    help="the instruction's length in tokens")
    ap.add_argument("--placements", default="host,offload,card")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def vl_processor():
    """The published Qwen2-VL image processor (its defaults) with the
    synthetic byte-level tokenizer of `weights.tiny_vl` (ids far under the
    published vocabulary)."""
    from transformers import Qwen2VLImageProcessor

    from regione_tpu_torch.models.text_encoders import _MinimalVLProcessor
    from regione_tpu_torch.weights.tiny_vl import build_tokenizer
    return _MinimalVLProcessor(Qwen2VLImageProcessor(), build_tokenizer())


def synthetic_vl(device, tokenizer, seed: int = 0):
    """Qwen2.5-VL-7B's published widths with random fp32 weights, built on
    `device` by `transformers`' own initialisation from `seed`; its special
    token ids are `tokenizer`'s."""
    import transformers

    from regione_tpu_torch.utils.memplan import ENCODER_CONFIGS
    from regione_tpu_torch.weights.tiny_vl import SPECIAL_TOKENS
    (model_cls, config_cls, kw), = ENCODER_CONFIGS["qwen2.5-vl-7b"]
    ids = {t: tokenizer.convert_tokens_to_ids(t) for t in SPECIAL_TOKENS}
    config = getattr(transformers, config_cls)(
        **kw, image_token_id=ids["<|image_pad|>"],
        video_token_id=ids["<|video_pad|>"],
        vision_start_token_id=ids["<|vision_start|>"],
        vision_end_token_id=ids["<|vision_end|>"])
    torch.manual_seed(seed)
    with torch.device(device):
        model = getattr(transformers, model_cls)(config)
    return model.float().eval()


def prompt_of(tokenizer, n: int) -> str:
    """An instruction of `n` tokens (`tokenizer`'s), words of
    PROMPT_WORDS in turn."""
    words = PROMPT_WORDS.split()
    prompt = ""
    while len(tokenizer(prompt)["input_ids"]) < n:
        prompt += (" " if prompt else "") + words[len(prompt.split())
                                                  % len(words)]
    return prompt


def run(args) -> dict:
    from regione_tpu_torch.models.text_encoders import (QWEN_EDIT_TEMPLATE,
                                                        QwenVLPromptEncoder)
    from regione_tpu_torch.models.vae_wan import WanVAEConfig
    from regione_tpu_torch.ops import _build
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    from regione_tpu_torch.utils import memplan
    from regione_tpu_torch.weights.from_jax import init_params, init_vae_params

    dev = common.resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("encoder_placement measures the card: no --device "
                         "cpu")
    _build.build()
    gib = 2 ** 30
    hbm = torch.cuda.get_device_properties(dev).total_memory
    cfg = common.config("qwen-image-edit", "bf16")
    placement, mp = memplan.choose_placement(cfg, "qwen2.5-vl-7b", hbm,
                                             grid=args.grid)
    row = {"model": "qwen-image-edit", "encoder": "qwen2.5-vl-7b",
           "grid": args.grid, "prompt_tokens": args.prompt_tokens,
           "card_gib": round(hbm / gib, 3),
           "memplan": {k: v for k, v in mp.as_dict().items()
                       if k.endswith("_gib")},
           "memplan_choice": placement, "placements": {}}
    common.log(f"memplan: {row['memplan']} -> {placement}", "encoder")

    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    model.cfg = cfg
    pipe = QwenImageEditPipeline(model, common.DEFAULT_PARAMS[
        "qwen-image-edit"])
    pipe.attach_vae(init_vae_params(
        WanVAEConfig(base_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1),
        torch.Generator(dev).manual_seed(1), dev))
    processor = vl_processor()
    vl = synthetic_vl(dev, processor.tokenizer)
    prompt = prompt_of(processor.tokenizer, args.prompt_tokens)
    common.sync()
    row["encoder_params"] = sum(p.numel() for p in vl.parameters())
    common.log(f"backbone {common.param_count(model) / 1e9:.2f} B bf16 and "
               f"encoder {row['encoder_params'] / 1e9:.2f} B fp32 on the card "
               f"in {time.perf_counter() - t:.1f}s", "encoder")
    size = 16 * args.grid
    image = (np.random.default_rng(3).random((size, size, 3)) * 255
             ).astype(np.uint8)
    encoder = None
    ref = None
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # fp32 vision convs
    for name in args.placements.split(","):
        if encoder is None:
            encoder = QwenVLPromptEncoder(
                None, variant="qwen-image-edit", template=QWEN_EDIT_TEMPLATE,
                device=dev, placement=name, model=vl, processor=processor)
        else:
            encoder._place([vl], dev, name)
        pipe.attach_text_encoder(encoder)
        common.sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = {"resident_gib_before": round(
            torch.cuda.memory_allocated() / gib, 3)}
        copy0 = encoder.copy_s
        stage = "prepare_inputs"
        try:
            t = time.perf_counter()
            ctx, (w, h, gh, gw, _) = pipe.prepare_inputs(image, prompt,
                                                         width=size,
                                                         height=size)
            common.sync()
            res["encode_s"] = round(time.perf_counter() - t, 3)
            res["prepare_peak_gib"] = round(
                torch.cuda.max_memory_allocated() / gib, 3)
            stage = "edit_latents"
            lat0 = pipe.initial_latents(110, (1, gh * gw, cfg.in_channels))
            t1 = time.perf_counter()
            _, stats = pipe.edit_latents(lat0, ctx, gh, gw)
            common.sync()
            res["denoise_s"] = round(time.perf_counter() - t1, 3)
            res["edit_s"] = round(time.perf_counter() - t, 3)
            res["t_txt"] = int(ctx.txt.shape[1])
            res["edited_tokens"] = stats.edited_tokens
            txt = ctx.txt.float().cpu().numpy()
            if ref is None:
                ref = txt
            res["embeddings_err_vs_first"] = float(
                np.abs(txt - ref).max() / np.abs(ref).max())
        except torch.cuda.OutOfMemoryError as e:
            res.update(oom=True, at=stage, error=str(e).split("\n")[0][:160])
        res["copy_s"] = round(encoder.copy_s - copy0, 3)
        res["peak_gib"] = round(torch.cuda.max_memory_allocated() / gib, 3)
        common.log(f"{name}: {res}", "encoder")
        row["placements"][name] = res
        ctx = lat0 = None
    torch.backends.cudnn.allow_tf32 = tf32
    row["device"] = common.device_name(dev)
    return row


def main(argv=None) -> dict:
    row = run(parse_args(argv))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
