"""The port's command line: demo and evaluation runs.

Counterpart of `regione_tpu/cli/main.py`, with its flags (every flag,
default and choice of the JAX parser, held equal by
tests/test_torch_core_config.py; `--backend` adds the port's own
`flux2-dev`, whose image path is not ported and raises) and its output
schema: demo mode
writes `demo_<i>.png` per (image, prompt) item; `--evaluation` walks
<eval_dir>/<task>/metadata.jsonl and writes generation/<key>.png,
time_consuming.json (`ave_time_consuming`, `time_consuming_list`) and
metadata.json per task.

    python -m regione_tpu_torch.cli.main --backend flux-kontext \\
        --random_weights --use_regione --image_path in.png --prompt "..."

`--device` places the model (default `cuda`); with no CUDA card the run
stops instead of moving to the CPU: pass `--device cpu` for the plain
PyTorch path (tests, small presets).  `--model_path` loads a
diffusers-layout checkpoint directory (transformer/, vae/ and, when
present, text_encoder/ with the backend's prompt-encoder recipe, in fp32
and placed where `utils.memplan` says it fits beside the weights in their
final format; `weights.convert.load_converted`).  Without it the weights
are random, drawn from `--seed` (`init_params`), with a small AutoencoderKL
of the production spatial factor 8 (so the default ~1024^2 target is a 64
x 64 token grid) and `MockTextEncoder`.  `--int8` / `--int4` quantize the
backbone in place after loading (`ops.quant.quantize_params`, with
`--quantize_mods` and `--int4_mods`), `--act_int8` runs the int8 linears
as W8A8; `--act_int8` needs `--int8` and excludes `--int4`, as in the JAX
CLI.  `--enable_thinking` / `--enable_reflection` run demo mode's edits
through the v1.2 outer loop (`pipelines.thinker.edit_with_reflection`,
up to `--max_try_cnt` tries), with the JAX CLI's `EchoThinker`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from regione_tpu_torch.utils.metadata import item_key, resolve_item

def _flag(text: str):
    """--flag value parsed as a bool ("1", "true", "yes" are true)."""
    return text.lower() in ("1", "true", "yes")


def make_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, defaults and choices; `--device` places the
    model here (default cuda)."""
    ap = argparse.ArgumentParser("regione-tpu-torch")
    ap.add_argument("--backend", default="step1x-edit",
                    choices=["step1x-edit", "step1x-edit-v1p2", "flux-kontext",
                             "qwen-image-edit", "qwen-image-edit-plus",
                             "flux2-dev"])
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--use_regione", action="store_true")
    ap.add_argument("--warmup_step", type=int, default=6)
    ap.add_argument("--post_step", type=int, default=2)
    ap.add_argument("--refresh_step", default="16")
    ap.add_argument("--threshold", type=float, default=0.88)
    ap.add_argument("--cache_threshold", type=float, default=0.02)
    # bare (the reference scripts' form) or with an explicit True/False
    ap.add_argument("--erosion_dilation", type=lambda s: s != "False",
                    nargs="?", const=True, default=True)
    ap.add_argument("--seed", type=int, default=110)
    ap.add_argument("--guidance_scale", type=float, default=None,
                    help="FLUX guidance embed / true CFG scale elsewhere "
                         "(default: the backend's reference value)")
    ap.add_argument("--size_level", type=int, default=None)
    ap.add_argument("--num_inference_steps", type=int, default=None,
                    help="denoise step count: any value for the dense "
                         "baseline; must stay 28 with --use_regione")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda); with no "
                         "CUDA card the run stops: pass 'cpu' for the plain "
                         "PyTorch path")
    ap.add_argument("--image_path", default=None)
    ap.add_argument("--ref_image_path", action="append", default=None,
                    help="extra reference image(s) for multi-reference "
                         "conditioning (qwen-image-edit-plus); repeatable")
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--data_jsonl", default=None)
    ap.add_argument("--output_dir", default="outputs")
    ap.add_argument("--evaluation", action="store_true")
    ap.add_argument("--eval_dir", default=None)
    ap.add_argument("--num_warmup_runs", type=int, default=0,
                    help="full-pipeline warmup invocations before timing")
    ap.add_argument("--dev", action="store_true",
                    help="use the scaled :dev architecture preset")
    ap.add_argument("--preset", default=None,
                    help="explicit architecture preset name (overrides "
                         "--backend/--dev resolution; e.g. 'tiny')")
    ap.add_argument("--random_weights", action="store_true")
    ap.add_argument("--save_format", default="png", choices=["png", "webp"])
    ap.add_argument("--no_resize_back", action="store_true",
                    help="keep outputs at the processed (snapped) resolution "
                         "instead of restoring the input image's geometry")
    ap.add_argument("--print_plan", action="store_true",
                    help="dump the static 28-step stage plan and continue")
    ap.add_argument("--enable_thinking", action="store_true")
    ap.add_argument("--enable_reflection", action="store_true")
    ap.add_argument("--max_try_cnt", type=int, default=3)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int4", action="store_true")
    ap.add_argument("--int4_mods", default=None, type=_flag)
    ap.add_argument("--act_int8", action="store_true")
    ap.add_argument("--quantize_mods", default=None, type=_flag)
    return ap


def save_png(path: Path, img_uint8: np.ndarray):
    """Save an image; .webp paths use lossless webp."""
    from PIL import Image
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".webp":
        Image.fromarray(img_uint8).save(path, lossless=True)
    else:
        Image.fromarray(img_uint8).save(path)


def load_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _first_item(args):
    """(image path, prompt) of the first input the timed run will see, so
    --num_warmup_runs warms the same shapes in every input mode."""
    if args.image_path:
        return args.image_path, args.prompt
    if args.data_jsonl:
        for line in open(args.data_jsonl):
            return resolve_item(json.loads(line))
    if args.eval_dir:
        for task_dir in sorted(p for p in Path(args.eval_dir).iterdir()
                               if p.is_dir()):
            meta_file = task_dir / "metadata.jsonl"
            if not meta_file.exists():
                continue
            for line in open(meta_file):
                return resolve_item(json.loads(line),
                                    img_dir=task_dir / "img")
    return None, None


def resolve_device(name) -> torch.device:
    """The model's device; a CUDA device with no card stops the run."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {dev} needs a CUDA card and none is "
                         f"available; pass --device cpu to run on the CPU")
    return dev


def build_pipeline(args):
    from regione_tpu_torch.core.config import DEFAULT_PARAMS
    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.models.text_encoders import MockTextEncoder
    from regione_tpu_torch.models.vae import VAEConfig
    from regione_tpu_torch.pipelines import PIPELINES
    from regione_tpu_torch.weights.from_jax import init_params, init_vae_params

    dev = resolve_device(getattr(args, "device", None))
    backend = args.backend
    preset = args.preset or (backend + (":dev" if args.dev else ""))
    try:
        cfg = get_config(preset)
    except KeyError:
        cfg = get_config(backend)

    re = DEFAULT_PARAMS[backend].replace(
        warmup_step=args.warmup_step, post_step=args.post_step,
        refresh_step=args.refresh_step, threshold=args.threshold,
        cache_threshold=args.cache_threshold,
        erosion_dilation=args.erosion_dilation).validate()
    steps = getattr(args, "num_inference_steps", None)
    if steps is not None and steps != re.num_inference_steps:
        if args.use_regione:
            # the gamma tables are fitted at 28 steps
            raise SystemExit("--num_inference_steps must be 28 with "
                             "--use_regione (fitted gamma tables)")
        if steps < 4:
            raise SystemExit("--num_inference_steps must be >= 4")
        # dense-only run: any step count; the unused RegionE knobs are
        # pinned to values validate() accepts
        re = re.replace(num_inference_steps=steps, allow_custom_steps=True,
                        warmup_step=1, post_step=0,
                        refresh_step=(3,)).validate()

    int8, int4 = getattr(args, "int8", False), getattr(args, "int4", False)
    act_int8 = getattr(args, "act_int8", False)
    if act_int8 and not int8:
        # W8A8 needs int8 weights: activation quant alone quantizes nothing
        raise SystemExit("--act_int8 requires --int8 (W8A8 = int8 weights "
                         "+ int8 activations)")
    if int4 and act_int8:
        # int4 projections run a float matmul; mixing the flags would leave
        # most of the model outside the W8A8 path asked for
        raise SystemExit("--int4 and --act_int8 are mutually exclusive "
                         "(int4 buys single-card fit; W8A8 speed needs "
                         "int8 weights)")

    quantize_mods = getattr(args, "quantize_mods", None)
    if quantize_mods is None:
        quantize_mods = act_int8 or int4
    int4_mods = getattr(args, "int4_mods", None)
    if int4_mods is None:
        # the single-card format of the 60-block Qwen packs the
        # modulations to int4 too; --int4_mods false keeps them int8
        int4_mods = int4
    if args.model_path:
        from regione_tpu_torch.weights.convert import load_converted
        # the prompt encoder's placement is planned for the weights' format
        # of the denoise (they are quantized after loading)
        weights = (dict(int8=True, bits=4 if int4 else 8,
                        quantize_mods=quantize_mods,
                        int4_mods=int4_mods and int4)
                   if int8 or int4 else {})
        model, vae_cfg, vae, encoder = load_converted(
            args.model_path, cfg, backend=backend, device=dev,
            weights=weights)
    else:
        model = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                            dev)
        # 4 levels: spatial factor 8, token factor 16, as the production
        # VAEs
        vae_cfg = VAEConfig(block_out_channels=(8, 16, 32, 64),
                            norm_num_groups=8, layers_per_block=1,
                            latent_channels=cfg.in_channels // 4)
        vae = init_vae_params(
            vae_cfg, torch.Generator(dev).manual_seed(args.seed + 1), dev)
        encoder = MockTextEncoder(cfg.txt_in_dim, cfg.pooled_dim or None,
                                  max_length=128)
    if int8 or int4:
        from regione_tpu_torch.ops.quant import quantize_params
        quantize_params(model, quantize_mods=quantize_mods,
                        bits=4 if int4 else 8, int4_mods=int4_mods and int4)
    if act_int8:
        model.cfg = dataclasses.replace(model.cfg, act_int8=True)
    # --guidance_scale: FLUX's embedded guidance, true CFG elsewhere; None
    # keeps the backend's default
    kw = {}
    gs = getattr(args, "guidance_scale", None)
    if gs is not None:
        kw["guidance_scale" if backend in ("flux-kontext", "flux2-dev")
           else "true_cfg_scale"] = gs
    pipe = PIPELINES[backend](model, re, **kw)
    pipe.attach_vae(vae)
    pipe.attach_text_encoder(encoder)
    pipe._regione_enabled = args.use_regione
    return pipe


def _edit(pipe, img, prompt, args, thinker=False):
    """One timed edit: (uint8 image, stats, seconds to the finished image).
    `thinker`: through the v1.2 outer loop (stats None, as in the JAX
    CLI)."""
    kw = dict(width=args.size_level, height=args.size_level,
              resize_to_input=not args.no_resize_back)
    t0 = time.perf_counter()
    if thinker:
        from regione_tpu_torch.pipelines.thinker import edit_with_reflection
        out, _ = edit_with_reflection(
            pipe, img, prompt, enable_thinking=args.enable_thinking,
            enable_reflection=args.enable_reflection,
            max_try_cnt=args.max_try_cnt, seed=args.seed, **kw)
        stats = None
    else:
        out, stats = pipe(img, prompt, seed=args.seed, output_type="uint8",
                          **kw)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    return out, stats, time.perf_counter() - t0


def run_demo(pipe, args):
    items = ([json.loads(line) for line in open(args.data_jsonl)]
             if args.data_jsonl
             else [{"image": args.image_path, "prompt": args.prompt}])
    out_dir = Path(args.output_dir)
    refs = [load_image(p) for p in getattr(args, "ref_image_path", None) or []]
    times = []
    for i, item in enumerate(items):
        path, prompt = resolve_item(item)
        img = load_image(path)
        if refs:
            img = [img] + refs   # multi-reference conditioning (Plus)
        out, stats, dt = _edit(
            pipe, img, prompt, args,
            thinker=args.enable_thinking or args.enable_reflection)
        times.append(dt)
        save_png(out_dir / f"demo_{i}.{args.save_format}", out)
        print(f"[{i}] {dt:.2f}s edited={getattr(stats, 'edited_tokens', '-')} "
              f"prompt={prompt[:60]!r}")
    if times:
        print(f"avg {np.mean(times):.3f}s over {len(times)} images")


def run_evaluation(pipe, args):
    """Per task dir with metadata.jsonl: generation/<key>.png,
    time_consuming.json and metadata.json (the JAX CLI's schema)."""
    for task_dir in sorted(p for p in Path(args.eval_dir).iterdir()
                           if p.is_dir()):
        meta_file = task_dir / "metadata.jsonl"
        if not meta_file.exists():
            continue
        out_task = Path(args.output_dir) / task_dir.name
        times, metadata = [], {}
        for line in open(meta_file):
            item = json.loads(line)
            path, prompt = resolve_item(item, img_dir=task_dir / "img")
            key = item_key(item, path)
            out, _, dt = _edit(pipe, load_image(path), prompt, args)
            times.append(dt)
            save_png(out_task / "generation" / f"{key}.{args.save_format}",
                     out)
            metadata[key] = prompt
        out_task.mkdir(parents=True, exist_ok=True)
        ave = float(np.mean(times)) if times else 0.0
        with open(out_task / "time_consuming.json", "w") as fh:
            json.dump({"num_item": len(times), "ave_time_consuming": ave,
                       "time_consuming_list": times, "ave": ave,
                       "list": times}, fh, indent=2)
        with open(out_task / "metadata.json", "w") as fh:
            json.dump(metadata, fh, indent=2)
        print(f"{task_dir.name}: {len(times)} items, avg {ave:.2f}s")


def main(argv=None):
    args = make_parser().parse_args(argv)
    # the reference's --image_path overloading: a .jsonl is the demo list;
    # with --evaluation a directory is the dataset root
    if args.image_path:
        p = Path(args.image_path)
        if args.data_jsonl is None and p.suffix == ".jsonl":
            args.data_jsonl, args.image_path = args.image_path, None
        elif args.eval_dir is None and args.evaluation and p.is_dir():
            args.eval_dir, args.image_path = args.image_path, None
    if args.evaluation:
        if args.eval_dir is None:
            hint = (f" ({args.image_path!r} is not an existing directory)"
                    if args.image_path else "")
            raise SystemExit("--evaluation needs a dataset root: pass "
                             "--eval_dir (or the reference-style "
                             "--image_path) pointing at an existing "
                             "directory of task dirs" + hint)
        if not Path(args.eval_dir).is_dir():
            raise SystemExit(f"--eval_dir {args.eval_dir!r} is not a "
                             f"directory")

    pipe = build_pipeline(args)
    if args.print_plan:
        from regione_tpu_torch.core.schedule import (build_stage_plan,
                                                     describe_plan)
        plan = build_stage_plan(pipe.re, pipe.flow_shift.sigmas(
            pipe.re.num_inference_steps, 4096), pipe.gamma)
        print(describe_plan(plan))
    if args.num_warmup_runs:
        # warm on the first real input, so no timed edit pays first-call
        # costs (the kernels' build, cuBLAS / cuDNN heuristics)
        wpath, wprompt = _first_item(args)
        if wpath is None:
            raise SystemExit("--num_warmup_runs needs an input to warm on "
                             "(no --image_path/--data_jsonl/--eval_dir "
                             "items found)")
        img = load_image(wpath)
        for _ in range(args.num_warmup_runs):
            pipe(img, wprompt or "warmup", seed=args.seed,
                 width=args.size_level, height=args.size_level)
    if args.evaluation:
        run_evaluation(pipe, args)
    else:
        run_demo(pipe, args)


if __name__ == "__main__":
    main()
