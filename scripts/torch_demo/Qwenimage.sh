#!/usr/bin/env bash
# Vanilla + demo + evaluation script for Qwen-Image-Edit on the PyTorch
# port, one card: the port's counterpart of scripts/demo/Qwenimage.sh (the
# reference's script/Qwenimage.sh).
#
# No --int4 here, unlike the JAX script: `python -m
# regione_tpu_torch.utils.memplan --preset qwen-image-edit --grid 64
# --t-txt 512 --encoder auto` plans the full 60-block bf16 weights at
# 38.06 GiB, the bf16 KV cache at 11.25 GiB and the activations at 0.80
# GiB: 50.1 GiB of an H100's 79.2, so bf16 fits one card.  With the fp32
# Qwen2.5-VL-7B prompt encoder (30.89 GiB) beside them it would not (81.0
# GiB): the loader offloads the encoder (on the card for the encode only).
set -euo pipefail
cd "$(dirname "$0")/../.."
MODEL=${MODEL:-checkpoints/qwen-image-edit}

# Vanilla (dense 28-step) baseline
python -m regione_tpu_torch.cli.main \
    --backend qwen-image-edit \
    --model_path "$MODEL" \
    --num_inference_steps 28 \
    --guidance_scale 4.0 \
    --seed 110 \
    --device cuda \
    --image_path assets/data.jsonl \
    --output_dir result/Qwen-Image-Edit/Pretrain

# RegionE demo
python -m regione_tpu_torch.cli.main \
    --backend qwen-image-edit \
    --model_path "$MODEL" \
    --num_inference_steps 28 \
    --use_regione \
    --warmup_step 6 \
    --post_step 2 \
    --refresh_step "16" \
    --threshold 0.80 \
    --cache_threshold 0.03 \
    --erosion_dilation \
    --guidance_scale 4.0 \
    --seed 110 \
    --device cuda \
    --image_path assets/data.jsonl \
    --output_dir result/Qwen-Image-Edit/Demo/RegionE

# Evaluation over preprocessed GEdit-Bench
python -m regione_tpu_torch.cli.main \
    --backend qwen-image-edit \
    --model_path "$MODEL" \
    --num_inference_steps 28 \
    --use_regione \
    --warmup_step 6 \
    --post_step 2 \
    --refresh_step "16" \
    --threshold 0.80 \
    --cache_threshold 0.03 \
    --erosion_dilation \
    --guidance_scale 4.0 \
    --seed 110 \
    --device cuda \
    --evaluation \
    --image_path data/Processed/GEdit-Bench \
    --output_dir result/Qwen-Image-Edit/RegionE
