#!/usr/bin/env bash
# Vanilla + demo + evaluation script for Step1X-Edit v1.2 on the PyTorch
# port, one card: the port's counterpart of scripts/demo/Step1XEditv1p2.sh
# (the reference's script/Step1XEditv1p2.sh).  Thinking/reflection are off
# by default exactly like the reference CLI (hardcoded False,
# src/Step1X-Edit-v1p2/main.py:42-43); opt in with --enable_thinking /
# --enable_reflection.
set -euo pipefail
cd "$(dirname "$0")/../.."
MODEL=${MODEL:-checkpoints/step1x-edit-v1p2}

python -m regione_tpu_torch.cli.main \
    --backend step1x-edit-v1p2 \
    --model_path "$MODEL" \
    --num_inference_steps 28 \
    --guidance_scale 6.0 \
    --seed 110 \
    --device cuda \
    --image_path assets/data.jsonl \
    --output_dir result/Step1X-Edit-v1p2/Pretrain

python -m regione_tpu_torch.cli.main \
    --backend step1x-edit-v1p2 \
    --model_path "$MODEL" \
    --num_inference_steps 28 \
    --use_regione \
    --warmup_step 6 \
    --post_step 2 \
    --refresh_step "16" \
    --threshold 0.88 \
    --cache_threshold 0.02 \
    --erosion_dilation \
    --guidance_scale 6.0 \
    --seed 110 \
    --device cuda \
    --image_path assets/data.jsonl \
    --output_dir result/Step1X-Edit-v1p2/Demo/RegionE

python -m regione_tpu_torch.cli.main \
    --backend step1x-edit-v1p2 \
    --model_path "$MODEL" \
    --num_inference_steps 28 \
    --use_regione \
    --warmup_step 6 \
    --post_step 2 \
    --refresh_step "16" \
    --threshold 0.88 \
    --cache_threshold 0.02 \
    --erosion_dilation \
    --guidance_scale 6.0 \
    --seed 110 \
    --device cuda \
    --evaluation \
    --image_path data/Processed/GEdit-Bench \
    --output_dir result/Step1X-Edit-v1p2/RegionE
