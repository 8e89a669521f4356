#!/usr/bin/env bash
# Demo + evaluation script for Step1X-Edit v1.1 on the PyTorch port, one
# card: the port's counterpart of scripts/demo/Step1XEdit.sh (the
# reference's script/Step1XEdit.sh; same knobs, same demo-jsonl /
# evaluation modes; --model_path points at a diffusers-layout checkpoint
# directory).
set -euo pipefail
cd "$(dirname "$0")/../.."
MODEL=${MODEL:-checkpoints/step1x-edit-v1p1}

# Demo over the in-repo jsonl
python -m regione_tpu_torch.cli.main \
    --backend step1x-edit \
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
    --output_dir result/Step1X-Edit/Demo/RegionE

# Evaluation over preprocessed GEdit-Bench
python -m regione_tpu_torch.cli.main \
    --backend step1x-edit \
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
    --output_dir result/Step1X-Edit/RegionE
