#!/usr/bin/env bash
# Demo + evaluation script for FLUX.1 Kontext on the PyTorch port, one
# card: the port's counterpart of scripts/demo/FluxKontext.sh (the
# reference's script/FluxKontext.sh; demo cache_threshold 0.01, evaluation
# 0.04, both documented in SURVEY Appendix B).
set -euo pipefail
cd "$(dirname "$0")/../.."
MODEL=${MODEL:-checkpoints/flux1-kontext-dev}

python -m regione_tpu_torch.cli.main \
    --backend flux-kontext \
    --model_path "$MODEL" \
    --num_inference_steps 28 \
    --use_regione \
    --warmup_step 6 \
    --post_step 2 \
    --refresh_step "16" \
    --threshold 0.93 \
    --cache_threshold 0.01 \
    --erosion_dilation \
    --guidance_scale 2.5 \
    --seed 110 \
    --device cuda \
    --image_path assets/data.jsonl \
    --output_dir result/FluxKontext/Demo/RegionE

python -m regione_tpu_torch.cli.main \
    --backend flux-kontext \
    --model_path "$MODEL" \
    --num_inference_steps 28 \
    --use_regione \
    --warmup_step 6 \
    --post_step 2 \
    --refresh_step "16" \
    --threshold 0.93 \
    --cache_threshold 0.04 \
    --erosion_dilation \
    --guidance_scale 2.5 \
    --seed 110 \
    --device cuda \
    --evaluation \
    --image_path data/Processed/Kontext-Bench \
    --output_dir result/FluxKontext/RegionE
