#!/usr/bin/env bash
# Timing sweep of the backends at dev scale on one card, through the port's
# console script (regione-tpu-torch, pyproject.toml): the port's
# counterpart of scripts/bench_all_backends.sh.
#
# Usage: scripts/torch_bench_all_backends.sh <image> [prompt]
set -euo pipefail
for b in step1x-edit flux-kontext qwen-image-edit; do
  echo "=== $b (vanilla) ==="
  regione-tpu-torch --backend "$b" --dev --image_path "$1" \
    --prompt "${2:-edit}" --device cuda --output_dir "out/$b-vanilla"
  echo "=== $b (RegionE) ==="
  regione-tpu-torch --backend "$b" --dev --use_regione --image_path "$1" \
    --prompt "${2:-edit}" --device cuda --output_dir "out/$b-regione"
done
