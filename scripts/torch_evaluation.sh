#!/usr/bin/env bash
# Full evaluation pass on the PyTorch port (the port's counterpart of
# scripts/evaluation.sh, the reference's script/Evaluation.sh):
#   1. pixel metrics vanilla-vs-RegionE per task -> metric.csv
#   2. item-weighted merge -> merged_metric.txt
#   3. VIEScore semantic judging (needs an OpenAI key file) -> vie_score.csv
#
# Usage: scripts/torch_evaluation.sh <vanilla_results_dir> <regione_results_dir> [key_file]
# LPIPS and a local judge run on $DEVICE (default cuda; DEVICE=cpu for the
# CPU).
set -euo pipefail
PY=${PYTHON:-python}

VANILLA=${1:?vanilla results dir}
REGIONE=${2:?regione results dir}
KEYS=${3:-}
DEVICE=${DEVICE:-cuda}

"$PY" -m regione_tpu_torch.eval.run_metrics --folder1 "$VANILLA" \
    --folder2 "$REGIONE" --device "$DEVICE"
"$PY" -m regione_tpu_torch.eval.merge --direction "$REGIONE"
"$PY" -m regione_tpu_torch.eval.merge --direction "$VANILLA" --pretrain

if [[ -n "$KEYS" ]]; then
  "$PY" -m regione_tpu_torch.eval.run_viescore \
    --data_dir "$REGIONE" --backbone gpt4o --key_path "$KEYS" \
    --device "$DEVICE"
fi
