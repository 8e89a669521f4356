#!/usr/bin/env bash
# Canned mini-benchmark sweep on the PyTorch port: vanilla + RegionE
# generation over assets/minibench through regione_tpu_torch.cli.main, then
# the port's eval stack (pixel metrics -> merge -> VIEScore).  The port's
# counterpart of scripts/run_minibench.sh, with its flags and
# --device cuda (the default) in place of the TPU.
#
# Usage:
#   bash scripts/torch_run_minibench.sh <out_dir> --model_path <ckpt> \
#        [--backend step1x-edit] [--device cpu]
#   bash scripts/torch_run_minibench.sh <out_dir> --dev   # on the card: no
#        weights, random step1x-edit:dev (head_dim 128) at 512^2
#   bash scripts/torch_run_minibench.sh <out_dir> --mock --device cpu
#        # no weights, the tiny preset at 64^2 on the CPU
#
# $PYTHON names the interpreter (default python).
#
# --mock is the tiny preset (head_dim 16), which the card's attention
# kernels do not take (they run head_dim 128 only): it needs --device cpu,
# and on the card --dev takes its place.  The script never picks either by
# itself.  With real weights the PSNR row is the reference's headline
# fidelity metric (target >= 30 dB vs the vanilla run).
set -euo pipefail
PY=${PYTHON:-python}
cd "$(dirname "$0")/.."

OUT=${1:?usage: torch_run_minibench.sh <out_dir> [--mock --device cpu | --dev | --model_path <dir>]}
shift
BACKEND="step1x-edit"
DEVICE="cuda"
MOCK=0
EXTRA=()
while [ $# -gt 0 ]; do
  case "$1" in
    --mock) MOCK=1; EXTRA+=(--random_weights --preset tiny --size_level 64) ;;
    --dev) EXTRA+=(--random_weights --dev --size_level 512) ;;
    --backend) BACKEND=${2:?--backend needs a value}; shift ;;
    --device) DEVICE=${2:?--device needs a value}; shift ;;
    *) EXTRA+=("$1") ;;
  esac
  shift
done
if [ "$MOCK" = 1 ] && [ "$DEVICE" != cpu ]; then
  echo "--mock is the tiny preset (head_dim 16): pass --device cpu, or" \
       "--dev on the card" >&2
  exit 2
fi

COMMON=(--backend "$BACKEND" --evaluation --eval_dir assets/minibench
        --seed 110 --device "$DEVICE" "${EXTRA[@]}")

echo "== vanilla (dense) generation =="
"$PY" -m regione_tpu_torch.cli.main "${COMMON[@]}" --output_dir "$OUT/vanilla"
echo "== RegionE generation =="
"$PY" -m regione_tpu_torch.cli.main "${COMMON[@]}" --use_regione \
    --output_dir "$OUT/regione"

echo "== pixel metrics + merge =="
"$PY" -m regione_tpu_torch.eval.run_metrics --folder1 "$OUT/vanilla" \
    --folder2 "$OUT/regione" --device "$DEVICE" \
    ${LPIPS_WEIGHTS:+--lpips_weights "$LPIPS_WEIGHTS"}
"$PY" -m regione_tpu_torch.eval.merge --direction "$OUT/regione"

echo "== VIEScore (dry-run backbone unless OPENAI_KEY_PATH is set) =="
BACKBONE=dryrun
KEYS=()
if [ -n "${OPENAI_KEY_PATH:-}" ]; then
  BACKBONE=gpt4o
  KEYS=(--key_path "$OPENAI_KEY_PATH")
fi
"$PY" -m regione_tpu_torch.eval.run_viescore --data_dir assets/minibench \
    --gen_root "$OUT/regione" --backbone "$BACKBONE" --device "$DEVICE" \
    "${KEYS[@]}"
echo "minibench sweep complete -> $OUT"
