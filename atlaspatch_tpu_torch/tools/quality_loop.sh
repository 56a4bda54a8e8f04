#!/usr/bin/env bash
# Mask-quality loop with the PyTorch/CUDA port (atlaspatch_tpu_torch):
# synthetic corpus -> train SAM2 from random init on the card -> detect-tissue
# on held-out slides -> score against the truth (and against a random-weights
# baseline). The port of tools/quality_loop.sh: the same five steps with the
# same options, through the port's modules.
#
# Usage: bash atlaspatch_tpu_torch/tools/quality_loop.sh [WORKDIR]
#        (default ${TMPDIR:-/tmp}/qloop; WORKDIR is removed and made anew)
#
# SEG_INPUT_SIZE=<px> (default 1024) trains AND evaluates at a reduced SAM2
# input resolution — the evidence gate for lowering --seg-input-size in
# production (512 is ~4x less trunk compute on <=1024px thumbnails).
# EPOCHS=<n> overrides the training length. PYTHON=<interpreter> (default
# python) runs every step.
#
# Every command runs on the command line's default device, cuda. There is no
# CPU fallback: without a card the first CLI command stops with an error that
# names --device cpu, and set -e stops the script there.
set -ex
QL=${1:-${TMPDIR:-/tmp}/qloop}
SEG_INPUT_SIZE=${SEG_INPUT_SIZE:-1024}
EPOCHS=${EPOCHS:-20}
PY=${PYTHON:-python}
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
cd "$REPO"
rm -rf "$QL"; mkdir -p "$QL"

# 1. corpora: train thumbnails at 1024x768; eval "slides" at 4096x3072 so the
#    detect-tissue thumbnail (mag 5 / power 1.25 => ds 4) lands at 1024x768.
"$PY" -m atlaspatch_tpu_torch.tools.synthetic_corpus "$QL/train" --n 96 --seed 0
"$PY" -m atlaspatch_tpu_torch.tools.synthetic_corpus "$QL/eval" --n 16 \
  --width 4096 --height 3072 --seed 5000 --prefix ev
( echo "wsi,mpp"; for f in "$QL"/eval/images/*.png; do echo "$(basename "$f"),1.5"; done ) \
  > "$QL/eval_mpp.csv"

# 2. full training from random init on the card at 1024^2 (--trainable norms
#    is the reference recipe when starting from pretrained SAM2 weights instead)
ATLASPATCH_ALLOW_RANDOM_WEIGHTS=1 "$PY" -m atlaspatch_tpu_torch.cli finetune-sam2 \
  "$QL/train/images" --masks "$QL/train/masks" --output "$QL/run" \
  --epochs "$EPOCHS" --batch-size 4 --trainable all --learning-rate 3e-4 \
  --image-size "$SEG_INPUT_SIZE" \
  --lr-schedule cosine --warmup-steps 30 --val-fraction 0.15 --augment --seed 0 -v

# 3. trained predictions on held-out slides
"$PY" -m atlaspatch_tpu_torch.cli detect-tissue "$QL/eval/images" \
  --output "$QL/pred_trained" --seg-batch-size 16 \
  --seg-input-size "$SEG_INPUT_SIZE" \
  --mpp-csv "$QL/eval_mpp.csv" --sam2-checkpoint "$QL/run/sam2_finetuned.npz"

# 4. random-weights baseline predictions
ATLASPATCH_ALLOW_RANDOM_WEIGHTS=1 "$PY" -m atlaspatch_tpu_torch.cli detect-tissue \
  "$QL/eval/images" --output "$QL/pred_random" --seg-batch-size 16 \
  --seg-input-size "$SEG_INPUT_SIZE" \
  --mpp-csv "$QL/eval_mpp.csv"

# 5. score
echo '=== TRAINED ==='
"$PY" -m atlaspatch_tpu_torch.cli evaluate-masks "$QL/pred_trained/visualization" \
  --truth "$QL/eval/masks" --csv "$QL/trained.csv"
echo '=== RANDOM BASELINE ==='
"$PY" -m atlaspatch_tpu_torch.cli evaluate-masks "$QL/pred_random/visualization" \
  --truth "$QL/eval/masks" --csv "$QL/random.csv"
