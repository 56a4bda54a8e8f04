#!/bin/bash
# Patch feature embedding into existing per-slide H5s on a GPU node, with the
# PyTorch/CUDA port (atlaspatch_tpu_torch).
# Safe to run many copies concurrently: per-slide phase=features locks +
# complete-feature row-count checks make the job idempotent and elastic.
# With more than one card on the node (SLURM_GPUS_ON_NODE), each feature
# batch is split over all of them (--feature-parallel data). float16 runs as
# bfloat16 on the card.
#
# Usage:
#   WSI_DIR=/data/slides OUT_DIR=/data/out EXTRACTORS="uni_v1 conch_v1" \
#     sbatch jobs/atlaspatch_tpu_torch_features.slurm.sh [extra CLI flags...]
#SBATCH --job-name=atlaspatch-torch-features
#SBATCH --cpus-per-task=8
#SBATCH --gres=gpu:1
#SBATCH --mem=64G
#SBATCH --time=24:00:00

set -euo pipefail

WSI_DIR=${WSI_DIR:?set WSI_DIR to the slide directory}
OUT_DIR=${OUT_DIR:?set OUT_DIR to the output root}
EXTRACTORS=${EXTRACTORS:-uni_v1}

FEATURE_PARALLEL=""
if [ "${SLURM_GPUS_ON_NODE:-1}" -gt 1 ]; then
  FEATURE_PARALLEL="--feature-parallel data"
fi

# $FEATURE_PARALLEL is left unquoted on purpose: empty it adds no argument,
# else it splits into the flag and its value.
"${PYTHON:-python}" -m atlaspatch_tpu_torch.cli process "$WSI_DIR" \
  --output "$OUT_DIR" \
  --patch-size 256 \
  --target-mag 20 \
  --device cuda \
  --feature-extractors "$EXTRACTORS" \
  --feature-batch-size 64 \
  --feature-precision float16 \
  --seg-batch-size 32 \
  --skip-existing \
  $FEATURE_PARALLEL "$@"
