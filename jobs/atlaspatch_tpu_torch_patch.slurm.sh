#!/bin/bash
# Tissue segmentation + patch-coordinate extraction on a GPU node, with the
# PyTorch/CUDA port (atlaspatch_tpu_torch).
# Submit N identical copies for a cohort: per-slide lock files on the shared
# filesystem self-shard the work (same protocol as the reference's SLURM
# templates — SURVEY.md §2 rows 52-53). For several nodes under one process
# group use jobs/atlaspatch_tpu_torch_multinode.slurm.sh; static host sharding
# also follows ATLASPATCH_NUM_HOSTS / ATLASPATCH_HOST_ID when they are exported.
# With more than one card on the node (SLURM_GPUS_ON_NODE), each segmentation
# batch is split over all of them (--seg-data-parallel).
#
# Usage:
#   WSI_DIR=/data/slides OUT_DIR=/data/out \
#     sbatch jobs/atlaspatch_tpu_torch_patch.slurm.sh [extra CLI flags...]
#SBATCH --job-name=atlaspatch-torch-patch
#SBATCH --cpus-per-task=8
#SBATCH --gres=gpu:1
#SBATCH --mem=64G
#SBATCH --time=24:00:00

set -euo pipefail

WSI_DIR=${WSI_DIR:?set WSI_DIR to the slide directory}
OUT_DIR=${OUT_DIR:?set OUT_DIR to the output root}

SEG_PARALLEL=""
if [ "${SLURM_GPUS_ON_NODE:-1}" -gt 1 ]; then
  SEG_PARALLEL="--seg-data-parallel"
fi

# $SEG_PARALLEL is left unquoted on purpose: empty, it adds no argument.
"${PYTHON:-python}" -m atlaspatch_tpu_torch.cli segment-and-get-coords "$WSI_DIR" \
  --output "$OUT_DIR" \
  --patch-size 256 \
  --target-mag 20 \
  --device cuda \
  --seg-batch-size 32 \
  --patch-workers "${SLURM_CPUS_PER_TASK:-8}" \
  --max-open-slides 200 \
  --skip-existing \
  $SEG_PARALLEL "$@"
