#!/bin/bash
# segment-and-get-coords across the GPU nodes of one SLURM allocation, with
# the PyTorch/CUDA port (atlaspatch_tpu_torch): one torchrun per node, one
# rank per card, all ranks in one torch.distributed process group.
#
# The GPU counterpart of jobs/atlaspatch_tpu_pod.sh (itself the counterpart
# of submitting N identical SLURM copies; SURVEY.md §2 rows 52-53). Work
# distribution combines:
#   * static host sharding — each rank takes its round-robin share of the
#     cohort, with its index and the rank count read from the live group
#     (atlaspatch_tpu_torch/parallel/multihost.py); exported
#     ATLASPATCH_NUM_HOSTS / ATLASPATCH_HOST_ID still win, and
#   * lock-file elasticity — a rank that finishes its shard steals the
#     unfinished slides of slower ranks through the same O_CREAT|O_EXCL
#     locks the reference uses, so stragglers cannot strand work.
# With one rank per card the group runs on nccl, each rank on the card at its
# LOCAL_RANK; ranks that share a card (G above the node's cards) run on gloo.
#
# Requires: this repo and the slide and output paths on every node (shared
# filesystem), torchrun on PATH, and the rendezvous port (RDZV_PORT) free on
# the first node.
#
# Usage:
#   WSI_DIR=/data/slides OUT_DIR=/data/out \
#     sbatch --nodes=4 --gres=gpu:8 jobs/atlaspatch_tpu_torch_multinode.slurm.sh [extra CLI flags...]
#SBATCH --job-name=atlaspatch-torch-multinode
#SBATCH --nodes=2
#SBATCH --ntasks-per-node=1
#SBATCH --gres=gpu:8
#SBATCH --cpus-per-task=32
#SBATCH --mem=256G
#SBATCH --time=24:00:00

set -euo pipefail

WSI_DIR=${WSI_DIR:?set WSI_DIR to the slide directory}
OUT_DIR=${OUT_DIR:?set OUT_DIR to the output root}
PATCH_SIZE=${PATCH_SIZE:-256}
TARGET_MAG=${TARGET_MAG:-20}
G=${G:-${SLURM_GPUS_ON_NODE:-8}}  # ranks per node: one per card
RDZV_PORT=${RDZV_PORT:-29500}
NNODES=${SLURM_NNODES:?run under sbatch or salloc}
HEAD=$(scontrol show hostnames "${SLURM_JOB_NODELIST:?run under sbatch or salloc}" | sed -n 1p)

# One task per node runs torchrun, which starts G workers on the interpreter
# ${PYTHON:-python}. Extra CLI flags pass through as given, spaces included.
srun torchrun \
  --nnodes "$NNODES" \
  --nproc-per-node "$G" \
  --rdzv-backend c10d \
  --rdzv-endpoint "$HEAD:$RDZV_PORT" \
  --rdzv-id "$SLURM_JOB_ID" \
  --no-python "${PYTHON:-python}" -m atlaspatch_tpu_torch.cli segment-and-get-coords "$WSI_DIR" \
  --output "$OUT_DIR" \
  --patch-size "$PATCH_SIZE" \
  --target-mag "$TARGET_MAG" \
  --device cuda \
  --seg-batch-size 32 \
  --fast \
  --skip-existing "$@"
