"""SAM2 fine-tuning loop: (thumbnail, mask) pairs → norm-only updates.

The port of ``atlaspatch_tpu/models/train/loop.py``. The reference ships
no training code — its model card only documents the recipe ("~35,000
semi-manually annotated WSI thumbnails; SAM2 finetuned with backbone
frozen, only normalization layers trained", SURVEY.md §6 / reference
CHANGELOG.md:13). This module runs that recipe: the train step of
``models/train/finetune.py`` (focal + dice + IoU loss, AdamW on the norm
parameters), host-side image loading on threads, step checkpoints,
and a final ``sam2_finetuned.npz`` in the JAX package's archive layout,
which either package's ``--sam2-checkpoint`` loads. The data order, the
validation split, the augmentation flips and the resume rules are the JAX
loop's, so the same seed gives the same batches.

Several devices, as the JAX loop runs them: ``data_parallel`` N > 1 runs
the step over N local devices (``finetune.shard_train_step``); under a live
``torch.distributed`` group of more than one rank (``parallel/multihost.py``)
every rank runs the loop in lockstep on its own device, loads only its
contiguous slice of each global batch (flips drawn for the global batch),
and averages gradients and loss over the ranks before each update. Every
rank scores the whole holdout; rank 0 alone writes the checkpoints,
``meta.json`` and ``sam2_finetuned.npz``, and tells the others whether it
could (``_rank0_writes``). ``ATLASPATCH_NUM_HOSTS`` alone does not make
training multi-process.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger("atlaspatch_tpu_torch.train")

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def collect_pairs(images_dir: Path, masks_dir: Path) -> list[tuple[Path, Path]]:
    """Match images to masks by stem (`<stem>.*` or `<stem>_mask.*`)."""
    images_dir, masks_dir = Path(images_dir), Path(masks_dir)
    mask_by_stem: dict[str, Path] = {}
    for p in sorted(masks_dir.iterdir()) if masks_dir.is_dir() else []:
        if p.suffix.lower() not in _IMAGE_EXTS:
            continue
        stem = p.stem[:-5] if p.stem.endswith("_mask") else p.stem
        mask_by_stem.setdefault(stem, p)
    pairs = []
    for p in sorted(images_dir.iterdir()):
        if p.suffix.lower() not in _IMAGE_EXTS:
            continue
        m = mask_by_stem.get(p.stem)
        if m is not None:
            pairs.append((p, m))
    if not pairs:
        raise FileNotFoundError(
            f"no (image, mask) pairs: images={images_dir} masks={masks_dir} "
            "(masks match images by stem, with an optional '_mask' suffix)"
        )
    return pairs


def load_pair(img_path: Path, mask_path: Path, size: int) -> tuple[np.ndarray, np.ndarray]:
    """uint8 (S,S,3) image + float32 (S,S) {0,1} mask, resized like the
    inference path (bilinear image, NEAREST mask — segmentation service
    parity)."""
    from PIL import Image

    img = Image.open(img_path).convert("RGB").resize((size, size), Image.BILINEAR)
    mask = Image.open(mask_path).convert("L").resize((size, size), Image.NEAREST)
    return np.asarray(img, np.uint8), (np.asarray(mask) > 127).astype(np.float32)


def _data_parallel_devices(data_parallel: int, device: str, batch_size: int) -> list:
    """The first ``data_parallel`` local devices of ``device``'s kind, with
    the JAX loop's errors for too few devices and an uneven batch."""
    from atlaspatch_tpu_torch.parallel import mesh

    devices = mesh.local_devices(device)
    if len(devices) < data_parallel:
        raise RuntimeError(f"--data-parallel {data_parallel} needs that many devices; {len(devices)} visible")
    if batch_size % data_parallel:
        raise ValueError("batch size must divide evenly over data_parallel")
    return devices[:data_parallel]


def _rank0_writes(what: str, write: Callable[[], object]):
    """``write()`` on rank 0 alone (on the one process without a group).
    Rank 0 then broadcasts whether it succeeded, so no rank waits on one
    that failed: rank 0 raises its own error chained, every other rank a
    RuntimeError naming rank 0's failure. Returns what ``write`` returned
    (None on the other ranks)."""
    import torch
    import torch.distributed as dist

    from atlaspatch_tpu_torch.parallel import multihost

    group = multihost.live_group()
    rank = group[0] if group is not None else 0
    result = error = None
    if rank == 0:
        try:
            result = write()
        except Exception as e:  # noqa: BLE001 — told to the other ranks, then raised chained
            error = e
    if group is not None:
        failed = torch.tensor([float(error is not None)], device=multihost.collective_device())
        dist.broadcast(failed, src=0)
        if rank != 0 and failed.item():
            raise RuntimeError(f"rank 0 failed at {what}; rank {rank} stops with it")
    if error is not None:
        raise RuntimeError(f"{what} failed") from error
    return result


def finetune_sam2(
    images_dir: Path,
    masks_dir: Path,
    output_dir: Path,
    *,
    epochs: int = 1,
    batch_size: int = 2,
    learning_rate: float = 1e-4,
    checkpoint: Optional[Path] = None,
    config_path: Optional[Path] = None,
    image_size: Optional[int] = None,
    data_parallel: int = 1,
    save_every: int = 0,
    seed: int = 0,
    device: str = "cuda",
    loader_threads: int = 8,
    val_fraction: float = 0.0,
    resume: bool = False,
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    augment: bool = False,
    trainable: str = "norms",
    on_step: Optional[Callable[[int, float], None]] = None,
) -> dict:
    """Run the finetune and return a summary dict (the JAX loop's keys).

    ``image_size`` overrides the model input size — useful for small-scale
    experiments with random init; a checkpoint trained at 1024 loads only at
    its own size (shape mismatches fail loudly at load). ``device`` is a
    torch device (``cuda`` by default, ``cuda:N`` or ``cpu``).
    """
    from atlaspatch_tpu_torch.core.config import SegmentationConfig
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.convert import torch_to_flax_flat
    from atlaspatch_tpu_torch.models.train.checkpoints import save_checkpoint
    from atlaspatch_tpu_torch.models.train import finetune
    from atlaspatch_tpu_torch.parallel import multihost
    from atlaspatch_tpu_torch.parallel.mesh import LocalMesh
    from atlaspatch_tpu_torch.services.segmentation import SAM2Predictor

    # Multi-process: meet every rank while all are in lockstep, right after
    # the group's rendezvous, before minutes of model loading skew them.
    group = multihost.live_group()
    multihost.barrier("atlaspatch_finetune_start")
    seg_cfg = SegmentationConfig(checkpoint_path=checkpoint, device=device).validated()
    dp_devices = None
    if group is None and data_parallel > 1:
        dp_devices = _data_parallel_devices(data_parallel, seg_cfg.device, batch_size)
        seg_cfg = dataclasses.replace(seg_cfg, device=str(dp_devices[0]))
    rows = slice(None)  # this rank's rows of each global batch
    if group is not None:
        rank, world = group
        if batch_size % world:
            raise ValueError(
                f"global batch size {batch_size} must divide over the {world} ranks of the process group"
            )
        rows = slice(rank * (batch_size // world), (rank + 1) * (batch_size // world))

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    pairs = collect_pairs(images_dir, masks_dir)

    val_pairs: list = []
    if val_fraction > 0:
        split_rng = np.random.default_rng(seed)  # deterministic holdout
        order = split_rng.permutation(len(pairs))
        n_val = max(1, int(round(len(pairs) * val_fraction)))
        if n_val >= len(pairs):
            raise ValueError("val_fraction leaves no training pairs")
        val_pairs = [pairs[i] for i in order[:n_val]]
        pairs = [pairs[i] for i in order[n_val:]]

    sam2_cfg = (
        SAM2Config.from_reference_yaml(config_path)
        if config_path is not None
        else SAM2Config.tiny()
    )
    if image_size is not None:
        sam2_cfg = dataclasses.replace(sam2_cfg, image_size=int(image_size))

    # float32 (the config's default): the predictor turns TF32 off on a card
    model = SAM2Predictor(seg_cfg, sam2_cfg=sam2_cfg).model
    sam2_cfg = model.cfg
    size = sam2_cfg.image_size

    steps_per_epoch = max(1, len(pairs) // batch_size)
    params = finetune.trainable_parameters(model, trainable)
    optimizer, lr = finetune.make_optimizer(
        params.values(),
        learning_rate,
        schedule=lr_schedule,
        warmup_steps=warmup_steps,
        total_steps=epochs * steps_per_epoch,
    )
    if dp_devices is not None:
        step = finetune.shard_train_step(model, optimizer, lr, LocalMesh([[d] for d in dp_devices]),
                                         trainable=trainable)
    elif group is not None:
        step = finetune.make_train_step(model, optimizer, lr, all_reduce=True)
    else:
        step = finetune.make_train_step(model, optimizer, lr)

    rng = np.random.default_rng(seed)
    pool = ThreadPoolExecutor(max_workers=max(1, loader_threads))
    ahead = ThreadPoolExecutor(max_workers=1)  # loads the next batch (on ``pool``) while a step runs
    losses: list[float] = []
    global_step = 0
    start_epoch = 0

    ckpt_dir = output_dir / "checkpoints"
    run_meta = {
        "n_pairs": len(pairs),
        "n_val_pairs": len(val_pairs),
        "batch_size": batch_size,
        "seed": seed,
        "image_size": size,
        "lr_schedule": lr_schedule,
        "warmup_steps": warmup_steps,
        "augment": augment,
        "trainable": trainable,
        # A changed LR breaks the exact-reproduction guarantee in any
        # schedule, so it is always pinned. epochs/total_steps shape ONLY the
        # cosine decay — pinning them under "constant" would reject the
        # legitimate resume-an-interrupted-run-with-the-full-epoch-count
        # workflow, so they are recorded only when they matter.
        "learning_rate": learning_rate,
    }
    if lr_schedule == "cosine":
        run_meta["epochs"] = epochs
        run_meta["total_steps"] = epochs * steps_per_epoch
    resumed_at = 0
    if resume:
        from atlaspatch_tpu_torch.models.train.checkpoints import latest_step, restore_checkpoint

        multihost.barrier("atlaspatch_resume")  # every rank restores rank 0's file
        step_no = latest_step(ckpt_dir)
        if step_no is None:
            # A silent fresh start would be indistinguishable from a real
            # resume — hours of training could restart unnoticed.
            raise FileNotFoundError(
                f"--resume: no checkpoints under {ckpt_dir} (the previous run "
                "needs --save-every > 0); rerun without --resume to start fresh"
            )
        meta_path = ckpt_dir / "meta.json"
        if meta_path.exists():
            saved = json.loads(meta_path.read_text())
            # Compare only keys the checkpointed run recorded: meta.json
            # written before a key existed must stay resumable (the value was
            # simply not tracked then), but any RECORDED value must match.
            diffs = {
                k: (saved[k], run_meta[k])
                for k in run_meta
                if k in saved and saved[k] != run_meta[k]
            }
            if diffs:
                raise ValueError(
                    "--resume: run configuration differs from the checkpointed "
                    f"run (saved vs current): {diffs}. Epoch replay would be "
                    "silently wrong; start a fresh output dir instead."
                )
            untracked = sorted(k for k in run_meta if k not in saved)
            if untracked:
                logger.warning(
                    "--resume: checkpoint meta.json predates %s; cannot verify "
                    "those settings match the original run",
                    untracked,
                )
        global_step = restore_checkpoint(ckpt_dir, step_no, model, optimizer, params)
        if global_step % steps_per_epoch:
            raise ValueError(
                f"--resume: checkpoint step {global_step} is not a whole number "
                f"of epochs at {steps_per_epoch} steps/epoch — the run "
                "configuration changed since the checkpoint was written"
            )
        resumed_at = global_step
        start_epoch = min(epochs, global_step // steps_per_epoch)
        # Replay the epoch shuffles consumed before the checkpoint so the
        # resumed run sees the data order the original run would have.
        for _ in range(start_epoch):
            rng.permutation(len(pairs))
        logger.info("resumed from step %d (epoch %d)", global_step, start_epoch)

    def _load_batch(idx: np.ndarray, source: list | None = None) -> tuple[np.ndarray, np.ndarray]:
        src = pairs if source is None else source
        loaded = list(pool.map(lambda i: load_pair(*src[i], size), idx))
        return (
            np.stack([im for im, _ in loaded]),
            np.stack([mk for _, mk in loaded]),
        )

    eval_step = finetune.make_eval_step(model) if val_pairs else None
    val_loss = val_iou = None

    def _run_validation() -> tuple[float, float]:
        # Fixed-size batches (wrap the tail), as the JAX loop keeps its
        # jitted shape static; per-sample outputs let us drop the wrapped
        # duplicates so every holdout pair counts exactly once in the means.
        losses_v, ious_v = [], []
        for b in range(0, len(val_pairs), batch_size):
            n_real = min(batch_size, len(val_pairs) - b)
            idx = np.arange(b, b + batch_size) % len(val_pairs)
            images_u8, targets = _load_batch(idx, val_pairs)
            lv, iv = eval_step(images_u8, targets)
            losses_v.extend(lv.cpu().numpy()[:n_real].tolist())
            ious_v.extend(iv.cpu().numpy()[:n_real].tolist())
        return float(np.mean(losses_v)), float(np.mean(ious_v))

    try:
        for epoch in range(start_epoch, epochs):
            order = rng.permutation(len(pairs))
            # Wrap modulo the dataset so every batch is exactly batch_size
            # even when batch_size > len(pairs). Multi-process: this rank
            # loads only its contiguous slice; the flips are drawn for the
            # global batch and sliced alike.
            batches = [order[np.arange(b * batch_size, (b + 1) * batch_size) % len(order)][rows]
                       for b in range(steps_per_epoch)]
            loading = ahead.submit(_load_batch, batches[0])
            for b in range(steps_per_epoch):
                images_u8, targets = loading.result()
                if b + 1 < steps_per_epoch:
                    loading = ahead.submit(_load_batch, batches[b + 1])
                if augment:
                    # Flips applied identically to image and mask. Seeded by
                    # (seed, global_step), not the shuffle rng, so checkpoint
                    # resume reproduces them without replaying draws.
                    aug = np.random.default_rng((seed, global_step))
                    flips = aug.integers(0, 2, size=(batch_size, 2), dtype=np.int64)[rows]
                    images_u8 = images_u8.copy()
                    targets = targets.copy()
                    for i, (fh, fv) in enumerate(flips):
                        if fh:
                            images_u8[i] = images_u8[i, :, ::-1]
                            targets[i] = targets[i, :, ::-1]
                        if fv:
                            images_u8[i] = images_u8[i, ::-1]
                            targets[i] = targets[i, ::-1]
                loss = step(images_u8, targets)
                global_step += 1
                loss_f = float(loss)
                losses.append(loss_f)
                if on_step is not None:
                    on_step(global_step, loss_f)
            if eval_step is not None:
                val_loss, val_iou = _run_validation()
                logger.info(
                    "epoch %d/%d: train loss %.4f | val loss %.4f val IoU %.4f",
                    epoch + 1,
                    epochs,
                    float(np.mean(losses[-steps_per_epoch:])),
                    val_loss,
                    val_iou,
                )
            else:
                logger.info(
                    "epoch %d/%d: mean loss %.4f",
                    epoch + 1,
                    epochs,
                    float(np.mean(losses[-steps_per_epoch:])),
                )
            if save_every and (epoch + 1) % save_every == 0:

                def save() -> Path:
                    path = save_checkpoint(ckpt_dir, global_step, model, optimizer, params)
                    (ckpt_dir / "meta.json").write_text(json.dumps(run_meta))
                    return path

                path = _rank0_writes(f"saving the step {global_step} checkpoint under {ckpt_dir}", save)
                if path is not None:
                    logger.info("saved %s", path)
        if eval_step is not None and val_loss is None:
            # Nothing-left-to-train resume: still score the restored params
            # so --resume --val-fraction reports metrics for the checkpoint.
            val_loss, val_iou = _run_validation()
    finally:
        ahead.shutdown(wait=False)
        pool.shutdown(wait=False)

    npz_path = output_dir / "sam2_finetuned.npz"
    _rank0_writes(f"writing {npz_path}", lambda: np.savez(npz_path, **torch_to_flax_flat(model, sam2_cfg)))
    summary = {
        "steps": global_step,
        "steps_this_run": global_step - resumed_at,
        "resumed_at": resumed_at,
        "pairs": len(pairs),
        # None when a resumed run had nothing left to do
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "checkpoint": str(npz_path),
        "image_size": size,
    }
    if val_loss is not None:
        summary.update({"val_pairs": len(val_pairs), "val_loss": val_loss, "val_iou": val_iou})
    return summary
