"""Binary mask quality metrics (IoU / Dice-F1 / precision / recall).

The port of ``atlaspatch_tpu/utils/maskeval.py``: host numpy and Pillow, the
same rows and summary. The reference's headline quality claim is
segmentation F1 versus TIAToolbox/CLAM/Trident baselines (SURVEY.md §6,
reference docs/index.html), but it ships no scoring code. This utility
scores predicted tissue masks (e.g. ``detect-tissue``'s
``<stem>_mask_bw.png``) against ground-truth annotation masks so the
comparison is reproducible on user data, and backs the ``evaluate-masks``
CLI command and finetune validation metrics.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("atlaspatch_tpu_torch.utils.maskeval")

_MASK_SUFFIXES = ("_mask_bw", "_mask")
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def binary_mask_metrics(pred: np.ndarray, truth: np.ndarray) -> dict:
    """IoU, Dice/F1, precision, recall for two boolean masks of equal shape.

    Empty-vs-empty scores 1.0 across the board (nothing to find, nothing
    found); empty truth with non-empty prediction scores 0 IoU/recall-style
    via the standard confusion-count formulas.
    """
    if pred.shape != truth.shape:
        raise ValueError(f"shape mismatch: pred {pred.shape} vs truth {truth.shape}")
    pred = pred.astype(bool)
    truth = truth.astype(bool)
    tp = float(np.logical_and(pred, truth).sum())
    fp = float(np.logical_and(pred, ~truth).sum())
    fn = float(np.logical_and(~pred, truth).sum())
    union = tp + fp + fn
    return {
        "iou": tp / union if union else 1.0,
        "f1": 2 * tp / (2 * tp + fp + fn) if (tp + fp + fn) else 1.0,
        "precision": tp / (tp + fp) if (tp + fp) else (1.0 if fn == 0 else 0.0),
        "recall": tp / (tp + fn) if (tp + fn) else (1.0 if fp == 0 else 0.0),
    }


def _stem_key(path: Path) -> str:
    stem = path.stem
    for suf in _MASK_SUFFIXES:
        if stem.endswith(suf):
            return stem[: -len(suf)]
    return stem


def _load_mask(path: Path, threshold: int, size_wh: Optional[tuple[int, int]] = None):
    from PIL import Image

    img = Image.open(path).convert("L")
    if size_wh is not None and img.size != size_wh:
        img = img.resize(size_wh, Image.NEAREST)
    return np.asarray(img) > threshold


def score_mask_dirs(
    pred_dir: Path, truth_dir: Path, *, threshold: int = 127
) -> tuple[list[dict], dict]:
    """Score every prediction with a stem-matched ground-truth mask.

    Returns (per-slide rows, mean summary). Truth masks are NEAREST-resized
    to the prediction's grid when sizes differ (annotations are commonly at
    a different thumbnail scale).
    """
    pred_dir, truth_dir = Path(pred_dir), Path(truth_dir)

    # One file per stem, on both sides. Visualization directories mix binary
    # masks with overlays and grid renderings for the same slide — prefer
    # the explicit binary mask: <stem>_mask_bw > <stem>_mask > <stem>.
    def _priority(p: Path) -> int:
        if p.stem.endswith("_mask_bw"):
            return 0
        if p.stem.endswith("_mask"):
            return 1
        return 2

    def _collect(d: Path) -> dict[str, Path]:
        by_stem: dict[str, Path] = {}
        for p in sorted(d.iterdir()) if d.is_dir() else []:
            if p.suffix.lower() not in _IMAGE_EXTS:
                continue
            stem = _stem_key(p)
            cur = by_stem.get(stem)
            if cur is None or _priority(p) < _priority(cur):
                by_stem[stem] = p
        return by_stem

    truth_by_stem = _collect(truth_dir)
    pred_by_stem = _collect(pred_dir)

    rows: list[dict] = []
    unmatched: list[str] = []
    for stem, p in sorted(pred_by_stem.items()):
        t = truth_by_stem.get(stem)
        if t is None:
            unmatched.append(stem)
            continue
        pred = _load_mask(p, threshold)
        truth = _load_mask(t, threshold, size_wh=(pred.shape[1], pred.shape[0]))
        rows.append({"slide": stem, **binary_mask_metrics(pred, truth)})
    if unmatched:
        # a silent subset would make the headline mean misleading
        logger.warning(
            "evaluate-masks: %d/%d prediction(s) had no stem-matched truth "
            "mask and were EXCLUDED from the summary: %s",
            len(unmatched),
            len(pred_by_stem),
            ", ".join(unmatched[:10]) + ("..." if len(unmatched) > 10 else ""),
        )
    if not rows:
        raise FileNotFoundError(
            f"no stem-matched (prediction, truth) mask pairs: pred={pred_dir} "
            f"truth={truth_dir}"
        )
    summary = {
        k: float(np.mean([r[k] for r in rows]))
        for k in ("iou", "f1", "precision", "recall")
    }
    summary["n"] = len(rows)
    return rows, summary
