"""File discovery and per-slide MPP overrides.

Parity: supported extension set and CSV contract match the reference
(reference: atlas_patch/utils/params.py:27-190). Errors raise ValueError; the
CLI layer translates them to user-facing messages.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger("atlaspatch_tpu_torch.utils")

# TIFF-family WSI containers decodable by the native layer, first-party
# non-TIFF container readers (MIRAX, Hamamatsu VMS/VMU, DICOM WSI — see
# io/mirax_wsi.py, io/hamamatsu_wsi.py, io/dicom_wsi.py), plus plain images.
SUPPORTED_EXTS = {
    ".svs",
    ".tif",
    ".tiff",
    ".ndpi",
    ".scn",
    ".bif",
    ".biff",
    ".mrxs",
    ".vms",
    ".vmu",
    ".dcm",
    ".dicom",
    ".png",
    ".jpg",
    ".jpeg",
    ".bmp",
    ".webp",
    ".gif",
}


def get_wsi_files(path: str, *, recursive: bool = False) -> list[str]:
    """List WSI files from a file or directory path (sorted, deduplicated)."""
    path_obj = Path(path)

    if path_obj.is_file():
        if path_obj.suffix.lower() not in SUPPORTED_EXTS:
            logger.warning("File may not be a supported WSI format: %s", path_obj.name)
        return [str(path_obj)]

    files_set: set[Path] = set()
    globber = path_obj.rglob if recursive else path_obj.glob
    for ext in SUPPORTED_EXTS:
        files_set.update(globber(f"*{ext}"))
        files_set.update(globber(f"*{ext.upper()}"))

    # Hamamatsu .vms/.vmu slides live beside their data files (ImageFile
    # JPEGs, MapFile, macro images...). Those companions must not be
    # discovered as standalone slides — exclude every file a map file in
    # the cohort references. (The reference, going through OpenSlide's
    # extension list, would try to open the companion JPEGs as plain
    # images; skipping them is strictly more correct.)
    companions: set[Path] = set()
    for f in files_set:
        if f.suffix.lower() not in (".vms", ".vmu"):
            continue
        try:
            # The same tolerant INI parse the Hamamatsu backend uses — a
            # hand-rolled splitter would accept a different dialect than
            # the reader that actually opens the slide.
            from atlaspatch_tpu_torch.io.hamamatsu_wsi import _read_ini

            cp = _read_ini(f)
        except Exception:  # noqa: BLE001 — unparseable map file: nothing to exclude
            continue
        for section in cp.sections():
            for key, value in cp.items(section):
                value = value.strip()
                if not value:
                    continue
                if key.strip().lower().startswith(
                    ("imagefile", "mapfile", "optimisationfile", "macroimage")
                ):
                    companions.add(f.parent / value)

    # DICOM WSI pyramids are usually stored as one file PER LEVEL plus
    # LABEL/OVERVIEW instances. Keep one entry per series — the base
    # (largest VOLUME) instance — so the pyramid is processed once, not once
    # per file; associated-image instances are companions like VMS maps.
    # Unparseable .dcm files stay listed so opening them fails loudly.
    dcm_files = [f for f in files_set if f.suffix.lower() in (".dcm", ".dicom")]
    if len(dcm_files) > 1:
        from atlaspatch_tpu_torch.io.dicom_wsi import dicom_instance_info

        info: dict[Path, tuple] = {}
        for f in dcm_files:
            try:
                info[f] = dicom_instance_info(f)
            except Exception:  # noqa: BLE001 — not a readable WSI instance
                continue
        best: dict[str, tuple[int, Path]] = {}
        for f, (uid, area, pyramid) in info.items():
            if pyramid and uid:
                cur = best.get(uid)
                if cur is None or (area, str(f)) > (cur[0], str(cur[1])):
                    best[uid] = (area, f)
        for f, (uid, area, pyramid) in info.items():
            if not pyramid:
                companions.add(f)
            elif uid and best[uid][1] != f:
                companions.add(f)

    files = sorted(files_set - companions)
    if not files:
        raise ValueError(
            f"No WSI files found in directory: {path}\n"
            f"Supported formats: SVS, TIF, TIFF, NDPI, PNG, JPG, etc."
        )
    return [str(f) for f in files]


def load_mpp_csv(csv_path: str) -> Dict[str, float]:
    """Load a {slide stem: mpp} mapping from a CSV with 'wsi' and 'mpp' columns."""
    csv_path_obj = Path(csv_path)
    if not csv_path_obj.exists():
        raise ValueError(f"MPP CSV file not found: {csv_path}")

    mpp_dict: Dict[str, float] = {}
    with open(csv_path_obj, encoding="utf-8") as f:
        reader = csv.DictReader(f)
        if (
            reader.fieldnames is None
            or "wsi" not in reader.fieldnames
            or "mpp" not in reader.fieldnames
        ):
            raise ValueError(
                f"CSV must contain 'wsi' and 'mpp' columns. Found: {reader.fieldnames}"
            )
        for row_num, row in enumerate(reader, start=2):
            wsi_name = (row.get("wsi") or "").strip()
            mpp_str = (row.get("mpp") or "").strip()
            if not wsi_name or not mpp_str:
                continue
            try:
                mpp_value = float(mpp_str)
            except ValueError:
                logger.warning(
                    "Row %d: invalid MPP value '%s' for %s, skipping", row_num, mpp_str, wsi_name
                )
                continue
            if mpp_value <= 0:
                logger.warning(
                    "Row %d: MPP must be positive for %s, got %s, skipping",
                    row_num,
                    wsi_name,
                    mpp_value,
                )
                continue
            mpp_dict[Path(wsi_name).stem] = mpp_value

    if not mpp_dict:
        raise ValueError(f"No valid MPP entries found in CSV: {csv_path}")
    return mpp_dict


def get_mpp_for_wsi(wsi_path: str, mpp_dict: Optional[Dict[str, float]]) -> Optional[float]:
    if mpp_dict is None:
        return None
    return mpp_dict.get(Path(wsi_path).stem)
