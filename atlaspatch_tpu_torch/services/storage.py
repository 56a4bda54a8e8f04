"""HDF5 patch-coordinate storage.

Output schema is bit-compatible with the reference (reference:
atlas_patch/services/storage.py:17-392) so downstream MIL pipelines are
untouched:

  coords      (N, 5) int32 rows [x, y, read_w, read_h, level]
  passports   (N,)  S160 strings "{stem}__x{X}_y{Y}_rw{RW}_rh{RH}_lv{LV}_mag{MAG}_tmag{TMAG}_total{TOTAL}"

File attrs: patch_size, patch_size_level0, level0_magnification,
target_magnification, overlap, level0_width/height, wsi_path, passport_format,
passport_version=2, creation_date, num_patches, plus slide metadata
(filename, mpp, magnification, vendor, institution, stain when known).

Feature datasets: features/<name> (N, D) float32 with attrs name and
embedding_dim.

Files are written by the port's own HDF5 writer (utils/h5.py), one atomic
write per slide. Coordinate writing keeps the two-pass count-then-write shape
so passports embed the final total. Feature appends collect each feature's
rows on the host and add them to the published file in one atomic rewrite
(utils/h5.py ``add_datasets``), where the JAX package grows ``__tmp_<name>``
datasets in place and renames them.
"""

from __future__ import annotations

import concurrent.futures as _fut
import logging
import os
from collections import deque
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Callable, Iterable, Mapping

import numpy as np

from atlaspatch_tpu_torch.utils import perf
from atlaspatch_tpu_torch.utils.h5 import AtomicH5, add_datasets, read_h5_tree

logger = logging.getLogger("atlaspatch_tpu_torch.storage")

PASSPORT_FORMAT = "{stem}__x{X}_y{Y}_rw{RW}_rh{RH}_lv{LV}_mag{MAG}_tmag{TMAG}_total{TOTAL}"
PASSPORT_VERSION = 2
_PASSPORT_DTYPE = np.dtype("S160")

# Entry tuple yielded by extraction iterators: (x, y, read_w, read_h, level, patch|None)
Entry = tuple[int, int, int, int, int, "np.ndarray | None"]


def save_patch_png(patch_arr: np.ndarray, out_path: Path) -> None:
    from PIL import Image

    Image.fromarray(patch_arr).save(str(out_path))


class H5PatchWriter:
    """Writes patch coordinates (and optional images) for one slide."""

    def __init__(
        self,
        *,
        chunk_rows: int,
        patch_size: int,
        patch_size_level0: int,
        level0_mag: int,
        target_mag: int,
        level0_wh: tuple[int, int],
        overlap: int,
        slide_stem: str,
        wsi_path: str,
        total_patches: int | None = None,
        extra_file_attrs: Mapping[str, Any] | None = None,
    ) -> None:
        self.chunk_rows = max(1, int(chunk_rows))
        self.patch_size = int(patch_size)
        self.patch_size_level0 = int(patch_size_level0)
        self.level0_mag = int(level0_mag)
        self.target_mag = int(target_mag)
        self.level0_wh = (int(level0_wh[0]), int(level0_wh[1]))
        self.overlap = int(overlap)
        self.slide_stem = slide_stem
        self.wsi_path = wsi_path
        self.total_patches = int(total_patches) if total_patches is not None else None
        self.extra_file_attrs = dict(extra_file_attrs) if extra_file_attrs else {}

    # --- seed + coord writing ------------------------------------------------------
    def _file_attrs(self) -> dict[str, Any]:
        level0_width, level0_height = self.level0_wh
        file_attrs: dict[str, Any] = {
            "patch_size": self.patch_size,
            "patch_size_level0": self.patch_size_level0,
            "level0_magnification": self.level0_mag,
            "target_magnification": self.target_mag,
            "overlap": self.overlap,
            "level0_width": level0_width,
            "level0_height": level0_height,
            "wsi_path": self.wsi_path,
            "passport_format": PASSPORT_FORMAT,
            "passport_version": PASSPORT_VERSION,
            "creation_date": datetime.now(timezone.utc).isoformat(),
        }
        file_attrs.update(self.extra_file_attrs)
        return file_attrs

    def _passports_vec(self, coords: np.ndarray) -> np.ndarray:
        """Vectorized passport strings for an (N,5) int coord array."""
        mag_val: int | str = self.level0_mag if self.level0_mag else "na"
        tgt_val: int | str = self.target_mag if self.target_mag else "na"
        head = f"{self.slide_stem}__x"
        tail = f"_mag{mag_val}_tmag{tgt_val}_total{self.total_patches}"
        cols = coords.astype(np.int64).T
        s = np.char.add(head, cols[0].astype("U12"))
        for label, col in zip(("_y", "_rw", "_rh", "_lv"), cols[1:]):
            s = np.char.add(np.char.add(s, label), col.astype("U12"))
        out = np.char.add(s, tail)
        # S160 matches the reference's dtype, but a very long slide stem
        # would silently truncate the _mag/_tmag/_total suffix — widen the
        # row dtype (ascii: bytes == chars) instead of corrupting passports.
        width = max(
            _PASSPORT_DTYPE.itemsize,
            int(np.char.str_len(out).max()) if out.size else 0,
        )
        return out.astype(np.dtype(f"S{width}"))

    @staticmethod
    def _drain_png_future(fut: _fut.Future) -> None:
        """Per-patch PNG export is best-effort once coords are committed: a
        transient image-save failure logs but never aborts the slide
        (reference fault tolerance, atlas_patch/services/storage.py:96-104)."""
        try:
            fut.result()
        except Exception as e:  # noqa: BLE001
            logger.warning("Patch PNG export failed: %s", e)

    def _write_collected(
        self,
        output_path: Path,
        all_coords: list[tuple[int, int, int, int, int]],
    ) -> int:
        """Write a fully collected coordinate list (total already known): both
        datasets contiguous, the file built in memory and written at once."""
        self.total_patches = len(all_coords)
        coords = np.asarray(all_coords, dtype=np.int32).reshape(-1, 5)
        passports = (
            self._passports_vec(coords)
            if coords.shape[0]
            else np.empty((0,), dtype=_PASSPORT_DTYPE)
        )
        with perf.stage("h5_write"), AtomicH5(output_path) as store:
            store.put_all("coords", coords)
            store.put_all("passports", passports)
            store.set_attrs(self._file_attrs())
            store.set_attrs({"num_patches": int(coords.shape[0])})
        return int(coords.shape[0])

    def write_coords(
        self,
        output_path: Path,
        entries: Iterable[Entry],
        *,
        batch: int,
        collect_coords: bool = False,
    ) -> tuple[int, np.ndarray | None]:
        """Two-pass coordinate write; returns (total, optional (N,2) xy array).

        `batch` is part of the writer interface (streamed writers chunk by
        it); this collected implementation writes one-shot and ignores it."""
        del batch
        all_coords = [(int(x), int(y), int(rw), int(rh), int(lv)) for x, y, rw, rh, lv, _ in entries]
        total = self._write_collected(output_path, all_coords)
        coords_arr = (
            np.asarray([(c[0], c[1]) for c in all_coords], dtype=np.int32)
            if collect_coords
            else None
        )
        return total, coords_arr

    def write_coords_and_images(
        self,
        output_path: Path,
        entries: Iterable[Entry],
        image_dir: Path,
        *,
        batch: int,
        collect_coords: bool = False,
    ) -> tuple[int, np.ndarray | None]:
        """Coordinate write plus async per-patch PNG export.

        PNG writes run on a small bounded thread pool overlapping the entry
        iteration (which may be reading slide tiles), mirroring the reference's
        bounded-backlog scheme (reference: services/storage.py:73-104).
        """
        max_workers = max(2, min(8, os.cpu_count() or 4))
        max_pending = max_workers * 4
        futures: deque[_fut.Future[None]] = deque()
        all_coords: list[tuple[int, int, int, int, int]] = []

        with _fut.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="patch-img") as ex:
            for x, y, rw, rh, lv, patch in entries:
                all_coords.append((int(x), int(y), int(rw), int(rh), int(lv)))
                if patch is not None:
                    out_name = f"{self.slide_stem}_x{int(x)}_y{int(y)}.png"
                    futures.append(
                        ex.submit(save_patch_png, patch.copy(), image_dir / out_name)
                    )
                    if len(futures) >= max_pending:
                        self._drain_png_future(futures.popleft())
            total = self._write_collected(output_path, all_coords)
            while futures:
                self._drain_png_future(futures.popleft())

        coords_arr = (
            np.asarray([(c[0], c[1]) for c in all_coords], dtype=np.int32)
            if collect_coords
            else None
        )
        return total, coords_arr

    # --- features ------------------------------------------------------------------
    def append_features(
        self,
        *,
        output_path: Path,
        feature_name: str,
        feature_fn: Callable[[int, int], np.ndarray],
        num_rows: int,
        feature_batch: int,
        feature_attrs: Mapping[str, int | str] | None = None,
        expected_total: int | None = None,
    ) -> int:
        """Append `features/<name>` by pulling row blocks from feature_fn(start, stop).

        The dataset appears only when all rows were produced and the count
        matches expected_total, preserving the reference's crash/resume safety
        (reference: services/storage.py:250-337). One-name delegate to
        `append_features_multi`, which holds the one implementation.
        """
        written = self.append_features_multi(
            output_path=output_path,
            feature_names=[feature_name],
            block_fn=lambda start, stop: {feature_name: feature_fn(start, stop)},
            num_rows=num_rows,
            feature_batch=feature_batch,
            feature_attrs={feature_name: feature_attrs or {}},
            expected_total=expected_total,
        )
        return int(written.get(feature_name, 0))

    def append_features_multi(
        self,
        *,
        output_path: Path,
        feature_names: Iterable[str],
        block_fn: Callable[[int, int], Mapping[str, np.ndarray]],
        num_rows: int,
        feature_batch: int,
        feature_attrs: Mapping[str, Mapping[str, int | str]] | None = None,
        expected_total: int | None = None,
    ) -> dict[str, int]:
        """Append several `features/<name>` datasets from ONE pass over the rows.

        `block_fn(start, stop)` returns `{name: rows}` for every extractor
        still active, so the caller reads each pixel block from the slide once
        and fans it out to all encoders (reference:
        atlas_patch/services/feature_embedding.py:81-96 re-reads per
        extractor).

        Fault isolation: `block_fn` may DROP a name from later blocks (an
        encoder raised on this slide); the dropped name leaves nothing and is
        excluded from the result, the survivors still land. The key set must
        never grow mid-stream. A survivor lands only when its row count matches
        `expected_total`. Rows stay on the host until every block is in, and all
        survivors are added to the file in one atomic rewrite: any error leaves
        the file as it was.
        """
        names = [str(n) for n in feature_names]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate feature names requested: {names}")
        if not names:
            return {}
        present = read_h5_tree(output_path, data=False).datasets
        for name in names:
            if f"features/{name}" in present:
                raise ValueError(f"Feature dataset '{name}' already exists in {output_path}.")
        batch_size = max(1, int(feature_batch))
        blocks: dict[str, list[np.ndarray]] = {name: [] for name in names}
        written: dict[str, int] = {name: 0 for name in names}
        active = list(names)

        for start in range(0, int(num_rows), batch_size):
            stop = min(start + batch_size, int(num_rows))
            block = block_fn(start, stop)
            unknown = set(block) - set(active)
            if unknown:
                raise ValueError(
                    f"block_fn returned rows for unknown/dropped features "
                    f"{sorted(unknown)} (active: {active})"
                )
            for name in [n for n in active if n not in block]:
                active.remove(name)
                del blocks[name], written[name]
            if not active:
                break
            for name in active:
                arr = np.asarray(block[name], dtype=np.float32)
                if arr.ndim != 2:
                    raise ValueError(
                        f"Feature extractor '{name}' must return a 2D array, got shape {arr.shape}"
                    )
                if arr.shape[0] != stop - start:
                    raise ValueError(
                        f"Feature extractor '{name}' returned {arr.shape[0]} "
                        f"rows for request of {stop - start}."
                    )
                if blocks[name] and blocks[name][0].shape[1] != arr.shape[1]:
                    raise ValueError(
                        f"Feature dim mismatch for '{name}': "
                        f"existing {blocks[name][0].shape[1]}, new {arr.shape[1]}"
                    )
                blocks[name].append(arr)
                written[name] += int(arr.shape[0])

        rows: dict[str, np.ndarray] = {}
        for name in active:
            if blocks[name]:
                rows[name] = np.concatenate(blocks[name])
            else:
                emb_dim = int(((feature_attrs or {}).get(name) or {}).get("embedding_dim", 0))
                if emb_dim <= 0:
                    raise ValueError(
                        f"Feature extractor '{name}' missing valid embedding_dim "
                        "to create dataset."
                    )
                rows[name] = np.empty((0, emb_dim), np.float32)
            if expected_total is not None and written[name] != int(expected_total):
                raise ValueError(
                    f"Feature rows written for '{name}' ({written[name]}) do not "
                    f"match expected coords ({expected_total})"
                )
        if rows:
            with perf.stage("h5_append"):
                add_datasets(
                    output_path, rows, group="features",
                    attrs={name: (feature_attrs or {}).get(name) or {} for name in rows},
                )
        return {name: int(written[name]) for name in active}
