"""The benchmark's slide cohort: JPEG-tiled SVS pyramids and a seeded listing.

A pool of distinct slides is written once per checkout into
``portbench/_cache/cohort/<key>/`` (``key`` hashes the cohort's parameters), by
one spawned process per slide. A run lists the pool in an order drawn from its
seed, cycling through it, as hard links (symbolic links across file systems)
in a directory of its own: a listing long enough that no window can reach its
end. Every seed so sees the same slides, in another order.

Each slide is an H&E-like canvas: a smooth random field thresholded at the
share of tissue asked for, pink textured tissue on a near-white background,
written with a 2x pyramid down to the thumbnail's power and an Aperio
description (AppMag, MPP) the slide readers take the magnification from.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parents[1] / "_cache" / "cohort"
VERSION = 1
APERIO_DESC = "Aperio Image Library v12\r\n{}x{} | AppMag = {} | MPP = {}"


def make_canvas(width: int, height: int, seed: int, tissue_share: float) -> np.ndarray:
    """An (height, width, 3) uint8 H&E-like canvas, about ``tissue_share`` tissue."""
    import cv2

    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((height // 384 + 3, width // 384 + 3)).astype(np.float32)
    coarse = cv2.GaussianBlur(coarse, (0, 0), 0.8)
    field = cv2.resize(coarse, (width, height), interpolation=cv2.INTER_CUBIC)
    tissue = field > np.quantile(field[::16, ::16], 1.0 - tissue_share)
    del field
    tex = rng.standard_normal((height // 8 + 1, width // 8 + 1)).astype(np.float32)
    tex = cv2.resize(tex, (width, height), interpolation=cv2.INTER_LINEAR)
    canvas = np.empty((height, width, 3), dtype=np.uint8)
    fine = rng.integers(0, 9, size=(height, width), dtype=np.uint8)
    for c, (base, amp) in enumerate(((212.0, 22.0), (138.0, 30.0), (184.0, 20.0))):
        chan = np.where(tissue, np.float32(base) + np.float32(amp) * tex, np.float32(243.0)) + fine
        canvas[..., c] = np.clip(chan, 0, 255).astype(np.uint8)
    return canvas


def _write_one(path: str, width: int, height: int, levels: int, tile: int, seed: int,
               tissue_share: float, mag: int, mpp: float) -> str:
    from portbench.inputs.tiff_writer import write_pyramid

    tmp = f"{path}.tmp"
    write_pyramid(tmp, make_canvas(width, height, seed, tissue_share), levels=levels, tile=tile,
                  description=APERIO_DESC.format(width, height, mag, mpp))
    os.replace(tmp, path)
    return path


def pool(cohort: dict, workers: int = 8) -> list[Path]:
    """The pool's slide files, written if absent."""
    key = hashlib.sha256(json.dumps({**cohort, "v": VERSION}, sort_keys=True).encode()).hexdigest()[:16]
    root = CACHE / key
    root.mkdir(parents=True, exist_ok=True)
    paths = [root / f"slide_{i:02d}.svs" for i in range(cohort["pool"])]
    todo = [p for p in paths if not p.exists()]
    if todo:
        args = [(str(p), cohort["width"], cohort["height"], cohort["levels"], cohort["tile"],
                 cohort["pool_seed"] + paths.index(p), cohort["tissue_share"], cohort["app_mag"],
                 cohort["mpp"]) for p in todo]
        n = max(1, min(workers, len(todo)))
        if n == 1:
            for a in args:
                _write_one(*a)
        else:
            with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn")) as ex:
                list(ex.map(_write_one, *zip(*args)))
    return paths


def listing(paths: list[Path], n: int, seed: int, out_dir: Path) -> list[tuple[Path, Path]]:
    """``n`` entries ``out_dir/s00000.svs``... linking to the pool in a seeded
    order, each pass over the pool drawn anew; [(entry, pool file)]."""
    rng = np.random.default_rng(seed)
    out_dir.mkdir(parents=True, exist_ok=True)
    order: list[int] = []
    while len(order) < n:
        order.extend(int(i) for i in rng.permutation(len(paths)))
    entries = []
    for i, k in enumerate(order[:n]):
        entry = out_dir / f"s{i:05d}.svs"
        try:
            os.link(paths[k], entry)
        except OSError:
            entry.symlink_to(paths[k])
        entries.append((entry, paths[k]))
    return entries
