"""Synthetic annotated WSI-thumbnail corpus for SAM2 training/eval.

The port of ``atlaspatch_tpu/tools/synthetic_corpus.py``: numpy and Pillow,
pixel for pixel the same pairs for the same seed.

The reference's segmentation model was finetuned on ~35,000 semi-manually
annotated WSI thumbnails (reference: CHANGELOG.md:13, docs/index.html:114-115)
that cannot be redistributed. This generator produces a stand-in corpus that
is *histology-shaped*, not merely blob-shaped:

  * tissue rendered through the Beer-Lambert stain model with the standard
    Ruifrok & Johnston H&E optical-density vectors — hematoxylin and eosin
    concentration FIELDS (multi-octave value noise) produce the real
    pink-purple chromaticity distribution, stroma/cellularity variation, and
    stain-intensity drift across a section, instead of flat painted colors;
  * section morphology: irregular perturbed-ellipse unions plus elongated
    curved strips (needle biopsies), satellite fragments, lumen/vessel holes,
    and adipose patches (honeycomb vacuoles — low-stain tissue riddled with
    white holes, the dominant real-slide hole morphology);
  * in-tissue artifacts that stay truth=1: tissue folds (locally doubled
    optical density along a curved band) — dark ≠ pen;
  * distractors that a naive darkness threshold calls tissue but truth=0:
    marker-pen strokes in saturated ink, coverslip edge shadows, air-bubble
    rims, dust specks;
  * scanner background: warm off-white with vignette + sensor noise.

Output layout (what finetune-sam2 and evaluate-masks consume):

  <out>/images/<stem>.png        RGB thumbnail
  <out>/masks/<stem>_mask.png    binary truth mask (255 = tissue)

Usage: python -m atlaspatch_tpu_torch.tools.synthetic_corpus <out> --n 128
(the pairs are made in one spawned process per CPU; a 4096x3072 pair takes ~1.5 GB)
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# Ruifrok & Johnston (2001) normalized H&E optical-density vectors — the
# standard stain-separation basis used across computational pathology.
H_OD = np.array([0.6443, 0.7167, 0.2668], np.float32)
E_OD = np.array([0.0928, 0.9541, 0.2831], np.float32)


def _noise2d(rng: np.random.Generator, h: int, w: int, cells: int,
             octaves: int = 3) -> np.ndarray:
    """Multi-octave value noise in [0, 1]: random low-res grids upsampled
    bilinearly and summed with halving amplitude."""
    from PIL import Image

    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        c = max(2, cells * (2**o))
        grid = rng.random((min(c, h), min(c, w))).astype(np.float32)
        up = Image.fromarray(grid, mode="F").resize((w, h), Image.BILINEAR)
        out += amp * np.asarray(up, np.float32)
        total += amp
        amp *= 0.5
    return out / total


def _window(shape: tuple[int, int], x_lo: float, x_hi: float, y_lo: float, y_hi: float) -> tuple[slice, slice]:
    """The (rows, columns) of a grid of ``shape`` that cover [x_lo, x_hi] x
    [y_lo, y_hi], widened by 2 px and clipped (possibly empty). A shape's
    test run over this window alone gives the same bits as over the whole
    grid: each pixel's value is computed alone, and outside the window it
    is False."""
    h, w = shape
    return (slice(max(0, int(np.floor(y_lo)) - 2), max(0, min(h, int(np.ceil(y_hi)) + 3))),
            slice(max(0, int(np.floor(x_lo)) - 2), max(0, min(w, int(np.ceil(x_hi)) + 3))))


def _blob(xx: np.ndarray, yy: np.ndarray, cx: float, cy: float, rx: float,
          ry: float, rng: np.random.Generator, wobble: float = 0.45) -> np.ndarray:
    """Irregular blob: unit ellipse with smooth radial harmonics."""
    reach = 1.0 + wobble * (1 + 1 / 2 + 1 / 3 + 1 / 4)  # the largest edge: r < edge only within it
    rows, cols = _window(xx.shape, cx - reach * rx, cx + reach * rx, cy - reach * ry, cy + reach * ry)
    dx = (xx[rows, cols] - cx) / rx
    dy = (yy[rows, cols] - cy) / ry
    r = np.sqrt(dx * dx + dy * dy)
    theta = np.arctan2(dy, dx)
    edge = np.ones_like(r)
    for k in range(1, 5):
        edge += rng.uniform(0.0, wobble / k) * np.sin(k * theta + rng.uniform(0, 2 * np.pi))
    out = np.zeros(xx.shape, dtype=bool)
    out[rows, cols] = r < edge
    return out


def _stroke(xx: np.ndarray, yy: np.ndarray, pts: np.ndarray, width: float) -> np.ndarray:
    """Thick polyline: union of distance-to-segment bands."""
    hit = np.zeros(xx.shape, dtype=bool)
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        rows, cols = _window(xx.shape, min(x0, x1) - width, max(x0, x1) + width,
                             min(y0, y1) - width, max(y0, y1) + width)
        xs, ys = xx[rows, cols], yy[rows, cols]
        vx, vy = x1 - x0, y1 - y0
        L2 = vx * vx + vy * vy + 1e-6
        t = np.clip(((xs - x0) * vx + (ys - y0) * vy) / L2, 0.0, 1.0)
        d2 = (xs - (x0 + t * vx)) ** 2 + (ys - (y0 + t * vy)) ** 2
        hit[rows, cols] |= d2 < width * width
    return hit


def _curved_strip(xg: np.ndarray, yg: np.ndarray, rng: np.random.Generator,
                  width: int, height: int) -> np.ndarray:
    """Elongated curved tissue strip (needle-biopsy core): a thick smooth
    polyline across a fraction of the frame."""
    n_pts = int(rng.integers(4, 7))
    x0, y0 = rng.uniform(0.1, 0.9) * width, rng.uniform(0.1, 0.9) * height
    ang = rng.uniform(0, 2 * np.pi)
    step = rng.uniform(0.08, 0.16) * max(width, height)
    pts = [(x0, y0)]
    for _ in range(n_pts - 1):
        ang += rng.uniform(-0.7, 0.7)
        pts.append((pts[-1][0] + step * np.cos(ang), pts[-1][1] + step * np.sin(ang)))
    return _stroke(xg, yg, np.asarray(pts, np.float32),
                   width=rng.uniform(0.015, 0.04) * max(width, height))


def make_annotated_thumbnail(
    width: int = 1024,
    height: int = 768,
    *,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """One (RGB uint8 image, bool truth mask) pair."""
    rng = np.random.default_rng(seed)
    xx = np.arange(width, dtype=np.float32)[None, :]
    yy = np.arange(height, dtype=np.float32)[:, None]
    xg = np.broadcast_to(xx, (height, width))
    yg = np.broadcast_to(yy, (height, width))

    # ---- tissue geometry -----------------------------------------------
    tissue = np.zeros((height, width), dtype=bool)
    adipose = np.zeros((height, width), dtype=bool)
    n_regions = int(rng.integers(1, 5))
    for _ in range(n_regions):
        cx = rng.uniform(0.15, 0.85) * width
        cy = rng.uniform(0.15, 0.85) * height
        rx = rng.uniform(0.08, 0.28) * width
        ry = rng.uniform(0.08, 0.28) * height
        if rng.random() < 0.25:  # needle-biopsy core instead of a block
            region = _curved_strip(xg, yg, rng, width, height)
            cx, cy = width / 2, height / 2
        else:
            region = _blob(xg, yg, cx, cy, rx, ry, rng)
            # satellite fragments hugging the main section (common in biopsies)
            for _ in range(int(rng.integers(0, 3))):
                fx = cx + rng.uniform(-1.4, 1.4) * rx
                fy = cy + rng.uniform(-1.4, 1.4) * ry
                region |= _blob(xg, yg, fx, fy, rx * rng.uniform(0.1, 0.3),
                                ry * rng.uniform(0.1, 0.3), rng)
        # lumen/vessel holes: inside the region but NOT tissue
        holes = np.zeros_like(region)
        for _ in range(int(rng.integers(0, 4))):
            hx = cx + rng.uniform(-0.5, 0.5) * rx
            hy = cy + rng.uniform(-0.5, 0.5) * ry
            holes |= _blob(xg, yg, hx, hy, rx * rng.uniform(0.06, 0.18),
                           ry * rng.uniform(0.06, 0.18), rng)
        # adipose patch: honeycomb of small vacuole holes in one corner of
        # the section — the dominant hole morphology on real slides
        if rng.random() < 0.5:
            ax = cx + rng.uniform(-0.6, 0.6) * rx
            ay = cy + rng.uniform(-0.6, 0.6) * ry
            patch = _blob(xg, yg, ax, ay, rx * rng.uniform(0.3, 0.6),
                          ry * rng.uniform(0.3, 0.6), rng) & region
            adipose |= patch
            n_vac = int(rng.integers(15, 50))
            vr = rng.uniform(0.015, 0.035) * min(width, height)
            vx_ = ax + rng.normal(0, rx * 0.35, n_vac)
            vy_ = ay + rng.normal(0, ry * 0.35, n_vac)
            for j in range(n_vac):
                r_j = vr * rng.uniform(0.5, 1.4)
                rows, cols = _window(holes.shape, vx_[j] - r_j, vx_[j] + r_j, vy_[j] - r_j, vy_[j] + r_j)
                holes[rows, cols] |= (((xg[rows, cols] - vx_[j]) ** 2 + (yg[rows, cols] - vy_[j]) ** 2 < r_j * r_j)
                                      & patch[rows, cols])
        holes &= region
        region &= ~holes
        tissue |= region

    # ---- stain fields (Beer-Lambert) -------------------------------------
    # Eosin: stroma/cytoplasm — smooth mid-frequency field with section-wide
    # intensity drift. Hematoxylin: cellularity — finer field so dense
    # (basophilic) areas read purple and loose stroma reads pink.
    # Scales tuned so pale stroma reads ~(240,165,225) and dense basophilic
    # areas ~(100,55,150) — the pink→purple range of real H&E thumbnails.
    drift = _noise2d(rng, height, width, 2, octaves=1)
    c_e = (0.10 + 0.35 * _noise2d(rng, height, width, 6)) * (0.75 + 0.5 * drift)
    c_h = (0.03 + 0.55 * _noise2d(rng, height, width, 14) ** 1.5) * (0.6 + 0.8 * drift)
    c_e = c_e * rng.uniform(0.7, 1.2)
    c_h = c_h * rng.uniform(0.6, 1.3)
    # adipose: vacuolated, nearly unstained cytoplasm between the holes
    c_e = np.where(adipose, c_e * 0.25, c_e)
    c_h = np.where(adipose, c_h * 0.35, c_h)

    # tissue folds: doubled optical density along a curved band (truth = 1)
    if rng.random() < 0.45:
        fold = _curved_strip(xg, yg, rng, width, height)
        fold &= tissue
        fold_f = np.where(fold, rng.uniform(1.7, 2.3), 1.0).astype(np.float32)
        c_e *= fold_f
        c_h *= fold_f

    od = c_h[..., None] * H_OD[None, None, :] + c_e[..., None] * E_OD[None, None, :]
    stain_rgb = 255.0 * np.power(10.0, -od)

    # ---- compose ----------------------------------------------------------
    # background: warm off-white with a gentle vignette
    bg = rng.uniform(238, 250)
    img = np.full((height, width, 3), bg, dtype=np.float32)
    img[:, :, 2] *= rng.uniform(0.97, 1.0)  # slight warm cast
    vign = 1.0 - 0.06 * (((xg / width - 0.5) ** 2 + (yg / height - 0.5) ** 2) * 2)
    img *= vign[..., None]
    img[tissue] = stain_rgb[tissue] * vign[tissue, None]

    # ---- distractors (truth = 0) -------------------------------------------
    # marker-pen strokes in saturated ink colors — always at least one, so a
    # plain darkness threshold is measurably wrong and "meaningful mask"
    # means more than thresholding
    pen_palette = [(30, 90, 40), (30, 50, 140), (150, 30, 30), (20, 20, 20)]
    for _ in range(int(rng.integers(1, 4))):
        n_pts = int(rng.integers(3, 6))
        pts = np.stack([
            rng.uniform(0.05, 0.95, n_pts) * width,
            rng.uniform(0.05, 0.95, n_pts) * height,
        ], axis=1)
        stroke = _stroke(xg, yg, pts, width=rng.uniform(3, 9))
        ink = np.array(pen_palette[int(rng.integers(len(pen_palette)))], np.float32)
        alpha = rng.uniform(0.7, 0.95)
        img[stroke] = (1 - alpha) * img[stroke] + alpha * ink

    # air bubble: bright interior with a dark rim, over background or tissue
    # (the rim is dark but must not read as tissue where truth says no)
    if rng.random() < 0.4:
        bx = rng.uniform(0.1, 0.9) * width
        by = rng.uniform(0.1, 0.9) * height
        br = rng.uniform(0.04, 0.12) * min(width, height)
        d = np.sqrt((xg - bx) ** 2 + (yg - by) ** 2)
        rim = (d > br * 0.88) & (d < br)
        inside = d <= br * 0.88
        img[rim] *= rng.uniform(0.3, 0.5)
        img[inside] = img[inside] * 0.3 + 0.7 * rng.uniform(225, 245)
        tissue &= ~inside  # bubble displaces the section optically

    # coverslip edge shadow along one border (dark, not tissue)
    if rng.random() < 0.5:
        side = int(rng.integers(4))
        depth = int(rng.uniform(4, 14))
        shade = rng.uniform(0.35, 0.7)
        sl = [np.s_[:depth, :], np.s_[-depth:, :], np.s_[:, :depth], np.s_[:, -depth:]][side]
        img[sl] *= shade

    # dust specks
    n_dust = int(rng.integers(0, 30))
    ys = rng.integers(0, height, n_dust)
    xs_d = rng.integers(0, width, n_dust)
    img[ys, xs_d] *= rng.uniform(0.3, 0.7, (n_dust, 1))

    # sensor noise
    img += rng.normal(0, 2.2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), tissue


def _write_pair(images: Path, masks: Path, width: int, height: int, seed: int, stem: str) -> None:
    from PIL import Image

    img, mask = make_annotated_thumbnail(width, height, seed=seed)
    Image.fromarray(img).save(images / f"{stem}.png")
    Image.fromarray((mask * 255).astype(np.uint8)).save(masks / f"{stem}_mask.png")


def generate_corpus(
    out_dir: Path,
    *,
    n: int = 128,
    width: int = 1024,
    height: int = 768,
    seed: int = 0,
    prefix: str = "syn",
    workers: int = 1,
) -> tuple[Path, Path]:
    """Write n annotated pairs; returns (images_dir, masks_dir). With
    ``workers`` > 1 the pairs are made in that many spawned processes: each
    pair depends on its seed alone, so the files are the same bytes."""
    images = Path(out_dir) / "images"
    masks = Path(out_dir) / "masks"
    images.mkdir(parents=True, exist_ok=True)
    masks.mkdir(parents=True, exist_ok=True)
    jobs = [(images, masks, width, height, seed + i, f"{prefix}{i:04d}") for i in range(n)]
    if min(workers, n) <= 1:
        for job in jobs:
            _write_pair(*job)
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=min(workers, n), mp_context=multiprocessing.get_context("spawn")) as pool:
            for done in [pool.submit(_write_pair, *job) for job in jobs]:
                done.result()
    return images, masks


def main() -> None:
    import os

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", type=Path)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix", default="syn")
    args = ap.parse_args()
    images, masks = generate_corpus(
        args.out, n=args.n, width=args.width, height=args.height,
        seed=args.seed, prefix=args.prefix, workers=len(os.sched_getaffinity(0)),
    )
    print(f"{args.n} pairs: {images} | {masks}")


if __name__ == "__main__":
    main()
