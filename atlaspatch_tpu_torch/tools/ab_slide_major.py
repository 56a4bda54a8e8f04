"""A/B: slide-major against extractor-major multi-extractor embedding on the card.

    python3 -m atlaspatch_tpu_torch.tools.ab_slide_major

The port of ``tools/ab_slide_major.py``. It measures the ``embed_all`` loop
order in isolation: the same warm, pre-built extractors serve both modes
through a registry whose ``cleanup`` does nothing, the same coordinate H5
files are copied fresh for every pass, and the modes alternate A,B,A,B,...
so drift hits both alike. Per pass it reports the wall time and the
``patch_read`` stage's seconds and share of the wall; per mode the
medians; and the largest difference between the features the two modes
wrote (the same patches through the same extractors: 0 where the batches
match).

Settings (environment):
  AB_SLIDES      synthetic JPEG SVS pyramids of 4096x3072 (default 8)
  AB_PASSES      pass pairs (default 3)
  AB_EXTRACTORS  comma-separated zoo names, at least two (default vit_l_16,resnet50)
  AB_DEVICE      cuda (default; bfloat16) or cpu (float32), for a functional run

Run it with the host otherwise idle. Random weights; nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SLIDE_W, SLIDE_H = 4096, 3072
TESTS = Path(__file__).resolve().parents[2] / "tests"  # tests/tiff_builder.py writes the pyramids


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> tuple[int, int, list[str], str]:
    """(slides, pass pairs, extractors, device) from the environment; refuses
    a device this port does not run on, or a card that is not there."""
    slides = int(os.environ.get("AB_SLIDES", "8"))
    passes = int(os.environ.get("AB_PASSES", "3"))
    extractors = os.environ.get("AB_EXTRACTORS", "vit_l_16,resnet50").split(",")
    device = os.environ.get("AB_DEVICE", "cuda")
    if device.split(":")[0] not in ("cuda", "cpu"):
        raise SystemExit(f"AB_DEVICE={device!r}: this PyTorch port runs on cuda or cpu, not elsewhere")
    if device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("AB_DEVICE=cuda but no CUDA card is visible; set AB_DEVICE=cpu to run on the CPU")
    if len(extractors) < 2:
        raise SystemExit("AB_EXTRACTORS needs >= 2 names: with one extractor the service "
                         "runs extractor-major in BOTH modes, so the A/B ratio is noise.")
    return slides, passes, extractors, device


def build_corpus(tmp: Path, n_slides: int):
    """Synthetic SVS pyramids → segmentation (thresholded thumbnails) → coordinate H5s."""
    from atlaspatch_tpu_torch.core.config import (
        AppConfig, ExtractionConfig, OutputConfig, ProcessingConfig, SegmentationConfig,
    )
    from atlaspatch_tpu_torch.core.models import Mask
    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader

    sys.path.insert(0, str(TESTS))
    from tiff_builder import write_pyramid

    in_dir = tmp / "slides"
    in_dir.mkdir()
    log(f"writing {n_slides} JPEG-tiled SVS pyramids ...")
    canvases = [make_tissue_canvas(SLIDE_W, SLIDE_H, seed=7 + s, n_blobs=3) for s in range(4)]
    for i in range(n_slides):
        write_pyramid(
            in_dir / f"ab{i:03d}.svs", canvases[i % 4], levels=3, tile=256, compression=7,
            description=f"Aperio Image Library v12\r\n{SLIDE_W}x{SLIDE_H} | AppMag = 20 | MPP = 0.5",
        )

    class ThresholdSeg:
        def segment_thumbnail(self, wsi) -> Mask:
            thumb = np.asarray(wsi.get_thumb((256, 256)).convert("L"), dtype=np.float32)
            mask = (thumb < 220).astype(np.float32)
            return Mask(data=mask, source_shape=mask.shape)

        def segment_batch(self, wsis):
            return [self.segment_thumbnail(w) for w in wsis]

        def close(self):
            pass

    class NullResolver:
        def resolve(self, slide):
            return None

    cfg = AppConfig(
        processing=ProcessingConfig(input_path=in_dir),
        segmentation=SegmentationConfig(device="cpu", batch_size=8),
        extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
        output=OutputConfig(output_root=tmp / "coords_out", skip_existing=False),
        device="cpu",
    )
    runner = ProcessingRunner(
        config=cfg,
        segmentation=ThresholdSeg(),
        extractor=PatchExtractionService(cfg.extraction, cfg.output),
        visualizer=None,
        mpp_resolver=NullResolver(),
        wsi_loader=DefaultWSILoader(),
    )
    results, failures = runner.run()
    if failures:
        raise RuntimeError(f"coordinates failed for {failures}")
    log(f"corpus ready: {len(results)} slides, {sum(r.num_patches for r in results)} patches total")
    return sorted(results, key=lambda r: r.slide.stem), cfg


class WarmRegistry:
    """Serves pre-built warm extractor instances; cleanup() is disarmed so
    both modes reuse the same models and device params."""

    def __init__(self, extractors: dict):
        self._ext = extractors
        for ext in extractors.values():
            ext.cleanup = lambda: None  # instance-level no-op

    def create(self, name: str):
        return self._ext[name]


def _features(run_dir: Path) -> dict:
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    out = {}
    for path in sorted((run_dir / "patches").glob("*.h5")):
        datasets = read_h5(path)[0]
        out.update({(path.stem, k): v for k, v in datasets.items() if k.startswith("features/")})
    return out


def main() -> dict:
    """Runs the A/B; returns {"passes": [(mode, wall s, patch_read s)], "patches", "extractors",
    "feature_max_abs"} (also logged)."""
    os.environ.setdefault("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    os.environ.setdefault("ATLASPATCH_PROFILE", "1")
    n_slides, pass_pairs, extractor_names, device = settings()

    from atlaspatch_tpu_torch.core.config import FeatureExtractionConfig
    from atlaspatch_tpu_torch.models.encoders.zoo import build_default_registry
    from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader
    from atlaspatch_tpu_torch.utils import perf

    tmp = Path(tempfile.mkdtemp(prefix="ab_slide_major_"))
    try:
        results, cfg = build_corpus(tmp, n_slides)
        total_patches = sum(r.num_patches for r in results)
        dtype = "float32" if device == "cpu" else "bfloat16"
        real_reg = build_default_registry(device=device, dtype=dtype)
        warm_patches = list(np.random.default_rng(0).integers(0, 255, (64, 256, 256, 3), dtype=np.uint8))
        extractors = {}
        for name in extractor_names:
            log(f"building + warming {name} ...")
            ext = real_reg.create(name)
            if not np.isfinite(ext.extract_batch(warm_patches, batch_size=32)).all():
                raise RuntimeError(f"{name}: non-finite features on the warm batch")
            extractors[name.lower()] = ext  # the embedding service lowercases names before create()
        registry = WarmRegistry(extractors)
        feat_cfg = FeatureExtractionConfig(extractors=extractor_names, batch_size=32, device=device,
                                           precision="float16" if device != "cpu" else "float32")

        def run_mode(mode: str, tag: str) -> tuple[float, dict, Path]:
            os.environ["ATLASPATCH_SLIDE_MAJOR"] = "1" if mode == "slide" else "0"
            run_dir = tmp / f"run_{tag}"
            (run_dir / "patches").mkdir(parents=True)
            run_results = []
            for r in results:
                dst = run_dir / "patches" / r.h5_path.name
                shutil.copyfile(r.h5_path, dst)
                run_results.append(dataclasses.replace(r, h5_path=dst, metadata=dict(r.metadata)))
            svc = PatchFeatureEmbeddingService(
                cfg.extraction, dataclasses.replace(cfg.output, output_root=run_dir, skip_existing=False),
                feat_cfg, registry=registry,
            )
            perf.reset()
            t0 = time.perf_counter()
            fails = svc.embed_all(run_results, wsi_loader=DefaultWSILoader())
            dt = time.perf_counter() - t0
            if fails:
                raise RuntimeError(f"{mode}-major embed_all failed: {fails}")
            return dt, perf.report(), run_dir

        passes, first = [], {}
        for p in range(pass_pairs):
            for mode in ("extractor", "slide"):
                dt, counters, run_dir = run_mode(mode, f"{mode}{p}")
                read = counters.get("patch_read", {})
                read_s = read.get("total_s", 0.0)
                rate = total_patches * len(extractor_names) / dt
                log(f"pass {p} {mode:9s}: {dt:6.2f}s wall  {rate:7.1f} unit-patches/s  patch_read {read_s:6.2f}s "
                    f"({100 * read_s / dt:4.1f}% of the wall) / {int(read.get('count', 0))} blocks")
                passes.append((mode, dt, read_s))
                first.setdefault(mode, run_dir)
        want, got = _features(first["extractor"]), _features(first["slide"])
        if sorted(want) != sorted(got) or not want:
            raise RuntimeError(f"the modes wrote other feature sets: {sorted(want)} against {sorted(got)}")
        max_abs = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        for mode in ("extractor", "slide"):
            walls = [d for m, d, _ in passes if m == mode]
            reads = [r for m, _, r in passes if m == mode]
            log(f"{mode:9s}: wall median {statistics.median(walls):.2f}s (best {min(walls):.2f}s)  patch_read "
                f"median {statistics.median(reads):.2f}s ({100 * statistics.median(reads) / statistics.median(walls):.1f}"
                f"% of the median wall)")
        em = statistics.median([d for m, d, _ in passes if m == "extractor"])
        sm = statistics.median([d for m, d, _ in passes if m == "slide"])
        log(f"slide-major speedup (median wall): {em / sm:.3f}x over {total_patches} patches x "
            f"{len(extractor_names)} extractors on {device}; features of the two modes: max-abs {max_abs:.3g}")
        return dict(passes=passes, patches=total_patches, extractors=extractor_names, feature_max_abs=max_abs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
