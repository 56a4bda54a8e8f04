"""High-level orchestration: discovery → skip → lock → segment → extract.

Behavior parity with the reference runner (reference:
atlas_patch/orchestration/runner.py:39-306): per-slide O_CREAT|O_EXCL lock
files dedupe work across processes on a shared filesystem; slides whose H5
exists are skipped; the segmentation batch feeds an extraction thread pool
with a global cap on simultaneously open slides.

Multi-host addition: when ATLASPATCH_NUM_HOSTS/ATLASPATCH_HOST_ID indicate
a multi-host run, slides are statically sharded round-robin across hosts
before processing — each host's reads stay local, no cross-host tensor
traffic.

With ``features.extractors`` set, a slide whose H5 exists is reused when
features are missing (its result is handed on for embedding, with no
segmentation) and skipped when they are complete. An H5 the port's reader
cannot read is reprocessed, as the JAX package reprocesses a file h5py cannot
read. A requested zoo encoder whose entry is not implemented raises
``NotImplementedError`` in ``run()`` before any slide is touched.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Iterable, Sequence

from atlaspatch_tpu_torch.core.config import AppConfig
from atlaspatch_tpu_torch.core.models import ExtractionResult, Slide
from atlaspatch_tpu_torch.core.paths import find_existing_patch, patch_lock_path
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.orchestration.parallel import (
    ExtractionTask,
    InflightTracker,
    PatchExtractionExecutor,
)
from atlaspatch_tpu_torch.parallel.multihost import host_shard
from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
from atlaspatch_tpu_torch.services.interfaces import (
    ExtractionService,
    MPPResolver,
    SegmentationService,
    VisualizationService,
    WSILoader,
)
from atlaspatch_tpu_torch.utils.features import missing_features
from atlaspatch_tpu_torch.utils.h5 import read_h5_tree
from atlaspatch_tpu_torch.utils.params import get_wsi_files
from atlaspatch_tpu_torch.utils.progress import ProgressBar

logger = logging.getLogger("atlaspatch_tpu_torch.runner")


def _chunked(items: Sequence[Slide], size: int) -> Iterable[Sequence[Slide]]:
    for i in range(0, len(items), size):
        yield items[i : i + size]


class ProcessingRunner:
    def __init__(
        self,
        config: AppConfig,
        segmentation: SegmentationService,
        extractor: ExtractionService,
        visualizer: VisualizationService | None,
        mpp_resolver: MPPResolver,
        wsi_loader: WSILoader,
        *,
        show_progress: bool = False,
    ) -> None:
        self.config = config.validated()
        self.segmentation = segmentation
        self.extractor = extractor
        self.visualizer = visualizer
        self.mpp_resolver = mpp_resolver
        self.wsi_loader = wsi_loader
        self.show_progress = show_progress

    # --- discovery -----------------------------------------------------------------
    def discover_slides(self) -> list[Slide]:
        files = get_wsi_files(
            str(self.config.processing.input_path), recursive=self.config.processing.recursive
        )
        # Output paths key on the filename stem (patches/<stem>.h5, the
        # reference layout), so duplicate stems from different directories —
        # possible under --recursive — would silently overwrite or mislabel
        # each other's features. Fail loudly instead.
        by_stem: dict[str, str] = {}
        collisions: list[str] = []
        for f in files:
            stem = Path(f).stem
            if stem in by_stem:
                collisions.append(f"{by_stem[stem]} <-> {f}")
            else:
                by_stem[stem] = f
        if collisions:
            raise ValueError(
                "Slide filename stems collide in the flat output layout "
                "(patches/<stem>.h5); rename the files or process the "
                "directories separately:\n  " + "\n  ".join(collisions)
            )
        slides = [Slide(path=Path(f)) for f in files]
        # Work stealing is only safe when finished slides are skipped.
        return host_shard(slides, steal=self.config.output.skip_existing)

    def _attach_mpp(self, slides: list[Slide]) -> list[Slide]:
        return [
            Slide(path=s.path, mpp=self.mpp_resolver.resolve(s), backend=s.backend)
            for s in slides
        ]

    # --- skip / reuse --------------------------------------------------------------
    def _build_existing_result(self, slide: Slide, h5_path: Path) -> ExtractionResult | None:
        num_patches: int | None = None
        patch_size_level0: int | None = None
        try:
            tree = read_h5_tree(h5_path, data=False)
            num_attr = tree.attrs.get("num_patches")
            if num_attr is not None:
                num_patches = int(num_attr)
            elif "coords" in tree.datasets:
                num_patches = int(tree.datasets["coords"].shape[0])
            ps = tree.attrs.get("patch_size_level0")
            if ps is not None:
                patch_size_level0 = int(ps)
        except Exception as e:  # noqa: BLE001
            logger.warning(
                "Failed to read existing output for %s; will reprocess. Error: %s",
                slide.path.name,
                e,
            )
            return None
        if num_patches is None or num_patches <= 0:
            return None
        return ExtractionResult(
            slide=slide,
            h5_path=h5_path,
            num_patches=num_patches,
            patch_size_level0=patch_size_level0,
        )

    def _handle_existing_slide(self, slide: Slide, results: list, progress) -> bool:
        """True when the slide is fully handled by skip/reuse."""
        if not self.config.output.skip_existing:
            return False
        existing_path = find_existing_patch(slide, self.config.output, self.config.extraction)
        if existing_path is None:
            return False

        feat_cfg = self.config.features
        if feat_cfg is None or not feat_cfg.extractors:
            logger.info("Skipping %s (already processed).", slide.path.name)
            if progress:
                progress.update(1)
            return True

        existing_result = self._build_existing_result(slide, existing_path)
        if existing_result is None:
            logger.info("Existing output invalid for %s; reprocessing.", slide.path.name)
            return False

        missing = missing_features(
            existing_path, feat_cfg.extractors, expected_total=existing_result.num_patches
        )
        if not missing:
            logger.info("Skipping %s (features complete).", slide.path.name)
        else:
            results.append(existing_result)
            logger.info(
                "Reusing existing patches for %s; missing features: %s",
                slide.path.name,
                ", ".join(missing),
            )
        if progress:
            progress.update(1)
        return True

    # --- locking -------------------------------------------------------------------
    def _acquire_lock(self, slide: Slide) -> tuple[int | None, Path]:
        lock_path = patch_lock_path(slide, self.config.output, self.config.extraction)
        lock_path.parent.mkdir(parents=True, exist_ok=True)
        payload = f"pid={os.getpid()},time={int(time.time())},slide={slide.path}"
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, payload.encode())
            os.fsync(fd)
            return fd, lock_path
        except FileExistsError:
            return None, lock_path
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(f"Failed to create lock {lock_path}: {e}") from e

    @staticmethod
    def _release_lock(fd: int | None, path: Path) -> None:
        if fd is not None:
            try:
                os.close(fd)
            except Exception:
                pass
        try:
            path.unlink()
        except (FileNotFoundError, OSError):
            pass

    # --- batch preparation (host stage, runs on the prefetch thread) ---------------
    def _prepare_batch(
        self,
        batch: Sequence[Slide],
        results: list,
        failures: list,
        progress,
        tracker: InflightTracker,
        allow_inflight: int,
    ):
        """Skip/lock/open a batch and (when the service supports it) render its
        thumbnails — overlapped with the device stage of the previous batch."""
        tracker.wait_until_at_most(limit=allow_inflight)
        opened: list[tuple[Slide, IWSI, int | None, Path]] = []
        try:
            for slide in batch:
                try:
                    if self._handle_existing_slide(slide, results, progress):
                        continue
                    fd, lock_path = self._acquire_lock(slide)
                except Exception as e:  # noqa: BLE001 — isolate per slide
                    failures.append((slide, e))
                    logger.error("Failed to prepare %s: %s", slide.path.name, e)
                    progress.update(1)
                    continue
                if fd is None:
                    logger.info(
                        "Skipping %s (locked by another process).", slide.path.name
                    )
                    progress.update(1)
                    continue
                try:
                    opened.append((slide, self.wsi_loader.open(slide), fd, lock_path))
                except Exception as e:  # noqa: BLE001
                    failures.append((slide, e))
                    logger.error("Failed to open %s: %s", slide.path.name, e)
                    self._release_lock(fd, lock_path)
                    progress.update(1)
        except BaseException:
            # Anything escaping the per-slide isolation (MemoryError, ...):
            # leaked O_EXCL lock files would make EVERY later run skip these
            # slides as "locked by another process" — release before raising.
            for _slide, wsi, fd, lock_path in opened:
                try:
                    wsi.cleanup()
                except Exception:  # noqa: BLE001
                    pass
                self._release_lock(fd, lock_path)
            raise

        thumbs = None
        prepare = getattr(self.segmentation, "prepare_thumbnails", None)
        if opened and callable(prepare):
            try:
                thumbs = prepare([w for _, w, _, _ in opened])
            except Exception:  # noqa: BLE001 — fall back to the combined path
                thumbs = None
        return opened, thumbs

    # --- segmentation dispatch / batch completion ------------------------------------
    def _dispatch_segmentation(self, opened, thumbs, failures, progress):
        """Start segmentation for a batch; returns a zero-arg resolve() → masks,
        or None when dispatch itself failed (failures recorded)."""
        try:
            wsis = [w for _, w, _, _ in opened]
            seg_async = getattr(self.segmentation, "segment_thumbnails_async", None)
            if thumbs is not None and callable(seg_async):
                return seg_async(thumbs)
            if len(wsis) > 1:
                masks = self.segmentation.segment_batch(wsis)
            else:
                masks = [self.segmentation.segment_thumbnail(wsis[0])]
            return lambda: masks
        except Exception as e:  # noqa: BLE001
            for slide, wsi, fd, path in opened:
                failures.append((slide, e))
                logger.error("Segmentation failed for %s: %s", slide.path.name, e)
                try:
                    wsi.cleanup()
                except Exception:
                    pass
                self._release_lock(fd, path)
                progress.update(1)
            return None

    def _finish_batch(self, pending, executor, tracker, failures, progress) -> None:
        """Resolve a dispatched batch's masks and hand slides to extraction."""
        opened, resolve = pending
        submitted: set[int] = set()
        try:
            masks = resolve()
        except Exception as e:  # noqa: BLE001
            for slide, wsi, fd, path in opened:
                failures.append((slide, e))
                logger.error("Segmentation failed for %s: %s", slide.path.name, e)
                progress.update(1)
        else:
            if len(masks) < len(opened):
                # a short mask list means an upstream segmentation bug — the
                # unmatched slides must surface as failures, not vanish from
                # results/progress (zip would silently drop them)
                for slide, _w, _fd, _lp in opened[len(masks) :]:
                    failures.append(
                        (slide, RuntimeError("segmentation returned no mask"))
                    )
                    logger.error("No mask returned for %s", slide.path.name)
                    progress.update(1)
            for (slide, wsi, lock_fd, lock_path), mask in zip(opened, masks):
                fut = executor.submit(
                    ExtractionTask(
                        slide=slide,
                        wsi=wsi,
                        mask=mask.data,
                        lock_fd=lock_fd,
                        lock_path=lock_path,
                    )
                )
                tracker.add(fut, slide)
                submitted.add(id(wsi))
        finally:
            for _slide, wsi, lock_fd, lock_path in opened:
                if id(wsi) in submitted:
                    continue
                try:
                    wsi.cleanup()
                except Exception:
                    pass
                self._release_lock(lock_fd, lock_path)

    # --- main loop -----------------------------------------------------------------
    def run(self) -> tuple[list[ExtractionResult], list[tuple[Slide, Exception | str]]]:
        from concurrent.futures import ThreadPoolExecutor

        feat_cfg = self.config.features
        unported = [
            n for n in (feat_cfg.extractors if feat_cfg is not None else [])
            if str(n).lower() in ENTRIES and not ENTRIES[str(n).lower()].implemented
        ]
        if unported:
            raise NotImplementedError(
                f"feature extractor(s) {unported}: tower not implemented in this build; "
                "nothing was processed"
            )
        slides = self._attach_mpp(self.discover_slides())
        if not slides:
            logger.warning("No slides found to process.")
            return [], []

        results: list[ExtractionResult] = []
        failures: list[tuple[Slide, Exception | str]] = []
        progress = ProgressBar(
            total=len(slides), enabled=self.show_progress, desc="Processing slides"
        )

        patch_workers = max(1, int(self.config.extraction.workers or os.cpu_count() or 4))
        batch_size = max(1, self.config.segmentation.batch_size)
        max_open_slides = max(1, int(self.config.extraction.max_open_slides or 200))
        # Pipeline depths. pend_depth = dispatched-but-unfetched device batches
        # held before blocking on the oldest fetch; prep_depth = prepared
        # batches queued ahead on the prefetch thread. Depth 2/2 reproduces the
        # classic 3-stage pipeline; the defaults go one deeper so the host has
        # queued work to run during each mask-fetch wait (measured: the fetch
        # is a pure device/link wait — cpu_s ≈ 0 — while host stages total less
        # than wall, i.e. the CPU idles exactly when a fetch blocks).
        pend_depth = max(2, int(os.environ.get("ATLASPATCH_SEG_PENDING_DEPTH", "3")))
        prep_depth = max(1, int(os.environ.get("ATLASPATCH_PREP_DEPTH", "2")))
        allow_inflight = max(0, max_open_slides - (pend_depth + prep_depth) * batch_size)

        batches = list(_chunked(slides, batch_size))
        prefetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="batch-prep")

        with PatchExtractionExecutor(
            extractor=self.extractor,
            visualizer=self.visualizer,
            release_lock=self._release_lock,
            max_workers=patch_workers,
        ) as executor:
            tracker = InflightTracker(results=results, failures=failures, progress=progress)

            prep_args = (results, failures, progress, tracker, allow_inflight)

            # Pipelined loop: while the device segments batches [i-P+1 .. i],
            # the host (a) keeps up to prep_depth batches prepared ahead on the
            # prefetch thread and (b) fetches the oldest dispatched batch's
            # masks and submits its extraction.
            # Ownership tracking for abnormal-exit cleanup. Exactly one owner
            # per open slide at any instant: a `prep_futs` entry (in-flight,
            # unfetched), `current` (fetched, not yet pending), a `pending`
            # entry (dispatched), or _finish_batch/ExtractionTask (which
            # release their own). The except block must release ONLY
            # pipeline-owned slides — a consumed future or finished batch must
            # never be re-released (it would unlink lock files of in-flight
            # extractions).
            from collections import deque

            prep_futs: deque = deque()
            next_prep = 0

            def _top_up_prep() -> None:
                nonlocal next_prep
                while next_prep < len(batches) and len(prep_futs) < prep_depth:
                    prep_futs.append(
                        prefetcher.submit(self._prepare_batch, batches[next_prep], *prep_args)
                    )
                    next_prep += 1

            pending: deque = deque()  # (opened, resolve) in dispatch order
            current: list = []
            try:
                _top_up_prep()
                for _idx in range(len(batches)):
                    opened, thumbs = prep_futs.popleft().result()
                    _top_up_prep()
                    current = opened

                    resolve = None
                    if opened:
                        resolve = self._dispatch_segmentation(
                            opened, thumbs, failures, progress
                        )
                    if resolve is None:
                        current = []  # empty, or dispatch released them itself
                    else:
                        pending.append((opened, resolve))
                        current = []  # ownership moved to `pending`

                    while len(pending) >= pend_depth:
                        self._finish_batch(
                            pending.popleft(), executor, tracker, failures, progress
                        )
                        tracker.wait_until_at_most(limit=max_open_slides)

                while pending:
                    self._finish_batch(pending.popleft(), executor, tracker, failures, progress)
                tracker.wait_until_at_most(limit=0)
            except BaseException:
                # Abnormal exit: release every slide the pipeline still holds,
                # else their O_EXCL lock files survive and later runs skip
                # those slides as "locked by another process".
                leftovers = list(current)
                for opened_b, _resolve in pending:
                    leftovers.extend(opened_b)
                for fut in prep_futs:
                    try:
                        prep_opened, _ = fut.result(timeout=60)
                        leftovers.extend(prep_opened)
                    except Exception:  # noqa: BLE001 — prep failed/cleaned itself
                        pass
                for _slide, wsi, fd, lock_path in leftovers:
                    try:
                        wsi.cleanup()
                    except Exception:  # noqa: BLE001
                        pass
                    self._release_lock(fd, lock_path)
                raise

        prefetcher.shutdown(wait=True)
        progress.close()
        return results, failures
