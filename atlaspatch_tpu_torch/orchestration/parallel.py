"""Slide-level concurrency for the extraction stage.

Segmentation batches run on the device while per-slide extraction (tile
decode + vectorized geometry + H5 writes) runs on host threads. Two pieces:

* :class:`PatchExtractionExecutor` — the worker pool. Each task owns its WSI
  handle and work lock; both are released in the worker whatever happens.
* :class:`InflightTracker` — completion accounting. Results and failures are
  appended to caller-owned lists from the future callback, and a condition
  variable implements backpressure against the ``max_open_slides`` cap (the
  runner blocks in :meth:`wait_until_at_most` until enough slides drain).

Role parity with the reference's thread-pool pipeline
(atlas_patch/orchestration/parallel.py), rebuilt around condition-variable
accounting rather than future-set polling.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np

from atlaspatch_tpu_torch.core.models import ExtractionResult, Slide
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.services.interfaces import ExtractionService, VisualizationService

logger = logging.getLogger("atlaspatch_tpu_torch.parallel")


@dataclass
class ExtractionTask:
    """One slide's unit of extraction work: open WSI, its mask, the held lock."""

    slide: Slide
    wsi: IWSI
    mask: np.ndarray
    lock_fd: int | None
    lock_path: Path


class InflightTracker:
    """Counts in-flight futures and routes completions to results/failures."""

    def __init__(
        self,
        *,
        results: list[ExtractionResult],
        failures: list[tuple[Slide, Exception | str]],
        progress=None,
    ) -> None:
        self._results = results
        self._failures = failures
        self._progress = progress
        self._pending: dict[Future, Slide] = {}
        self._cond = threading.Condition()

    def add(self, fut: Future, slide: Slide) -> None:
        with self._cond:
            self._pending[fut] = slide
        fut.add_done_callback(self._settle)

    def count(self) -> int:
        with self._cond:
            return len(self._pending)

    def wait_until_at_most(self, limit: int) -> None:
        """Block the caller until at most ``limit`` tasks remain in flight."""
        limit = max(0, int(limit))
        with self._cond:
            self._cond.wait_for(lambda: len(self._pending) <= limit)

    def _settle(self, fut: Future) -> None:
        # Record the outcome and drop the pending entry atomically: a waiter
        # woken by the count reaching its limit must already see the result.
        with self._cond:
            slide = self._pending.pop(fut, None)
            if slide is None:
                return  # duplicate callback / unknown future
            err = fut.exception()
            if err is not None:
                self._failures.append((slide, err))
            else:
                self._results.append(fut.result())
            self._cond.notify_all()
        if err is not None:
            logger.error("Failed to process %s: %s", slide.path.name, err)
        else:
            res = fut.result()
            logger.info(
                "Processed %s -> %s (patches=%s)",
                slide.path.name,
                res.h5_path,
                res.num_patches,
            )
        if self._progress:
            self._progress.update(1)


class PatchExtractionExecutor:
    """Thread pool that extracts (and optionally visualizes) one slide per task.

    The worker always cleans up: the WSI handle is closed and the work lock
    released even when extraction raises, so a crashed slide never wedges a
    lock for other processes.
    """

    def __init__(
        self,
        *,
        extractor: ExtractionService,
        visualizer: VisualizationService | None,
        release_lock: Callable[[int | None, Path], None],
        max_workers: int | None = None,
    ) -> None:
        self.extractor = extractor
        self.visualizer = visualizer
        self.release_lock = release_lock
        self.max_workers = max(1, int(max_workers or os.cpu_count() or 4))
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="patch-extract"
        )

    def submit(self, task: ExtractionTask) -> Future:
        return self._pool.submit(self._process_slide, task)

    def _process_slide(self, task: ExtractionTask) -> ExtractionResult:
        try:
            result = self.extractor.extract(task.wsi, task.mask, slide=task.slide)
            if self.visualizer is not None:
                self.visualizer.visualize(result, wsi=task.wsi, mask=task.mask)
            return result
        finally:
            try:
                task.wsi.cleanup()
            except Exception:  # noqa: BLE001 — never mask the real outcome
                logger.debug("WSI cleanup failed for %s", task.slide.path.name)
            self.release_lock(task.lock_fd, task.lock_path)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=False)

    def __enter__(self) -> "PatchExtractionExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()
