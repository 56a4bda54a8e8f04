"""Per-stage timing counters for the pipeline's host stages.

Lightweight wall-clock counters for the pipeline stages (thumbnail,
segment dispatch/fetch, contours, grid scan). Thread-safe; aggregated report
via `report()` and logged at the end of a run when ATLASPATCH_PROFILE=1.
Device time is not seen here: a stage that dispatches CUDA work returns
before the card finishes, so `segment_fetch` carries the wait.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import Counter, defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path

logger = logging.getLogger("atlaspatch_tpu_torch.perf")

_lock = threading.Lock()
_tracing = False  # True while maybe_trace profiles
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_cpu_totals: dict[str, float] = defaultdict(float)


def enabled() -> bool:
    return os.environ.get("ATLASPATCH_PROFILE") == "1"


@contextmanager
def stage(name: str):
    """Time a pipeline stage. Near-zero overhead when profiling is off.

    Records wall time AND the calling thread's CPU time: on a 1-CPU host a
    stage's wall inflates whenever its thread is descheduled by another
    pipeline stage, so cpu_s is the signal for "cycles to cut" while
    total_s - cpu_s is contention/IO wait."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    c0 = time.thread_time()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        dc = time.thread_time() - c0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1
            _cpu_totals[name] += dc


def add(name: str, seconds: float, count: int = 1) -> None:
    with _lock:
        _totals[name] += seconds
        _counts[name] += count


def report() -> dict[str, dict[str, float]]:
    with _lock:
        return {
            name: {
                "total_s": round(_totals[name], 4),
                "cpu_s": round(_cpu_totals[name], 4),
                "count": _counts[name],
                "mean_ms": round(1000 * _totals[name] / max(1, _counts[name]), 3),
            }
            for name in sorted(_totals)
        }


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _cpu_totals.clear()


@contextmanager
def maybe_trace():
    """Device timelines: when ATLASPATCH_TORCH_TRACE=<dir> is set, run the
    wrapped code under torch.profiler (CPU ops, and CUDA kernels where a card
    is present) and write a Chrome / Perfetto trace into that directory.
    Complements the host-side stage counters above, which cannot see device
    time."""
    trace_dir = os.environ.get("ATLASPATCH_TORCH_TRACE")
    if not trace_dir:
        yield
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    logger.warning("torch profiler trace capturing to %s", out)
    # every thread: the encoder engine dispatches its forwards from a worker
    # thread, whose CPU ops the profiler otherwise leaves out
    global _tracing
    with profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        _tracing = True
        try:
            yield
        finally:
            _tracing = False
    path = out / f"trace-{os.getpid()}-{time.strftime('%Y%m%d-%H%M%S')}.json"
    prof.export_chrome_trace(str(path))
    logger.warning("torch profiler trace written to %s", path)


def span(name: str):
    """A named span (one per forward: ``sam2_forward``, ``embed_forward``) in
    the trace ``maybe_trace`` writes; nothing outside it, so no other
    profiler's device-time totals gain the span's device-side copy."""
    if not _tracing:
        return nullcontext()
    import torch

    return torch.profiler.record_function(name)


def trace_counts(path: str | Path) -> Counter:
    """What a Chrome trace written by ``maybe_trace`` holds, counted by name:
    ``span:<name>`` for each user-annotated span (``sam2_forward``,
    ``embed_forward``: one per forward) and ``kernel:<name>`` for each device
    kernel launch the profiler kept."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kinds = {"user_annotation": "span", "kernel": "kernel"}
    return Counter(f"{kinds[e['cat']]}:{e['name']}" for e in events if e.get("cat") in kinds)


def log_report() -> None:
    if not enabled():
        return
    for name, row in report().items():
        logger.warning(
            "perf %-18s total=%8.3fs n=%6d mean=%8.3fms",
            name,
            row["total_s"],
            row["count"],
            row["mean_ms"],
        )
