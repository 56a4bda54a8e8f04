"""The port's tracer: stage counters and program spans, on one recorder.

Each ``stage(name)`` is a span of the calling thread: its start and end (in
``time.time_ns()``), the thread, the innermost span open on that thread (its
parent) and the slide it serves (``slide(stem)``, carried onto pool threads
by ``carry``). Spans are kept in memory, in a bounded buffer (``spans()``),
and ``maybe_trace`` writes them into its Chrome trace on each thread's own
track, on the profiler's clock. With ``ATLASPATCH_PROFILE=1`` each stage also
adds to an aggregate row of ``report()`` (wall, the thread's CPU time, self
time, count), logged at the end of a run. Nothing is recorded with both
``ATLASPATCH_PROFILE`` and ``ATLASPATCH_TORCH_TRACE`` off, and no span ever
reaches a profiler as a ``record_function``, so no profiler's device rows
gain a copy of it.

Device time is not seen here: a stage that dispatches CUDA work returns
before the card finishes, so `segment_fetch` carries the wait; the encoder
engine times its batches on the card itself (``embed_device_span`` /
``embed_device_gap``, through ``add``). ``idle_by_span`` reads a trace's
device idle time against the spans.
"""

from __future__ import annotations

import contextvars
import functools
import heapq
import json
import logging
import os
import re
import threading
import time
from collections import Counter, defaultdict, deque
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import NamedTuple

logger = logging.getLogger("atlaspatch_tpu_torch.perf")

SPAN_CAPACITY = 100_000  # the buffer keeps the newest spans
SPAN_CATEGORY = "program_span"  # the category of the spans maybe_trace merges
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")  # a trace's device work

_lock = threading.Lock()
_tracing = False  # True while maybe_trace profiles
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_cpu_totals: dict[str, float] = defaultdict(float)
_self_totals: dict[str, float] = defaultdict(float)
_local = threading.local()  # .stack: the thread's open stages, innermost last
_slide: contextvars.ContextVar[str | None] = contextvars.ContextVar("atlaspatch_slide", default=None)
_NULL = nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: str
    tid: int  # the thread's native id: its track in a profiler's trace
    parent: str | None
    slide: str | None


_spans: deque[Span] = deque(maxlen=SPAN_CAPACITY)


def enabled() -> bool:
    return os.environ.get("ATLASPATCH_PROFILE") == "1"


def recording() -> bool:
    """Spans are recorded: ``ATLASPATCH_PROFILE=1`` or inside ``maybe_trace``."""
    return _tracing or enabled()


class _Stage:
    __slots__ = ("name", "counted", "parent", "slide", "child_ns", "c0", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.counted = enabled()
        self.parent = stack[-1].name if stack else None
        self.slide = _slide.get()
        self.child_ns = 0
        stack.append(self)
        self.c0 = time.thread_time()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        dc = time.thread_time() - self.c0
        stack = _local.stack
        stack.pop()
        dur = t1 - self.t0
        if stack:
            stack[-1].child_ns += dur
        thread = threading.current_thread()
        _spans.append(Span(self.name, self.t0, t1, thread.name, thread.native_id, self.parent, self.slide))
        if self.counted:
            with _lock:
                _totals[self.name] += dur * 1e-9
                _counts[self.name] += 1
                _cpu_totals[self.name] += dc
                _self_totals[self.name] += (dur - self.child_ns) * 1e-9
        return False


def stage(name: str):
    """Time a pipeline stage as a span of the calling thread; a shared no-op
    when nothing records.

    Records wall time AND the calling thread's CPU time: on a 1-CPU host a
    stage's wall inflates whenever its thread is descheduled by another
    pipeline stage, so cpu_s is the signal for "cycles to cut" while
    total_s - cpu_s is contention/IO wait. self_s is the wall its child
    stages on the same thread do not cover."""
    if not recording():
        return _NULL
    return _Stage(name)


@contextmanager
def slide(stem: str):
    """Tag the spans begun inside with ``stem``, those of pool threads that
    ``carry`` hands the work too."""
    if not recording():
        yield
        return
    token = _slide.set(stem)
    try:
        yield
    finally:
        _slide.reset(token)


def carry(fn):
    """``fn`` run in a copy of the caller's context (its slide tag), for a
    pool thread, which starts from an empty one; ``fn`` itself when nothing
    records. Call once per submission: a context runs on one thread at a
    time."""
    if not recording():
        return fn
    return functools.partial(contextvars.copy_context().run, fn)


def add(name: str, seconds: float, count: int = 1) -> None:
    """Add a measured time (or, with 0 seconds, a count) to a row of
    ``report()``, with ``ATLASPATCH_PROFILE=1``."""
    if not enabled():
        return
    with _lock:
        _totals[name] += seconds
        _self_totals[name] += seconds
        _counts[name] += count


def report() -> dict[str, dict[str, float]]:
    with _lock:
        return {
            name: {
                "total_s": round(_totals[name], 4),
                "cpu_s": round(_cpu_totals[name], 4),
                "count": _counts[name],
                "mean_ms": round(1000 * _totals[name] / max(1, _counts[name]), 3),
                "self_s": round(_self_totals[name], 4),
            }
            for name in sorted(_totals)
        }


def spans() -> list[Span]:
    """The recorded spans still in the buffer, oldest first."""
    return list(_spans)


def reset() -> None:
    """Start ``report()``'s rows over; the recorded spans stay (a trace
    around the reset still gets them)."""
    with _lock:
        _totals.clear()
        _counts.clear()
        _cpu_totals.clear()
        _self_totals.clear()


def cover(intervals) -> tuple[float, float]:
    """(covered, holes) of (start, end) intervals: the time inside at least
    one of them, and the time between the first start and the last end that
    none covers."""
    covered = holes = 0.0
    end = None
    for s, e in sorted(intervals):
        if end is None:
            covered, end = e - s, e
        elif s > end:
            holes += s - end
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, holes


@contextmanager
def maybe_trace():
    """Device timelines: when ATLASPATCH_TORCH_TRACE=<dir> is set, run the
    wrapped code under torch.profiler (CPU ops, and CUDA kernels where a card
    is present) and write a Chrome / Perfetto trace into that directory, with
    the program's spans (category ``program_span``) on each thread's track."""
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
        t0 = time.time_ns()
        _tracing = True
        try:
            yield
        finally:
            _tracing = False
    path = out / f"trace-{os.getpid()}-{time.strftime('%Y%m%d-%H%M%S')}.json"
    prof.export_chrome_trace(str(path))
    _merge_spans(path, [s for s in spans() if s.end_ns >= t0])
    logger.warning("torch profiler trace written to %s", path)


def _merge_spans(path: str | Path, recorded: list[Span]) -> None:
    """Write ``recorded`` into the Chrome trace at ``path`` as complete
    events on their threads' tracks: ``ts = (t_ns - baseTimeNanoseconds) /
    1000``, the profiler's own mapping of its clock."""
    trace = json.loads(Path(path).read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace["traceEvents"]
    named = {e.get("tid") for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for s in recorded:
        events.append({"ph": "X", "cat": SPAN_CATEGORY, "name": s.name, "pid": pid, "tid": s.tid,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"thread": s.thread, "parent": s.parent, "slide": s.slide}})
        if s.tid not in named:
            named.add(s.tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": s.tid, "args": {"name": s.thread}})
    Path(path).write_text(json.dumps(trace))


def _events(trace) -> list[dict]:
    if isinstance(trace, dict):
        return trace["traceEvents"]
    return json.loads(Path(trace).read_text())["traceEvents"]


def trace_counts(trace) -> Counter:
    """What a Chrome trace written by ``maybe_trace`` holds, counted by name:
    ``span:<name>`` for each program span (``sam2_forward``,
    ``embed_forward``: one per forward) and ``kernel:<name>`` for each device
    kernel launch the profiler kept."""
    kinds = {SPAN_CATEGORY: "span", "kernel": "kernel"}
    return Counter(f"{kinds[e['cat']]}:{e['name']}" for e in _events(trace) if e.get("cat") in kinds)


def thread_group(thread: str) -> str:
    """A pool's threads as one group: ``h2d-dispatch_1`` → ``h2d-dispatch``;
    ``MainThread`` → ``main``."""
    return "main" if thread == "MainThread" else re.sub(r"_\d+$", "", thread)


def _innermost(spans_of_thread: list[tuple[float, float, str]]) -> list[tuple[float, float, str, float]]:
    """Disjoint (start, end, name, began) pieces of one thread's nested spans:
    at each instant its innermost open span, and when that span began."""
    pieces = []
    stack: list[tuple[float, str, float]] = []  # (end, name, began)
    t = None
    for s, e, name in sorted(spans_of_thread, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, nm, b = stack.pop()
            if t < end:
                pieces.append((t, end, nm, b))
                t = end
        if stack and t < s:
            pieces.append((t, s, stack[-1][1], stack[-1][2]))
        stack.append((e, name, s))
        t = s
    while stack:
        end, nm, b = stack.pop()
        if t < end:
            pieces.append((t, end, nm, b))
            t = end
    return pieces


def idle_by_span(trace) -> dict[str, dict[str, float]]:
    """Why the card was idle: each idle gap between the first and the last
    device row of a ``maybe_trace`` trace (kernels, copies, sets; a
    ``gpu_user_annotation`` is no work), in seconds, charged per thread
    group to the innermost program span open then. A pool's threads form one
    group (``thread_group``), and an instant goes to the innermost span of
    the group's thread whose span began last, so each group's row adds up
    to the whole idle time; ``untracked`` where the group had none open."""
    events = _events(trace)
    busy = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                  if e.get("cat") in DEVICE_CATEGORIES and e.get("ph") == "X")
    gaps: list[tuple[float, float]] = []
    end = None
    for s, e in busy:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    idle = sum(b - a for a, b in gaps)
    by_thread: dict[int, list] = defaultdict(list)
    names: dict[int, str] = {}
    for e in events:
        if e.get("cat") == SPAN_CATEGORY:
            by_thread[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
            names[e["tid"]] = e["args"]["thread"]
    groups: dict[str, list] = defaultdict(list)
    for tid, sp in by_thread.items():
        groups[thread_group(names[tid])].extend(_innermost(sp))
    out = {}
    for group, pieces in sorted(groups.items()):
        charged: dict[str, float] = defaultdict(float)
        marks = sorted({p[0] for p in pieces} | {p[1] for p in pieces})
        order = sorted(range(len(pieces)), key=lambda i: pieces[i][0])
        heap: list[tuple[float, float, str]] = []  # (-began, end, name) of the pieces begun
        nxt = gi = 0
        for a, b in zip(marks, marks[1:]):
            while nxt < len(order) and pieces[order[nxt]][0] <= a:
                s, e, name, began = pieces[order[nxt]]
                heapq.heappush(heap, (-began, e, name))
                nxt += 1
            while heap and heap[0][1] <= a:
                heapq.heappop(heap)
            if not heap:
                continue
            while gi < len(gaps) and gaps[gi][1] <= a:
                gi += 1
            j, overlap = gi, 0.0
            while j < len(gaps) and gaps[j][0] < b:
                overlap += min(b, gaps[j][1]) - max(a, gaps[j][0])
                j += 1
            if overlap > 0:
                charged[heap[0][2]] += overlap
        row = {name: v * 1e-6 for name, v in sorted(charged.items(), key=lambda kv: -kv[1])}
        row["untracked"] = max(0.0, idle - sum(charged.values())) * 1e-6
        out[group] = row
    return out


def log_report() -> None:
    if not enabled():
        return
    for name, row in report().items():
        logger.warning(
            "perf %-18s total=%8.3fs self=%8.3fs n=%6d mean=%8.3fms",
            name,
            row["total_s"],
            row["self_s"],
            row["count"],
            row["mean_ms"],
        )
