"""The port's tracer (atlaspatch_tpu_torch/utils/perf.py) and what reads it.

The recorder (nesting, parents, self time, the bounded buffer, slide tags
carried onto pool threads), its clock against torch.profiler's, the merged
trace and ``idle_by_span``, the encoder engine's device union and its
silence with tracing off, the embedding service's spans, and the
benchmark's readers of the new rows (``portbench/metrics/``). CPU only.
"""

import json
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from atlaspatch_tpu_torch.models.encoders import engine
from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor
from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
from atlaspatch_tpu_torch.utils import perf
from portbench import harness


@pytest.fixture(autouse=True)
def fresh_spans(monkeypatch):
    """Each test reads only its own spans: a buffer of its own."""
    monkeypatch.setattr(perf, "_spans", deque(maxlen=perf.SPAN_CAPACITY))


@pytest.fixture
def profiled(monkeypatch):
    monkeypatch.setenv("ATLASPATCH_PROFILE", "1")
    perf.reset()
    yield
    perf.reset()


class Pooled(torch.nn.Module):  # (N, S, S, 3) → (N, 4)
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 4)

    def forward(self, x):
        return self.proj(x.mean(dim=(1, 2)))


def _encoder(name="tiny"):
    return TorchFeatureExtractor(name=name, embedding_dim=4, spec=ENTRIES["resnet50"].preprocess, device="cpu",
                                 model=Pooled(), prep_workers=2)


# --- the recorder ----------------------------------------------------------------------
def test_spans_nest_with_parents_and_self_time(profiled):
    with perf.stage("outer"):
        time.sleep(0.02)
        with perf.stage("inner"):
            time.sleep(0.03)
        with perf.stage("inner"):
            time.sleep(0.01)
    spans = {(s.name, s.start_ns): s for s in perf.spans()}
    inner = sorted((s for s in spans.values() if s.name == "inner"), key=lambda s: s.start_ns)
    (outer,) = [s for s in spans.values() if s.name == "outer"]
    assert [s.parent for s in inner] == ["outer", "outer"] and outer.parent is None
    assert all(outer.start_ns <= s.start_ns < s.end_ns <= outer.end_ns for s in inner)
    assert {s.thread for s in spans.values()} == {threading.current_thread().name}
    rows = perf.report()
    child = sum(s.end_ns - s.start_ns for s in inner) * 1e-9
    assert rows["inner"]["count"] == 2 and rows["outer"]["count"] == 1
    assert rows["inner"]["self_s"] == rows["inner"]["total_s"]
    assert rows["outer"]["self_s"] == pytest.approx(rows["outer"]["total_s"] - child, abs=2e-4)
    assert 0.015 <= rows["outer"]["self_s"] < rows["outer"]["total_s"]
    assert set(rows["outer"]) == {"total_s", "cpu_s", "count", "mean_ms", "self_s"}


def test_the_buffer_keeps_the_newest_spans(profiled, monkeypatch):
    monkeypatch.setattr(perf, "_spans", deque(maxlen=5))
    for i in range(12):
        with perf.stage(f"s{i}"):
            pass
    assert [s.name for s in perf.spans()] == [f"s{i}" for i in range(7, 12)]
    assert perf.report()["s0"]["count"] == 1  # the aggregate rows keep everything


def test_a_slide_tag_reaches_pool_threads_only_when_carried(profiled):
    def work(name):
        with perf.stage(name):
            return threading.current_thread().name

    with ThreadPoolExecutor(2, thread_name_prefix="pool") as ex, perf.slide("slide-7"):
        with perf.stage("main_side"):
            carried = ex.submit(perf.carry(work), "carried").result()
            bare = ex.submit(work, "bare").result()
    by_name = {s.name: s for s in perf.spans()}
    assert by_name["main_side"].slide == "slide-7" and by_name["carried"].slide == "slide-7"
    assert by_name["bare"].slide is None
    assert by_name["carried"].thread == carried and carried.startswith("pool_")
    assert by_name["carried"].parent is None  # parents are per thread
    with perf.stage("after"):
        pass
    assert perf.spans()[-1].slide is None


def test_nothing_is_recorded_with_tracing_off(monkeypatch):
    monkeypatch.delenv("ATLASPATCH_PROFILE", raising=False)
    monkeypatch.delenv("ATLASPATCH_TORCH_TRACE", raising=False)
    perf.reset()
    assert perf.stage("a") is perf.stage("b")  # one shared no-op
    f = lambda: None  # noqa: E731
    assert perf.carry(f) is f
    with perf.slide("s"), perf.stage("a"):
        perf.add("counter", 1.0)
    assert perf.spans() == [] and perf.report() == {}


def test_concurrent_stages_lose_no_update(profiled):
    """16 threads nest stages under a short switch interval; every count and
    every self time adds up."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with perf.stage("outer"), perf.stage("inner"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rows = perf.report()
    assert rows["outer"]["count"] == rows["inner"]["count"] == 3200
    spans = perf.spans()
    assert len(spans) == 6400 and all(s.parent == "outer" for s in spans if s.name == "inner")
    inner = sum(s.end_ns - s.start_ns for s in spans if s.name == "inner") * 1e-9
    outer = sum(s.end_ns - s.start_ns for s in spans if s.name == "outer") * 1e-9
    assert rows["outer"]["self_s"] == pytest.approx(outer - inner, abs=1e-3)


# --- the clock -------------------------------------------------------------------------
def test_a_span_encloses_its_record_function_on_the_profilers_clock(tmp_path, monkeypatch):
    """``ts = (t_ns - baseTimeNanoseconds) / 1000`` in the exported trace,
    and ``kineto_results.trace_start_ns()`` as the base of ``events()``: a
    recorder span around a record_function range encloses it in both. (This
    build names short ranges wrongly in ``events()``, so the range's name is
    long.)"""
    monkeypatch.setenv("ATLASPATCH_TORCH_TRACE", str(tmp_path / "trace"))
    monkeypatch.delenv("ATLASPATCH_PROFILE", raising=False)
    perf.reset()
    probe = "probe_range_of_the_clock_test"
    with perf.maybe_trace():
        with perf.stage("around_probe"):
            with torch.profiler.record_function(probe):
                torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    (rf,) = [e for e in events if e.get("name") == probe]
    (span,) = [e for e in events if e.get("name") == "around_probe"]
    assert span["cat"] == perf.SPAN_CATEGORY and rf["cat"] == "user_annotation"
    assert span["tid"] == rf["tid"] == threading.current_thread().native_id
    assert span["ts"] <= rf["ts"] and rf["ts"] + rf["dur"] <= span["ts"] + span["dur"]
    assert {"thread": threading.current_thread().name, "parent": None, "slide": None} == span["args"]

    span_end_ns = perf.spans()[-1].end_ns
    monkeypatch.setenv("ATLASPATCH_PROFILE", "1")  # spans in memory, under a profiler of the caller's
    perf.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with perf.stage("around_probe"):
            with torch.profiler.record_function(probe):
                torch.ones(64, 64) @ torch.ones(64, 64)
    (rec,) = [s for s in perf.spans() if s.start_ns >= span_end_ns]
    perf.reset()
    base = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == probe]
    assert (rec.start_ns - base) / 1e3 <= ev.time_range.start and ev.time_range.end <= (rec.end_ns - base) / 1e3
    assert "around_probe" not in {e.name for e in prof.events()}


def test_a_trace_holds_each_threads_spans_and_their_idle(tmp_path, monkeypatch):
    """maybe_trace with the engine: the dispatch thread's spans land on its
    own track, named; idle_by_span answers for the trace (no device rows on
    the CPU, so no idle)."""
    monkeypatch.setenv("ATLASPATCH_TORCH_TRACE", str(tmp_path / "trace"))
    monkeypatch.delenv("ATLASPATCH_PROFILE", raising=False)
    perf.reset()
    enc = _encoder()
    with perf.maybe_trace(), perf.slide("s0"):
        enc.extract_batch([np.zeros((64, 64, 3), np.uint8)] * 5, batch_size=2)
    (path,) = (tmp_path / "trace").glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == perf.SPAN_CATEGORY]
    threads = {e["args"]["thread"] for e in spans}
    assert "MainThread" in threads and any(t.startswith("h2d-dispatch") for t in threads)
    assert all(e["args"]["slide"] == "s0" for e in spans)
    named = {e["tid"]: e["args"]["name"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert all(e["tid"] in named for e in spans)
    fwd = [e for e in spans if e["name"] == "embed_forward"]
    assert len(fwd) == 3 and all(e["args"]["parent"] == "embed_dispatch" for e in fwd)
    assert perf.trace_counts(path)["span:embed_forward"] == 3
    assert all(sum(row.values()) == 0 for row in perf.idle_by_span(path).values())


# --- idle_by_span ----------------------------------------------------------------------
def _x(cat, name, ts, dur, tid=0, thread=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}
    if thread is not None:
        e["args"] = {"thread": thread, "parent": None, "slide": None}
    return e


def test_idle_is_charged_per_thread_to_the_innermost_span():
    """Kernels at [0, 10), [20, 30), [40, 50) µs: idle 10-20 and 30-40. A
    user annotation over all of it is no device work."""
    sp = perf.SPAN_CATEGORY
    trace = {"traceEvents": [
        _x("kernel", "k", 0, 10), _x("gpu_memcpy", "Memcpy DtoH", 20, 10), _x("kernel", "k", 40, 10),
        _x("gpu_user_annotation", "embed_forward", 0, 60),
        _x(sp, "slide", -5, 70, tid=1, thread="MainThread"),
        _x(sp, "block_wait", 12, 6, tid=1, thread="MainThread"),
        _x(sp, "embed_drain", 33, 10, tid=1, thread="MainThread"),
        _x(sp, "embed_dispatch", 5, 20, tid=2, thread="h2d-dispatch_0"),
        _x(sp, "embed_forward", 6, 18, tid=2, thread="h2d-dispatch_0"),
        _x(sp, "embed_dispatch", 15, 20, tid=3, thread="h2d-dispatch_1"),
    ]}
    got = perf.idle_by_span(trace)
    assert got.keys() == {"main", "h2d-dispatch"}
    main = got["main"]
    # 10-12 slide, 12-18 block_wait, 18-20 slide; 30-33 slide, 33-40 embed_drain
    assert main == pytest.approx({"slide": 7e-6, "block_wait": 6e-6, "embed_drain": 7e-6, "untracked": 0.0})
    # 10-15 embed_forward (thread 0 alone); 15-20 thread 1's later-begun embed_dispatch;
    # 30-35 thread 1's embed_dispatch; 35-40 no span open
    assert got["h2d-dispatch"] == pytest.approx(
        {"embed_forward": 5e-6, "embed_dispatch": 10e-6, "untracked": 5e-6})
    assert all(sum(row.values()) == pytest.approx(20e-6) for row in got.values())


def test_idle_by_span_ignores_annotations_as_busy():
    trace = {"traceEvents": [_x("kernel", "k", 0, 10), _x("gpu_user_annotation", "a", 10, 20),
                             _x("kernel", "k", 30, 10),
                             _x(perf.SPAN_CATEGORY, "slide_wait", 0, 40, tid=1, thread="MainThread")]}
    assert perf.idle_by_span(trace) == {"main": pytest.approx({"slide_wait": 20e-6, "untracked": 0.0})}
    assert perf.thread_group("patch-read_3") == "patch-read" and perf.thread_group("slide-prep_0") == "slide-prep"


# --- the device union ------------------------------------------------------------------
@pytest.mark.parametrize("intervals, want", [
    ([], (0.0, 0.0)),
    ([(0, 4)], (4, 0)),
    ([(0, 4), (2, 6), (3, 5)], (6, 0)),  # overlapping: one dispatch thread's batch inside another's
    ([(0, 4), (6, 8), (7, 12), (15, 16)], (11, 5)),
    ([(7, 12), (0, 4), (6, 8)], (10, 2)),  # out of order
])
def test_cover_unites_overlapping_and_gapped_intervals(intervals, want):
    assert perf.cover(intervals) == pytest.approx(want)


class _At:
    """A completed event at a fixed time (ms)."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_the_device_union_counts_gaps_within_and_between_calls(profiled):
    union = engine._DeviceUnion()
    union.add_call(_At(0.0), [(_At(1.0), _At(5.0)), (_At(3.0), _At(6.0)), (_At(8.0), _At(9.0))])
    rows = perf.report()
    assert rows["embed_device_span"]["total_s"] == pytest.approx(6e-3) and rows["embed_device_gap"]["total_s"] == \
        pytest.approx(2e-3)  # the first call has no gap before it
    # the next call's base lies 2 ms after the last end (9), its first batch 1 ms later
    union.add_call(_At(11.0), [(_At(13.0), _At(14.0)), (_At(12.0), _At(13.5))])
    rows = perf.report()
    assert rows["embed_device_span"]["total_s"] == pytest.approx(8e-3)
    assert rows["embed_device_gap"]["total_s"] == pytest.approx(5e-3)
    assert union.last.ms == 14.0


def test_the_engine_times_its_batches_only_when_profiling(monkeypatch):
    """With ATLASPATCH_PROFILE and ATLASPATCH_TORCH_TRACE unset the engine
    makes no timing mark and records no span; with ATLASPATCH_PROFILE=1 it
    times every batch and counts its rows."""
    made = []
    real = engine._mark

    def counting(device, timing=True):
        made.append(timing)
        return real(device, timing)

    monkeypatch.setattr(engine, "_mark", counting)
    monkeypatch.delenv("ATLASPATCH_PROFILE", raising=False)
    monkeypatch.delenv("ATLASPATCH_TORCH_TRACE", raising=False)
    perf.reset()
    enc = _encoder()
    patches = [np.zeros((64, 64, 3), np.uint8)] * 7
    off = enc.extract_batch(patches, batch_size=4)
    assert made == [] and perf.spans() == [] and perf.report() == {}
    monkeypatch.setenv("ATLASPATCH_PROFILE", "1")
    try:
        on = enc.extract_batch(patches, batch_size=4)
        enc.extract_batch(patches[:3], batch_size=4)
        rows = perf.report()
    finally:
        perf.reset()
    assert np.array_equal(on, off)
    # per call a base, and per batch a start and an end (the fetch's event)
    assert len(made) == (1 + 2 * 2) + (1 + 2 * 1)
    assert rows["embed_rows"]["count"] == 4 + 4 + 4 and rows["embed_pad_rows"]["count"] == 1 + 1
    assert rows["embed_device_span"]["count"] == rows["embed_device_gap"]["count"] == 2
    assert rows["embed_device_span"]["total_s"] > 0 and rows["embed_device_gap"]["total_s"] >= 0
    assert rows["embed_forward"]["count"] == 3 and rows["embed_drain"]["count"] == 2


# --- the embedding service's spans -----------------------------------------------------
def test_every_span_of_a_slide_carries_its_stem(tmp_path, monkeypatch, profiled):
    """embed_all over two PNG slides with the engine: the main thread's
    slide, slide_wait and block_wait spans, the reads on the prep and
    prefetch threads and the dispatch threads' spans all name their slide."""
    from test_torch_embedding import PORT, _extract, _feat_cfg
    from test_torch_runner import _slides

    monkeypatch.setenv("ATLASPATCH_EMBED_BLOCK_CHUNKS", "1")
    slide_dir = _slides(tmp_path, n=2)
    feat_cfg = _feat_cfg(PORT, ["tiny"], batch=4)
    cfg, results = _extract(PORT, slide_dir, tmp_path / "out", feat_cfg)
    registry = PORT.registry.PatchFeatureExtractorRegistry()
    registry.register("tiny", _encoder)
    service = PORT.embedding.PatchFeatureEmbeddingService(cfg.extraction, cfg.output, feat_cfg, registry=registry)
    perf.reset()
    before = len(perf.spans())  # the extraction's spans
    fails = service.embed_all(results, wsi_loader=PORT.loader.DefaultWSILoader())
    assert fails == []
    spans = perf.spans()[before:]
    stems = {r.slide.stem for r in results}
    assert len(stems) == 2 and {s.slide for s in spans} == stems
    by_name: dict[str, set] = {}
    for s in spans:
        by_name.setdefault(s.name, set()).add(perf.thread_group(s.thread))
    assert by_name["slide"] == by_name["slide_wait"] == by_name["block_wait"] == {"main"}
    assert {"slide-prep", "block-read"} <= by_name["patch_read"]
    assert by_name["embed_dispatch"] == by_name["embed_forward"] == {"h2d-dispatch"}
    rows = perf.report()
    assert rows["slide"]["count"] == 2 and rows["slide_wait"]["count"] == 2
    assert rows["block_wait"]["count"] == sum(-(-r.num_patches // 4) for r in results)
    for s in spans:
        if s.name in ("slide_wait", "block_wait", "embed_drain"):
            assert s.parent is not None


# --- the benchmark's readers -----------------------------------------------------------
def _layer(**stages):
    return {"stages": stages, "patches": 2000}


@pytest.mark.parametrize("name, layer, want", [
    ("forward_launch_ms", _layer(embed_forward={"total_s": 6.0, "cpu_s": 4.5, "count": 100}), 60.0),
    ("forward_launch_wait_pct", _layer(embed_forward={"total_s": 6.0, "cpu_s": 4.5, "count": 100}), 25.0),
    ("block_wait_ms", _layer(block_wait={"total_s": 0.3, "count": 60}, slide_wait={"total_s": 0.1, "count": 5}),
     200.0),
    ("block_wait_ms", _layer(block_wait={"total_s": 0.3, "count": 60}), 150.0),
    ("embed_drain_ms", _layer(embed_drain={"total_s": 1.0, "count": 60}), 500.0),
    ("device_gap_pct.embed", _layer(embed_device_gap={"total_s": 1.0, "count": 9},
                                    embed_device_span={"total_s": 3.0, "count": 9}), 25.0),
])
def test_each_reader_reads_its_rows(name, layer, want):
    assert harness.metric_module(name).read(layer) == pytest.approx(want)


@pytest.mark.parametrize("name", ["forward_launch_ms", "forward_launch_wait_pct", "block_wait_ms",
                                  "embed_drain_ms", "device_gap_pct.embed"])
@pytest.mark.parametrize("layer", [
    {},
    {"stages": {}, "patches": 2000},
    {"stages": {"embed_prep": {"total_s": 1.0, "cpu_s": 1.0, "count": 3}}, "patches": 0},
    {"stages": {"embed_forward": {"total_s": 0.0, "cpu_s": 0.0, "count": 0},
                "embed_device_gap": {"total_s": 0.0, "count": 0},
                "embed_device_span": {"total_s": 0.0, "count": 0}}, "patches": 0},
], ids=["no-stages", "empty", "other-rows", "zero-rows"])
def test_each_reader_is_silent_without_its_rows(name, layer):
    """The parent program records none of the new rows: every reader gives
    None there, and raises nothing."""
    assert harness.metric_module(name).read(layer) is None
