"""What every cell shares: the manifest, files found by name, the profiled
slice, the card's description and the check that JAX stayed out.

Nothing here imports the program: a traffic module does that.
"""

from __future__ import annotations

import heapq
import importlib.util
import json
import subprocess
import sys
import threading
import time
import zlib
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "atlaspatch_tpu")
# Published dense peaks of one H100 SXM (NVIDIA's data sheet), by the
# precision a cell's products run in, and its HBM bandwidth.
PEAK_FLOPS = {"float32": 67e12, "tf32x3": 495e12 / 3, "bfloat16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


class WindowClosed(BaseException):
    """Raised from a hook into the program when the measured window ends; a
    BaseException, so the program's per-item ``except Exception`` lets it
    through and its cleanup runs."""


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def load_module(path: Path):
    """A module from its file, named by its path under the benchmark."""
    stem = "_".join(Path(path).relative_to(BENCH).with_suffix("").parts).replace(".", "_").replace("-", "_")
    name = f"portbench_{stem}_{zlib.crc32(str(path).encode()):08x}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def traffic_module(kind: str):
    return load_module(BENCH / "traffic" / f"{kind}.py")


def metric_module(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.splitlines()[0] if out else "unknown"


@dataclass
class Context:
    """One run of one cell."""

    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_process: float = field(default_factory=time.perf_counter)

    def log(self, msg: str) -> None:
        print(f"# [{self.name}] {msg}", file=sys.stderr, flush=True)


class Profile:
    """A ``torch.profiler`` slice of the window, started and stopped by the
    traffic module's hooks, and the benchmark's spans inside it.

    ``span(name)`` marks what the host is doing while the slice records (a
    ``record_function``, so it shares the trace's clock); outside a slice it
    is a no-op. Kernel, copy and set rows of the trace are the device's work;
    the spans' own device-side copies are left out."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.active = False
        self.prof = None
        self.t0 = self.t1 = None
        self.count: dict[str, int] = {}
        self._lock = threading.Lock()

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.start()
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.active = False
        self.prof.stop()

    def finish(self) -> dict:
        """The slice's ``summarize``, its window the slice's wall time; read
        after the measured window, which it would otherwise stall."""
        self.stop()
        summary = summarize(self.prof)
        summary["window_s"] = self.t1 - self.t0
        return summary

    def add(self, key: str, n: int = 1) -> None:
        if self.active:
            with self._lock:
                self.count[key] = self.count.get(key, 0) + n

    def span(self, name: str):
        if not self.active:
            return nullcontext()
        import torch

        return torch.profiler.record_function(f"bench.{name}")


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof) -> dict:
    """Device busy and window seconds, seconds by kernel name, the device
    operations that took most time and the idle gaps by the benchmark span
    open at the time (the innermost on any thread; "untracked" where none)."""
    import torch

    # a CPU rehearsal reads the CPU's top-level aten ops as its "device" rows
    device_type = "CUDA" if torch.cuda.is_available() else "CPU"
    device, spans = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end  # microseconds, one clock
        if e.device_type.name == device_type:
            if not e.name.startswith("bench."):
                device.append((e.name, start, end))
        if e.device_type.name == "CPU" and e.name.startswith("bench."):
            spans.append((e.name[6:], start, end))
    if not device:
        return {"busy_s": 0.0, "window_s": 0.0, "by_name": {}, "launches": {}, "device_ops": [], "idle_gaps": []}
    busy = _union([(s, e) for _, s, e in device])
    lo = min(s for _, s, _ in device)
    hi = max(e for _, _, e in device)
    by_name: dict[str, float] = {}
    launches: dict[str, int] = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        launches[name] = launches.get(name, 0) + 1
    gaps: dict[str, float] = {}
    spans.sort(key=lambda x: x[1])
    heap: list[tuple[float, float, str]] = []  # (-start, end, name) of spans begun so far
    nxt = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        while nxt < len(spans) and spans[nxt][1] <= mid:
            name, s0, e0 = spans[nxt]
            heapq.heappush(heap, (-s0, e0, name))
            nxt += 1
        while heap and heap[0][1] < mid:  # the latest-begun span has ended
            heapq.heappop(heap)
        key = heap[0][2] if heap else "untracked"
        gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "by_name": by_name,
        "launches": launches,
        "device_ops": [[n, v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
