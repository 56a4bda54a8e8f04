"""Time int8_linear_s8's two bodies and the wgmma body's two tile widths at the int8 serving mode's shapes.

    python3 -m atlaspatch_tpu_torch.tools.int8_variants

Builds the ``atlas_int8_linear`` library (``csrc/int8_linear.cu`` and
``csrc/int8_linear_wgmma.cu``) and prints, per kernel instantiation, its
registers and stack or spills by ``ptxas -v`` and the library's SASS counts
of IMMA (mma.sync), IGMMA (wgmma s8) and UTMALDG (TMA loads). Then, at
vit_l_16's four block linears at batch 32 and 256 (M = 6,304 and 50,432)
and medsiglip's MLP (hidden 4,304) at M = 8,192 and 5, it forces each body
the shape admits: ``mma``, ``wgmma`` in 128-column tiles and in 256-column
tiles, each held against the plain version at max-abs 0, and times each by
its device time per launch (torch.profiler), in two rounds (forward and
reverse order), beside the tile width ``wgmma_block_n`` picks, the bound,
``torch._int_mm`` alone (cuBLASLt's int8 product, M > 16 only; the kernels
it ran are printed) and bf16 ``F.linear``, which are timed only. Then the
sums over one vit_l_16 forward (96 linears) per batch, and the host time of
one call: the routed ``int8_linear``, the wgmma body's C entry alone
(through ctypes), ``torch._int_mm`` and ``F.linear``. Last, builds the wgmma
body again once per entry of VARIANTS, each the committed source with a few
lines replaced, all in parallel, and times each build's two tile widths at
vit_l_16's shapes (the median of three profiler windows), each build's
output equal to the committed body's. Needs an NVIDIA Hopper card and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from atlaspatch_tpu_torch.build import BUILD_DIR, CSRC, build_log, build_shared_library, nvcc_path
from atlaspatch_tpu_torch.ops import int8 as I

VITL = {"qkv": (1024, 3072), "proj": (1024, 1024), "fc1": (1024, 4096), "fc2": (4096, 1024)}
MEDSIGLIP = {"fc1": (1152, 4304), "fc2": (4304, 1152)}
INT8_OPS, BYTES_PER_S = 1979e12, 3.35e12  # H100 SXM: dense int8 tensor cores, HBM3
BODIES = {"mma": ("mma", None), "wgmma/128": ("wgmma", 128), "wgmma/256": ("wgmma", 256)}
_STORE = "        sts32(out_tile + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ g) << 4) + 4 * t, pack_bf16(y[0], y[1]));"
# variant -> (text of the committed int8_linear_wgmma.cu, its replacement) pairs
VARIANTS = {
    "committed": [],
    "a plain store to shared memory, which the compiler may move": [(_STORE, (
        "        *reinterpret_cast<uint32_t*>(smem_raw + (out_tile - smem_u32(smem_raw)) + (j >> 3) * 8192 + "
        "r * 128 + (((j & 7) ^ g) << 4) + 4 * t) = pack_bf16(y[0], y[1]);"))],
    "at most 4 stages": [("constexpr int kMaxStages = 6;", "constexpr int kMaxStages = 4;")],
}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int = 20, kernel: str | None = None, seen: dict | None = None) -> float:
    """Mean device time of one fn() call: the self device time of the kernels
    whose name holds ``kernel`` (every kernel for None) over the launches the
    profiler kept of the one that took the most of it (the call's product
    kernel: a library call may launch a helper more often, and the profiler
    may drop some launches of a burst). With ``seen``, fills it with the
    kernels' names and launches in the window."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                  and (kernel is None or kernel in e.key)]
        count = max(events, key=lambda e: e.self_device_time_total).count if events else 0
        if 0 < count <= reps:
            if seen is not None:
                seen.update((e.key, e.count) for e in events)
            return sum(e.self_device_time_total for e in events) / 1e3 / count
    raise RuntimeError(f"the profiler kept none of {reps} launches in 3 windows")


def bound_ms(m: int, n: int, k: int) -> tuple[float, str]:
    """The least time of one (M, K) x (N, K) product to bfloat16: 2 M N K
    int8 operations at the tensor-core peak, or xq, W, both scales, the bias
    and the output over HBM once, whichever is longer."""
    ops = 1e3 * 2.0 * m * n * k / INT8_OPS
    nbytes = 1e3 * (m * k + n * k + 4 * m + 6 * n + 2 * m * n) / BYTES_PER_S
    return (ops, "operations") if ops >= nbytes else (nbytes, "bytes")


def build_report() -> None:
    lib = I.load_int8_library()
    log = build_log(Path(lib._name))
    for name, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)", log, re.S):
        regs = re.search(r"Used (\d+) registers", body).group(1)
        stack = re.search(r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill loads)", body)
        print(f"ptxas {name}: {regs} registers, {stack.group(1) if stack else 'no stack line'}")
    for line in log.splitlines():
        if "warning" in line.lower():
            print(f"ptxas {line.strip()}")
    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    ops = Counter(re.findall(r"\b(IMMA\.[\w.]+|IGMMA\.[\w.]+|\w*GMMA\.[\w.]+|UTMALDG[\w.]*)", sass))
    print(f"SASS {dict(ops)}")


def _source(patches) -> str:
    src = (CSRC / "int8_linear_wgmma.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"the source no longer holds one copy of {old!r}")
        src = src.replace(old, new)
    return src


def _build_variant(item):
    """(name, the variant's atlas_int8_linear_s8_wgmma, its ptxas summary)."""
    i, (name, patches) = item
    cu = BUILD_DIR / "int8_variants" / f"variant{i}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(_source(patches))
    path = build_shared_library(f"atlas_int8_wgmma_variant{i}", [cu], [nvcc_path(), *I._NVCC_FLAGS])
    fn = ctypes.CDLL(str(path)).atlas_int8_linear_s8_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    found = re.findall(r"(\d+ bytes spill stores).*?Used (\d+) registers", build_log(path), re.S)
    return name, fn, "; ".join(f"{regs} registers, {spill}" for spill, regs in sorted(set(found)))


def _launch_variant(fn, xq, s_x, w, qscale, bias, block_n: int) -> torch.Tensor:
    m, k = xq.shape
    n = w.shape[0]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=xq.device)
    err = fn(xq.data_ptr(), w.data_ptr(), s_x.data_ptr(), qscale.data_ptr(), bias.data_ptr(), 1, out.data_ptr(),
             m, n, k, block_n, I._sm_count(0), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def variants(card: str) -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(_build_variant, enumerate(VARIANTS.items())))
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(b * 197, k, n) for b in (32, 256) for k, n in VITL.values()]
    for name, fn, ptxas in built:
        sums, cells = Counter(), []
        for m, k, n in shapes:
            _, xq, s_x, w, qscale, bias = _operands(m, n, k, gen)
            for bn in (128, 256):
                want = I._launch_linear("wgmma", xq, s_x, w, qscale, bias, torch.bfloat16, bn)
                if not torch.equal(_launch_variant(fn, xq, s_x, w, qscale, bias, bn), want):
                    raise AssertionError(f"variant {name!r} differs from the committed body at {(m, k, n, bn)}")
                ms = sorted(_device_ms(lambda: _launch_variant(fn, xq, s_x, w, qscale, bias, bn),
                                       kernel="int8_linear") for _ in range(3))[1]
                sums[f"b{m // 197}/{bn}"] += 24 * ms
                cells.append(f"{m}x{k}x{n}/{bn} {ms:.4f}")
            del xq, s_x, w, qscale, bias
        print(f"variant {name}: {ptxas}; forward sums (ms) {dict((k, round(v, 3)) for k, v in sums.items())}; "
              f"per launch {' '.join(cells)} [{card}]")


def _operands(m: int, n: int, k: int, gen: torch.Generator):
    x = (torch.randn(m, k, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    xq, s_x = I.quantize_rows(x)
    w = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int32).to(torch.int8)
    qscale = (torch.rand(n, device="cuda", generator=gen) + 0.5) / 127.0
    bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
    return x, xq, s_x, w, qscale, bias


def main() -> None:
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_report()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(b * 197, k, n, f"vit_l_16 {name} b{b}") for b in (32, 256) for name, (k, n) in VITL.items()]
    cases += [(m, k, n, f"medsiglip {name} M={m}") for m in (8192, 5) for name, (k, n) in MEDSIGLIP.items()]
    sums: dict = {}
    for m, k, n, label in cases:
        x, xq, s_x, w, qscale, bias = _operands(m, n, k, gen)
        want = I.int8_linear_plain(xq, s_x, w, qscale, bias, torch.bfloat16)
        bodies = {name: (lambda v=v, bn=bn: I._launch_linear(v, xq, s_x, w, qscale, bias, torch.bfloat16, bn))
                  for name, (v, bn) in BODIES.items()}
        for name, fn in bodies.items():
            err = (fn().float() - want.float()).abs().max().item()
            if err != 0:
                raise AssertionError(f"{label}: {name} max-abs {err} against the plain version (must be 0)")
        del want
        times: dict = {name: [] for name in bodies}
        for order in (list(bodies), list(reversed(bodies))):
            for name in order:
                times[name].append(_device_ms(bodies[name], kernel="int8_linear_s8"))
        w16 = w.to(torch.bfloat16)
        int_mm_kernels: dict = {}
        int_mm = _device_ms(lambda: torch._int_mm(xq, w.t()), seen=int_mm_kernels) if m > 16 else None
        bf16 = _device_ms(lambda: F.linear(x, w16, bias))
        bound, by = bound_ms(m, n, k)
        picked = I.wgmma_block_n(m, n, I._sm_count(0))
        body_s = " ".join(f"{name} {min(t):.4f}/{max(t):.4f}" for name, t in times.items())
        print(f"{label:22s} M={m:6d} K={k:5d} N={n:5d}: {body_s}; picked wgmma/{picked}; bound {bound:.4f} ({by}); "
              f"_int_mm {'null' if int_mm is None else f'{int_mm:.4f}'}; bf16 F.linear {bf16:.4f} "
              f"(device ms per launch, min/max of 2 rounds) [{card}]")
        if int_mm_kernels:
            print(f"{label:22s} _int_mm ran (kernel: launches in 20 calls) {int_mm_kernels}")
        if label.startswith("vit_l_16"):
            b = label.rsplit(" ", 1)[1]
            row = sums.setdefault(b, Counter())
            for name, t in times.items():
                row[name] += 24 * min(t)
            row["picked"] += 24 * min(times[f"wgmma/{picked}"])
            row["bound"] += 24 * bound
            row["_int_mm"] += 24 * int_mm
            row["bf16"] += 24 * bf16
        del x, xq, s_x, w, w16, qscale, bias
        torch.cuda.empty_cache()
    for b, row in sums.items():
        print(f"vit_l_16 forward {b} (96 linears), ms: " + ", ".join(f"{k} {v:.3f}" for k, v in row.items())
              + f" [{card}]")
    host_times(card)
    variants(card)


def _host_us(fn, reps: int = 200) -> float:
    """Host microseconds per fn() call, the least of three bursts of ``reps``
    calls that the card queues without waiting (the host clock stops before
    the synchronisation)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return best


def host_times(card: str) -> None:
    """The host time of one call at vit_l_16's qkv at batch 32 and medsiglip's
    fc2 at M = 5: the routed int8_linear (Python checks, the output's
    allocation, ctypes, three tensor-map encodes and the launch), the wgmma
    body's C entry alone through ctypes (encodes and launch), and the
    library calls, each after a warm call."""
    lib = I.load_int8_library()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in ((32 * 197, 1024, 3072), (5, 4304, 1152)):
        x, xq, s_x, w, qscale, bias = _operands(m, n, k, gen)
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        args = (xq.data_ptr(), w.data_ptr(), s_x.data_ptr(), qscale.data_ptr(), bias.data_ptr(), 1, out.data_ptr(),
                m, n, k, I.wgmma_block_n(m, n, I._sm_count(0)), I._sm_count(0),
                torch.cuda.current_stream().cuda_stream)
        w16 = w.to(torch.bfloat16)
        calls = {"int8_linear (routed)": lambda: I.int8_linear(xq, s_x, w, qscale, bias, torch.bfloat16),
                 "atlas_int8_linear_s8_wgmma (C entry)": lambda: lib.atlas_int8_linear_s8_wgmma(*args),
                 "quantize_rows": lambda: I.quantize_rows(x),
                 "torch._int_mm": (lambda: torch._int_mm(xq, w.t())) if m > 16 else None,
                 "bf16 F.linear": lambda: F.linear(x, w16, bias)}
        times = {name: _host_us(fn) for name, fn in calls.items() if fn is not None}
        print(f"host us per call at M={m} K={k} N={n}: "
              + ", ".join(f"{name} {us:.2f}" for name, us in times.items()) + f" [{card}]")
        del x, xq, s_x, w, w16, qscale, bias, out


if __name__ == "__main__":
    main()
