"""SAM2 segmentation-forward ceiling: FLOPs, bytes, share of peak, and the op table.

    python3 -m atlaspatch_tpu_torch.tools.sam2_ceiling --sizes 512,768,1024 --batch 8 \\
        [--precision bfloat16] [--measure | --thumbs-per-sec R --rate-size S] [--peak-tflops P]

The port of ``tools/sam2_ceiling.py``. For each input size it runs the port's
``segment_step_packed`` (Hiera-tiny at full width, the ``--seg-input-size``
override the service applies) on the meta device, where every op runs on
shapes alone and the attention takes its plain version, under two counters:

1. ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs of the matrix
   products, convolutions and attention products (2 per multiply-add). The
   elementwise work is not counted, so the count sits a few percent under
   XLA's ``cost_analysis`` of the JAX step (0.97 at 512 and 1024). The
   trunk is ``backbone``, the neck ``image_features`` minus the trunk, the
   heads the rest, as the JAX tool splits them.
2. A ``TorchDispatchMode`` that adds, for every aten op that is not a view,
   the bytes of the tensors it reads and of those it writes: an unfused,
   eager count of the memory traffic, one round trip per op. It is not
   XLA's "bytes accessed" of the fused JAX program, and not comparable to it.

With ``--measure`` it also measures the resident thumbnails/s on the card
(random weights, the images already on the card; ``REPS`` dispatches, then
one sync, best of 3), the JAX tool's protocol. The share of peak uses
``--peak-tflops``, by default the card's published dense peak for
``--precision``: 989 TFLOP/s for bfloat16 (tensor cores), 67 for float32
(CUDA cores: the segmentation path keeps TF32 off). Every such share is
printed beside the card's name and power limit as ``nvidia-smi`` gives them.
Prints a markdown table ready for PERF.md.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}  # H100 SXM dense: bf16 tensor cores; FP32 CUDA cores
MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution")  # the aten ops the FLOP count sees
REPS = 8
_FREE = ("empty", "empty_strided", "empty_like")  # allocate without writing


class ByteCounter(TorchDispatchMode):
    """Bytes read and written by every aten op that runs under it (views
    and bare allocations move none), and how often each op ran."""

    def __init__(self):
        super().__init__()
        self.read = self.written = 0
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with self:  # a composite op (linear, einsum, ...) counts as the ops it runs, as FlopCounterMode counts it
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        written = sum(_nbytes(t) for t in tree_leaves(out))
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        if written and not func.is_view and name not in _FREE:
            self.read += sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
            self.written += written
        return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _meta_model(size: int, precision: str):
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel

    cfg = SAM2Config.tiny()
    if size != cfg.image_size:
        cfg = dataclasses.replace(cfg, image_size=size)  # as the seg service applies --seg-input-size
    with torch.device("meta"):
        model = SAM2ImageModel(cfg).eval()
    return model.to(getattr(torch, precision))


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def analyze_size(size: int, batch: int, precision: str) -> dict:
    """FLOPs and bytes of one ``segment_step_packed`` at ``size``, counted
    on the meta device, per thumbnail, with the trunk / neck / heads split
    and the aten op counts."""
    from atlaspatch_tpu_torch.models.sam2.model import normalize_images, segment_step_packed

    model = _meta_model(size, precision)
    images = torch.zeros((batch, size, size, 3), dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as flop_counter, ByteCounter() as byte_counter:
        segment_step_packed(model, images, 0.0)
    flops = flop_counter.get_total_flops()
    pix = normalize_images(model.cfg, images).to(getattr(torch, precision))
    with torch.inference_mode():
        trunk = _flops(lambda: model.vision_encoder.backbone(pix))
        features = _flops(lambda: model.image_features(pix))
    return {
        "size": size,
        "batch": batch,
        "precision": precision,
        "flops_per_thumb": flops / batch,
        "trunk_flops_per_thumb": trunk / batch,
        "neck_flops_per_thumb": (features - trunk) / batch,
        "head_flops_per_thumb": (flops - features) / batch,
        "gbytes_per_thumb": (byte_counter.read + byte_counter.written) / batch / 1e9,
        "flops_by_op": {str(k).split(".")[-1]: v / batch for k, v in flop_counter.get_flop_counts()["Global"].items()},
        "aten_ops": dict(byte_counter.ops),
    }


def measure_rate(size: int, batch: int, precision: str) -> float:
    """Resident thumbnails/s of ``segment_step_packed`` on the card: random
    weights and uint8 images already there, ``REPS`` dispatches and one
    sync (a small slice fetched), best of 3 after a warm call."""
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.model import init_params, segment_step_packed

    if not torch.cuda.is_available():
        raise SystemExit("--measure needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(SAM2Config.tiny(), image_size=size)
    model = init_params(cfg, seed=0).to("cuda", getattr(torch, precision))
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 255, (batch, size, size, 3), dtype=torch.uint8, generator=gen).cuda()
    segment_step_packed(model, images, 0.0).cpu()  # warm: the kernels' build, cuDNN plans
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = segment_step_packed(model, images, 0.0)
        out.reshape(-1)[:8].cpu()
        best = max(best, batch * REPS / (time.perf_counter() - t0))
    return best


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi on this machine"
    return out.stdout.strip().splitlines()[0]


def table(rows: list[dict]) -> list[str]:
    lines = ["| input | GFLOP/thumb | trunk | neck | heads | GB/thumb | arith. intensity (FLOP/B) |",
             "|---|---|---|---|---|---|---|"]
    for r in rows:
        ai = r["flops_per_thumb"] / max(1.0, r["gbytes_per_thumb"] * 1e9)
        lines.append(f"| {r['size']} | {r['flops_per_thumb'] / 1e9:.2f} | {r['trunk_flops_per_thumb'] / 1e9:.2f} "
                     f"| {r['neck_flops_per_thumb'] / 1e9:.2f} | {r['head_flops_per_thumb'] / 1e9:.2f} "
                     f"| {r['gbytes_per_thumb']:.2f} | {ai:.0f} |")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="512,768,1024")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--precision", default="bfloat16", choices=sorted(PEAK_TFLOPS))
    ap.add_argument("--thumbs-per-sec", type=float, default=None,
                    help="measured resident rate at --rate-size")
    ap.add_argument("--rate-size", type=int, default=1024,
                    help="the input size --thumbs-per-sec was measured at")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="default: the card's dense peak for --precision (989 bfloat16, 67 float32)")
    ap.add_argument("--measure", action="store_true",
                    help="also measure the resident rate per size on the card (host otherwise idle)")
    args = ap.parse_args(argv)
    peak = args.peak_tflops or PEAK_TFLOPS[args.precision]

    rows = [analyze_size(int(s), args.batch, args.precision) for s in args.sizes.split(",")]
    print(f"# {args.precision}, batch {args.batch}; bytes: the eager, unfused count (each op's reads and writes)")
    print("\n".join(table(rows)))
    card = None
    for r in rows:
        rate = measure_rate(r["size"], args.batch, args.precision) if args.measure else None
        if rate is None and args.thumbs_per_sec and r["size"] == args.rate_size:
            rate = args.thumbs_per_sec
        if rate:
            card = card or card_line()
            tflops = r["flops_per_thumb"] * rate / 1e12
            print(f"\n@{r['size']}: {rate:.1f} thumbs/s resident -> {tflops:.1f} TFLOP/s = "
                  f"{100 * tflops / peak:.1f}% of {peak:.0f} TFLOP/s peak [{card}]")
    for r in rows:
        kinds = {k: n for k, n in sorted(r["aten_ops"].items()) if k in MATMUL_OPS}
        print(f"# size {r['size']} aten op counts: {kinds}, {sum(r['aten_ops'].values())} ops in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
