"""The port's SAM2 ceiling tool (``atlaspatch_tpu_torch/tools/sam2_ceiling.py``) on the CPU.

The tool counts ``segment_step_packed`` on the meta device with
``FlopCounterMode`` and a byte-counting dispatch mode. Held here:

  * at Hiera-tiny width and input 256, batch 1, float32, the port's FLOPs per
    thumbnail lie between 0.95 and 1.0 of XLA's ``cost_analysis`` flops of
    the JAX ``segment_step_packed`` (measured 0.972 here; 0.969 at 512 and
    0.971 at 1024): the counter leaves out the elementwise work XLA counts;
  * the meta-device count equals the count of the same step run on CPU
    tensors (the plain versions of the kernels), at the miniature config;
  * trunk + neck + heads equal the total;
  * a ``Linear`` and a convolution count 2·M·N·K; a single ``mm`` moves its
    operands' and its result's bytes, a view none;
  * the table has the JAX tool's columns; the share of peak uses the card's
    peak for the precision and names the card (or its absence).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from atlaspatch_tpu_torch.tools import sam2_ceiling as C

REPO = Path(__file__).resolve().parent.parent
SIZE = 256
JAX_BAND = (0.95, 1.0)


@pytest.fixture(scope="module")
def counted():
    return C.analyze_size(SIZE, 1, "float32")


def test_flops_lie_under_the_jax_cost_analysis(counted):
    import jax
    import jax.numpy as jnp

    from atlaspatch_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
    from atlaspatch_tpu.models.sam2.model import init_params, segment_step_packed

    cfg = dataclasses.replace(JaxSAM2Config.tiny(), image_size=SIZE)
    params = jax.eval_shape(lambda: init_params(cfg, 0))
    images = jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.uint8)
    cost = segment_step_packed.lower(cfg, params, images, jax.ShapeDtypeStruct((), jnp.float32)).compile()
    cost = cost.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    ratio = counted["flops_per_thumb"] / float(cost["flops"])
    print(f"input {SIZE}: port {counted['flops_per_thumb'] / 1e9:.3f} GFLOP, XLA {float(cost['flops']) / 1e9:.3f}, "
          f"ratio {ratio:.4f}")
    assert JAX_BAND[0] <= ratio <= JAX_BAND[1]


def test_meta_count_equals_the_cpu_plain_versions(monkeypatch):
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel, segment_step_packed
    from atlaspatch_tpu_torch.ops import attention as A

    monkeypatch.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
    size = SAM2Config.test_tiny().image_size
    meta = C.analyze_size(size, 2, "float32")
    model = SAM2ImageModel(SAM2Config.test_tiny()).eval()
    A.reset_launch_counts()
    with FlopCounterMode(display=False) as counter:
        segment_step_packed(model, torch.zeros((2, size, size, 3), dtype=torch.uint8), 0.0)
    assert A.flash_attention.launches == 0
    assert meta["flops_per_thumb"] == counter.get_total_flops() / 2 > 0


def test_trunk_neck_and_heads_sum_to_the_total(counted):
    parts = [counted[f"{p}_flops_per_thumb"] for p in ("trunk", "neck", "head")]
    assert all(p > 0 for p in parts) and parts[0] > 0.9 * counted["flops_per_thumb"]
    assert sum(parts) == pytest.approx(counted["flops_per_thumb"], rel=1e-12)
    assert sum(counted["flops_by_op"].values()) == pytest.approx(counted["flops_per_thumb"], rel=1e-12)
    assert counted["aten_ops"]["addmm"] > 0 and counted["aten_ops"]["convolution"] > 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_linear_and_a_conv_count_2mnk(device):
    m, k, n = 37, 48, 20
    with torch.device(device):
        linear = torch.nn.Linear(k, n)
        conv = torch.nn.Conv2d(3, 8, kernel_size=4, stride=4)
        x = torch.zeros(m, k)
        img = torch.zeros(2, 3, 32, 32)
    assert C._flops(lambda: linear(x)) == 2 * m * n * k
    out_positions = 2 * 8 * 8  # batch x output pixels: M of the implicit product
    assert C._flops(lambda: conv(img)) == 2 * out_positions * 8 * (3 * 4 * 4)


def test_an_mm_moves_its_operands_and_result():
    a, b = torch.zeros(5, 7), torch.zeros(7, 3, dtype=torch.float32)
    with C.ByteCounter() as counter:
        out = torch.mm(a, b)
    assert (counter.read, counter.written) == (a.nbytes + b.nbytes, out.nbytes)
    assert counter.ops == {"mm": 1}
    with C.ByteCounter() as counter:
        a.view(7, 5).t()
    assert counter.read == counter.written == 0 and sum(counter.ops.values()) == 2


def test_the_table_has_the_jax_tools_columns(counted):
    jax_tool = (REPO / "tools" / "sam2_ceiling.py").read_text()
    header = re.search(r'print\("(\| input \|[^"]*)"\)', jax_tool).group(1)
    lines = C.table([counted])
    assert lines[0] == header and lines[1] == "|---|---|---|---|---|---|---|"
    assert lines[2].startswith(f"| {SIZE} | ") and len(lines[2].split("|")) == len(header.split("|"))


def test_main_prints_the_share_of_the_precisions_peak(capsys, monkeypatch):
    monkeypatch.setattr(C, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert C.main(["--sizes", str(SIZE), "--batch", "1", "--precision", "float32", "--thumbs-per-sec", "100",
                   "--rate-size", str(SIZE)]) == 0
    out = capsys.readouterr().out
    assert "| input | GFLOP/thumb |" in out and f"% of 67 TFLOP/s peak [NVIDIA H100 80GB HBM3, 700.00 W]" in out
    assert re.search(rf"# size {SIZE} aten op counts: \{{'addmm': \d+, 'bmm': \d+, 'convolution': \d+", out)
    assert C.main(["--sizes", str(SIZE), "--batch", "1", "--thumbs-per-sec", "100", "--rate-size", str(SIZE)]) == 0
    assert "% of 989 TFLOP/s peak" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            C.main(["--sizes", str(SIZE), "--batch", "1", "--measure"])
