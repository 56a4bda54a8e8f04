"""What a cell served at int8 reads, with no such cell in ``BENCHMARK.json``:
the reference's W4A4 control that ``traffic/embed.py::control`` runs for it,
and the two int8 kernel readers. A later cell at int8 names them from its
workload file and its ``BENCHMARK.json`` entries alone."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests import rehearsal


def _control(monkeypatch, tmp_path, bits: int) -> dict:
    ctx = rehearsal.embed_context("embed.virchow2_bf16", monkeypatch, cache=tmp_path)
    ctx.workload["traffic"]["control"] = {"reference_bits": bits}
    return harness.traffic_module("embed").control(ctx)


def test_w4a4_control_reads_far_above_w8a8(monkeypatch, tmp_path):
    w4 = _control(monkeypatch, tmp_path, 4)["feature_rel_err"]
    w8 = _control(monkeypatch, tmp_path, 8)["feature_rel_err"]
    assert w4 >= 3 * w8 > 0, (w4, w8)


@pytest.mark.parametrize("name", ["int8_linear_roofline_pct", "quantize_roofline_pct"])
def test_int8_reader_is_its_bound_over_the_kernel_time(name):
    reader = harness.metric_module(name)
    cfg = harness.config("virchow2")
    kernel = {"int8_linear_roofline_pct": "int8_linear_s8_wgmma_kernel<256>",
              "quantize_roofline_pct": "quantize_rows_s8_kernel<bf16>"}[name]
    if name == "int8_linear_roofline_pct":
        least = 3 * reader.bound_s(cfg, 32) + reader.bound_s(cfg, 4)
    else:
        least = (3 * reader.bytes_per_forward(cfg, 32) + reader.bytes_per_forward(cfg, 4)) / harness.HBM_BYTES_PER_S
    layer = {"precision": "int8", "config": cfg, "counts": {"batch:32": 3, "batch:4": 1, "rows": 100},
             "slice": {"by_name": {kernel: 2.0 * least, "other_kernel": 1.0}}}
    assert reader.read(layer) == pytest.approx(50.0)
    assert reader.read({**layer, "precision": "bfloat16"}) is None
    assert reader.read({**layer, "slice": {"by_name": {"other_kernel": 1.0}}}) is None
