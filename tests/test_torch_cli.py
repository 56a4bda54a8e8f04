"""The port's command line (atlaspatch_tpu_torch/cli.py) against the JAX
package's (atlaspatch_tpu/cli.py), both run in this process through
click.testing with ``--device cpu``.

One module fixture runs ``segment-and-get-coords`` with ``--save-images`` and
the three overlays through each CLI over the same two PNG slides, with the
miniature SAM2 and one shared weight archive, then runs it again
(``--skip-existing``). The masks each run hands to extraction are recorded:

  * the same stdout lines (the output root written as <out>; the [OK] lines
    in any order);
  * masks within slice 1's bar: at most 3 pixels differ in all, and at least
    one slide agrees bit for bit;
  * where a slide's masks agree: the same H5 file as h5py reads it (every
    attr but ``creation_date``), the same patch PNGs, the same overlay
    pixels;
  * the second pass segments nothing and rewrites no file.

The rest costs no model run: the ``--fast`` preset fills only values not
typed (both packages' configs equal), ``--seg-input-size`` and ``tpu`` are
refused at the option layer, the default device without CUDA stops with an
error naming ``--device cpu``, multi-GPU flags run on one device and are
refused with more, ``info`` prints the JAX package's lines with a ready
list that is a subset of the JAX package's, and ATLASPATCH_TORCH_TRACE
writes a profiler trace.
"""

import importlib
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    CLI_PACKAGES,
    h5_view,
    invoke_cli,
    png_array,
    shared_cli_weights,
    stdout_lines,
    write_png_slides,
)

MAX_MASK_DIFF = 3  # pixels, in all (slice 1's bar)
OVERLAYS = {"grids": "{}.png", "mask": "{}_mask.png", "mask_bw": "{}_mask_bw.png",
            "contours": "{}_contours.png"}
STEMS = ("s0", "s1")


def _seg_args(slides, out, csv, *extra):
    return ["segment-and-get-coords", slides, "--output", out, "--patch-size", "64",
            "--target-mag", "20", "--device", "cpu", "--seg-batch-size", "2", "--mpp-csv", csv,
            *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    slides, csv = write_png_slides(tmp, {"s0": 0, "s1": 1}, {"s0": 0.5, "s1": 0.5})
    record = {pkg: {"masks": {}, "segment_calls": 0} for pkg in CLI_PACKAGES}
    with pytest.MonkeyPatch.context() as mp:
        shared_cli_weights(mp, tmp)
        for pkg in CLI_PACKAGES:
            extraction = importlib.import_module(f"{pkg}.services.extraction").PatchExtractionService
            segmentation = importlib.import_module(f"{pkg}.services.segmentation").SAM2SegmentationService

            def extract(self, wsi, mask, *, slide, _orig=extraction.extract, _rec=record[pkg]):
                _rec["masks"][slide.stem] = np.array(mask, copy=True)
                return _orig(self, wsi, mask, slide=slide)

            def segment(self, thumbs, _orig=segmentation.segment_thumbnails_async, _rec=record[pkg]):
                _rec["segment_calls"] += 1
                return _orig(self, thumbs)

            mp.setattr(extraction, "extract", extract)
            mp.setattr(segmentation, "segment_thumbnails_async", segment)
        for pkg in CLI_PACKAGES:
            out = tmp / f"out-{pkg}"
            args = _seg_args(slides, out, csv, "--save-images", "--visualize-grids", "--visualize-mask",
                             "--visualize-contours", "--verbose")
            first = invoke_cli(pkg, args, catch_exceptions=False)
            calls = record[pkg]["segment_calls"]
            mtimes = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
            second = invoke_cli(pkg, args, catch_exceptions=False)
            record[pkg].update(
                out=out, first=first, second=second, first_calls=calls,
                second_calls=record[pkg]["segment_calls"] - calls, mtimes=mtimes,
                mtimes_after={p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()},
            )
    return record


def _agreeing(runs) -> list[str]:
    masks = [runs[pkg]["masks"] for pkg in CLI_PACKAGES]
    return [s for s in STEMS if np.array_equal(masks[0][s], masks[1][s])]


def test_segment_and_get_coords_prints_the_same_lines(runs):
    jax_run, port_run = (runs[pkg] for pkg in CLI_PACKAGES)
    assert jax_run["first"].exit_code == port_run["first"].exit_code == 0, port_run["first"].output
    # [OK] lines come in the order slides finish, which threads decide
    want = sorted(stdout_lines(jax_run["first"], jax_run["out"]))
    assert "Completed 2 slide(s), failures: 0" in want
    assert sorted(stdout_lines(port_run["first"], port_run["out"])) == want


def test_masks_meet_slice_one_bar(runs):
    masks = [runs[pkg]["masks"] for pkg in CLI_PACKAGES]
    assert set(masks[0]) == set(masks[1]) == set(STEMS)
    diff = sum(int((masks[0][s] != masks[1][s]).sum()) for s in STEMS)
    assert diff <= MAX_MASK_DIFF
    assert _agreeing(runs), "no slide's masks agree bit for bit"


def test_h5_files_identical_where_masks_agree(runs):
    for stem in _agreeing(runs):
        want, got = (h5_view(runs[pkg]["out"] / "patches" / f"{stem}.h5") for pkg in CLI_PACKAGES)
        assert got == want, stem
        assert want[0]["coords"][1][0] > 0, f"{stem}: no patch to compare"


def test_save_images_identical_where_masks_agree(runs):
    for stem in _agreeing(runs):
        dirs = [runs[pkg]["out"] / "images" / stem for pkg in CLI_PACKAGES]
        names = [sorted(p.name for p in d.iterdir()) for d in dirs]
        assert names[0] == names[1] and names[0], stem
        for name in names[0]:
            np.testing.assert_array_equal(png_array(dirs[1] / name), png_array(dirs[0] / name))


@pytest.mark.parametrize("kind", list(OVERLAYS))
def test_overlays_identical_where_masks_agree(runs, kind):
    for stem in _agreeing(runs):
        want, got = (png_array(runs[pkg]["out"] / "visualization" / OVERLAYS[kind].format(stem))
                     for pkg in CLI_PACKAGES)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_skip_existing_second_pass_segments_nothing(runs):
    for pkg in CLI_PACKAGES:
        run = runs[pkg]
        assert run["second"].exit_code == 0
        assert run["first_calls"] > 0 and run["second_calls"] == 0, pkg
        assert run["mtimes_after"] == run["mtimes"], pkg
    want, got = (stdout_lines(runs[pkg]["second"], runs[pkg]["out"]) for pkg in CLI_PACKAGES)
    assert got == want and "Completed 0 slide(s), failures: 0" in want


class _Stop(Exception):
    pass


def _captured_config(pkg, monkeypatch, args):
    """The AppConfig each CLI builds for ``args``; the run stops right after."""
    cli_mod = importlib.import_module(f"{pkg}.cli")
    captured = {}
    real = cli_mod._build_app_config

    def spy(kw, feature_cfg):
        captured["cfg"] = real(kw, feature_cfg)
        raise _Stop

    monkeypatch.setattr(cli_mod, "_build_app_config", spy)
    result = invoke_cli(pkg, args)
    assert isinstance(result.exception, _Stop), result.output
    return captured["cfg"].segmentation


@pytest.mark.parametrize("extra, want", [
    (["--fast"], (768, "bfloat16", 8, True)),
    (["--fast", "--seg-input-size", "1024"], (1024, "bfloat16", 8, False)),
    (["--fast", "--seg-precision", "float32"], (768, "float32", 8, True)),
    (["--fast", "--seg-batch-size", "4"], (768, "bfloat16", 4, True)),
    ([], (None, "float32", 1, False)),
])
def test_fast_preset_fills_only_values_not_typed(tmp_path, monkeypatch, extra, want):
    args = ["segment-and-get-coords", tmp_path, "--output", tmp_path / "o", "--patch-size", "64",
            "--target-mag", "20", "--device", "cpu", *extra]
    for pkg in CLI_PACKAGES:
        seg = _captured_config(pkg, monkeypatch, args)
        assert (seg.input_size, seg.precision, seg.batch_size, seg.input_size_preset) == want, pkg


_FEATURE_ARGS = ["--patch-size", "256", "--feature-extractors", "resnet50"]


@pytest.mark.parametrize("command", ["segment-and-get-coords", "detect-tissue", "process"])
def test_seg_input_size_refused_at_the_option_layer(tmp_path, command):
    extra = {"segment-and-get-coords": ["--patch-size", "256", "--target-mag", "20"],
             "process": [*_FEATURE_ARGS, "--target-mag", "20"]}.get(command, [])
    for pkg in CLI_PACKAGES:
        result = invoke_cli(pkg, [command, tmp_path, "--output", tmp_path / "o",
                                  "--seg-input-size", "100", *extra])
        assert result.exit_code == 2, (pkg, result.output)
        assert "positive multiple of 32" in result.output


@pytest.mark.parametrize("command, flag", [
    ("segment-and-get-coords", "--device"), ("detect-tissue", "--device"),
    ("process", "--device"), ("process", "--feature-device"),
])
@pytest.mark.parametrize("value", ["tpu", "tpu:0", "TPU"])
def test_tpu_is_refused(tmp_path, command, flag, value):
    extra = [] if command == "detect-tissue" else ["--patch-size", "64", "--target-mag", "20"]
    if command == "process":
        extra += _FEATURE_ARGS[2:]
    result = invoke_cli(CLI_PACKAGES[1], [command, tmp_path, "--output", tmp_path / "o", flag, value, *extra])
    assert result.exit_code == 2, result.output
    assert "TPU" in result.output and "cuda" in result.output
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("value, want", [("cuda", "cuda"), ("gpu", "cuda"), ("cuda:1", "cuda:1"),
                                         ("GPU:0", "cuda:0"), ("cpu", "cpu")])
def test_device_flags_take_torch_devices(tmp_path, monkeypatch, value, want):
    args = ["segment-and-get-coords", tmp_path, "--output", tmp_path / "o", "--patch-size", "64",
            "--target-mag", "20", "--device", value]
    assert _captured_config(CLI_PACKAGES[1], monkeypatch, args).device == want


@pytest.mark.parametrize("command", ["segment-and-get-coords", "detect-tissue", "process"])
def test_default_device_without_cuda_stops_naming_device_cpu(tmp_path, monkeypatch, capsys, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    extra = [] if command == "detect-tissue" else ["--patch-size", "64", "--target-mag", "20"]
    if command == "process":
        extra += _FEATURE_ARGS[2:]
    args = [command, str(tmp_path), "--output", str(tmp_path / "o"), *extra]
    result = invoke_cli(CLI_PACKAGES[1], args)
    assert result.exit_code != 0 and "--device cpu" in result.output, result.output
    assert not (tmp_path / "o" / "patches").exists() and not (tmp_path / "o" / "visualization").exists()
    # the console entry point too: a non-zero exit, never a run on the CPU
    from atlaspatch_tpu_torch import cli as cli_mod

    with pytest.raises(SystemExit) as stop:
        cli_mod.main(args)
    assert stop.value.code != 0 and "--device cpu" in capsys.readouterr().err


def test_multi_gpu_flags_are_refused_with_more_than_one_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    base = [tmp_path, "--output", tmp_path / "o", "--patch-size", "64", "--target-mag", "20"]
    for args in (["segment-and-get-coords", *base, "--seg-data-parallel"],
                 ["process", *base, *_FEATURE_ARGS[2:], "--feature-parallel", "data"],
                 ["process", *base, *_FEATURE_ARGS[2:], "--feature-parallel", "tensor"]):
        result = invoke_cli(CLI_PACKAGES[1], args)
        assert result.exit_code == 2, result.output
        assert "2 CUDA devices" in result.output and "not ported" in result.output
    assert not (tmp_path / "o" / "patches").exists()


def test_seg_data_parallel_on_one_device_warns_and_runs(tmp_path, monkeypatch, caplog):
    slides, csv = write_png_slides(tmp_path, {"s0": 0}, {"s0": 0.5})
    shared_cli_weights(monkeypatch, tmp_path)
    with caplog.at_level(logging.WARNING, logger="atlaspatch_tpu_torch.cli"):
        result = invoke_cli(CLI_PACKAGES[1], _seg_args(slides, tmp_path / "out", csv, "--seg-data-parallel"),
                            catch_exceptions=False)
    assert result.exit_code == 0 and "Completed 1 slide(s), failures: 0" in result.stdout
    assert any("only one device is visible" in r.getMessage() for r in caplog.records)


def test_info_prints_the_jax_lines_and_a_ready_subset():
    jax_lines, port_lines = (invoke_cli(pkg, ["info"]).stdout.splitlines() for pkg in CLI_PACKAGES)
    lists = ("Feature extractors (", "Registered, tower pending: ")
    assert [ln for ln in port_lines if not ln.startswith(lists)] == \
        [ln for ln in jax_lines if not ln.startswith(lists)]

    def ready(lines):
        line = next(ln for ln in lines if ln.startswith(lists[0]))
        return set(line.split(": ", 1)[1].split(", "))

    assert ready(port_lines) <= ready(jax_lines)
    assert {"resnet50", "convnext_tiny", "vit_l_16"} <= ready(port_lines)


def test_python_m_entry_point_runs_without_install(tmp_path):
    """``python -m atlaspatch_tpu_torch.cli`` from the repository root."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", "atlaspatch_tpu_torch.cli", "info"], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == invoke_cli(CLI_PACKAGES[1], ["info"]).stdout.splitlines()


def test_torch_trace_is_written_where_asked(tmp_path, monkeypatch):
    """ATLASPATCH_TORCH_TRACE=<dir>: the run inside maybe_trace leaves one
    Chrome trace there that names the torch ops it ran; unset, nothing."""
    import json

    from atlaspatch_tpu_torch.utils import perf

    with perf.maybe_trace():
        torch.ones(4, 4) @ torch.ones(4, 4)
    monkeypatch.setenv("ATLASPATCH_TORCH_TRACE", str(tmp_path / "trace"))
    with perf.maybe_trace():
        torch.ones(8, 8) @ torch.ones(8, 8)
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
