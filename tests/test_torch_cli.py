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
error naming ``--device cpu``, multi-GPU flags run on one device and build
a mesh of every card with more, ``info`` prints the JAX package's lines with a ready
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


# ------------------------------------------------------------ finetune-sam2 → detect-tissue → evaluate-masks
FINETUNE_ARGS = ["--epochs", "2", "--batch-size", "2", "--val-fraction", "0.2", "--device", "cpu"]


@pytest.fixture(scope="module")
def finetunes(tmp_path_factory):
    """Both CLIs' finetune-sam2 over one synthetic corpus (5 pairs of 256x192:
    4 train, 1 held out) from one JAX init archive, at the miniature config;
    then the port's detect-tissue with its sam2_finetuned.npz over the
    held-out image, and evaluate-masks of that mask against the truth."""
    import shutil

    from atlaspatch_tpu.tools.convert_weights import _flatten
    from atlaspatch_tpu_torch.tools.synthetic_corpus import generate_corpus
    from torch_port_helpers import shared_flax_params

    tmp = tmp_path_factory.mktemp("finetune")
    images, masks = generate_corpus(tmp / "corpus", n=5, width=256, height=192)
    init = tmp / "init.npz"
    np.savez(init, **_flatten(shared_flax_params(0)))
    record = {}
    with pytest.MonkeyPatch.context() as mp:
        shared_cli_weights(mp, tmp)
        for pkg in CLI_PACKAGES:
            out = tmp / f"ft-{pkg}"
            result = invoke_cli(pkg, ["finetune-sam2", images, "--masks", masks, "-o", out, *FINETUNE_ARGS,
                                      "--sam2-checkpoint", init], catch_exceptions=False)
            record[pkg] = dict(out=out, result=result, npz=out / "sam2_finetuned.npz")
        # the held-out pair: the validation split of np.random.default_rng(seed 0)
        held = sorted(images.iterdir())[int(np.random.default_rng(0).permutation(5)[0])]
        slides = tmp / "held_out"
        slides.mkdir()
        shutil.copy(held, slides / held.name)
        (tmp / "mpp.csv").write_text(f"wsi,mpp\n{held.name},0.5\n")
        port = record[CLI_PACKAGES[1]]
        detect = invoke_cli(CLI_PACKAGES[1], ["detect-tissue", slides, "--output", tmp / "detect", "--device", "cpu",
                                              "--mpp-csv", tmp / "mpp.csv", "--sam2-checkpoint", port["npz"]],
                            catch_exceptions=False)
        scored = invoke_cli(CLI_PACKAGES[1], ["evaluate-masks", tmp / "detect" / "visualization", "--truth", masks,
                                              "--csv", tmp / "scores.csv"], catch_exceptions=False)
        record.update(held=held.stem, detect=detect, scored=scored, csv=(tmp / "scores.csv").read_text(),
                      init=init, tmp=tmp)
        yield record
    shutil.rmtree(tmp)


def _numbers(line: str) -> tuple[str, list[float]]:
    import re

    pattern = r"\d+\.\d{4}"
    return re.sub(pattern, "<x>", line), [float(x) for x in re.findall(pattern, line)]


def test_finetune_sam2_prints_the_jax_lines(finetunes):
    """The same lines; each loss and IoU printed to 4 decimals within 1e-4 of
    JAX's (float32 sums in another order can round the last digit apart)."""
    lines = {}
    for pkg in CLI_PACKAGES:
        run = finetunes[pkg]
        assert run["result"].exit_code == 0, run["result"].output
        lines[pkg] = stdout_lines(run["result"], run["out"])
    jax_lines, port_lines = (lines[p] for p in CLI_PACKAGES)
    assert port_lines[0].startswith("Finetuned 4 step(s) over 4 pair(s): loss ")
    assert port_lines[1].startswith("Validation (1 held-out pair(s)): loss ")
    assert port_lines[2] == "Checkpoint: <out>/sam2_finetuned.npz" and len(port_lines) == 3
    for got, want in zip(port_lines, jax_lines, strict=True):
        (text, values), (want_text, want_values) = _numbers(got), _numbers(want)
        assert text == want_text
        np.testing.assert_allclose(values, want_values, rtol=0, atol=1e-4 + 1e-9)


def test_finetuned_archive_has_the_jax_keys_and_loads_in_both(finetunes):
    """sam2_finetuned.npz: JAX's keys, shapes and dtypes, only the norm
    tensors moved from init, and the parameter changes within the three-step
    bar of JAX's; JAX's SAM2Predictor loads the port's archive and the
    port's loads JAX's."""
    import jax

    from atlaspatch_tpu.core.config import SegmentationConfig as JaxSegmentationConfig
    from atlaspatch_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
    from atlaspatch_tpu.services.segmentation import SAM2Predictor as JaxSAM2Predictor
    from atlaspatch_tpu.tools.convert_weights import _flatten
    from atlaspatch_tpu_torch.core.config import SegmentationConfig
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.convert import load_npz
    from atlaspatch_tpu_torch.services.segmentation import SAM2Predictor

    def arrays(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    port, want, init = (arrays(p) for p in (finetunes[CLI_PACKAGES[1]]["npz"], finetunes[CLI_PACKAGES[0]]["npz"],
                                            finetunes["init"]))
    assert {k: (v.shape, v.dtype) for k, v in port.items()} == {k: (v.shape, v.dtype) for k, v in want.items()}
    moved = {k for k in port if not np.array_equal(port[k], init[k])}
    assert moved and all("norm" in k.rsplit("/", 1)[0] for k in moved)
    for k in moved:
        delta = want[k] - init[k]
        assert float(np.abs((port[k] - init[k]) - delta).max()) <= 1e-3 * float(np.abs(delta).max()) + 1e-7, k

    jax_cfg = JaxSAM2Config.test_tiny()
    jax_pred = JaxSAM2Predictor(JaxSegmentationConfig(checkpoint_path=finetunes[CLI_PACKAGES[1]]["npz"],
                                                      device="cpu").validated(), sam2_cfg=jax_cfg)
    loaded = {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, jax_pred.params)).items()}
    assert loaded.keys() == port.keys() and all(np.array_equal(loaded[k], port[k]) for k in port)
    cfg = SAM2Config.test_tiny()
    pred = SAM2Predictor(SegmentationConfig(checkpoint_path=finetunes[CLI_PACKAGES[0]]["npz"], device="cpu")
                         .validated(), sam2_cfg=cfg)
    sd = load_npz(finetunes[CLI_PACKAGES[0]]["npz"], cfg)
    own = pred.model.state_dict()
    assert all(torch.equal(own[k], v) for k, v in sd.items())


def test_finetuned_checkpoint_drives_detect_tissue_and_evaluate_masks(finetunes):
    assert finetunes["detect"].exit_code == 0, finetunes["detect"].output
    assert "Created 1 mask overlay(s), failures: 0" in finetunes["detect"].stdout
    lines = finetunes["scored"].stdout.splitlines()
    held = finetunes["held"]
    assert lines[0].startswith(f"{held}: IoU ") and lines[1].startswith("Mean over 1 slide(s): IoU ")
    rows = finetunes["csv"].splitlines()
    assert rows[0] == "slide,iou,f1,precision,recall" and len(rows) == 2 and rows[1].startswith(f"{held},")


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


def _command_args(command, tmp_path) -> list:
    """The arguments ``command`` needs besides --output and --device."""
    if command == "finetune-sam2":
        return ["--masks", tmp_path]
    extra = [] if command == "detect-tissue" else ["--patch-size", "64", "--target-mag", "20"]
    return extra + (_FEATURE_ARGS[2:] if command == "process" else [])


@pytest.mark.parametrize("command, flag", [
    ("segment-and-get-coords", "--device"), ("detect-tissue", "--device"),
    ("process", "--device"), ("process", "--feature-device"), ("finetune-sam2", "--device"),
])
@pytest.mark.parametrize("value", ["tpu", "tpu:0", "TPU"])
def test_tpu_is_refused(tmp_path, command, flag, value):
    extra = _command_args(command, tmp_path)
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


@pytest.mark.parametrize("command", ["segment-and-get-coords", "detect-tissue", "process", "finetune-sam2"])
def test_default_device_without_cuda_stops_naming_device_cpu(tmp_path, monkeypatch, capsys, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    args = [command, str(tmp_path), "--output", str(tmp_path / "o"), *map(str, _command_args(command, tmp_path))]
    result = invoke_cli(CLI_PACKAGES[1], args)
    assert result.exit_code != 0 and "--device cpu" in result.output, result.output
    assert not (tmp_path / "o" / "patches").exists() and not (tmp_path / "o" / "visualization").exists()
    if command == "finetune-sam2":
        assert not (tmp_path / "o").exists()
    # the console entry point too: a non-zero exit, never a run on the CPU
    from atlaspatch_tpu_torch import cli as cli_mod

    with pytest.raises(SystemExit) as stop:
        cli_mod.main(args)
    assert stop.value.code != 0 and "--device cpu" in capsys.readouterr().err


def test_multi_gpu_flags_are_refused_with_more_than_one_card(tmp_path, monkeypatch):
    """Named when the multi-GPU flags were refused with more than one card:
    now each builds a mesh of every visible card (segmentation data-parallel
    over both; embedding data-parallel (2, 1) or tensor-parallel (1, 2)),
    recorded where the services take it, before any slide; tensor-parallel
    int8 (named when it was refused) builds the tensor-parallel mesh too."""
    from atlaspatch_tpu_torch.models import encoders
    from atlaspatch_tpu_torch.services import segmentation

    class Built(Exception):
        pass

    seen = {}

    def seg_service(self, cfg, sam2_cfg=None, *, mesh=None, **_kw):
        seen["seg"] = mesh
        raise Built

    def registry(**kw):
        seen["features"] = (kw["mesh"], kw["tensor_parallel"])
        raise Built

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(segmentation.SAM2SegmentationService, "__init__", seg_service)
    monkeypatch.setattr(encoders, "build_default_registry", registry)
    base = [tmp_path, "--output", tmp_path / "o", "--patch-size", "64", "--target-mag", "20"]
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    for args, key, want in (
            (["segment-and-get-coords", *base, "--seg-data-parallel"], "seg", ([[cards[0]], [cards[1]]], None)),
            (["process", *base, *_FEATURE_ARGS[2:], "--feature-parallel", "data"], "features",
             ([[cards[0]], [cards[1]]], False)),
            (["process", *base, *_FEATURE_ARGS[2:], "--feature-parallel", "tensor"], "features", ([cards], True))):
        seen.clear()
        result = invoke_cli(CLI_PACKAGES[1], args)
        assert isinstance(result.exception, Built), result.output
        mesh = seen[key][0] if key == "features" else seen[key]
        assert mesh.grid == want[0], mesh
        if key == "features":
            assert seen[key][1] is want[1]
    # named when tensor-parallel int8 was refused: it builds the same tensor-parallel mesh
    seen.clear()
    result = invoke_cli(CLI_PACKAGES[1], ["process", *base, *_FEATURE_ARGS[2:], "--feature-parallel", "tensor",
                                          "--feature-precision", "int8"])
    assert isinstance(result.exception, Built), result.output
    assert seen["features"][0].grid == [cards] and seen["features"][1] is True


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
