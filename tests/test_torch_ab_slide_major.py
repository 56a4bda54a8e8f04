"""The port's slide-major A/B tool (``atlaspatch_tpu_torch/tools/ab_slide_major.py``) on the CPU.

With ``AB_DEVICE=cpu``, 2 slides, 1 pass pair and two small zoo extractors
(resnet18, dinov2_small; random weights) the tool builds its corpus, runs
``embed_all`` extractor-major and slide-major, and reports each pass's
wall time and ``patch_read`` share; the features the two modes write are
equal (max-abs 0). It refuses a TPU, a missing card and a single
extractor before any work. The tool runs on the card by hand (PERF.md).
"""

from __future__ import annotations

import re

import pytest

from atlaspatch_tpu_torch.tools import ab_slide_major as AB
from torch_port_helpers import free_tmp_path  # noqa: F401

SMALL = {"AB_DEVICE": "cpu", "AB_SLIDES": "2", "AB_PASSES": "1", "AB_EXTRACTORS": "resnet18,dinov2_small"}


@pytest.fixture(scope="module")
def ab_run():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in {**SMALL, "ATLASPATCH_ALLOW_RANDOM_WEIGHTS": "1", "ATLASPATCH_PROFILE": "1",
                     "ATLASPATCH_SLIDE_MAJOR": "1"}.items():
            mp.setenv(k, v)
        capture = []
        mp.setattr(AB, "log", capture.append)
        yield AB.main(), capture


def test_both_modes_run_and_report_wall_and_patch_read_share(ab_run):
    result, lines = ab_run
    assert [m for m, _, _ in result["passes"]] == ["extractor", "slide"]
    assert result["patches"] > 0 and result["extractors"] == ["resnet18", "dinov2_small"]
    for mode in ("extractor", "slide"):
        (line,) = [ln for ln in lines if ln.startswith(f"pass 0 {mode}")]
        assert re.search(r"\d+\.\d+s wall .* patch_read +\d+\.\d+s \( *\d+\.\d% of the wall\)", line), line
        (median,) = [ln for ln in lines if ln.startswith(f"{mode:9s}: wall median")]
        assert "% of the median wall" in median
    assert any(ln.startswith("slide-major speedup (median wall): ") for ln in lines)
    for _, wall, read in result["passes"]:
        assert wall > 0 and 0 < read < wall


def test_the_two_modes_write_the_same_features(ab_run):
    result, lines = ab_run
    assert result["feature_max_abs"] == 0.0
    assert lines[-1].endswith("features of the two modes: max-abs 0")


@pytest.mark.parametrize("env,match", [
    ({"AB_DEVICE": "tpu"}, "runs on cuda or cpu, not elsewhere"),
    ({"AB_DEVICE": "cpu", "AB_EXTRACTORS": "resnet18"}, "needs >= 2 names"),
])
def test_refusals_before_any_work(monkeypatch, env, match):
    built = []
    monkeypatch.setattr(AB, "build_corpus", lambda *a: built.append(a))
    for k, v in {**SMALL, **env}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        AB.main()
    assert not built


def test_cuda_without_a_card_is_refused(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in {**SMALL, "AB_DEVICE": "cuda"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="no CUDA card is visible; set AB_DEVICE=cpu"):
        AB.settings()
