"""The port's mask scoring (atlaspatch_tpu_torch/utils/maskeval.py and the
``evaluate-masks`` command) against the JAX package's, on the same files.

Rows, summaries, stdout lines and the CSV's bytes must be equal, not close:
both are the same host numpy and Pillow code on the same PNGs.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from atlaspatch_tpu.utils import maskeval as jax_maskeval
from atlaspatch_tpu_torch.utils import maskeval
from torch_port_helpers import CLI_PACKAGES, invoke_cli, stdout_lines


def _save(path: Path, arr: np.ndarray) -> None:
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def _blobby(rng, shape) -> np.ndarray:
    """A random mask with structure: thresholded smoothed noise."""
    noise = rng.random((shape[0] // 4 + 1, shape[1] // 4 + 1))
    up = np.kron(noise, np.ones((4, 4)))[: shape[0], : shape[1]]
    return up > 0.5


@pytest.fixture(scope="module")
def mask_dirs(tmp_path_factory):
    """Predictions and truths with every naming rule of score_mask_dirs: the
    detect-tissue _mask_bw.png beside an overlay twin and a grid rendering,
    truths named <stem>.png or <stem>_mask.png at another scale, an empty
    pair, a prediction with no truth, and a non-image file."""
    root = tmp_path_factory.mktemp("maskeval")
    pred, truth = root / "pred", root / "truth"
    pred.mkdir()
    truth.mkdir()
    rng = np.random.default_rng(7)
    for i in range(6):
        shape = (40 + 4 * i, 52 + 4 * i)
        p = _blobby(rng, shape)
        t = p.copy() if i == 0 else _blobby(rng, shape)
        _save(pred / f"slide{i}_mask_bw.png", p)
        _save(pred / f"slide{i}_mask.png", np.ones_like(p))  # overlay stand-in
        _save(pred / f"slide{i}.png", ~p)  # grid rendering stand-in
        if i % 2:
            _save(truth / f"slide{i}.png", np.kron(t, np.ones((2, 2), bool)))
        else:
            _save(truth / f"slide{i}_mask.png", t)
    _save(pred / "empty_mask_bw.png", np.zeros((16, 16), bool))
    _save(truth / "empty_mask.png", np.zeros((16, 16), bool))
    _save(pred / "orphan_mask_bw.png", np.ones((8, 8), bool))
    (pred / "notes.txt").write_text("not a mask")
    return pred, truth


@pytest.mark.parametrize("seed", range(4))
def test_binary_mask_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _blobby(rng, (33, 47)), _blobby(rng, (33, 47))
    for pred, truth in ((a, b), (a, a), (a, np.zeros_like(a)), (np.zeros_like(a), a),
                        (np.zeros_like(a), np.zeros_like(a))):
        assert maskeval.binary_mask_metrics(pred, truth) == jax_maskeval.binary_mask_metrics(pred, truth)
    with pytest.raises(ValueError, match="shape mismatch"):
        maskeval.binary_mask_metrics(a, a[:-1])


@pytest.mark.parametrize("threshold", [0, 127, 254])
def test_score_mask_dirs_equal_jax(mask_dirs, threshold, caplog):
    pred, truth = mask_dirs
    with caplog.at_level(logging.WARNING):
        got = maskeval.score_mask_dirs(pred, truth, threshold=threshold)
    want = jax_maskeval.score_mask_dirs(pred, truth, threshold=threshold)
    assert got == want
    rows, summary = got
    assert [r["slide"] for r in rows] == ["empty", *(f"slide{i}" for i in range(6))]
    assert summary["n"] == 7 and rows[1]["iou"] == 1.0
    warned = [r.getMessage() for r in caplog.records if r.name == "atlaspatch_tpu_torch.utils.maskeval"]
    assert len(warned) == 1 and "1/8 prediction(s)" in warned[0] and "orphan" in warned[0]


def test_score_mask_dirs_refuses_no_pairs_as_jax(mask_dirs, tmp_path):
    pred, _ = mask_dirs
    for module in (maskeval, jax_maskeval):
        with pytest.raises(FileNotFoundError, match="no stem-matched"):
            module.score_mask_dirs(pred, tmp_path / "nowhere")


def test_evaluate_masks_cli_prints_the_jax_lines_and_csv(mask_dirs, tmp_path):
    pred, truth = mask_dirs
    outputs = {}
    for pkg in CLI_PACKAGES:
        out = tmp_path / pkg
        out.mkdir()
        result = invoke_cli(pkg, ["evaluate-masks", pred, "--truth", truth, "--csv", out / "m.csv"],
                            catch_exceptions=False)
        assert result.exit_code == 0, result.output
        outputs[pkg] = (stdout_lines(result, out), (out / "m.csv").read_bytes())
    (jax_lines, jax_csv), (port_lines, port_csv) = (outputs[p] for p in CLI_PACKAGES)
    assert port_lines == jax_lines
    assert port_csv == jax_csv
    assert port_lines[-1] == "CSV: <out>/m.csv" and port_lines[-2].startswith("Mean over 7 slide(s): ")
    assert port_csv.decode().count("\n") == 8  # header + 7 rows


def test_evaluate_masks_cli_refusals_match_jax(mask_dirs, tmp_path):
    pred, truth = mask_dirs
    for args in (["--threshold", "256"], ["--truth", tmp_path / "missing"]):
        codes = [invoke_cli(pkg, ["evaluate-masks", pred, *(["--truth", truth] if "--truth" not in args else []),
                                  *args]).exit_code for pkg in CLI_PACKAGES]
        assert codes == [2, 2], (args, codes)
