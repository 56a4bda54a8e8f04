"""``detect-tissue`` in the port (atlaspatch_tpu_torch/cli.py) against the JAX
package's, and the per-slide thumbnail fault isolation under it
(``SAM2SegmentationService.prepare_thumbnails_safe``).

One module fixture runs ``detect-tissue --device cpu --seg-batch-size 3``
through each CLI over three PNG slides in one batch, with the miniature SAM2
and one shared weight archive; the third slide has no MPP, which a plain
image needs to be opened. The mask each run renders is recorded:

  * the same ``Created 2 mask overlay(s), failures: 1`` line, the same [OK]
    lines (any order) and the same [FAIL] line for the poisoned slide, which
    gets no PNG in either package;
  * masks within slice 1's bar (at most 3 pixels differ in all, one slide at
    least agreeing bit for bit); where they agree, ``_mask.png`` and
    ``_mask_bw.png`` pixel-equal.

``prepare_thumbnails_safe`` against the JAX one on a mixed batch, in both
segmentation precisions: the same exception types and messages in the same
places, and thumbnails byte-equal. It is host work that reads only the
service's config and thumbnail pool, so both services are made without their
SAM2 predictor there.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest

from torch_port_helpers import (
    CLI_PACKAGES,
    invoke_cli,
    png_array,
    shared_cli_weights,
    stdout_lines,
    write_png_slides,
)

MAX_MASK_DIFF = 3  # pixels, in all (slice 1's bar)
GOOD = ("s0", "s1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("detect")
    slides, csv = write_png_slides(tmp, {"s0": 0, "s1": 1, "s2_bad": 9}, {"s0": 0.5, "s1": 0.5})
    record = {pkg: {"masks": {}} for pkg in CLI_PACKAGES}
    with pytest.MonkeyPatch.context() as mp:
        shared_cli_weights(mp, tmp)
        for pkg in CLI_PACKAGES:
            vis = importlib.import_module(f"{pkg}.utils.visualization")

            def render(*, mask, wsi, _orig=vis.visualize_mask_on_thumbnail, _rec=record[pkg], **kw):
                _rec["masks"][Path(wsi.path).stem] = np.array(mask, copy=True)
                return _orig(mask=mask, wsi=wsi, **kw)

            mp.setattr(vis, "visualize_mask_on_thumbnail", render)
        for pkg in CLI_PACKAGES:
            out = tmp / f"out-{pkg}"
            result = invoke_cli(pkg, ["detect-tissue", slides, "--output", out, "--device", "cpu",
                                      "--seg-batch-size", "3", "--mpp-csv", csv, "--verbose"],
                                catch_exceptions=False)
            record[pkg].update(out=out, result=result)
    return record


def _agreeing(runs) -> list[str]:
    masks = [runs[pkg]["masks"] for pkg in CLI_PACKAGES]
    return [s for s in GOOD if np.array_equal(masks[0][s], masks[1][s])]


def test_detect_tissue_prints_the_same_lines(runs):
    jax_run, port_run = (runs[pkg] for pkg in CLI_PACKAGES)
    assert jax_run["result"].exit_code == port_run["result"].exit_code == 0, port_run["result"].output
    want = sorted(stdout_lines(jax_run["result"], jax_run["out"]))
    assert "Created 2 mask overlay(s), failures: 1" in want
    assert sorted(stdout_lines(port_run["result"], port_run["out"])) == want


def test_poisoned_slide_fails_alone_in_both(runs):
    fails = []
    for pkg in CLI_PACKAGES:
        run = runs[pkg]
        lines = [ln for ln in run["result"].stderr.splitlines() if ln.startswith("[FAIL]")]
        assert len(lines) == 1 and lines[0].startswith("[FAIL] s2_bad.png: "), lines
        fails.append(lines[0])
        vis = run["out"] / "visualization"
        assert sorted(p.name for p in vis.iterdir()) == sorted(
            f"{s}{suffix}" for s in GOOD for suffix in ("_mask.png", "_mask_bw.png"))
        assert set(run["masks"]) == set(GOOD)
    assert fails[0] == fails[1]


def test_masks_meet_slice_one_bar(runs):
    masks = [runs[pkg]["masks"] for pkg in CLI_PACKAGES]
    assert sum(int((masks[0][s] != masks[1][s]).sum()) for s in GOOD) <= MAX_MASK_DIFF
    assert _agreeing(runs), "no slide's masks agree bit for bit"


@pytest.mark.parametrize("suffix", ["_mask.png", "_mask_bw.png"])
def test_overlays_identical_where_masks_agree(runs, suffix):
    for stem in _agreeing(runs):
        want, got = (png_array(runs[pkg]["out"] / "visualization" / f"{stem}{suffix}") for pkg in CLI_PACKAGES)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _outcome(item):
    if isinstance(item, Exception):
        return ("raised", type(item).__name__, str(item))
    return ("thumb", item.mode, item.size, np.asarray(item).tobytes())


def _host_only_service(pkg, precision):
    """``pkg``'s SAM2SegmentationService with its config and thumbnail pool
    but no predictor (building the JAX one compiles the model)."""
    cls = importlib.import_module(f"{pkg}.services.segmentation").SAM2SegmentationService
    svc = cls.__new__(cls)
    svc.cfg = importlib.import_module(f"{pkg}.core.config").SegmentationConfig(
        device="cpu", precision=precision).validated()
    svc._thumb_pool_obj = None
    return svc


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_prepare_thumbnails_safe_matches_jax(tmp_path, precision):
    """A batch of a PNG slide, a synthetic pyramid without an MPP (no
    magnification to pick the thumbnail level by) and one with it: the middle
    one raises in both, the others give byte-equal thumbnails."""
    slides, _csv = write_png_slides(tmp_path, {"a": 3}, {})
    got = {}
    for pkg in CLI_PACKAGES:
        models = importlib.import_module(f"{pkg}.core.models")
        loader = importlib.import_module(f"{pkg}.services.wsi_loader").DefaultWSILoader()
        synthetic = importlib.import_module(f"{pkg}.io.synthetic_wsi").SyntheticWSI
        seg = _host_only_service(pkg, precision)
        wsis = [loader.open(models.Slide(path=slides / "a.png", mpp=0.5)),
                synthetic(path="/virtual/nompp.svs", mpp=None, size=(3072, 2048), seed=4),
                synthetic(path="/virtual/syn.svs", mpp=0.5, size=(3072, 2048), seed=5)]
        try:
            got[pkg] = [_outcome(item) for item in seg.prepare_thumbnails_safe(wsis)]
        finally:
            seg._thumb_pool_obj.shutdown(wait=True)
            for w in wsis:
                w.cleanup()
    want = got[CLI_PACKAGES[0]]
    assert [o[0] for o in want] == ["thumb", "raised", "thumb"]
    assert got[CLI_PACKAGES[1]] == want
