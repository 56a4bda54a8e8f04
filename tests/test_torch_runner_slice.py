"""Slice 5 as a whole: synthetic slides → runner → SAM2 masks → H5 files.

Each package's SAM2SegmentationService (miniature config, float32, CPU, the
same weights through the JAX package's ``.npz`` archive format) runs inside
its own ProcessingRunner over the same three synthetic slides. The masks each
runner hands to extraction are recorded:

  * masks meet slice 1's bar: bit-identical except at pixels whose logit lies
    within 1e-4 of the threshold (counted, at most 3 in all);
  * each slide's H5 equals the H5 that the OTHER package's extraction writes
    from the same mask (datasets byte-identical; attrs equal in value and
    read-back type except ``creation_date``, ISO-8601 UTC in both);
  * slides whose masks agree bit for bit have identical H5 files from the two
    runners, and at least one slide does.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.models.sam2.model import pil_nearest_index, thumbs_to_logits
from atlaspatch_tpu_torch.utils.h5 import read_h5
from torch_port_helpers import CFG, JAX_CFG, assert_creation_dates_utc, h5_view

NEAR = 1e-4
SLIDES = {"slide000": ((2048, 1536), 0), "slide001": ((2560, 1792), 1), "slide002": ((3072, 2048), 2)}
PACKAGES = ("atlaspatch_tpu", "atlaspatch_tpu_torch")


def _mod(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}")


def _config(pkg, in_dir, out):
    c = _mod(pkg, "core.config")
    return c.AppConfig(
        processing=c.ProcessingConfig(input_path=in_dir),
        segmentation=c.SegmentationConfig(device="cpu", batch_size=2),
        extraction=c.ExtractionConfig(patch_size=64, target_magnification=20),
        output=c.OutputConfig(output_root=out),
        device="cpu",
    )


def _wsi(pkg, stem):
    size, seed = SLIDES[stem]
    return _mod(pkg, "io.synthetic_wsi").SyntheticWSI(
        path=f"/virtual/{stem}.svs", mpp=0.5, size=size, seed=seed
    )


class _Loader:
    def __init__(self, pkg):
        self.pkg = pkg

    def open(self, slide):
        return _wsi(self.pkg, slide.stem)


class _NullResolver:
    def resolve(self, slide):
        return None


def _recording_extractor(pkg, cfg, masks):
    base = _mod(pkg, "services.extraction").PatchExtractionService

    class Recording(base):
        def extract(self, wsi, mask, *, slide):
            masks[slide.stem] = mask.copy()
            return super().extract(wsi, mask, slide=slide)

    return Recording(cfg.extraction, cfg.output)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner-slice")
    in_dir = tmp / "slides"
    in_dir.mkdir()
    for stem in SLIDES:
        (in_dir / f"{stem}.svs").touch()  # discovery placeholders
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
        mp.setenv("HF_HOME", str(tmp / "empty-hf"))
        mp.delenv("ATLASPATCH_SAM2_CHECKPOINT", raising=False)
        mp.delenv("ATLASPATCH_WEIGHTS_DIR", raising=False)
        mp.delenv("ATLASPATCH_HOST_RESIZE", raising=False)
        jax_seg = _mod(PACKAGES[0], "services.segmentation").SAM2SegmentationService(
            _mod(PACKAGES[0], "core.config").SegmentationConfig(device="cpu"), JAX_CFG
        )
        npz = tmp / "sam2_hiera_tiny.npz"
        np.savez(npz, **_flatten(jax.tree.map(np.asarray, jax_seg.predictor.params)))
        port_seg = _mod(PACKAGES[1], "services.segmentation").SAM2SegmentationService(
            _mod(PACKAGES[1], "core.config").SegmentationConfig(checkpoint_path=npz, device="cpu"), CFG
        )
        out = {}
        for pkg, seg in zip(PACKAGES, (jax_seg, port_seg)):
            cfg = _config(pkg, in_dir, tmp / f"out-{pkg}")
            masks: dict = {}
            runner = _mod(pkg, "orchestration.runner").ProcessingRunner(
                config=cfg, segmentation=seg, extractor=_recording_extractor(pkg, cfg, masks),
                visualizer=None, mpp_resolver=_NullResolver(), wsi_loader=_Loader(pkg),
            )
            results, failures = runner.run()
            out[pkg] = {"cfg": cfg, "masks": masks, "results": results, "failures": failures}

    # the port's logits at mask resolution, to find near-threshold pixels
    pred = port_seg.predictor
    near = {}
    for stem in SLIDES:
        thumb = port_seg.prepare_thumbnails([_wsi(PACKAGES[1], stem)])[0]
        arr = pred._normalize_input(thumb)
        h, w = arr.shape[:2]
        logits = thumbs_to_logits(pred.model, torch.from_numpy(arr)[None])[0].numpy()
        logits = logits[pil_nearest_index(h, pred.input_size)][:, pil_nearest_index(w, pred.input_size)]
        near[stem] = np.abs(logits - port_seg.cfg.mask_threshold) < NEAR
    return {"out": out, "near": near, "tmp": tmp}


def _h5(run, pkg, stem):
    return run["out"][pkg]["cfg"].output.output_root / "patches" / f"{stem}.h5"


def test_both_runners_process_every_slide(run):
    for pkg in PACKAGES:
        got = run["out"][pkg]
        assert got["failures"] == []
        assert sorted(r.slide.stem for r in got["results"]) == sorted(SLIDES)
        assert sorted(got["masks"]) == sorted(SLIDES)
        assert sum(r.num_patches for r in got["results"]) > 0
        patches = got["cfg"].output.output_root / "patches"
        assert sorted(p.name for p in patches.iterdir()) == sorted(f"{s}.h5" for s in SLIDES)


def test_masks_match_outside_the_threshold(run):
    n_near = 0
    for stem in SLIDES:
        got, want = run["out"][PACKAGES[1]]["masks"][stem], run["out"][PACKAGES[0]]["masks"][stem]
        near = run["near"][stem]
        assert got.shape == want.shape == near.shape and got.dtype == want.dtype
        assert not ((got != want) & ~near).any()
        assert 0 < got.mean() < 1
        n_near += int(near.sum())
    assert n_near <= 3, n_near


@pytest.mark.parametrize("writer,other", [(0, 1), (1, 0)])
def test_h5_equals_the_other_packages_extraction_of_the_same_mask(run, writer, other):
    w_pkg, o_pkg = PACKAGES[writer], PACKAGES[other]
    cfg = _config(o_pkg, run["tmp"] / "slides", run["tmp"] / f"redo-{o_pkg}-from-{w_pkg}")
    svc = _mod(o_pkg, "services.extraction").PatchExtractionService(cfg.extraction, cfg.output)
    Slide = _mod(o_pkg, "core.models").Slide
    for stem in SLIDES:
        mask = run["out"][w_pkg]["masks"][stem]
        slide = Slide(path=run["tmp"] / "slides" / f"{stem}.svs")
        res = svc.extract(_wsi(o_pkg, stem), mask, slide=slide)
        ours = _h5(run, w_pkg, stem)
        assert h5_view(res.h5_path) == h5_view(ours), stem
        assert_creation_dates_utc(res.h5_path, ours)


def test_slides_with_equal_masks_have_identical_files(run):
    same = 0
    for stem in SLIDES:
        jax_mask, port_mask = (run["out"][p]["masks"][stem] for p in PACKAGES)
        if not np.array_equal(jax_mask, port_mask):
            continue
        same += 1
        jax_h5, port_h5 = (_h5(run, p, stem) for p in PACKAGES)
        assert h5_view(jax_h5) == h5_view(port_h5), stem
        assert_creation_dates_utc(jax_h5, port_h5)
        datasets, attrs = read_h5(port_h5)
        assert attrs["num_patches"] == datasets["coords"].shape[0]
    assert same >= 1
