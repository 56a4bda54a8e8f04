"""Slice 7 as a whole: real slide files → the port's readers → runner → H5
→ ``process``, against the JAX package, on the CPU.

* Mixed cohort: tests/test_mixed_cohort.py's directory holding every
  container the readers open (tiled-JPEG SVS, NDPI in both layouts, SCN,
  MIRAX, VMS, VMU, DICOM, BIF, Philips, OME, palette TIFF, Trestle, PNG)
  goes through both packages' runners with the thresholding fake
  segmentation of tests/test_torch_runner.py. Every slide must succeed in
  both, and each slide's H5 must be byte-identical in every dataset with
  every attr equal but ``creation_date`` (tolerance: none).
* SAM2 on real thumbnails: each package's SAM2SegmentationService
  (miniature config, float32, the same weights through one ``.npz``) runs
  inside its runner over a JPEG SVS, a MIRAX and a DICOM slide; the port's
  trunk attention runs its plain version on the CPU. Masks must be
  bit-identical except where the logit lies within 1e-4 of the threshold
  (at most 3 pixels in all), and slides with equal masks give identical H5s.
* ``process``: both runners then ``embed_all`` over the JPEG SVS with a
  tiny vit_b_16 from one ``.npz``; the patches are read by each package's
  native reader. Coordinates byte-identical, float32 features within 1e-4.
"""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest
import torch

from atlaspatch_tpu.io.synthetic_wsi import make_tissue_canvas
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.models.sam2.model import pil_nearest_index, thumbs_to_logits
from test_torch_process_slice import _h5 as features_view
from test_torch_process_slice import _pkg as process_pkg
from test_torch_process_slice import _registry, _tiny_vit_entry
from test_torch_runner import PACKAGES, _assert_same_h5_files, _cfg, _outcome, _run_both, _runner
from tests.container_builders import write_dicom_level, write_mirax
from tests.test_mixed_cohort import _build_cohort
from tests.tiff_builder import write_pyramid
from torch_port_helpers import CFG, JAX_CFG, assert_creation_dates_utc, h5_view, shared_vit_params

NEAR = 1e-4
TOL = 1e-4
REAL = ("svs.svs", "mrx.mrxs", "dcm.dcm")


def _mod(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cohort")
    stems = _build_cohort(tmp)
    got = _run_both(tmp, tmp / "slides", patch_size=64)
    return {"stems": stems, "got": got}


def test_mixed_cohort_runs_in_both_packages(cohort):
    (jax_outcome, _), (port_outcome, _) = (cohort["got"][p] for p in PACKAGES)
    assert port_outcome == jax_outcome
    assert port_outcome["failures"] == []
    assert sorted(stem for stem, _ in port_outcome["results"]) == sorted(cohort["stems"])
    assert all(n > 0 for _, n in port_outcome["results"])


@pytest.mark.parametrize("stem", ["a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l.ome", "m", "n"])
def test_mixed_cohort_h5_matches_jax(cohort, stem):
    (_, jax_out), (_, port_out) = (cohort["got"][p] for p in PACKAGES)
    jax_h5, port_h5 = (out / "patches" / f"{stem}.h5" for out in (jax_out, port_out))
    assert h5_view(port_h5) == h5_view(jax_h5)
    assert_creation_dates_utc(jax_h5, port_h5)


def test_mixed_cohort_files_are_complete(cohort):
    (_, jax_out), (_, port_out) = (cohort["got"][p] for p in PACKAGES)
    assert _assert_same_h5_files(jax_out, port_out) == len(cohort["stems"])


@pytest.fixture(scope="module")
def real_slides(tmp_path_factory):
    """A 3-level JPEG SVS, a 2-level MIRAX and a DICOM slide at 20x."""
    sdir = tmp_path_factory.mktemp("real") / "slides"
    sdir.mkdir()
    write_pyramid(sdir / "svs.svs", make_tissue_canvas(2048, 1536, seed=31, n_blobs=3), levels=3, tile=256,
                  compression=7, description="Aperio Image Library\r\n2048x1536 | AppMag = 20 | MPP = 0.5")
    write_mirax(sdir / "mrx.mrxs", make_tissue_canvas(1024, 768, seed=32, n_blobs=2), tile_w=256, tile_h=192,
                n_levels=2, mpp=0.5, objective=20)
    write_dicom_level(sdir / "dcm.dcm", make_tissue_canvas(1024, 768, seed=33, n_blobs=2), tile=256, mpp=0.5,
                      objective=20.0)
    return sdir


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
def sam2_run(real_slides, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sam2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
        mp.setenv("HF_HOME", str(tmp / "empty-hf"))
        for var in ("ATLASPATCH_SAM2_CHECKPOINT", "ATLASPATCH_WEIGHTS_DIR", "ATLASPATCH_HOST_RESIZE"):
            mp.delenv(var, raising=False)
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
            p = _mod(pkg, "core.config")
            cfg = p.AppConfig(
                processing=p.ProcessingConfig(input_path=real_slides),
                segmentation=p.SegmentationConfig(device="cpu", batch_size=2),
                extraction=p.ExtractionConfig(patch_size=64, target_magnification=20),
                output=p.OutputConfig(output_root=tmp / f"out-{pkg}"),
                device="cpu",
            )
            masks: dict = {}
            runner = _mod(pkg, "orchestration.runner").ProcessingRunner(
                config=cfg, segmentation=seg, extractor=_recording_extractor(pkg, cfg, masks), visualizer=None,
                mpp_resolver=_NullResolver(), wsi_loader=_mod(pkg, "services.wsi_loader").DefaultWSILoader(),
            )
            results, failures = runner.run()
            out[pkg] = {"masks": masks, "outcome": _outcome(results, failures, tmp / f"out-{pkg}"),
                        "root": tmp / f"out-{pkg}"}

    # the port's logits at mask resolution over its own decoded thumbnails
    pred = port_seg.predictor
    loader = _mod(PACKAGES[1], "services.wsi_loader").DefaultWSILoader()
    Slide = _mod(PACKAGES[1], "core.models").Slide
    near = {}
    for path in (real_slides / name for name in REAL):
        wsi = loader.open(Slide(path=path))
        arr = pred._normalize_input(port_seg.prepare_thumbnails([wsi])[0])
        h, w = arr.shape[:2]
        logits = thumbs_to_logits(pred.model, torch.from_numpy(arr)[None])[0].numpy()
        logits = logits[pil_nearest_index(h, pred.input_size)][:, pil_nearest_index(w, pred.input_size)]
        near[path.stem] = np.abs(logits - port_seg.cfg.mask_threshold) < NEAR
        wsi.cleanup()
    return {"out": out, "near": near}


def test_sam2_runners_process_every_real_slide(sam2_run):
    want, got = (sam2_run["out"][p]["outcome"] for p in PACKAGES)
    assert got["failures"] == [] and want["failures"] == []
    assert sorted(s for s, _ in got["results"]) == ["dcm", "mrx", "svs"]
    assert got["files"] == want["files"] == ["dcm.h5", "mrx.h5", "svs.h5"]


def test_sam2_masks_match_outside_the_threshold(sam2_run):
    n_near = 0
    for stem, near in sam2_run["near"].items():
        want, got = (sam2_run["out"][p]["masks"][stem] for p in PACKAGES)
        assert got.shape == want.shape == near.shape and got.dtype == want.dtype
        assert not ((got != want) & ~near).any(), stem
        n_near += int(near.sum())
    assert n_near <= 3, n_near


def test_sam2_slides_with_equal_masks_have_identical_files(sam2_run):
    same = 0
    for stem in sam2_run["near"]:
        masks = [sam2_run["out"][p]["masks"][stem] for p in PACKAGES]
        if not np.array_equal(*masks):
            continue
        same += 1
        jax_h5, port_h5 = (sam2_run["out"][p]["root"] / "patches" / f"{stem}.h5" for p in PACKAGES)
        assert h5_view(port_h5) == h5_view(jax_h5), stem
    assert same >= 1


@pytest.fixture(scope="module")
def process_run(real_slides, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("process-real")
    sdir = tmp / "slides"
    sdir.mkdir()
    (sdir / "svs.svs").symlink_to(real_slides / "svs.svs")
    (tmp / "mpp.csv").write_text("wsi,mpp\nsvs.svs,0.5\n")
    weights = tmp / "weights"
    weights.mkdir()
    np.savez(weights / "vit_b_16.npz", **_flatten(shared_vit_params(_tiny_vit_entry(process_pkg(PACKAGES[0])).spec,
                                                                      seed=5)))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ATLASPATCH_WEIGHTS_DIR", str(weights))
        mp.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
        for name in PACKAGES:
            pkg = process_pkg(name)
            feat_cfg = pkg.config.FeatureExtractionConfig(extractors=["vit_b_16"], batch_size=16, device="cpu",
                                                          precision="float32")
            cfg = _cfg(pkg, sdir, tmp / name, features=feat_cfg, patch_size=64)
            results, failures = _runner(pkg, cfg).run()
            assert failures == []
            svc = pkg.embedding.PatchFeatureEmbeddingService(cfg.extraction, cfg.output, feat_cfg,
                                                             registry=_registry(pkg))
            fails = svc.embed_all(results, wsi_loader=pkg.loader.DefaultWSILoader())
            assert fails == []
            out[name] = features_view(results[0].h5_path)
    return out


def test_process_on_a_real_tiff_matches_jax(process_run):
    want, got = (process_run[p] for p in PACKAGES)
    assert got[0] == want[0]  # coordinates and passports, byte for byte
    assert got[1] == want[1]  # every attr but creation_date
    (wv, wattrs), (gv, gattrs) = want[2]["vit_b_16"], got[2]["vit_b_16"]
    assert gattrs == wattrs and gv.shape == wv.shape and gv.shape[0] > 100
    assert np.abs(gv - wv).max() <= TOL
