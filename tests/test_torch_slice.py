"""Slice 1 as a whole: synthetic slides → tissue masks → patch coordinates.

The JAX package's SAM2SegmentationService (random weights, miniature config,
float32, CPU) and the port's service, loaded with the same weights through
the JAX package's ``.npz`` archive format, segment the same three synthetic
slides. Masks must be bit-identical except at pixels whose logit lies within
1e-4 of the threshold (counted). The coordinates that each package's
PatchExtractionService computes from its own mask must be byte-identical,
with containment run by the port's native scan and again by its numpy
oracle.
"""

import numpy as np
import pytest
import torch

import jax

from atlaspatch_tpu.core.config import ExtractionConfig as JaxExtractionConfig
from atlaspatch_tpu.core.config import OutputConfig as JaxOutputConfig
from atlaspatch_tpu.core.config import SegmentationConfig as JaxSegmentationConfig
from atlaspatch_tpu.io.synthetic_wsi import SyntheticWSI as JaxSyntheticWSI
from atlaspatch_tpu.services.extraction import PatchExtractionService as JaxExtraction
from atlaspatch_tpu.services.segmentation import SAM2SegmentationService as JaxService
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.core.config import ExtractionConfig, SegmentationConfig
from atlaspatch_tpu_torch.io.synthetic_wsi import SyntheticWSI
from atlaspatch_tpu_torch.models.sam2.model import (
    pil_nearest_index,
    segment_step,
    thumbs_to_logits,
)
from atlaspatch_tpu_torch.ops import contours as port_contours
from atlaspatch_tpu_torch.ops.polygon import point_polygon_test_numpy
from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
from torch_port_helpers import CFG, JAX_CFG

NEAR = 1e-4
SLIDES = [((2048, 1536), 0), ((2560, 1792), 1), ((3072, 2048), 2)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
        mp.setenv("HF_HOME", str(tmp / "empty-hf"))
        mp.delenv("ATLASPATCH_SAM2_CHECKPOINT", raising=False)
        mp.delenv("ATLASPATCH_WEIGHTS_DIR", raising=False)
        jax_svc = JaxService(JaxSegmentationConfig(device="cpu"), JAX_CFG)
        npz = tmp / "sam2_hiera_tiny.npz"
        np.savez(npz, **_flatten(jax.tree.map(np.asarray, jax_svc.predictor.params)))
        port_svc = SAM2SegmentationService(
            SegmentationConfig(checkpoint_path=npz, device="cpu"), CFG
        )

    jax_wsis = [JaxSyntheticWSI(size=size, mpp=0.5, seed=seed) for size, seed in SLIDES]
    wsis = [SyntheticWSI(size=size, mpp=0.5, seed=seed) for size, seed in SLIDES]
    jax_masks = [m.data for m in jax_svc.segment_batch(jax_wsis)]
    thumbs = port_svc.prepare_thumbnails(wsis)
    masks = [m.data for m in port_svc.segment_thumbnails(thumbs)]

    # the port's logits at mask resolution, to find near-threshold pixels
    pred = port_svc.predictor
    near = []
    for thumb in thumbs:
        arr = pred._normalize_input(thumb)
        h, w = arr.shape[:2]
        if max(h, w) > pred.input_size:
            arr = pred._resize_input(arr)[0]
        logits = thumbs_to_logits(pred.model, torch.from_numpy(arr)[None])[0].numpy()
        logits = logits[pil_nearest_index(h, pred.input_size)][:, pil_nearest_index(w, pred.input_size)]
        near.append(np.abs(logits - port_svc.cfg.mask_threshold) < NEAR)
    return {"jax_svc": jax_svc, "svc": port_svc, "jax_wsis": jax_wsis, "wsis": wsis,
            "thumbs": thumbs, "jax_masks": jax_masks, "masks": masks, "near": near, "tmp": tmp}


def _host_resize_near(svc, thumb):
    """Near-threshold pixels of the host-resize chain: PIL bilinear to the
    model input, logits, PIL-NEAREST back (the index tables)."""
    pred = svc.predictor
    resized, (h, w) = pred._resize_input(pred._normalize_input(thumb))
    logits = segment_step(pred.model, torch.from_numpy(resized)[None])[0].numpy()
    logits = logits[pil_nearest_index(h, pred.input_size)][:, pil_nearest_index(w, pred.input_size)]
    return np.abs(logits - svc.cfg.mask_threshold) < NEAR


def test_masks_match_outside_the_threshold(run):
    n_near = 0
    for got, want, near in zip(run["masks"], run["jax_masks"], run["near"]):
        assert got.shape == want.shape and got.dtype == want.dtype
        differ = got != want
        assert not (differ & ~near).any()
        assert 0 < got.mean() < 1  # tissue and background both present
        n_near += int(near.sum())
    assert n_near <= 3, n_near


@pytest.mark.parametrize("containment", ["native", "numpy"])
@pytest.mark.parametrize("patch_size,target_mag", [(64, 20), (128, 10)])
def test_coords_byte_identical(run, monkeypatch, containment, patch_size, target_mag):
    if containment == "numpy":
        monkeypatch.setattr(port_contours, "point_polygon_test", point_polygon_test_numpy)
    jax_svc = JaxExtraction(
        JaxExtractionConfig(patch_size=patch_size, target_magnification=target_mag),
        JaxOutputConfig(output_root=run["tmp"] / "out"),
    )
    svc = PatchExtractionService(
        ExtractionConfig(patch_size=patch_size, target_magnification=target_mag)
    )
    total = 0
    for jwsi, wsi, jmask, mask in zip(run["jax_wsis"], run["wsis"], run["jax_masks"], run["masks"]):
        want_geom = jax_svc._prepare_geometry(jwsi)
        geom = svc._prepare_geometry(wsi)
        assert geom == want_geom
        want = jax_svc.compute_coords(
            *jax_svc._prepare_contours(jmask, jwsi), patch_size_src=want_geom[2], step_src=want_geom[3]
        )
        got = svc.compute_coords(
            *svc._prepare_contours(mask, wsi), patch_size_src=geom[2], step_src=geom[3]
        )
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        total += got.shape[0]
    assert total > 0


def test_host_resize_path_matches_jax(run, monkeypatch):
    monkeypatch.setenv("ATLASPATCH_HOST_RESIZE", "1")
    want = run["jax_svc"].segment_thumbnails(run["thumbs"])
    got = run["svc"].segment_thumbnails(run["thumbs"])
    for g, w, thumb in zip(got, want, run["thumbs"]):
        assert g.source_shape == w.source_shape
        near = _host_resize_near(run["svc"], thumb)
        assert not ((g.data != w.data) & ~near).any()
        assert near.sum() <= 3


def test_segment_thumbnail_matches_jax(run):
    want = run["jax_svc"].segment_thumbnail(run["jax_wsis"][0])
    got = run["svc"].segment_thumbnail(run["wsis"][0])
    assert got.source_shape == want.source_shape and got.data.dtype == np.float32
    near = _host_resize_near(run["svc"], run["thumbs"][0])
    assert not ((got.data != want.data) & ~near).any()
