"""The whole ``process`` slice in both packages, on the CPU: each package's
runner (segment → coordinates → H5) and then its ``embed_all`` (patch pixels →
the zoo's engine → ``features/<name>`` appended to the H5), as
``atlaspatch_tpu/cli.py:313-347`` composes them.

Both run on the same PNG slides with the same fake segmentation
(tests/test_torch_runner.py) and the same encoder: vit_b_16's zoo entry cut to
a tiny spec (32 wide), loading one ``.npz`` of Flax params through each package's
``build_extractor``. Coordinates and passports must be byte-identical, every
attr equal but ``creation_date``, the feature sets equal, and the features
within max-abs 1e-4 (float32). A second configuration asking for one more
encoder reuses the coordinates and embeds only what is missing, in both.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import h5py
import numpy as np
import pytest

from atlaspatch_tpu.tools.convert_weights import _flatten
from test_torch_runner import PACKAGES, _cfg, _runner, _slides
from test_torch_runner import _pkg as runner_pkg
from tests.test_slide_major_embedding import ToyEncoder
from torch_port_helpers import assert_creation_dates_utc, shared_vit_params

TOL = 1e-4


def _pkg(name: str) -> SimpleNamespace:
    """test_torch_runner's modules of one package, and the embedding ones."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        **vars(runner_pkg(name)), name=name, embedding=mod("services.feature_embedding"),
        registry=mod("models.encoders.registry"), zoo=mod("models.encoders.zoo"),
    )


def _tiny_vit_entry(pkg):
    entry = pkg.zoo.ENTRIES["vit_b_16"]
    return dataclasses.replace(
        entry,
        embedding_dim=32,
        spec=dataclasses.replace(entry.spec, img_size=32, patch_size=8, dim=32, depth=2, heads=4),
        preprocess=dataclasses.replace(entry.preprocess, crop=32, resize=36),
    )


def _registry(pkg, *, toy=False):
    import jax

    device = jax.devices("cpu")[0] if pkg.name == PACKAGES[0] else "cpu"
    reg = pkg.registry.PatchFeatureExtractorRegistry()
    reg.register("vit_b_16", lambda: pkg.zoo.build_extractor(_tiny_vit_entry(pkg), device=device))
    if toy:
        reg.register("toy", ToyEncoder)
    return reg


def _h5(path):
    """(datasets but features, file attrs but creation_date, {feature: (values, attrs)})."""
    with h5py.File(path, "r") as f:
        data = {k: (f[k].dtype, f[k].shape, f[k][()].tobytes()) for k in f if k != "features"}
        attrs = {k: (type(v), v) for k, v in f.attrs.items() if k != "creation_date"}
        feats = {k: (ds[()], dict(ds.attrs)) for k, ds in f["features"].items()} if "features" in f else {}
    return data, attrs, feats


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("process")
    slide_dir = _slides(tmp, n=3)
    weights = tmp / "weights"
    weights.mkdir()
    spec = _tiny_vit_entry(_pkg(PACKAGES[0])).spec
    np.savez(weights / "vit_b_16.npz", **_flatten(shared_vit_params(spec, seed=3)))
    mp = pytest.MonkeyPatch()
    mp.setenv("ATLASPATCH_WEIGHTS_DIR", str(weights))
    mp.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
    out = {}
    try:
        for name in PACKAGES:
            pkg = _pkg(name)
            feat_cfg = pkg.config.FeatureExtractionConfig(
                extractors=["vit_b_16"], batch_size=8, device="cpu", precision="float32")
            cfg = _cfg(pkg, slide_dir, tmp / name, features=feat_cfg)
            results, failures = _runner(pkg, cfg).run()
            assert failures == []
            svc = pkg.embedding.PatchFeatureEmbeddingService(
                cfg.extraction, cfg.output, feat_cfg, registry=_registry(pkg))
            fails = svc.embed_all(results, wsi_loader=pkg.loader.DefaultWSILoader())
            results = sorted(results, key=lambda r: r.slide.stem)
            first = {r.slide.stem: _h5(r.h5_path) for r in results}

            # a second configuration: one more encoder; the coordinates are reused
            feat_cfg2 = pkg.config.FeatureExtractionConfig(
                extractors=["vit_b_16", "toy"], batch_size=8, device="cpu", precision="float32")
            cfg2 = _cfg(pkg, slide_dir, tmp / name, features=feat_cfg2)
            runner2 = _runner(pkg, cfg2)
            runner2.segmentation.segment_batch = runner2.segmentation.segment_thumbnail = None
            results2, failures2 = runner2.run()
            assert failures2 == []
            svc2 = pkg.embedding.PatchFeatureEmbeddingService(
                cfg2.extraction, cfg2.output, feat_cfg2, registry=_registry(pkg, toy=True))
            fails2 = svc2.embed_all(results2, wsi_loader=pkg.loader.DefaultWSILoader())
            results2 = sorted(results2, key=lambda r: r.slide.stem)
            out[name] = dict(results=results, fails=fails, first=first, results2=results2,
                             fails2=fails2, second={r.slide.stem: _h5(r.h5_path) for r in results2})
    finally:
        mp.undo()
    return out


def test_both_packages_embed_every_slide(run):
    for name in PACKAGES:
        got = run[name]
        assert got["fails"] == [] and len(got["results"]) == 3
        for res in got["results"]:
            assert res.num_patches > 0
            assert res.metadata["feature_sets"] == ["vit_b_16"]
            values, attrs = got["first"][res.slide.stem][2]["vit_b_16"]
            assert values.shape == (res.num_patches, 32) and values.dtype == np.float32
            assert attrs == {"name": "vit_b_16", "embedding_dim": 32}
    assert [r.metadata for r in run[PACKAGES[0]]["results"]] == [r.metadata for r in run[PACKAGES[1]]["results"]]


def test_coords_and_attrs_are_identical(run):
    jax_first, port_first = run[PACKAGES[0]]["first"], run[PACKAGES[1]]["first"]
    assert jax_first.keys() == port_first.keys()
    for stem in jax_first:
        assert port_first[stem][0] == jax_first[stem][0], stem  # coords, passports: byte for byte
        assert port_first[stem][1] == jax_first[stem][1], stem  # every attr but creation_date
    assert_creation_dates_utc(*(r.h5_path for name in PACKAGES for r in run[name]["results"]))


def test_features_agree_with_the_jax_package(run):
    jax_first, port_first = run[PACKAGES[0]]["first"], run[PACKAGES[1]]["first"]
    for stem in jax_first:
        want, wattrs = jax_first[stem][2]["vit_b_16"]
        got, gattrs = port_first[stem][2]["vit_b_16"]
        assert gattrs == wattrs
        assert np.abs(got - want).max() <= TOL, stem


def test_missing_features_reuse_the_coordinates_in_both(run):
    for name in PACKAGES:
        got = run[name]
        assert got["fails2"] == []
        assert [r.slide.stem for r in got["results2"]] == [r.slide.stem for r in got["results"]]
        for res in got["results2"]:
            stem = res.slide.stem
            before, after = got["first"][stem], got["second"][stem]
            assert res.metadata["feature_sets"] == ["toy", "vit_b_16"]
            assert after[0] == before[0] and after[1] == before[1]  # coordinates reused
            assert after[2]["vit_b_16"][0].tobytes() == before[2]["vit_b_16"][0].tobytes()
            assert after[2]["toy"][0].shape == (res.num_patches, 8)
    jax_second, port_second = run[PACKAGES[0]]["second"], run[PACKAGES[1]]["second"]
    for stem in jax_second:
        assert port_second[stem][2]["toy"][0].tobytes() == jax_second[stem][2]["toy"][0].tobytes()
