"""The port's ProcessingRunner against the JAX package's, on the CPU.

Both runners process the same PNG slides with the same fake segmentation
(the thumbnail thresholded at < 220, as tests/test_pipeline_e2e.py does) into
separate output roots. Each slide's H5 must be byte-identical in every
dataset, and every attr equal in value and read-back type except
``creation_date``, which must parse as ISO-8601 UTC in both (tolerance:
none). The same files are published, and failures and locks behave the same,
in each scenario of tests/test_pipeline_e2e.py and
tests/test_concurrency_faults.py that runs both packages here; the port's
own refusal of features is tested on the port.
"""

import importlib
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from atlaspatch_tpu.io.synthetic_wsi import make_tissue_canvas
from atlaspatch_tpu_torch.utils.h5 import read_h5
from torch_port_helpers import assert_creation_dates_utc, h5_view

PACKAGES = ("atlaspatch_tpu", "atlaspatch_tpu_torch")


def _pkg(name: str) -> SimpleNamespace:
    """The modules of one package that a runner test needs."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        config=mod("core.config"), models=mod("core.models"), paths=mod("core.paths"),
        runner=mod("orchestration.runner"), extraction=mod("services.extraction"),
        mpp=mod("services.mpp"), loader=mod("services.wsi_loader"),
        image_wsi=mod("io.image_wsi"), storage=mod("services.storage"),
    )


def _fake_segmentation(pkg: SimpleNamespace, delay: float = 0.0, thumb: int = 256):
    Mask = pkg.models.Mask

    class FakeSegmentation:
        """Thresholds the thumbnail itself: non-background pixels are tissue."""

        def segment_thumbnail(self, wsi):
            time.sleep(delay)
            arr = np.asarray(wsi.get_thumb((thumb, thumb)).convert("L"), dtype=np.float32)
            mask = (arr < 220).astype(np.float32)
            return Mask(data=mask, source_shape=mask.shape)

        def segment_batch(self, wsis):
            return [self.segment_thumbnail(w) for w in wsis]

    return FakeSegmentation()


def _slides(tmp_path: Path, n: int = 3, size=(1024, 768), prefix="slide") -> Path:
    sdir = tmp_path / "slides"
    sdir.mkdir()
    for i in range(n):
        Image.fromarray(make_tissue_canvas(*size, seed=i, n_blobs=2)).save(sdir / f"{prefix}{i}.png")
    (tmp_path / "mpp.csv").write_text(
        "wsi,mpp\n" + "\n".join(f"{prefix}{i}.png,0.5" for i in range(n))
    )
    return sdir


def _cfg(pkg, slide_dir: Path, out: Path, *, batch=2, features=None, **extraction_kw):
    c = pkg.config
    kw = dict(patch_size=128, target_magnification=20, tissue_threshold=0.0)
    kw.update(extraction_kw)
    return c.AppConfig(
        processing=c.ProcessingConfig(input_path=slide_dir, mpp_csv=slide_dir.parent / "mpp.csv"),
        segmentation=c.SegmentationConfig(device="cpu", batch_size=batch),
        extraction=c.ExtractionConfig(**kw),
        output=c.OutputConfig(output_root=out),
        features=features,
        device="cpu",
    )


def _runner(pkg, cfg, **seg_kw):
    return pkg.runner.ProcessingRunner(
        config=cfg,
        segmentation=_fake_segmentation(pkg, **seg_kw),
        extractor=pkg.extraction.PatchExtractionService(cfg.extraction, cfg.output),
        visualizer=None,
        mpp_resolver=pkg.mpp.CSVMPPResolver(cfg.processing.mpp_csv),
        wsi_loader=pkg.loader.DefaultWSILoader(),
    )


def _outcome(results, failures, out: Path) -> dict:
    patches = out / "patches"
    return {
        "results": sorted((r.slide.stem, r.num_patches) for r in results),
        "failures": sorted((s.stem, type(e).__name__) for s, e in failures),
        "files": sorted(p.name for p in patches.iterdir()) if patches.exists() else [],
    }


def _run_both(tmp_path, slide_dir, scenario=None, **cfg_kw) -> dict:
    """Run the scenario with each package's runner; {package: (outcome, out)}."""
    got = {}
    for name in PACKAGES:
        pkg = _pkg(name)
        out = tmp_path / f"out-{name}"
        cfg = _cfg(pkg, slide_dir, out, **cfg_kw)
        if scenario is None:
            results, failures = _runner(pkg, cfg).run()
        else:
            results, failures = scenario(pkg, cfg)
        got[name] = (_outcome(results, failures, out), out)
    return got


def _assert_same_h5_files(jax_out: Path, port_out: Path) -> int:
    files = sorted(p.name for p in (jax_out / "patches").glob("*.h5"))
    assert files == sorted(p.name for p in (port_out / "patches").glob("*.h5"))
    for name in files:
        jax_h5, port_h5 = jax_out / "patches" / name, port_out / "patches" / name
        assert h5_view(jax_h5) == h5_view(port_h5), name
        assert_creation_dates_utc(jax_h5, port_h5)
        datasets, _ = read_h5(port_h5)
        assert datasets["coords"].tobytes() == h5_view(port_h5)[0]["coords"][2]
    return len(files)


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_runner_parity_with_jax(tmp_path, batch):
    slide_dir = _slides(tmp_path, n=5)
    got = _run_both(tmp_path, slide_dir, batch=batch)
    (jax_outcome, jax_out), (port_outcome, port_out) = got[PACKAGES[0]], got[PACKAGES[1]]
    assert port_outcome == jax_outcome
    assert port_outcome["failures"] == [] and len(port_outcome["results"]) == 5
    assert all(n > 0 for _, n in port_outcome["results"])
    assert not [f for f in port_outcome["files"] if not f.endswith(".h5")]  # no lock / stage left
    assert _assert_same_h5_files(jax_out, port_out) == 5


def test_runner_parity_slow_mode_and_images(tmp_path):
    """fast_mode off reads every patch and applies the black/white filters;
    save_images also writes the PNGs."""
    slide_dir = _slides(tmp_path, n=2, size=(768, 512))

    def scenario(pkg, cfg):
        cfg.output.save_images = True
        return _runner(pkg, cfg).run()

    got = _run_both(tmp_path, slide_dir, scenario, fast_mode=False, black_threshold=120,
                    white_threshold=40)
    (jax_outcome, jax_out), (port_outcome, port_out) = got[PACKAGES[0]], got[PACKAGES[1]]
    assert port_outcome == jax_outcome and port_outcome["failures"] == []
    assert _assert_same_h5_files(jax_out, port_out) == 2
    for stem, n in port_outcome["results"]:
        pngs = sorted(p.name for p in (port_out / "images" / stem).glob("*.png"))
        assert len(pngs) == n
        assert pngs == sorted(p.name for p in (jax_out / "images" / stem).glob("*.png"))


def test_runner_skip_existing_and_lock(tmp_path):
    slide_dir = _slides(tmp_path)

    def scenario(pkg, cfg):
        results, failures = _runner(pkg, cfg).run()
        assert failures == [] and len(results) == 3
        h5s = sorted((cfg.output.output_root / "patches").glob("*.h5"))
        mtimes = [p.stat().st_mtime_ns for p in h5s]
        # Second run: everything skipped, nothing rewritten
        results2, failures2 = _runner(pkg, cfg).run()
        assert failures2 == [] and results2 == []
        assert [p.stat().st_mtime_ns for p in h5s] == mtimes
        # A held lock causes a skip (not a failure)
        cfg_force = _cfg(pkg, slide_dir, cfg.output.output_root.parent / (cfg.output.output_root.name + "2"))
        lock = pkg.paths.patch_lock_path(
            pkg.models.Slide(path=slide_dir / "slide0.png"), cfg_force.output, cfg_force.extraction
        )
        lock.parent.mkdir(parents=True, exist_ok=True)
        lock.write_text("pid=held")
        results3, failures3 = _runner(pkg, cfg_force).run()
        assert failures3 == [] and len(results3) == 2
        assert lock.read_text() == "pid=held"  # another process's lock is left alone
        return results3, failures3

    got = _run_both(tmp_path, slide_dir, scenario)
    assert got[PACKAGES[0]][0]["results"] == got[PACKAGES[1]][0]["results"]
    assert [s for s, _ in got[PACKAGES[1]][0]["results"]] == ["slide1", "slide2"]


def test_concurrent_runners_dedupe_via_locks(tmp_path):
    """Two port runners over the same cohort/output: every slide processed
    exactly once between them, no failures, and the files match the JAX
    runner's."""
    slide_dir = _slides(tmp_path, n=6, size=(512, 512), prefix="s")
    pkg = _pkg(PACKAGES[1])
    out = tmp_path / "out"
    outcomes = {}

    def run(tag):
        outcomes[tag] = _runner(pkg, _cfg(pkg, slide_dir, out, patch_size=64), delay=0.02).run()

    threads = [threading.Thread(target=run, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (res_a, fail_a), (res_b, fail_b) = outcomes["a"], outcomes["b"]
    assert fail_a == [] and fail_b == []
    assert sorted(r.slide.stem for r in res_a + res_b) == [f"s{i}" for i in range(6)]
    assert sorted(p.name for p in (out / "patches").iterdir()) == [f"s{i}.h5" for i in range(6)]

    jax = _pkg(PACKAGES[0])
    jax_out = tmp_path / "out-jax"
    _runner(jax, _cfg(jax, slide_dir, jax_out, patch_size=64)).run()
    assert _assert_same_h5_files(jax_out, out) == 6


def test_per_slide_fault_isolation(tmp_path, monkeypatch):
    """A slide raising in segmentation fails its batch (the batch shares one
    segment_batch call); the rest complete and every lock is released."""
    slide_dir = _slides(tmp_path, n=4, size=(512, 512), prefix="s")

    def scenario(pkg, cfg):
        original = pkg.image_wsi.ImageWSI.get_thumb

        def flaky_thumb(self, max_hw):
            if "s1" in str(self.path):
                raise RuntimeError("injected thumbnail failure")
            return original(self, max_hw)

        monkeypatch.setattr(pkg.image_wsi.ImageWSI, "get_thumb", flaky_thumb)
        return _runner(pkg, cfg).run()

    got = _run_both(tmp_path, slide_dir, scenario, patch_size=64)
    (jax_outcome, jax_out), (port_outcome, port_out) = got[PACKAGES[0]], got[PACKAGES[1]]
    assert port_outcome == jax_outcome
    assert port_outcome["failures"] == [("s0", "RuntimeError"), ("s1", "RuntimeError")]
    assert [s for s, _ in port_outcome["results"]] == ["s2", "s3"]
    assert port_outcome["files"] == ["s2.h5", "s3.h5"]  # all locks released
    _assert_same_h5_files(jax_out, port_out)


def test_crash_in_the_writer_leaves_no_partial_h5(tmp_path, monkeypatch):
    """A writer failure mid-write fails only that slide: no H5, no stage file
    and no lock is left for it, and the other slides publish."""
    slide_dir = _slides(tmp_path, n=3, size=(512, 512), prefix="s")

    def scenario(pkg, cfg):
        original = pkg.storage.H5PatchWriter._passports_vec

        def exploding(self, coords):
            if self.slide_stem == "s1":
                raise OSError("disk full mid-write")
            return original(self, coords)

        monkeypatch.setattr(pkg.storage.H5PatchWriter, "_passports_vec", exploding)
        return _runner(pkg, cfg).run()

    got = _run_both(tmp_path, slide_dir, scenario, patch_size=64)
    (jax_outcome, jax_out), (port_outcome, port_out) = got[PACKAGES[0]], got[PACKAGES[1]]
    assert port_outcome == jax_outcome
    assert port_outcome["failures"] == [("s1", "OSError")]
    assert port_outcome["files"] == ["s0.h5", "s2.h5"]
    _assert_same_h5_files(jax_out, port_out)


def test_abnormal_exit_releases_every_lock(tmp_path):
    """An error that escapes per-slide isolation (here a KeyboardInterrupt in
    segmentation) propagates, and no lock file outlives the run."""
    slide_dir = _slides(tmp_path, n=5, size=(512, 512), prefix="s")
    for name in PACKAGES:
        pkg = _pkg(name)
        out = tmp_path / f"out-{name}"
        runner = _runner(pkg, _cfg(pkg, slide_dir, out, patch_size=64))
        calls = []

        def interrupted(wsis, calls=calls):
            calls.append(len(wsis))
            if len(calls) == 2:
                raise KeyboardInterrupt
            return [runner.segmentation.segment_thumbnail(w) for w in wsis]

        runner.segmentation.segment_batch = interrupted
        with pytest.raises(KeyboardInterrupt):
            runner.run()
        assert list((out / "patches").glob("*.lock")) == []
        assert list((out / "patches").glob(".stage-*")) == []


def test_features_raise_before_any_slide_is_touched(tmp_path):
    slide_dir = _slides(tmp_path, n=2, size=(256, 256))
    pkg = _pkg(PACKAGES[1])
    features = pkg.config.FeatureExtractionConfig(extractors=["resnet50"], device="cpu")
    cfg = _cfg(pkg, slide_dir, tmp_path / "out", features=features)
    runner = _runner(pkg, cfg)
    touched = []
    runner.discover_slides = lambda: touched.append(1) or []
    with pytest.raises(NotImplementedError, match="feature"):
        runner.run()
    assert touched == [] and list((tmp_path / "out").iterdir()) == []


def test_unported_slide_format_is_a_per_slide_failure(tmp_path):
    """A junk .svs (a reader's extension over a corrupt container) is a
    per-slide failure in both runners, with the same error type; the other
    slides complete. The name dates from before the readers were ported and
    is kept so that the test's history stays one line."""
    slide_dir = _slides(tmp_path, n=2, size=(512, 512), prefix="s")
    (slide_dir / "t.svs").write_bytes(b"II*\x00not a real slide")
    got = _run_both(tmp_path, slide_dir, patch_size=64)
    (jax_outcome, _), (port_outcome, port_out) = got[PACKAGES[0]], got[PACKAGES[1]]
    assert port_outcome == jax_outcome
    assert [r[0] for r in port_outcome["results"]] == ["s0", "s1"]
    assert port_outcome["failures"] == [("t", "RuntimeError")]
    assert port_outcome["files"] == ["s0.h5", "s1.h5"]


def _reader_fixture(tmp_path: Path, ext: str) -> Path:
    """A real slide of each reader's container, as the JAX reader tests
    write them."""
    from tests.container_builders import write_dicom_level, write_mirax, write_vms, write_vmu
    from tests.tiff_builder import write_pyramid

    img = make_tissue_canvas(256, 192, seed=4, n_blobs=2)
    path = tmp_path / f"x{ext}"
    if ext in (".svs", ".tif"):
        write_pyramid(path, img, levels=2, tile=64, compression=7 if ext == ".svs" else 8,
                      description="Aperio Image Library\r\n256x192 | AppMag = 20 | MPP = 0.5")
    elif ext == ".mrxs":
        write_mirax(path, img, tile_w=64, tile_h=48, n_levels=2, mpp=0.5, objective=20)
    elif ext == ".vms":
        write_vms(path, img, cols=2, rows=1, mpp=0.5, lens=20)
    elif ext == ".vmu":
        write_vmu(path, img, column_width=32, mpp=0.5, lens=20)
    else:
        write_dicom_level(path, img, tile=64, mpp=0.5, objective=20.0)
    return path


@pytest.mark.parametrize("ext,backend", [(".svs", "tiff"), (".tif", "tiff"), (".mrxs", "mirax"),
                                         (".vms", "vms"), (".vmu", "vmu"), (".dcm", "dicom")])
def test_factory_names_the_unported_backend(tmp_path, ext, backend):
    """Each reader extension routes to its backend and opens a real fixture
    to the JAX reader's class and geometry. The name dates from before the
    readers were ported and is kept so that the test's history stays one
    line."""
    from atlaspatch_tpu.io.factory import WSIFactory as JaxFactory
    from atlaspatch_tpu_torch.io.factory import WSIFactory

    path = _reader_fixture(tmp_path, ext)
    assert WSIFactory.detect(str(path)) == JaxFactory.detect(str(path)) == backend
    want, got = JaxFactory.load(str(path), mpp=0.5), WSIFactory.load(str(path), mpp=0.5)
    want._ensure_loaded()
    got._ensure_loaded()
    assert type(got).__name__ == type(want).__name__
    assert type(got).__module__.startswith("atlaspatch_tpu_torch.io.")
    assert (got.w, got.h, got.nlvl, got.dims, got.ds, got.mpp, got.mag) == (
        want.w, want.h, want.nlvl, want.dims, want.ds, want.mpp, want.mag
    )
    want.cleanup()
    got.cleanup()


def test_discovery_and_mpp_match_jax(tmp_path):
    from atlaspatch_tpu.utils import params as jax_params
    from atlaspatch_tpu_torch.utils import params as port_params

    d = tmp_path / "cohort"
    (d / "sub").mkdir(parents=True)
    for name in ("a.PNG", "b.svs", "c.tiff", "d.txt", "sub/e.png", "f.vms", "tile0.jpg"):
        (d / name).write_bytes(b"")
    (d / "f.vms").write_text("[Virtual Microscope Specimen]\nImageFile=tile0.jpg\n")
    # A multi-instance DICOM series (two levels and a label) lists once, by
    # its base instance; an unreadable .dcm stays listed.
    from tests.container_builders import write_dicom_pyramid

    write_dicom_pyramid(d, np.zeros((64, 96, 3), np.uint8), n_levels=2, tile=32, encapsulated=False)
    (d / "junk.dcm").write_bytes(b"")
    for recursive in (False, True):
        want = jax_params.get_wsi_files(str(d), recursive=recursive)
        assert port_params.get_wsi_files(str(d), recursive=recursive) == want
        names = [Path(f).name for f in want]
        assert "level0.dcm" in names and "junk.dcm" in names
        assert "level1.dcm" not in names and "label.dcm" not in names
    csv = tmp_path / "mpp.csv"
    csv.write_text("wsi,mpp\na.png,0.25\nb.svs,bad\nc.tiff,-1\n,3\n")
    assert port_params.load_mpp_csv(str(csv)) == jax_params.load_mpp_csv(str(csv)) == {"a": 0.25}
    assert port_params.get_mpp_for_wsi("/x/a.svs", {"a": 0.25}) == 0.25
    with pytest.raises(ValueError):
        port_params.get_wsi_files(str(tmp_path / "cohort" / "sub" / "none"))


def test_duplicate_stems_fail_loudly(tmp_path):
    pkg = _pkg(PACKAGES[1])
    for sub in ("a", "b"):
        d = tmp_path / sub
        d.mkdir()
        Image.fromarray(np.full((64, 64, 3), 200, np.uint8)).save(d / "slide.png")
    c = pkg.config
    cfg = c.AppConfig(
        processing=c.ProcessingConfig(input_path=tmp_path, recursive=True),
        segmentation=c.SegmentationConfig(device="cpu"),
        extraction=c.ExtractionConfig(patch_size=64, target_magnification=20),
        output=c.OutputConfig(output_root=tmp_path / "out"),
        device="cpu",
    )
    runner = pkg.runner.ProcessingRunner.__new__(pkg.runner.ProcessingRunner)
    runner.config = cfg
    with pytest.raises(ValueError, match="stems collide"):
        runner.discover_slides()


@pytest.mark.parametrize("hosts,host_id,steal", [(None, None, False), (3, 1, False), (3, 2, True)])
def test_host_shard_matches_jax(monkeypatch, hosts, host_id, steal):
    from atlaspatch_tpu.parallel import multihost as jax_mh
    from atlaspatch_tpu_torch.parallel import multihost as port_mh

    for var, value in (("ATLASPATCH_NUM_HOSTS", hosts), ("ATLASPATCH_HOST_ID", host_id)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, str(value))
    items = list(range(10))
    assert port_mh.host_identity() == ((host_id or 0), (hosts or 1))
    assert port_mh.host_shard(items, steal=steal) == jax_mh.host_shard(items, steal=steal)
