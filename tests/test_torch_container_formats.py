"""The port's MIRAX, Hamamatsu VMS/VMU and DICOM WSI readers (and the shared
tile cache, io/tiled.py) against the JAX package's, on the CPU.

Each case writes one slide with the builders of tests/container_builders.py
as tests/test_container_formats.py does (seeded canvases; JPEG, PNG, BMP,
raw, sparse, implicit-VR and J2K frames; corrupted copies) and opens it
through each package's WSIFactory. Geometry, mpp, magnification, metadata,
metadata_attrs, thumbnails and level reads must be identical (tolerance:
none), and every refusal must raise the same exception type and message.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

from atlaspatch_tpu.io.factory import WSIFactory as JaxFactory
from atlaspatch_tpu_torch.io.factory import WSIFactory as PortFactory
from tests.container_builders import (
    write_dicom_level,
    write_dicom_pyramid,
    write_mirax,
    write_vms,
    write_vmu,
)
from tests.test_container_formats import smooth_rgb
from torch_port_helpers import assert_same_record, h5_view, outcome, wsi_record


def _rand(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _corrupt_slide_id(d: Path) -> Path:
    path = write_mirax(d / "bad.mrxs", smooth_rgb(64, 48), tile_w=64, tile_h=48, n_levels=1)
    index = path.with_suffix("") / "Index.dat"
    raw = bytearray(index.read_bytes())
    raw[5] ^= 0xFF
    index.write_bytes(bytes(raw))
    return path


def _corrupt_positions(d: Path) -> Path:
    import struct

    path = write_mirax(d / "h.mrxs", smooth_rgb(128, 96), tile_w=64, tile_h=48, n_levels=1)
    data = path.with_suffix("") / "Data0000.dat"
    raw = bytearray(data.read_bytes())
    struct.pack_into("<ii", raw, len(raw) - 9 * 4 + 1, 2**31 - 9, 2**31 - 9)
    data.write_bytes(bytes(raw))
    return path


def _tissue_mirax(d: Path) -> Path:
    img = np.full((256, 256, 3), 230, dtype=np.uint8)
    img[32:224, 32:224] = (180, 60, 120)
    return write_mirax(d / "tissue.mrxs", img, tile_w=64, tile_h=64, n_levels=1, mpp=0.5, objective=20)


def _junk_dcm(d: Path) -> Path:
    (d / "junk.dcm").write_bytes(b"\x00" * 200)
    return d / "junk.dcm"


def _fuzzed(write, target, seed: int):
    """tests/test_container_formats.py's TestContainerFuzz mutation: 1-7
    random bytes of one container file overwritten."""

    def build(d: Path) -> Path:
        path = write(d)
        victim = target(path)
        raw = bytearray(victim.read_bytes())
        rng = np.random.default_rng(seed)
        for _ in range(rng.integers(1, 8)):
            raw[int(rng.integers(0, len(raw)))] = int(rng.integers(0, 256))
        victim.write_bytes(bytes(raw))
        return path

    return build


_MIRAX2 = lambda d: write_mirax(d / "f.mrxs", smooth_rgb(128, 96), tile_w=64, tile_h=48, n_levels=2)  # noqa: E731
_MIRAX1 = lambda d: write_mirax(d / "g.mrxs", smooth_rgb(128, 96), tile_w=64, tile_h=48, n_levels=1)  # noqa: E731
_DCM = lambda d: write_dicom_level(d / "f.dcm", smooth_rgb(128, 64), tile=64)  # noqa: E731
_VMU = lambda d: write_vmu(d / "f.vmu", smooth_rgb(128, 64), column_width=32)  # noqa: E731

# name -> (builder(dir) -> path, expectation): "opens", "refused" or
# "either" (corrupt input: the packages must only agree).
CASES = {
    "mirax": (lambda d: write_mirax(d / "case.mrxs", smooth_rgb(256, 144), tile_w=64, tile_h=48,
                                    n_levels=2, mpp=0.25, objective=20), "opens"),
    "mirax-no-position-buffer": (lambda d: write_mirax(d / "nopos.mrxs", smooth_rgb(128, 96), tile_w=64,
                                                       tile_h=48, n_levels=1, use_position_buffer=False), "opens"),
    "mirax-compressed-positions": (lambda d: write_mirax(d / "zpos.mrxs", smooth_rgb(128, 96), tile_w=64,
                                                         tile_h=48, n_levels=1, compress_positions=True), "opens"),
    "mirax-slide-id-mismatch": (_corrupt_slide_id, "refused"),
    "mirax-corrupt-position": (_corrupt_positions, "opens"),
    "mirax-tissue": (_tissue_mirax, "opens"),
    **{
        f"mirax-{fmt.lower()}-tiles": (
            lambda d, fmt=fmt: write_mirax(d / "p.mrxs", smooth_rgb(128, 96), tile_w=64, tile_h=48,
                                           n_levels=1, image_format=fmt),
            "opens",
        )
        for fmt in ("PNG", "BMP")
    },
    "vms": (lambda d: write_vms(d / "case.vms", smooth_rgb(256, 128), cols=2, rows=1, mpp=0.5, lens=20), "opens"),
    "vms-2x2": (lambda d: write_vms(d / "g.vms", _rand(3, 160, 192), cols=2, rows=2, mpp=0.25, lens=40), "opens"),
    "vmu": (lambda d: write_vmu(d / "case.vmu", smooth_rgb(128, 64), column_width=32, mpp=0.3, lens=40), "opens"),
    "dicom-pyramid": (lambda d: write_dicom_pyramid(d / "series", smooth_rgb(256, 128), n_levels=2, tile=64,
                                                    mpp=0.25), "opens"),
    "dicom-pyramid-via-level1": (
        lambda d: write_dicom_pyramid(d / "series", smooth_rgb(256, 128), n_levels=2, tile=64, mpp=0.25).parent
        / "level1.dcm",
        "opens",
    ),
    "dicom-raw": (lambda d: write_dicom_level(d / "raw.dcm", smooth_rgb(128, 64), tile=64, encapsulated=False,
                                              mpp=0.5), "opens"),
    "dicom-sparse": (lambda d: write_dicom_level(d / "sparse.dcm", smooth_rgb(128, 128), tile=64,
                                                 encapsulated=False, sparse=True), "opens"),
    "dicom-implicit-vr-sparse": (
        lambda d: write_dicom_level(d / "impl.dcm", _rand(70, 96, 128), tile=64, encapsulated=False,
                                    implicit=True, sparse=True, mpp=0.5, objective=20.0),
        "opens",
    ),
    "dicom-nonbase-raw-level1": (
        lambda d: write_dicom_pyramid(d, _rand(71, 128, 192), n_levels=2, tile=64, mpp=0.25,
                                      encapsulated=False).parent / "level1.dcm",
        "opens",
    ),
    "dicom-label-only": (
        lambda d: write_dicom_level(d / "lab.dcm", np.full((32, 32, 3), 99, np.uint8), tile=32,
                                    image_type="ORIGINAL\\PRIMARY\\LABEL", encapsulated=False),
        "refused",
    ),
    "dicom-junk": (_junk_dcm, "refused"),
    "dicom-j2k": (lambda d: write_dicom_level(d / "j.dcm", smooth_rgb(160, 96), tile=64, codec="j2k"), "opens"),
    "dicom-j2k-ycbcr": (lambda d: write_dicom_level(d / "jy.dcm", smooth_rgb(160, 96), tile=64,
                                                    codec="j2k_ycc"), "opens"),
    **{
        f"dicom-{mono.lower()}": (
            lambda d, mono=mono: write_dicom_level(
                d / "g.dcm", np.random.default_rng(71).integers(0, 255, (96, 160), np.uint8), tile=64,
                encapsulated=False, monochrome=mono),
            "opens",
        )
        for mono in ("MONOCHROME2", "MONOCHROME1")
    },
    **{f"fuzz-mirax-index-{s}": (_fuzzed(_MIRAX2, lambda p: p.with_suffix("") / "Index.dat", s), "either")
       for s in range(5)},
    **{f"fuzz-mirax-slidedat-{s}": (_fuzzed(_MIRAX1, lambda p: p.with_suffix("") / "Slidedat.ini", s), "either")
       for s in range(5)},
    **{f"fuzz-dicom-{s}": (_fuzzed(_DCM, lambda p: p, s), "either") for s in range(5)},
    **{f"fuzz-vmu-ngr-{s}": (_fuzzed(_VMU, lambda p: p.parent / "f.ngr", s), "either") for s in range(5)},
}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("container_cases")


def _build(case_dir: Path, name: str) -> tuple[Path, str]:
    build, expect = CASES[name]
    d = case_dir / name
    marker = d / ".path"
    if not marker.exists():
        d.mkdir()
        marker.write_text(str(build(d)))
    return Path(marker.read_text()), expect


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_matches_jax(case_dir, name):
    path, expect = _build(case_dir, name)
    want = wsi_record(JaxFactory.load, path)
    got = wsi_record(PortFactory.load, path)
    assert_same_record(want, got, name)
    if expect == "opens":
        assert "open" not in got and not isinstance(got["thumb"], tuple), got.get("open")
        assert not isinstance(got["extract", 0], tuple), got["extract", 0]
    elif expect == "refused":
        assert got["open"][0] == "raised"


def test_reader_classes(case_dir):
    """Each container routes to the port's own reader class, named as in the
    JAX package."""
    for name, cls in (("mirax", "MiraxWSI"), ("vms", "HamamatsuVMSWSI"), ("vmu", "HamamatsuVMUWSI"),
                      ("dicom-pyramid", "DicomWSI")):
        wsi = PortFactory.load(str(_build(case_dir, name)[0]))
        assert type(wsi).__name__ == cls and type(wsi).__module__.startswith("atlaspatch_tpu_torch.io.")
        wsi.cleanup()


def _vms_reads(factory, path, *, threshold=None):
    wsi = factory.load(str(path))
    wsi._ensure_loaded()
    if threshold is not None:
        for level in wsi._levels:
            level._window_threshold = threshold
            level.clear_cache()
    boxes = ((0, 0, 0), (96, 32, 0), (200, 90, 0), (0, 0, 1), (40, 20, 2))
    out = [outcome(lambda: wsi.extract((x, y), lv, (64, 48), mode="array")) for x, y, lv in boxes]
    wsi.cleanup()
    return out


def test_vms_window_decode_matches_jax(case_dir):
    """The partial-decode path (libjpeg-turbo crop + skip), forced for every
    tile, gives the JAX reader's bytes and the whole-tile decode's bytes."""
    path, _ = _build(case_dir, "vms")
    want = _vms_reads(JaxFactory, path, threshold=0)
    assert_same_record(want, _vms_reads(PortFactory, path, threshold=0))
    whole = _vms_reads(PortFactory, path)
    assert_same_record(whole[:3], want[:3])


def test_vms_window_fallback_crops_like_jax(case_dir, monkeypatch):
    """When the windowed decode fails, both readers decode whole once and crop."""
    import atlaspatch_tpu.io.native as jax_native
    import atlaspatch_tpu_torch.io.native as port_native

    def boom(*a, **k):
        raise RuntimeError("simulated jpeg_decode_window failure")

    path, _ = _build(case_dir, "vms")
    monkeypatch.setattr(jax_native, "jpeg_decode_window", boom)
    monkeypatch.setattr(port_native, "jpeg_decode_window", boom)
    assert_same_record(_vms_reads(JaxFactory, path, threshold=0), _vms_reads(PortFactory, path, threshold=0))


def test_tiled_level_matches_jax():
    """TiledLevel: a None window falls back to the whole tile; missing tiles
    and out-of-bounds areas take the fill; the thumbnail refuses absurd
    level dimensions with the same message."""
    from atlaspatch_tpu.io import tiled as jax_tiled
    from atlaspatch_tpu_torch.io import tiled as port_tiled

    rng = np.random.default_rng(5)
    tiles = {k: rng.integers(0, 256, (32, 40, 3), dtype=np.uint8) for k in range(6)}
    boxes = [(40 * (k % 3), 32 * (k // 3), 40, 32, k) for k in range(6)] + [(0, 80, 40, 32, "missing")]
    reads = ((4, 6, 10, 12), (30, 20, 60, 50), (-8, -8, 200, 150), (110, 60, 30, 30))
    got = {}
    for name, mod in (("jax", jax_tiled), ("port", port_tiled)):
        levels = [
            mod.TiledLevel(120, 112, 1.0, boxes, tiles.get, fill_rgb=(250, 240, 230), cache_tiles=2,
                           decode_window=lambda *a: None, window_threshold_bytes=0),
            mod.TiledLevel(120, 112, 1.0, boxes, tiles.get, cache_tiles=2),
        ]
        got[name] = [lvl.read_region(*r) for lvl in levels for r in reads]
        got[name].append(np.asarray(mod.thumb_from_level(levels[1], (48, 48))))
        got[name].append(outcome(lambda: mod.thumb_from_level(mod.TiledLevel(2**20, 2**20, 1.0, [],
                                                                              lambda k: None), (32, 32))))
    assert_same_record(got["jax"], got["port"])
    np.testing.assert_array_equal(got["port"][0], tiles[0][6:18, 4:14])


def test_dicom_handles_closed(tmp_path):
    """A malformed instance raises _DicomError without leaking its fd, and
    cleanup() closes every kept instance (the JAX reader's contract)."""
    from atlaspatch_tpu_torch.io.dicom_wsi import _DicomError, _DicomLevel

    junk = _junk_dcm(tmp_path)
    fds_before = len(os.listdir("/proc/self/fd"))
    for _ in range(5):
        with pytest.raises(_DicomError):
            _DicomLevel(junk)
    assert len(os.listdir("/proc/self/fd")) <= fds_before
    wsi = PortFactory.load(str(write_dicom_level(tmp_path / "ok.dcm", smooth_rgb(64, 64), tile=64,
                                                 encapsulated=False)))
    wsi._ensure_loaded()
    instances = list(wsi._instances)
    assert instances
    wsi.cleanup()
    assert all(inst.buf is None and inst._f is None for inst in instances)


def test_dicom_series_discovery_matches_jax(tmp_path):
    """One discovered entry per DICOM series (its base VOLUME instance); an
    unrelated series beside it stays discoverable."""
    from atlaspatch_tpu.utils.params import get_wsi_files as jax_files
    from atlaspatch_tpu_torch.utils.params import get_wsi_files as port_files

    rng = np.random.default_rng(72)
    base = write_dicom_pyramid(tmp_path, rng.integers(0, 256, (128, 192, 3), dtype=np.uint8), n_levels=3,
                               tile=64, mpp=0.25, encapsulated=False, with_label=True)
    assert port_files(str(tmp_path)) == jax_files(str(tmp_path)) == [str(base)]
    other = write_dicom_level(tmp_path / "other.dcm", rng.integers(0, 256, (64, 96, 3), dtype=np.uint8),
                              tile=32, encapsulated=False, series_uid="9.9.9.9", sop_uid="9.9.9.9.1")
    assert sorted(port_files(str(tmp_path))) == sorted(jax_files(str(tmp_path))) == sorted([str(base), str(other)])


def test_container_feeds_extraction_like_jax(case_dir, tmp_path):
    """A MIRAX slide through each package's extraction service: mask →
    contours → grid → H5 coords, byte-identical."""
    import importlib

    path, _ = _build(case_dir, "mirax-tissue")
    mask = np.zeros((64, 64), dtype=np.float32)
    mask[8:56, 8:56] = 1.0
    views = []
    for pkg, factory in (("atlaspatch_tpu", JaxFactory), ("atlaspatch_tpu_torch", PortFactory)):
        config = importlib.import_module(f"{pkg}.core.config")
        models = importlib.import_module(f"{pkg}.core.models")
        extraction = importlib.import_module(f"{pkg}.services.extraction")
        svc = extraction.PatchExtractionService(
            config.ExtractionConfig(patch_size=64, target_magnification=20).validated(),
            config.OutputConfig(output_root=tmp_path / pkg).validated(),
        )
        wsi = factory.load(str(path))
        wsi._ensure_loaded()
        result = svc.extract(wsi, mask, slide=models.Slide(path=Path(path), mpp=0.5))
        assert result.num_patches > 0
        views.append(h5_view(result.h5_path))
        wsi.cleanup()
    assert views[0] == views[1]
