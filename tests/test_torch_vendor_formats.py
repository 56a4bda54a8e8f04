"""The port's native decoder on vendor TIFF containers against the JAX
package's, on the CPU: Hamamatsu NDPI (SourceLens levels, >4 GiB offsets,
single-strip giant JPEGs decoded in restart-marker stripes or sequentially),
Leica SCN, Ventana BIF (iScan XMP, AOI join overlaps), Philips TIFF and
Trestle (OverlapsXY), plus the generic-TIFF base-level rules.

Each case writes one file as tests/test_vendor_formats.py does (seeded
canvases, the repo's TIFF writer, Pillow's JPEG encoder) and opens it with
both packages, both through AtlasTiffFile and through TiffWSI. Levels,
properties, every read's bytes, mpp, magnification and metadata must be
identical (tolerance: none), and every refusal must match in type and
message.
"""

from __future__ import annotations

import io
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from atlaspatch_tpu.io import native as jax_native
from atlaspatch_tpu.io.tiff_wsi import TiffWSI as JaxTiffWSI
from atlaspatch_tpu_torch.io import native as port_native
from atlaspatch_tpu_torch.io.tiff_wsi import TiffWSI as PortTiffWSI
from tests.test_vendor_formats import (
    BIF_XMP,
    NDPI_MAGIC,
    PHILIPS_XML,
    TYPE_ASCII,
    _jpeg_with_restarts,
    _ndpi_tags,
    _overlapping_bif,
    _scn_xml,
    _trestle_mosaic,
    _write_single_strip_ndpi,
    _zero_sof_dims,
)
from tests.tiff_builder import TYPE_LONG, TiffWriter
from torch_port_helpers import assert_same_record, native_tiff_record, wsi_record


def _rand(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _gradient(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 255 / w).astype(np.uint8), (yy * 255 / h).astype(np.uint8),
                     ((xx + yy) * 127 / (h + w)).astype(np.uint8)], axis=-1)


def _tiff(*levels):
    """A TiffWriter file of (image, add_level kwargs) levels."""

    def build(path):
        w = TiffWriter()
        for image, kw in levels:
            w.add_level(image, **kw)
        w.save(path)

    return build


def _strip(stream, w, h, **kw):
    """One raw single-strip JPEG level."""

    def build(path):
        tw = TiffWriter()
        tw.add_level_raw_strips([stream], width=w, height=h, rows_per_strip=h, **kw)
        tw.save(path)

    return build


def _ndpi_strip(stream, w, h):
    return lambda path: _write_single_strip_ndpi(path, stream, w, h)


def _plain_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _ndpi_beyond_4gb(path):
    """tests/test_vendor_formats.py: strips after the first relocated past
    4 GiB (sparse), offsets stored as their low 32 bits."""
    w = TiffWriter()
    w.add_level(_rand(9, 48, 64), extra_tags=_ndpi_tags(40.0))
    w.save(path)
    raw = bytearray(path.read_bytes())
    ifd_off = struct.unpack_from("<I", raw, 4)[0]
    entry_at = {}
    for i in range(struct.unpack_from("<H", raw, ifd_off)[0]):
        entry_at[struct.unpack_from("<H", raw, ifd_off + 2 + 12 * i)[0]] = ifd_off + 2 + 12 * i
    _, _, cnt, arr_off = struct.unpack_from("<HHII", raw, entry_at[273])
    offsets = list(struct.unpack_from(f"<{cnt}I", raw, arr_off))
    counts = list(struct.unpack_from(f"<{cnt}I", raw, struct.unpack_from("<HHII", raw, entry_at[279])[3]))
    cursor = (1 << 32) + 8
    with open(path, "r+b") as f:
        for i in range(1, cnt):
            f.seek(cursor)
            f.write(raw[offsets[i] : offsets[i] + counts[i]])
            struct.pack_into("<I", raw, arr_off + 4 * i, cursor & 0xFFFFFFFF)
            cursor += counts[i]
        f.seek(0)
        f.write(raw)


def _ndpi_wrapped_byte_count(path):
    stream = _jpeg_with_restarts(_rand(44, 96, 128), rows=1, subsampling=0)
    _write_single_strip_ndpi(path, _zero_sof_dims(stream), 128, 96)
    raw = bytearray(path.read_bytes())
    ifd_off = struct.unpack_from("<I", raw, 4)[0]
    for i in range(struct.unpack_from("<H", raw, ifd_off)[0]):
        at = ifd_off + 2 + 12 * i
        tag, _typ, _cnt, val = struct.unpack_from("<HHII", raw, at)
        if tag == 279:
            struct.pack_into("<I", raw, at + 8, val // 2)
    path.write_bytes(bytes(raw))


def _gray_strip(photometric):
    buf = io.BytesIO()
    gray = np.random.default_rng(43).integers(0, 256, (32, 48), dtype=np.uint8)
    Image.fromarray(gray, mode="L").save(buf, "JPEG", quality=95, restart_marker_rows=1)
    return _strip(_zero_sof_dims(buf.getvalue()), 48, 32, spp=1, extra_tags=[(262, 3, [photometric])])


def _overlap_bif(**kw):
    def build(path):
        _overlapping_bif(path.parent, **kw)

    return build


def _multi_aoi_bif(path):
    """Two <AreaOfInterest> groups of TileJointInfo (the multi-AOI baseline
    of tests/test_vendor_formats.py)."""
    aois = "".join(
        f'<AreaOfInterest Id="{k}" OriginX="{ox0}" OriginY="0">'
        f'<TileJointInfo Tile1="{t1}" Tile2="{t1 + 1}" Direction="RIGHT" Confidence="99" '
        f'OverlapX="{rx}" OverlapY="0.2" />'
        f'<TileJointInfo Tile1="{t1}" Tile2="{t1 + 4}" Direction="UP" Confidence="98" '
        f'OverlapX="0.1" OverlapY="{uy}" />'
        "</AreaOfInterest>"
        for k, ox0, t1, rx, uy in ((1, 0, 1, 15.5, 15.75), (2, 4096, 7, 16.5, 16.25))
    )
    xmp = (
        '<?xpacket begin="" id="W5M0MpCehiHzreSzNTczkc9d"?>'
        '<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF>'
        '<iScan xmlns="http://ventana.com/iscan/1.0" UnitNumber="1" '
        'Magnification="40" ScanRes="0.25" />'
        f"<AoiJoinInfo>{aois}</AoiJoinInfo>"
        "</rdf:RDF></x:xmpmeta><?xpacket end=\"w\"?>"
    )
    tile, overlap, cols, rows = 64, 16, 4, 3
    rng = np.random.default_rng(57)
    adv = tile - overlap
    truth = rng.integers(0, 256, ((rows - 1) * adv + tile, (cols - 1) * adv + tile, 3), np.uint8)
    mosaic = np.zeros((rows * tile, cols * tile, 3), np.uint8)
    for r in range(rows):
        for c in range(cols):
            mosaic[r * tile : (r + 1) * tile, c * tile : (c + 1) * tile] = truth[
                r * adv : r * adv + tile, c * adv : c * adv + tile
            ]
    _tiff((_rand(58, 48, 64), dict(extra_tags=[(700, TYPE_ASCII, [xmp])])), (mosaic, dict(tile=tile)))(path)


def _trestle(desc, *dirs, software="MedScan"):
    """Trestle pyramid: the first directory carries the description and the
    MedScan Software tag."""
    first, *rest = dirs
    return _tiff((first[0], dict(first[1], description=desc, extra_tags=[(305, TYPE_ASCII, [software])])),
                 *rest)


def _trestle_pair():
    rng = np.random.default_rng(71)
    truth0 = rng.integers(0, 256, (176, 208, 3), dtype=np.uint8)
    m0 = _trestle_mosaic(truth0, 64, 16, 8, 256, 192, rng)
    m1 = _trestle_mosaic(truth0[::2, ::2].copy(), 64, 8, 12, 112, 100, rng)
    return truth0, m0, m1


TRUTH0, M0, M1 = _trestle_pair()
MAIN = _rand(7, 96, 128)
XMP_ADVERSARIAL = [
    "<iScan",
    '<iScan Magnification=',
    '<iScan Magnification="40',
    '<iScan Magnification="" ScanRes="">',
    '<iScan CoarseMagnification="4">',
    '<iScan Magnification="1e308" ScanRes="-0.25">',
    "x" * 70000 + "<iScan " + 'Magnification="40">',
    '<iScan Magnification="40"/><TileJointInfo Direction="RIGHT" OverlapX="12',
    '<iScan/>' + '<TileJointInfo Direction="RIGHT" OverlapX="nan" OverlapY="inf" Confidence="99"/>' * 3,
    '<iScan/>' + '<TileJointInfo Direction="SIDEWAYS" OverlapX="1e308"/>' * 5,
    '<iScan/>' + '<TileJointInfo Direction="RIGHT" OverlapX="8" Confidence="0"/>' * 5000,
    '<iScan/><TileJointInfo Direction= OverlapX=8>',
    '<iScan/><TileJointInfo ' + "A" * 70000,
]
PHILIPS_ADVERSARIAL = [
    '"DICOM_PIXEL_SPACING"',
    '<Attribute Name="DICOM_PIXEL_SPACING"',
    '<Attribute Name="DICOM_PIXEL_SPACING"></Attribute>',
    '<Attribute Name="DICOM_PIXEL_SPACING">no digits here</Attribute>',
    '<Attribute Name="DICOM_PIXEL_SPACING">&quot;-3&quot;</Attribute>',
    '<Attribute Name="DICOM_PIXEL_SPACING">' + "." * 5000 + "</Attribute>",
]
SCN_MULTI = _scn_xml((60, 100), [(128, 96, 1), (64, 48, 2)], 40)
SCN_SINGLE = _scn_xml((96, 64), [(96, 64, 0)], 20).replace('<image name="region"', "<!-- no second image --><junk")


def _fuzzed(base, seed: int, *, cut: float | None = None):
    """``base``'s bytes with 1-11 random bytes overwritten, or truncated."""

    def build(path):
        base(path)
        raw = bytearray(path.read_bytes())
        rng = np.random.default_rng(seed)
        if cut is not None:
            raw = raw[: int(len(raw) * cut)]
        else:
            for _ in range(int(rng.integers(1, 12))):
                raw[int(rng.integers(0, len(raw)))] = int(rng.integers(0, 256))
        path.write_bytes(bytes(raw))

    return build


_NDPI_STRIPED = _ndpi_strip(_zero_sof_dims(_jpeg_with_restarts(_rand(31, 64, 96), rows=1, subsampling=0)), 96, 64)
_BIF_SMALL = _tiff((_rand(56, 24, 32), dict(extra_tags=[(700, TYPE_ASCII, [BIF_XMP])])), (MAIN, dict(tile=64)))

# name -> (file name, builder, expectation)
CASES = {
    "ndpi-sourcelens-levels": ("slide.ndpi", _tiff(
        (MAIN, dict(extra_tags=_ndpi_tags(20.0), resolution=(20000.0, 20000.0, 3))),
        (_rand(8, 96, 128), dict(extra_tags=_ndpi_tags(20.0, z=1000))),
        (MAIN[::2, ::2].copy(), dict(extra_tags=_ndpi_tags(5.0))),
        (_rand(9, 40, 100), dict(extra_tags=_ndpi_tags(-1.0))),
        (_rand(10, 30, 80), dict(extra_tags=_ndpi_tags(-2.0))),
    ), "opens"),
    "ndpi-without-sourcelens": ("odd.ndpi", _tiff(
        (MAIN, dict(extra_tags=[(NDPI_MAGIC, TYPE_LONG, [1])])),
        (MAIN[::2, ::2].copy(), dict(extra_tags=[(NDPI_MAGIC, TYPE_LONG, [1])])),
    ), "opens"),
    "ndpi-offsets-beyond-4gb": ("big.ndpi", _ndpi_beyond_4gb, "opens"),
    "ndpi-striped-row-segments": ("giant.ndpi", _ndpi_strip(
        _zero_sof_dims(_jpeg_with_restarts(_rand(21, 120, 160), rows=1, subsampling=0)), 160, 120), "opens"),
    "ndpi-striped-subrow-segments": ("wide.ndpi", _ndpi_strip(
        _zero_sof_dims(_jpeg_with_restarts(_rand(22, 64, 160), blocks=2, subsampling=0)), 160, 64), "opens"),
    "ndpi-striped-420": ("chroma.ndpi", _ndpi_strip(
        _zero_sof_dims(_jpeg_with_restarts(_gradient(96, 128), rows=1, subsampling=2)), 128, 96), "opens"),
    "ndpi-misaligned-restarts": ("mis.ndpi", _ndpi_strip(
        _zero_sof_dims(_jpeg_with_restarts(_rand(24, 96, 120), blocks=4, subsampling=0)), 120, 96), "opens"),
    "ndpi-no-restarts": ("norst.ndpi", _ndpi_strip(
        _zero_sof_dims(_plain_jpeg(_rand(23, 64, 80), quality=90, subsampling=0)), 80, 64), "opens"),
    "ndpi-gray-min-is-black": ("gray1.ndpi", _gray_strip(1), "opens"),
    "ndpi-gray-min-is-white": ("gray0.ndpi", _gray_strip(0), "opens"),
    "ndpi-wrapped-byte-count": ("wrapped.ndpi", _ndpi_wrapped_byte_count, "opens"),
    "ndpi-real-sof-width-mismatch": ("mismatch.ndpi", _ndpi_strip(
        _plain_jpeg(_rand(60, 64, 96), quality=95, subsampling=0), 128, 64), "either"),
    "single-strip-progressive": ("prog.tif", _strip(
        _plain_jpeg(_rand(41, 48, 64), quality=92, progressive=True), 64, 48), "opens"),
    "single-strip-restarts-correct-dims": ("plain.tif", _strip(
        _jpeg_with_restarts(_rand(42, 48, 64), rows=1, subsampling=0), 64, 48), "opens"),
    "huge-single-strip-sequential": ("big_plain.tif", _strip(
        _jpeg_with_restarts(_gradient(96, 128), rows=1, subsampling=2), 128, 96), "opens"),
    "huge-single-strip-no-restarts": ("big_plain_nodri.tif", _strip(
        _plain_jpeg(_gradient(96, 128), quality=90, subsampling=2), 128, 96), "opens"),
    **{f"fuzz-ndpi-striped-{s}": ("fuzz.ndpi", _fuzzed(_NDPI_STRIPED, 31 + s), "either") for s in range(5)},
    **{f"fuzz-ndpi-striped-cut-{c}": ("cut.ndpi", _fuzzed(_NDPI_STRIPED, 0, cut=c), "either") for c in (0.75, 0.5)},
    "scn-main-pyramid": ("slide.scn", _tiff(
        (_rand(11, 100, 60), dict(description=SCN_MULTI)),
        (MAIN, dict(resolution=(40000.0, 40000.0, 3))),
        (MAIN[::2, ::2].copy(), {}),
    ), "opens"),
    "scn-single-image": ("one.scn", _tiff((_rand(12, 64, 96), dict(description=SCN_SINGLE))), "opens"),
    "generic-thumbnail-description": ("v.bif", _tiff(
        (MAIN, dict(tile=64)), (MAIN[::2, ::2].copy(), dict(tile=64, description="Thumbnail Image")),
        (MAIN[::4, ::4].copy(), dict(tile=64)),
    ), "opens"),
    "generic-base-stays-ifd0": ("generic.tiff", _tiff((MAIN, {}), (_rand(57, 256, 160), dict(tile=64))), "opens"),
    "thumbnail-first-striped": ("thumbfirst.tiff", _tiff((_rand(58, 128, 192)[::4, ::4].copy(), {}),
                                                         (_rand(58, 128, 192), {})), "opens"),
    "iscan-prefix-needs-delimiter": ("notventana.tiff", _tiff(
        (_rand(59, 64, 96), dict(tile=64, extra_tags=[(700, TYPE_ASCII,
                                                       ['<iScanSettings Magnification="4" ScanRes="9.9"/>'])])),
    ), "opens"),
    "bif-levels-and-metadata": ("slide.bif", _tiff(
        (_rand(51, 48, 64), dict(extra_tags=[(700, TYPE_ASCII, [BIF_XMP])])),
        (_rand(52, 192, 256), dict(tile=128)),
        (_rand(52, 192, 256)[::2, ::2].copy(), dict(tile=128)),
        (_rand(53, 40, 100), dict(description="Label Image")),
    ), "opens"),
    "bif-without-overview": ("flat.bif", _tiff(
        (_rand(52, 128, 192), dict(tile=64, extra_tags=[(700, TYPE_ASCII, [BIF_XMP])])),
        (_rand(52, 128, 192)[::2, ::2].copy(), dict(tile=64)),
    ), "opens"),
    "bif-aoi-join-overlaps": ("aoi.bif", _overlap_bif(), "opens"),
    "bif-multi-aoi": ("multiaoi.bif", _multi_aoi_bif, "opens"),
    **{
        f"bif-insane-overlap-{ox}": (
            "aoi.bif", _overlap_bif(joints=[("RIGHT", 99, ox, 0), ("UP", 99, 0, ox)], seed=54 + int(ox) % 7), "opens"
        )
        for ox in (64, 63.5, -3, 0, 400)
    },
    **{
        f"bif-xmp-adversarial-{i}": (
            "weird.bif", _tiff((_rand(54, 64, 96), dict(tile=64, extra_tags=[(700, TYPE_ASCII, [xmp])]))), "opens"
        )
        for i, xmp in enumerate(XMP_ADVERSARIAL)
    },
    **{f"fuzz-bif-{s}": ("fuzz.bif", _fuzzed(_BIF_SMALL, 56 + s), "either") for s in range(5)},
    **{f"fuzz-bif-cut-{c}": ("cut.bif", _fuzzed(_BIF_SMALL, 0, cut=c), "either") for c in (0.75, 0.5)},
    "philips-mpp-and-levels": ("slide.tiff", _tiff(
        (_rand(53, 192, 256), dict(tile=128, description=PHILIPS_XML,
                                    extra_tags=[(305, TYPE_ASCII, ["Philips DP v1.0"])])),
        (_rand(53, 192, 256)[::2, ::2].copy(), dict(tile=128)),
        (_rand(54, 40, 100), dict(description="Philips label image LABELIMAGE")),
    ), "opens"),
    **{
        f"philips-xml-adversarial-{i}": ("weird.tiff", _tiff(
            (_rand(55, 64, 96), dict(tile=64, description=xml, extra_tags=[(305, TYPE_ASCII, ["Philips DP v1.0"])])),
        ), "opens")
        for i, xml in enumerate(PHILIPS_ADVERSARIAL)
    },
    "trestle-overlaps": ("slide.tif", _trestle(
        "Background Color=FFFFFF;OverlapsXY=16 8 8 12;Objective Power=20",
        (M0, dict(tile=64)), (M1, dict(tile=64)), software="MedScan by Trestle"), "opens"),
    "trestle-without-overlaps": ("plain.tif", _trestle("JPEG Quality=75", (_rand(72, 128, 192), dict(tile=64))),
                                 "opens"),
    **{
        f"trestle-junk-overlaps-{i}": ("junk.tif", _trestle(desc, (_rand(73, 128, 192), dict(tile=64)),
                                                            software="MedScan x"), "opens")
        for i, desc in enumerate(("OverlapsXY=64 64", "OverlapsXY=0 0", "OverlapsXY=9999999 1",
                                  "OverlapsXY=banana", "OverlapsXY=16"))
    },
    "trestle-duplicate-key": ("dup.tif", _trestle(
        "OverlapsXY=16 8;OverlapsXY=4 4",
        (_trestle_mosaic(_rand(75, 120, 160), 64, 16, 8, 192, 128, np.random.default_rng(75)), dict(tile=64))),
        "opens"),
    "trestle-poisoned-then-valid": ("poison.tif", _trestle(
        "OverlapsXY=9999999 1;OverlapsXY=16 8", (_rand(76, 128, 192), dict(tile=64))), "opens"),
    "trestle-negative-overlap": ("neg.tif", _trestle("OverlapsXY=-16 8", (_rand(77, 128, 192), dict(tile=64))),
                                 "opens"),
    "trestle-pairs-by-directory": ("skip.tif", _trestle(
        "OverlapsXY=16 8 0 0 8 12;Objective Power=20",
        (M0, dict(tile=64)), (_rand(78, 96, 96), dict(tile=64)), (M1, dict(tile=64))), "opens"),
    "trestle-striped-directory-pair": ("striped_mid.tif", _trestle(
        "OverlapsXY=16 8 0 0 8 12;Objective Power=20",
        (M0, dict(tile=64)), (TRUTH0[::4, ::4].copy(), {}), (M1, dict(tile=64))), "opens"),
    "overlaps-need-medscan": ("generic.tif", _trestle("OverlapsXY=16 8", (_rand(74, 128, 192), dict(tile=64)),
                                                      software="OtherScan"), "opens"),
}

# Cases read with the 'huge single strip' trigger shrunk, as
# tests/test_vendor_formats.py does to reach the row-capped sequential path.
HUGE = {"huge-single-strip-sequential", "huge-single-strip-no-restarts"}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("vendor_cases")


def _build(case_dir: Path, name: str, monkeypatch) -> tuple[Path, str]:
    file_name, build, expect = CASES[name]
    if name in HUGE:
        monkeypatch.setenv("ATLASPATCH_TIFF_HUGE_BYTES", "1000")
    d = case_dir / name
    if not d.exists():
        d.mkdir()
        build(d / file_name)
    return d / file_name, expect


@pytest.mark.parametrize("name", sorted(CASES))
def test_vendor_file_matches_jax(case_dir, name, monkeypatch):
    path, expect = _build(case_dir, name, monkeypatch)
    want = native_tiff_record(jax_native.AtlasTiffFile, path)
    got = native_tiff_record(port_native.AtlasTiffFile, path)
    assert_same_record(want, got, name)
    if expect == "opens":
        assert "open" not in got and not isinstance(got[0, "whole"], tuple), got.get("open")


@pytest.mark.parametrize("name", sorted(CASES))
def test_vendor_wsi_matches_jax(case_dir, name, monkeypatch):
    path, expect = _build(case_dir, name, monkeypatch)
    want = wsi_record(JaxTiffWSI, path)
    got = wsi_record(PortTiffWSI, path)
    assert_same_record(want, got, name)
    if expect == "opens":
        assert "open" not in got and not isinstance(got["thumb"], tuple), got.get("open")


def test_vendor_metadata_values(case_dir, monkeypatch):
    """The vendor rules land where tests/test_vendor_formats.py pins them."""
    def rec(name):
        return native_tiff_record(port_native.AtlasTiffFile, _build(case_dir, name, monkeypatch)[0])

    ndpi = rec("ndpi-sourcelens-levels")
    assert ndpi["dims"] == [(128, 96), (64, 48)]
    assert ndpi["props"]["atlas.vendor"] == "hamamatsu-ndpi"
    scn = rec("scn-main-pyramid")
    assert scn["dims"] == [(128, 96), (64, 48)] and scn["props"]["leica.objective"] == "40"
    assert rec("generic-thumbnail-description")["dims"] == [(128, 96), (32, 24)]
    assert rec("trestle-overlaps")["dims"][0] == (208, 176)
    np.testing.assert_array_equal(rec("trestle-overlaps")[0, "whole"], TRUTH0)
    wsi = wsi_record(PortTiffWSI, _build(case_dir, "philips-mpp-and-levels", monkeypatch)[0])
    assert wsi["mpp"] == 0.25 and wsi["levels"] == 2
