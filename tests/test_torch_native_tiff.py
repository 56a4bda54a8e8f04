"""The port's native TIFF decoder (csrc/atlas_tiff.cc, csrc/atlas_j2k.cc) and
TiffWSI against the JAX package's, on the CPU.

Each case writes one file with the fixtures of tests/test_native_tiff.py,
tests/test_vendor_formats.py and tests/test_chunk_cache.py (seeded numpy
canvases, the repo's own TIFF writer, Pillow as an independent encoder) and
opens it with both packages. Everything the file exposes must be identical
(tolerance: none): level geometry, properties, the bytes of whole-level,
interior, edge and IDCT-scaled reads, TiffWSI's mpp / magnification /
metadata / metadata_attrs, thumbnails and level reads; and every refusal
must raise the same exception type with the same message.
"""

from __future__ import annotations

import ctypes
import io
import os
import struct
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from atlaspatch_tpu.io import native as jax_native
from atlaspatch_tpu.io.synthetic_wsi import make_tissue_canvas
from atlaspatch_tpu.io.tiff_wsi import TiffWSI as JaxTiffWSI
from atlaspatch_tpu_torch.io import native as port_native
from atlaspatch_tpu_torch.io.tiff_wsi import TiffWSI as PortTiffWSI
from tests.test_native_tiff import _patch_ifd_entry
from tests.test_vendor_formats import _jpeg_with_restarts, _write_single_strip_ndpi, _zero_sof_dims
from tests.tiff_builder import (
    TiffWriter,
    _j2k_encode_lossless,
    rgb_to_full_range_ycbcr,
    write_bigendian_single_level,
    write_bigtiff_single_level,
    write_ome_pyramid,
    write_pyramid,
)
from torch_port_helpers import assert_same_record, native_tiff_record, outcome, wsi_record

CANVAS = make_tissue_canvas(512, 384, seed=3, n_blobs=2)
APERIO = "Aperio Image Library v12\r\n512x384 | AppMag = 20 | MPP = 0.4990"


def _rand(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


def _pyramid(image=None, **kw):
    def build(path):
        write_pyramid(path, CANVAS if image is None else image, **kw)

    return build


def _writer(*levels):
    def build(path):
        w = TiffWriter()
        for image, kw in levels:
            w.add_level(image, **kw)
        w.save(path)

    return build


def _pil(**save_kw):
    def build(path):
        Image.fromarray(CANVAS).save(path, **save_kw)

    return build


def _pil_image(make, **save_kw):
    def build(path):
        make().save(path, **save_kw)

    return build


def _patched(base, ifd, tag, **patch):
    def build(path):
        base(path)
        buf = bytearray(path.read_bytes())
        _patch_ifd_entry(buf, ifd, tag, **patch)
        path.write_bytes(bytes(buf))

    return build


def _huge_first_tile_count(path):
    write_pyramid(path, _rand(11, 96, 128), levels=1, tile=64, compression=7)
    buf = bytearray(path.read_bytes())
    off = struct.unpack_from("<I", buf, 4)[0]
    for i in range(struct.unpack_from("<H", buf, off)[0]):
        eoff = off + 2 + 12 * i
        if struct.unpack_from("<H", buf, eoff)[0] == 325:  # TileByteCounts
            data_off = struct.unpack_from("<I", buf, eoff + 8)[0]
            struct.pack_into("<I", buf, data_off, 1 << 30)
    path.write_bytes(bytes(buf))


def _giant_height_ndpi(path):
    img = np.kron(_rand(14, 12, 32), np.ones((8, 8, 1), np.uint8))
    _write_single_strip_ndpi(path, _zero_sof_dims(_jpeg_with_restarts(img, rows=2)), 256, 96)
    buf = bytearray(path.read_bytes())
    _patch_ifd_entry(buf, 0, 257, value=4_587_616)
    path.write_bytes(bytes(buf))


def _giant_width_bad_header_ndpi(path):
    img = np.kron(_rand(17, 12, 32), np.ones((8, 8, 1), np.uint8))
    stream = bytearray(_jpeg_with_restarts(img, rows=2))
    stream[2:10] = b"\x00" * 8
    _write_single_strip_ndpi(path, bytes(stream), 1 << 24, 96)


def _j2k_ycbcr(path):
    write_pyramid(path, rgb_to_full_range_ycbcr(CANVAS), levels=1, tile=64, compression=33003)


def _fuzzed(base, seed: int, *, truncate: float | None = None, flips: int = 0, noise: bool = False):
    """``base``'s bytes, truncated, with the header followed by noise, or with
    random bit flips (tests/test_native_tiff.py's corruption campaign)."""

    def build(path):
        base(path)
        data = path.read_bytes()
        rng = np.random.default_rng(seed)
        if truncate is not None:
            data = data[: int(len(data) * truncate)]
        elif noise:
            data = data[:4] + bytes(rng.integers(0, 256, 2048, dtype=np.uint8))
        else:
            buf = bytearray(data)
            for _ in range(flips):
                buf[rng.integers(8, len(buf))] ^= 1 << rng.integers(0, 8)
            data = bytes(buf)
        path.write_bytes(data)

    return build


_DEFLATE2 = _pyramid(levels=2, tile=64, compression=8)
_JPEG2 = _pyramid(levels=2, tile=64, compression=7)

# name -> (file name, builder, expectation): "opens" must open at full
# geometry in both packages, "refused" must fail to open in both, "either"
# (corrupt input) must only agree.
CASES = {
    **{
        f"roundtrip-{'tiled' if tile else 'strips'}-c{c}": (
            "pyr.tiff", _pyramid(levels=3, tile=tile, compression=c), "opens"
        )
        for tile in (64, None)
        for c in (1, 8, 32773)
    },
    **{
        f"pil-{c or 'raw'}": ("pil.tiff", _pil(**({"compression": c} if c else {})), "opens")
        for c in (None, "tiff_adobe_deflate", "packbits", "tiff_lzw")
    },
    "pil-jpeg-in-tiff": ("jpeg.tiff", _pil(compression="jpeg", quality=95), "opens"),
    "jpeg-tiled-aperio": ("a.svs", _pyramid(levels=3, tile=64, compression=7, description=APERIO), "opens"),
    "jpeg-strips": ("s.tiff", _pyramid(levels=2, tile=None, compression=7), "opens"),
    "jpeg-shared-tables": (
        "shared.svs", _writer((CANVAS, dict(tile=64, compression=7, shared_jpeg_tables=True))), "opens"
    ),
    **{
        f"predictor2-strips-c{c}": ("p2.tiff", _writer((CANVAS, dict(compression=c, predictor=2))), "opens")
        for c in (1, 8)
    },
    "j2k-33005-tiled": ("j2k.svs", _pyramid(levels=2, tile=64, compression=33005), "opens"),
    "j2k-33005-strips": ("j2k.svs", _pyramid(levels=2, tile=None, compression=33005), "opens"),
    "j2k-33003-ycbcr": ("ycc.svs", _j2k_ycbcr, "opens"),
    "j2k-34712": ("std.tiff", _pyramid(levels=1, tile=64, compression=34712), "opens"),
    "bigtiff": ("big.tiff", lambda p: write_bigtiff_single_level(p, _rand(15, 96, 160)), "opens"),
    "bigendian": ("be.tiff", lambda p: write_bigendian_single_level(p, _rand(16, 96, 160)), "opens"),
    "palette": ("pal.tiff", _pil_image(lambda: Image.fromarray(CANVAS).quantize(colors=200)), "opens"),
    "palette-lzw": (
        "pal.tiff",
        _pil_image(lambda: Image.fromarray(CANVAS).quantize(colors=64), compression="tiff_lzw"),
        "opens",
    ),
    "gray-alpha": (
        "la.tiff",
        _pil_image(lambda: Image.fromarray(np.stack(
            [np.asarray(Image.fromarray(CANVAS).convert("L")), np.full(CANVAS.shape[:2], 255, np.uint8)],
            axis=-1), mode="LA")),
        "opens",
    ),
    "refuse-16bit": (
        "deep.tiff",
        _pil_image(lambda: Image.fromarray(
            (np.arange(96 * 128, dtype=np.uint32).reshape(96, 128) % 65536).astype(np.uint16), mode="I;16")),
        "refused",
    ),
    "refuse-cmyk": ("cmyk.tiff", _pil_image(lambda: Image.fromarray(CANVAS).convert("CMYK")), "refused"),
    "ome-subifd": (
        "s.ome.tiff", lambda p: write_ome_pyramid(p, CANVAS, levels=3, physical_size_x=0.25, mag=40.0), "opens"
    ),
    "ome-nm": ("nm.ome.tiff", lambda p: write_ome_pyramid(p, CANVAS, levels=1, physical_size_x=500.0, unit="nm"),
               "opens"),
    "ome-siblings": ("m.ome.tiff", lambda p: write_ome_pyramid(p, CANVAS, levels=2, extra_planes=2), "opens"),
    "mpp-free-text": ("b.tiff", _pyramid(tile=64, description="scanner image mpp=0.25 something"), "opens"),
    "mpp-resolution-tags": ("c.tiff", _pyramid(tile=64, resolution=(40000.0, 40000.0, 3)), "opens"),
    "mpp-72dpi-with-appmag": (
        "dpi_mag.svs",
        _pyramid(tile=64, resolution=(72.0, 72.0, 2), description="Aperio Image Library\r\n256x192 | AppMag = 40"),
        "opens",
    ),
    "mpp-72dpi-only": ("dpi.tiff", _pyramid(tile=64, resolution=(72.0, 72.0, 2)), "opens"),
    "rational-zero-count": (
        "r0.tiff", _patched(_pyramid(levels=1, tile=64, resolution=(40000.0, 40000.0, 3)), 0, 283, count=0), "opens"
    ),
    "tiled-dims-beyond-coverage": (
        "wide.svs",
        _patched(_pyramid(image=_rand(9, 160, 224), levels=2, tile=64, compression=7), 0, 256, value=50_000_000),
        "either",
    ),
    "absurd-tile-dims": (
        "tile.svs",
        _patched(_pyramid(image=_rand(10, 160, 224), levels=2, tile=64, compression=7), 1, 323, value=1 << 20),
        "either",
    ),
    "byte-count-beyond-eof": ("count.tiff", _huge_first_tile_count, "either"),
    "striped-jpeg-giant-width": (
        "giant.tiff",
        _patched(_pyramid(image=_rand(12, 64, 96), levels=1, tile=None, compression=7), 0, 256, value=1 << 26),
        "either",
    ),
    "giant-strip-width": (
        "strip.tiff",
        _patched(_pyramid(image=_rand(13, 96, 128), levels=1, tile=None, compression=8), 0, 256,
                 value=167_772_288),
        "either",
    ),
    "single-strip-giant-height": ("tall.ndpi", _giant_height_ndpi, "either"),
    "single-strip-giant-width-bad-header": ("wide.ndpi", _giant_width_bad_header_ndpi, "either"),
    **{f"fuzz-truncated-{f}": ("t.tiff", _fuzzed(_DEFLATE2, 5, truncate=f), "either") for f in (0.02, 0.3, 0.8)},
    "fuzz-header-then-noise": ("n.tiff", _fuzzed(_DEFLATE2, 5, noise=True), "either"),
    **{f"fuzz-deflate-flips-{s}": ("f.tiff", _fuzzed(_DEFLATE2, s, flips=40 + 20 * s), "either") for s in range(4)},
    **{f"fuzz-jpeg-flips-{s}": ("f.svs", _fuzzed(_JPEG2, 100 + s, flips=30 + 15 * s), "either") for s in range(4)},
}

# Cases opened again with a user-provided mpp (the ladder's first rung).
USER_MPP = {"jpeg-tiled-aperio": 1.0, "mpp-72dpi-only": 0.5}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tiff_cases")


def _build(case_dir: Path, name: str) -> tuple[Path, str]:
    file_name, build, expect = CASES[name]
    d = case_dir / name
    if not d.exists():
        d.mkdir()
        build(d / file_name)
    return d / file_name, expect


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_file_matches_jax(case_dir, name):
    path, expect = _build(case_dir, name)
    want = native_tiff_record(jax_native.AtlasTiffFile, path)
    got = native_tiff_record(port_native.AtlasTiffFile, path)
    assert_same_record(want, got, name)
    if expect == "opens":
        assert "open" not in got and got["levels"] >= 1
        assert not isinstance(got[0, "whole"], tuple), got[0, "whole"]
    elif expect == "refused":
        assert got["open"][:2] == ("raised", "RuntimeError")
        assert "no decodable pyramid levels" in got["open"][2]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiff_wsi_matches_jax(case_dir, name):
    path, expect = _build(case_dir, name)
    for mpp in (None, USER_MPP.get(name)) if name in USER_MPP else (None,):
        want = wsi_record(JaxTiffWSI, path, mpp)
        got = wsi_record(PortTiffWSI, path, mpp)
        assert_same_record(want, got, f"{name} mpp={mpp}")
        if expect == "opens":
            assert "open" not in got and not isinstance(got["thumb"], tuple), got.get("open")


def test_wsi_ladder_values(case_dir):
    """The ladder's rungs land where tests/test_native_tiff.py pins them."""
    expect = {
        "jpeg-tiled-aperio": (0.499, 20),
        "mpp-free-text": (0.25, 40),
        "mpp-resolution-tags": (0.25, 40),
        "mpp-72dpi-with-appmag": (0.25, 40),
        "mpp-72dpi-only": (None, None),
        "ome-subifd": (0.25, 40),
        "ome-nm": (0.5, 20),
    }
    for name, (mpp, mag) in expect.items():
        rec = wsi_record(PortTiffWSI, _build(case_dir, name)[0])
        assert (rec["mpp"], rec["mag"]) == (mpp, mag), name
    assert wsi_record(PortTiffWSI, _build(case_dir, "jpeg-tiled-aperio")[0], 1.0)["mpp"] == 1.0


def _jpeg_stream(kind: str) -> bytes:
    img = make_tissue_canvas(200, 136, seed=21, n_blobs=2)
    buf = io.BytesIO()
    if kind == "gray":
        Image.fromarray(img).convert("L").save(buf, "JPEG", quality=90)
    elif kind == "progressive":
        Image.fromarray(img).save(buf, "JPEG", quality=90, progressive=True)
    elif kind == "restarts-420":
        return _jpeg_with_restarts(img, rows=1, subsampling=2)
    else:
        Image.fromarray(img).save(buf, "JPEG", quality=90, subsampling={"444": 0, "420": 2}[kind])
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["444", "420", "gray", "progressive", "restarts-420"])
def test_standalone_jpeg_matches_jax(kind):
    """jpeg_image_info / jpeg_decode at every IDCT scale, and
    jpeg_decode_window over interior, edge and out-of-range windows (the
    MIRAX / Hamamatsu / DICOM tile paths), plus corrupted streams."""
    stream = _jpeg_stream(kind)
    rng = np.random.default_rng(7)
    corrupt = bytearray(stream)
    for _ in range(20):
        corrupt[rng.integers(2, len(corrupt))] ^= 1 << rng.integers(0, 8)
    for data in (stream, bytes(corrupt), stream[: len(stream) // 2]):
        for s in (1, 2, 4, 8):
            for fn in ("jpeg_image_info", "jpeg_decode"):
                want = outcome(lambda: getattr(jax_native, fn)(data, s))
                assert_same_record(want, outcome(lambda: getattr(port_native, fn)(data, s)), f"{fn} {s}")
            for win in ((0, 0, 24, 16), (5, 9, 17, 11), (13, 3, 8, 4), (0, 0, 400, 400), (-1, 0, 4, 4)):
                want = outcome(lambda: jax_native.jpeg_decode_window(data, s, *win))
                got = outcome(lambda: port_native.jpeg_decode_window(data, s, *win))
                assert_same_record(want, got, f"window {s} {win}")
    full = port_native.jpeg_decode(stream, 2)
    np.testing.assert_array_equal(port_native.jpeg_decode_window(stream, 2, 5, 9, 17, 11), full[9:20, 5:22])


@pytest.mark.parametrize("spp,force_ycbcr", [(3, False), (3, True), (1, False)])
def test_j2k_decode_rgb_matches_jax(spp, force_ycbcr):
    """j2k_decode_rgb (the DICOM .4.90/.4.91 frames) on lossless codestreams."""
    img = _rand(31, 48, 64)[..., :spp]
    stream = _j2k_encode_lossless(img)
    want = jax_native.j2k_decode_rgb(stream, 64, 48, spp, force_ycbcr)
    got = port_native.j2k_decode_rgb(stream, 64, 48, spp, force_ycbcr)
    assert_same_record(want, got)
    if not force_ycbcr:
        np.testing.assert_array_equal(got.reshape(img.shape), img)
    bad = outcome(lambda: port_native.j2k_decode_rgb(stream[:40], 64, 48, spp, force_ycbcr))
    assert_same_record(outcome(lambda: jax_native.j2k_decode_rgb(stream[:40], 64, 48, spp, force_ycbcr)), bad)


@pytest.fixture(scope="module")
def cache_slide(tmp_path_factory) -> Path:
    path = tmp_path_factory.mktemp("cache") / "s.svs"
    write_pyramid(path, make_tissue_canvas(1024, 768, seed=3, n_blobs=3), levels=2, tile=128,
                  compression=7, description="Aperio|AppMag = 20|MPP = 0.5")
    return path


@pytest.mark.parametrize("cache_mb", ["0", "1", "4", "32"])
def test_chunk_cache_concurrent_reads_match_jax(cache_slide, monkeypatch, cache_mb):
    """tests/test_chunk_cache.py's case: overlapping unaligned reads, serial
    and from 8 threads, through the port's decoded-chunk LRU at several caps,
    equal the JAX decoder's uncached reads."""
    monkeypatch.setenv("ATLASPATCH_TIFF_CACHE_MB", "0")
    ref = jax_native.AtlasTiffFile(str(cache_slide))
    monkeypatch.setenv("ATLASPATCH_TIFF_CACHE_MB", cache_mb)
    f = port_native.AtlasTiffFile(str(cache_slide))
    W, H = f.dimensions
    rng = np.random.default_rng(0)
    boxes = [(int(rng.integers(0, W - 160)), int(rng.integers(0, H - 160))) for _ in range(48)]
    boxes += [(x, y) for y in range(0, H - 200, 96) for x in range(0, W - 200, 96)]
    want = [ref.read_region_level(0, x, y, 160, 160) for x, y in boxes]
    serial = [f.read_region_level(0, x, y, 160, 160) for x, y in boxes]
    with ThreadPoolExecutor(max_workers=8) as ex:
        parallel = list(ex.map(lambda b: f.read_region_level(0, b[0], b[1], 160, 160), boxes))
    f.close()
    ref.close()
    for a, b, c in zip(want, serial, parallel):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_decoder_is_the_ports_own_library():
    """The port's readers load atlas_tiff built from atlaspatch_tpu_torch/csrc,
    never the JAX package's libatlas_native.so."""
    info = port_native.tiff_library_info()
    lib = Path(info["library"])
    assert lib.parent == Path(port_native.__file__).resolve().parent.parent / "_build"
    assert lib.name.startswith("libatlas_tiff-")
    assert Path(info["jpeg_headers"]) == port_native.VENDORED_LIBJPEG
    mapped = Path(f"/proc/{os.getpid()}/maps").read_text()
    assert str(lib) in mapped


def test_library_name_hashes_its_headers(tmp_path, monkeypatch):
    """An edit to a header that a source includes from csrc/ (as the
    vendored libjpeg headers are) builds a new library, never loads the old."""
    from atlaspatch_tpu_torch import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    header = tmp_path / "answer.h"
    source = tmp_path / "answer.cc"
    source.write_text('#include "answer.h"\nextern "C" int answer() { return ANSWER; }\n')
    command = ["g++", "-O0", "-shared", "-fPIC", "-I", str(tmp_path)]
    built = []
    for value in (41, 42):
        header.write_text(f"#define ANSWER {value}\n")
        built.append(build.build_shared_library("answer", [source], command, headers=[header]))
    assert built[0] != built[1]
    assert [ctypes.CDLL(str(lib)).answer() for lib in built] == [41, 42]


def test_vendored_libjpeg_route_matches(case_dir, tmp_path):
    """The build used where the system has no libjpeg.so.62: the vendored
    libjpeg-turbo headers, linked by absolute path to the libjpeg that
    Pillow's wheel bundles. Run in a fresh process; its reads of an
    Aperio-style JPEG pyramid (whole, interior and IDCT-scaled) and of a
    windowed standalone stream equal the JAX decoder's, which links the
    system libjpeg: this is the check of the decoder across two libjpegs."""
    path, _ = _build(case_dir, "jpeg-tiled-aperio")
    stream = _jpeg_stream("420")
    (tmp_path / "s.jpg").write_bytes(stream)
    script = textwrap.dedent(
        f"""
        import numpy as np
        from atlaspatch_tpu_torch.io import native
        native._system_library = lambda soname: None
        info = native.tiff_library_info()
        assert info["jpeg_headers"].endswith("vendor/libjpeg"), info
        assert "pillow.libs" in info["libjpeg"], info
        f = native.AtlasTiffFile({str(path)!r})
        data = open({str(tmp_path / 's.jpg')!r}, "rb").read()
        np.savez({str(tmp_path / 'out.npz')!r},
                 whole=f.read_region_level(0, 0, 0, 512, 384),
                 inner=f.read_region_level(1, 33, 21, 97, 61),
                 scaled=f.read_region_level_scaled(0, 0, 0, 512, 384, 4),
                 window=native.jpeg_decode_window(data, 2, 5, 9, 17, 11))
        """
    )
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(tmp_path / "out.npz")
    ref = jax_native.AtlasTiffFile(str(path))
    np.testing.assert_array_equal(got["whole"], ref.read_region_level(0, 0, 0, 512, 384))
    np.testing.assert_array_equal(got["inner"], ref.read_region_level(1, 33, 21, 97, 61))
    np.testing.assert_array_equal(got["scaled"], ref.read_region_level_scaled(0, 0, 0, 512, 384, 4))
    np.testing.assert_array_equal(got["window"], jax_native.jpeg_decode_window(stream, 2, 5, 9, 17, 11))
    ref.close()


def test_decoder_matches_pillow(tmp_path):
    """The port's decoder against Pillow's decode of the same bytes, as
    chip_smoke.py's tiff phase checks it on the card: a level-0 region and the
    --fast thumbnail (IDCT 1/4 of level 2) of bench.py's JPEG SVS layout, and
    a 33003 J2K tile (Pillow's openjpeg, then libjpeg's fixed-point YCbCr to
    RGB). The bar, measured here: max-abs 0."""
    from atlaspatch_tpu_torch.io.factory import WSIFactory
    from atlaspatch_tpu_torch.tools.pillow_check import j2k_ycbcr_tile, tiled_region

    svs = tmp_path / "f1.svs"
    write_pyramid(svs, make_tissue_canvas(2048, 1536, seed=100, n_blobs=3), levels=3, tile=256, compression=7,
                  description="Aperio Image Library v12\r\n2048x1536 | AppMag = 20 | MPP = 0.5")
    j2k = tmp_path / "j2k.svs"
    write_pyramid(j2k, rgb_to_full_range_ycbcr(make_tissue_canvas(512, 512, seed=300, n_blobs=2)), levels=1,
                  tile=256, compression=33003)
    f = port_native.AtlasTiffFile(str(svs))
    wsi = WSIFactory.load(str(svs))
    pairs = [
        (f.read_region_level(0, 256, 256, 512, 512), tiled_region(svs, 0, 256, 256, 512, 512)),
        (np.asarray(wsi.get_thumbnail_at_power(power=1.25, scaled_decode=True)),
         tiled_region(svs, 2, 0, 0, 512, 384, scale=4)),
        (port_native.AtlasTiffFile(str(j2k)).read_region_level(0, 256, 0, 256, 256), j2k_ycbcr_tile(j2k, 0, 1)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() == 0
    assert pairs[1][0].shape == (96, 128, 3)
    f.close()
    wsi.cleanup()
