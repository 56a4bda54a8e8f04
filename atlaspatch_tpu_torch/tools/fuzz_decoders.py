"""Out-of-process fuzz campaign over the port's slide decoders.

The port's counterpart of ``tools/fuzz_decoders.py``: the same 24-format
corpus and the same mutations (``_mutate`` / ``_mutate_tiff_entry``), so a
seed gives the same bytes in both tools, and a finding replays through the
reference's tool with ``--formats X --seed S --cases 1``. Here every case
opens the mutated file through ``atlaspatch_tpu_torch.io.factory.WSIFactory``
(the port's ``atlas_tiff`` build of ``csrc/atlas_tiff.cc`` and
``csrc/atlas_j2k.cc``, and its Python readers) in fork-isolated batches, so
that a crash (death by signal) or a hang is recorded with its seed and the
campaign goes on. Crashing and hanging inputs are copied to the report
directory for replay.

Usage:
    python -m atlaspatch_tpu_torch.tools.fuzz_decoders [--cases 500]
        [--formats svs_jpeg,mirax_index] [--out DIR] [--seed 0]

Every open that survives must also serve bounded reads (extract + thumbnail).
A clean Python exception is a pass; death by signal, a hang, or a child that
exits nonzero is a finding (exit code 1). A case slower than ``SOFT_HANG_S``
is logged as a soft hang with its seed, as is one the per-case alarm stops.

The builders are the test suite's synthetic writers (``tests/tiff_builder.py``,
``tests/container_builders.py``; the vendor ones are copied below, since
``tests/test_vendor_formats.py`` imports the JAX package), so every format
the factory registers is represented, the vendor TIFF flavours (NDPI striped
JPEG, SCN collections, Ventana BIF join overlaps, Philips UFS, Trestle) and
the non-TIFF containers (MIRAX, VMS, VMU, DICOM) included. This tool imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import io
import json
import multiprocessing as mp
import shutil
import signal
import struct
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]

CASE_TIMEOUT_S = 20  # per-case alarm inside the child (catches decode loops)
SOFT_HANG_S = 5  # a case slower than this is logged as a soft hang
BATCH = 50  # cases per forked child


# --------------------------------------------------------------------- corpus
def _rgb(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    return np.kron(base, np.ones((8, 8, 1), np.uint8))[:h, :w]


def _smooth_rgb(w: int, h: int) -> np.ndarray:
    """Low-frequency pattern, so JPEG round trips stay close
    (``tests/test_container_formats.py::smooth_rgb``)."""
    yy, xx = np.mgrid[0:h, 0:w]
    r = (128 + 100 * np.sin(xx / 37.0)).astype(np.uint8)
    g = (128 + 100 * np.cos(yy / 29.0)).astype(np.uint8)
    b = ((xx + yy) % 256).astype(np.uint8) // 2 + 64
    return np.stack([r, g, b.astype(np.uint8)], axis=-1)


# The vendor builders of tests/test_vendor_formats.py, byte for byte the same files.
NDPI_MAGIC = 65420
NDPI_SOURCE_LENS = 65421

PHILIPS_XML = (
    '<DataObject ObjectType="DPUfsImport">'
    '<Attribute Name="PIM_DP_IMAGE_TYPE" PMSVR="IString">WSI</Attribute>'
    '<Attribute Name="DICOM_PIXEL_SPACING" Group="0x0028" Element="0x0030" '
    'PMSVR="IDoubleArray">&quot;0.00025&quot; &quot;0.00025&quot;</Attribute>'
    "</DataObject>"
)


def _scn_xml(macro_wh, main_dims, objective) -> str:
    (mw, mh) = macro_wh
    dims = "\n".join(
        f'<dimension sizeX="{w}" sizeY="{h}" r="{r}" ifd="{ifd}"/>'
        for r, (w, h, ifd) in enumerate(main_dims)
    )
    return f"""<?xml version="1.0" encoding="utf-8"?>
<scn xmlns="http://www.leica-microsystems.com/scn/2010/10/01">
<collection sizeX="20000000" sizeY="15000000">
<image name="macro" uuid="u1">
<pixels sizeX="{mw}" sizeY="{mh}">
<dimension sizeX="{mw}" sizeY="{mh}" r="0" ifd="0"/>
</pixels>
<view sizeX="20000000" sizeY="15000000" offsetX="0" offsetY="0"/>
<scanSettings><objectiveSettings><objective>0.8</objective></objectiveSettings></scanSettings>
</image>
<image name="region" uuid="u2">
<pixels sizeX="{main_dims[0][0]}" sizeY="{main_dims[0][1]}">
{dims}
</pixels>
<view sizeX="4000000" sizeY="3000000" offsetX="2000000" offsetY="1000000"/>
<scanSettings><objectiveSettings><objective>{objective}</objective></objectiveSettings></scanSettings>
</image>
</collection>
</scn>"""


def _jpeg_with_restarts(img, *, rows=None, blocks=None, subsampling=0, quality=95) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    kw = {"quality": quality, "subsampling": subsampling}
    if blocks is not None:
        kw["restart_marker_blocks"] = blocks
    else:
        kw["restart_marker_rows"] = rows
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _zero_sof_dims(jpeg: bytes) -> bytes:
    """Zero the SOF height/width, as NDPI writers do beyond 65,535 px."""
    data = bytearray(jpeg)
    i = data.find(b"\xff\xc0")
    if i < 0:
        raise ValueError("no SOF0 marker in the JPEG stream")
    data[i + 5 : i + 9] = b"\x00\x00\x00\x00"
    return bytes(data)


def _write_single_strip_ndpi(path, stream, w, h, lens=40.0) -> None:
    from tiff_builder import TYPE_FLOAT, TYPE_LONG, TiffWriter

    tw = TiffWriter()
    tw.add_level_raw_strips(
        [stream], width=w, height=h, rows_per_strip=h,
        extra_tags=[(NDPI_MAGIC, TYPE_LONG, [1]), (NDPI_SOURCE_LENS, TYPE_FLOAT, [lens])],
    )
    tw.save(path)


def _bif_joint_xmp(joints) -> str:
    """BIF XMP: an iScan element and AoiJoinInfo TileJointInfo elements,
    (direction, confidence, overlap_x, overlap_y) each."""
    els = "".join(
        f'<TileJointInfo Tile1="{i + 1}" Tile2="{i + 2}" Direction="{d}" '
        f'Confidence="{conf}" OverlapX="{ox}" OverlapY="{oy}" />'
        for i, (d, conf, ox, oy) in enumerate(joints)
    )
    return (
        '<?xpacket begin="" id="W5M0MpCehiHzreSzNTczkc9d"?>'
        '<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF>'
        '<iScan xmlns="http://ventana.com/iscan/1.0" UnitNumber="1" '
        'Magnification="40" ScanRes="0.25" />'
        f"<AoiJoinInfo>{els}</AoiJoinInfo>"
        "</rdf:RDF></x:xmpmeta><?xpacket end=\"w\"?>"
    )


def _overlapping_bif(root: Path, *, tile=64, overlap=16, cols=4, rows=3, seed=53) -> Path:
    """A BIF whose base tiles overlap by ``overlap`` px, with junk in each
    tile's strips that a right or lower neighbour paints over."""
    from tiff_builder import TYPE_ASCII, TiffWriter

    rng = np.random.default_rng(seed)
    adv = tile - overlap
    truth = rng.integers(0, 256, size=((rows - 1) * adv + tile, (cols - 1) * adv + tile, 3), dtype=np.uint8)
    mosaic = np.zeros((rows * tile, cols * tile, 3), np.uint8)
    for r in range(rows):
        for c in range(cols):
            t = truth[r * adv : r * adv + tile, c * adv : c * adv + tile].copy()
            if c < cols - 1:
                t[:, adv:] = rng.integers(0, 256, (tile, overlap, 3), np.uint8)
            if r < rows - 1:
                t[adv:, :] = rng.integers(0, 256, (overlap, tile, 3), np.uint8)
            mosaic[r * tile : (r + 1) * tile, c * tile : (c + 1) * tile] = t
    joints = [
        ("RIGHT", 99, overlap - 0.5, 0.3),
        ("RIGHT", 97, overlap + 0.5, -0.1),
        ("UP", 98, 0.2, overlap + 0.25),
        ("UP", 96, -0.4, overlap - 0.25),
        ("RIGHT", 0, tile - 1, tile - 1),  # unmatched joint: junk overlaps at confidence 0
    ]
    overview = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    w = TiffWriter()
    w.add_level(overview, extra_tags=[(700, TYPE_ASCII, [_bif_joint_xmp(joints)])])
    w.add_level(mosaic, tile=tile)
    w.add_level(truth[::2, ::2].copy(), tile=tile)
    path = root / "aoi.bif"
    w.save(path)
    return path


def build_corpus(root: Path) -> dict[str, tuple[Path, Path]]:
    """name -> (open_path, mutate_target): the reference tool's 24 formats,
    byte for byte its files. Slides are small on purpose: the parser and
    geometry attack surface is in the structure, not the pixel count."""
    if str(REPO / "tests") not in sys.path:
        sys.path.insert(0, str(REPO / "tests"))
    import container_builders as cb
    from PIL import Image
    from tiff_builder import (
        TYPE_ASCII,
        TiffWriter,
        rgb_to_full_range_ycbcr,
        write_bigendian_single_level,
        write_bigtiff_single_level,
        write_ome_pyramid,
        write_pyramid,
    )

    rng = np.random.default_rng(7)
    corpus: dict[str, tuple[Path, Path]] = {}

    def add(name: str, open_path: Path, target: Path | None = None) -> None:
        corpus[name] = (open_path, target or open_path)

    d = root / "slides"
    d.mkdir(parents=True, exist_ok=True)

    # Plain + compressed TIFF pyramids through the Aperio-style description.
    p = d / "a.svs"
    write_pyramid(p, _rgb(rng, 160, 224), levels=2, tile=64, compression=7,
                  description="Aperio Fake |AppMag = 20|MPP = 0.5|")
    add("svs_jpeg", p)
    p = d / "a347.svs"  # shared JPEGTables (tag 347, abbreviated streams)
    w = TiffWriter()
    w.add_level(_rgb(rng, 160, 224), tile=64, compression=7, shared_jpeg_tables=True,
                description="Aperio Fake |AppMag = 20|MPP = 0.5|")
    w.save(p)
    add("svs_jpegtables", p)
    p = d / "b.tiff"
    write_pyramid(p, _rgb(rng, 128, 160), levels=2, tile=None, compression=8)
    add("tiff_deflate_strips", p)
    p = d / "c.tiff"
    write_pyramid(p, _rgb(rng, 96, 128), levels=1, tile=None, compression=32773)
    add("tiff_packbits", p)
    p = d / "c2.tiff"
    w = TiffWriter()
    w.add_level(_rgb(rng, 96, 128), compression=8, predictor=2)
    w.save(p)
    add("tiff_deflate_pred2", p)
    p = d / "lzw.tif"  # LZW comes from Pillow; the suite's builder does not emit it
    Image.fromarray(_rgb(rng, 96, 128)).save(p, compression="tiff_lzw")
    add("tiff_lzw", p)
    p = d / "pal.tif"  # palette colour (photometric 3 + ColorMap lookup)
    Image.fromarray(_rgb(rng, 96, 128)).quantize(colors=120).save(p)
    add("tiff_palette", p)
    p = d / "o.ome.tiff"  # SubIFD pyramid + OME-XML metadata
    write_ome_pyramid(p, _rgb(rng, 128, 96), levels=2, physical_size_x=0.5, mag=20.0, extra_planes=1)
    add("ome_subifd", p)
    p = d / "big.tiff"
    write_bigtiff_single_level(p, _rgb(rng, 96, 160))
    add("bigtiff", p)
    p = d / "be.tiff"
    write_bigendian_single_level(p, _rgb(rng, 96, 160))
    add("tiff_bigendian", p)

    # Aperio JPEG 2000 flavours (33005 RGB components, 33003 YCbCr components).
    p = d / "j2k_rgb.svs"
    write_pyramid(p, _rgb(rng, 128, 128), levels=1, tile=64, compression=33005,
                  description="Aperio |MPP = 0.25|")
    add("svs_j2k_rgb", p)
    p = d / "j2k_ycc.svs"
    write_pyramid(p, rgb_to_full_range_ycbcr(_rgb(rng, 128, 128)), levels=1, tile=64, compression=33003,
                  description="Aperio |MPP = 0.25|")
    add("svs_j2k_ycbcr", p)

    # NDPI giant single-strip JPEG with restart markers + SourceLens tags.
    stream = _jpeg_with_restarts(_rgb(rng, 96, 256), rows=2)
    p = d / "n.ndpi"
    _write_single_strip_ndpi(p, _zero_sof_dims(stream), 256, 96)
    add("ndpi_striped", p)

    # Leica SCN collection (macro + region pyramid).
    main = _rgb(rng, 96, 128)
    w = TiffWriter()
    w.add_level(_rgb(rng, 100, 60), description=_scn_xml((60, 100), [(128, 96, 1), (64, 48, 2)], 40))
    w.add_level(main, resolution=(40000.0, 40000.0, 3))
    w.add_level(main[::2, ::2].copy())
    p = d / "s.scn"
    w.save(p)
    add("scn", p)

    # Ventana BIF with AOI join overlaps (positioned painter in play).
    add("bif_joints", _overlapping_bif(d))

    # Philips TIFF with UFS XML.
    w = TiffWriter()
    w.add_level(_rgb(rng, 192, 256), tile=128, description=PHILIPS_XML,
                extra_tags=[(305, TYPE_ASCII, ["Philips DP v1.0"])])
    w.add_level(_rgb(rng, 96, 128), tile=128)
    p = d / "ph.tiff"
    w.save(p)
    add("philips", p)

    # Trestle .tif with per-level OverlapsXY (overlap-corrected canvases).
    w = TiffWriter()
    w.add_level(_rgb(rng, 192, 256), tile=64,
                description="Background Color=FFFFFF;OverlapsXY=16 8 4 2;Objective Power=20",
                extra_tags=[(305, TYPE_ASCII, ["MedScan"])])
    w.add_level(_rgb(rng, 96, 128), tile=64)
    p = d / "tr.tif"
    w.save(p)
    add("trestle", p)

    # Non-TIFF containers.
    p = cb.write_mirax(d / "m.mrxs", _smooth_rgb(128, 96), tile_w=64, tile_h=48, n_levels=2)
    add("mirax_index", p, p.with_suffix("") / "Index.dat")
    add("mirax_slidedat", p, p.with_suffix("") / "Slidedat.ini")
    data0 = next(p.with_suffix("").glob("Data*.dat"), None)
    if data0 is not None:
        add("mirax_data", p, data0)
    p = cb.write_vms(d / "v.vms", _smooth_rgb(128, 128))
    jpg = next(iter(sorted(d.glob("v_*.jpg"))), None)
    if jpg is not None:
        add("vms_jpeg", p, jpg)
    p = cb.write_vmu(d / "u.vmu", _smooth_rgb(128, 64), column_width=32)
    add("vmu_ngr", p, p.parent / "u.ngr")
    p = cb.write_dicom_level(d / "dj.dcm", _smooth_rgb(128, 64), tile=64)
    add("dicom", p)
    p = cb.write_dicom_level(d / "dk.dcm", _smooth_rgb(128, 64), tile=64, codec="j2k")
    add("dicom_j2k", p)
    return corpus


# ------------------------------------------------------------------ mutations
_INTERESTING_U32 = [0, 1, 2, 63, 64, 2**16, 2**24, 2**26, 2**30, 2**31, 2**32 - 1]


def _mutate_tiff_entry(rng: np.random.Generator, raw: bytearray) -> bool:
    """Structure-aware mutation: scramble one IFD entry's type, count or value
    in a classic little-endian TIFF (a tag that still parses but declares
    garbage: the shape of every stall the byte-level campaign found)."""
    if bytes(raw[:4]) != b"II*\x00":
        return False
    try:
        off = struct.unpack_from("<I", raw, 4)[0]
        ifds = []
        for _ in range(8):
            if not (8 <= off <= len(raw) - 6):
                break
            n = struct.unpack_from("<H", raw, off)[0]
            if n == 0 or off + 2 + 12 * n + 4 > len(raw):
                break
            ifds.append((off, n))
            off = struct.unpack_from("<I", raw, off + 2 + 12 * n)[0]
            if off == 0:
                break
        if not ifds:
            return False
        ioff, n = ifds[int(rng.integers(0, len(ifds)))]
        eoff = ioff + 2 + 12 * int(rng.integers(0, n))
        field = int(rng.integers(0, 3))
        if field == 0:  # type
            struct.pack_into("<H", raw, eoff + 2, int(rng.integers(0, 20)))
        elif field == 1:  # count
            struct.pack_into("<I", raw, eoff + 4, int(rng.choice(_INTERESTING_U32)))
        else:  # inline value / data offset
            struct.pack_into("<I", raw, eoff + 8, int(rng.choice(_INTERESTING_U32 + [len(raw) - 1])))
        return True
    except Exception:  # noqa: BLE001 — a mutation that does not apply is no mutation
        return False


def _mutate(rng: np.random.Generator, original: bytes) -> bytes:
    raw = bytearray(original)
    kind = rng.integers(0, 12)
    if kind >= 10:  # structured TIFF-entry mutation (1-2 entries)
        hit = _mutate_tiff_entry(rng, raw)
        if hit and rng.integers(0, 2):
            _mutate_tiff_entry(rng, raw)
        if hit:
            return bytes(raw)
        kind = rng.integers(0, 10)  # non-TIFF target: fall through
    if kind == 0 and len(raw) > 8:  # truncate
        return bytes(raw[: int(rng.integers(4, len(raw)))])
    if kind == 1:  # append garbage
        return bytes(raw) + bytes(rng.integers(0, 256, int(rng.integers(1, 512)), np.uint8))
    if kind == 2 and len(raw) > 64:  # zero a run
        pos = int(rng.integers(0, len(raw) - 32))
        n = int(rng.integers(4, 32))
        raw[pos : pos + n] = b"\x00" * n
        return bytes(raw)
    if kind == 3 and len(raw) > 64:  # duplicate a slice elsewhere
        a = int(rng.integers(0, len(raw) - 32))
        b = int(rng.integers(0, len(raw) - 32))
        raw[b : b + 16] = raw[a : a + 16]
        return bytes(raw)
    if kind == 4 and len(raw) > 16:  # interesting int32 at an aligned offset
        # Binary containers (MIRAX Index.dat, DICOM, TIFF value arrays) keep
        # counts and offsets as aligned little-endian ints; boundary constants
        # there find size-validation gaps that random flips rarely reach.
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(0, (len(raw) - 4) // 4)) * 4
            struct.pack_into("<i", raw, pos, int(rng.choice([0, 1, -1, 2**16, 2**24, 2**31 - 1, -2**31])))
        return bytes(raw)
    for _ in range(int(rng.integers(1, 16))):  # byte flips (default)
        raw[int(rng.integers(0, len(raw)))] = int(rng.integers(0, 256))
    return bytes(raw)


# ---------------------------------------------------------------------- child
def _raise_timeout(signum, frame):  # noqa: ARG001
    raise TimeoutError("case exceeded alarm")


def run_case(open_path: str) -> None:
    """One case: open through the port's factory, then bounded reads."""
    from atlaspatch_tpu_torch.io.factory import WSIFactory

    wsi = None
    try:
        wsi = WSIFactory().load(open_path, mpp=0.5)
        wsi.extract((0, 0), 0, (16, 16))
        wsi.get_thumb((32, 32))
    finally:
        if wsi is not None:
            try:
                wsi.cleanup()
            except Exception:  # noqa: BLE001 — the case's outcome stands
                pass


def run_batch(open_path: str, target_path: str, original: bytes,
              seeds: list[int], status_path: str, hang_log: str) -> None:
    """Child body: run each seed's case; write the seed to status_path BEFORE
    acting so the parent can attribute a signal death."""
    signal.signal(signal.SIGALRM, _raise_timeout)
    target = Path(target_path)
    status = Path(status_path)
    for seed in seeds:
        status.write_text(str(seed))
        target.write_bytes(_mutate(np.random.default_rng(seed), original))
        signal.alarm(CASE_TIMEOUT_S)
        t0 = time.monotonic()
        try:
            run_case(open_path)
        except TimeoutError:
            pass
        except Exception:  # noqa: BLE001 — a clean failure is the contract
            pass
        finally:
            signal.alarm(0)
        took = time.monotonic() - t0
        if took > SOFT_HANG_S:
            with open(hang_log, "a") as f:
                f.write(json.dumps({"seed": seed, "hang_s": round(took, 3)}) + "\n")
    status.write_text("done")


# --------------------------------------------------------------------- parent
def fuzz_format(name: str, open_path: Path, target: Path, cases: int,
                base_seed: int, report_dir: Path) -> dict:
    original = target.read_bytes()
    status_path = report_dir / f"{name}.status"
    hang_log = report_dir / f"{name}.hangs.jsonl"
    hang_log.unlink(missing_ok=True)
    findings: list[dict] = []
    t0 = time.monotonic()
    done = 0
    ctx = mp.get_context("fork")  # the parent has imported and loaded the decoder, and runs no thread
    while done < cases:
        seeds = [base_seed + done + i for i in range(min(BATCH, cases - done))]
        proc = ctx.Process(target=run_batch, args=(str(open_path), str(target), original, seeds,
                                                   str(status_path), str(hang_log)))
        proc.start()
        proc.join(timeout=CASE_TIMEOUT_S * len(seeds) + 60)
        kind = None
        if proc.is_alive():  # a batch-level hang the alarm did not catch
            proc.kill()
            proc.join(10)
            kind = "hard-hang"
        elif proc.exitcode != 0:
            kind = "crash"
        if kind is None:
            done += len(seeds)
            continue
        seed = status_path.read_text().strip()
        finding = {"kind": kind, "seed": seed}
        if kind == "crash":
            finding["exitcode"] = proc.exitcode
        findings.append(finding)
        shutil.copyfile(target, report_dir / f"{name}.{'hang' if kind == 'hard-hang' else 'crash'}.{seed}")
        # resume after the seed at fault
        done = (int(seed) - base_seed) + 1 if seed.isdigit() else done + len(seeds)
    target.write_bytes(original)
    hangs = sum(1 for _ in open(hang_log)) if hang_log.exists() else 0
    return {
        "format": name,
        "cases": done,
        "crashes": findings,
        "soft_hangs": hangs,
        "seconds": round(time.monotonic() - t0, 1),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", type=int, default=500, help="cases per format")
    ap.add_argument("--formats", type=str, default="", help="comma list; default all")
    ap.add_argument("--out", type=str, default=str(Path(tempfile.gettempdir()) / "fuzz_report_torch"),
                    help="report directory (summary.json, crashing inputs, soft-hang logs)")
    ap.add_argument("--seed", type=int, default=0, help="first seed of every format")
    args = ap.parse_args(argv)

    # import the readers and build and load the decoder once, before the forks
    import atlaspatch_tpu_torch.io.factory  # noqa: F401
    from atlaspatch_tpu_torch.io.native import load_tiff_library

    load_tiff_library()

    report_dir = Path(args.out)
    report_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="fuzzcorpus-torch-"))
    try:
        corpus = build_corpus(tmp)
        wanted = [f for f in args.formats.split(",") if f] or list(corpus)
        unknown = sorted(set(wanted) - set(corpus))
        if unknown:
            print(f"unknown formats: {unknown}; available: {sorted(corpus)}")
            return 2
        results = []
        for name in wanted:
            open_path, target = corpus[name]
            r = fuzz_format(name, open_path, target, args.cases, args.seed, report_dir)
            print(json.dumps(r), flush=True)
            results.append(r)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (report_dir / "summary.json").write_text(json.dumps(results, indent=1))
    total_findings = sum(len(r["crashes"]) for r in results)
    print(f"TOTAL: {sum(r['cases'] for r in results)} cases, "
          f"{total_findings} crash/hard-hang findings, "
          f"{sum(r['soft_hangs'] for r in results)} soft hangs "
          f"(report: {report_dir})")
    return 1 if total_findings else 0


if __name__ == "__main__":
    sys.exit(main())
