"""The port's H5PatchWriter and content filters against the JAX package's.

Mirrors tests/test_storage.py on the port, and writes every case with both
packages' writers from the same entries: the files must be byte-identical in
every dataset, and every attr equal in value and read-back type, except
``creation_date``, which must parse as ISO-8601 UTC in both (tolerance: none,
all comparisons are exact). The black/white patch filters of slow mode are
held to the JAX ones on random patches.
"""

from pathlib import Path

import h5py
import numpy as np
import pytest

import atlaspatch_tpu_torch.services.storage as storage_mod
from atlaspatch_tpu.services.storage import H5PatchWriter as JaxH5PatchWriter
from atlaspatch_tpu.utils import image as jax_image
from atlaspatch_tpu_torch.services.storage import PASSPORT_FORMAT, H5PatchWriter
from atlaspatch_tpu_torch.utils import image as port_image
from atlaspatch_tpu_torch.utils.h5 import read_h5
from torch_port_helpers import assert_creation_dates_utc, h5_view


def _kwargs(**overrides):
    kwargs = dict(
        chunk_rows=4,
        patch_size=256,
        patch_size_level0=512,
        level0_mag=40,
        target_mag=20,
        level0_wh=(10000, 8000),
        overlap=0,
        slide_stem="slideA",
        wsi_path="/data/slideA.svs",
        extra_file_attrs={"filename": "slideA.svs", "mpp": 0.25},
    )
    kwargs.update(overrides)
    return kwargs


def _entries(coords):
    return [(x, y, rw, rh, lv, None) for (x, y, rw, rh, lv) in coords]


def _assert_same_h5(jax_path: Path, port_path: Path) -> None:
    assert h5_view(jax_path) == h5_view(port_path)
    assert_creation_dates_utc(jax_path, port_path)


def _both(tmp_path: Path, method: str, entries, image_dir: str | None = None, **writer_kw):
    """Run one writer method of each package on the same entries:
    {"jax" | "port": ((total, xy), h5 path)}."""
    out = {}
    for tag, cls in (("jax", JaxH5PatchWriter), ("port", H5PatchWriter)):
        d = tmp_path / tag
        d.mkdir()
        args = []
        if image_dir is not None:
            (d / image_dir).mkdir()
            args.append(d / image_dir)
        writer = cls(**_kwargs(**writer_kw))
        result = getattr(writer, method)(d / "s.h5", list(entries), *args, batch=2, collect_coords=True)
        out[tag] = (result, d / "s.h5")
    return out


def test_write_coords_schema(tmp_path: Path):
    coords = [(0, 0, 128, 128, 1), (512, 0, 128, 128, 1), (0, 512, 128, 128, 1)]
    out = _both(tmp_path, "write_coords", _entries(coords))
    (total, viz), path = out["port"]
    assert total == 3
    np.testing.assert_array_equal(viz, np.asarray(coords, dtype=np.int32)[:, :2])
    np.testing.assert_array_equal(viz, out["jax"][0][1])
    _assert_same_h5(out["jax"][1], path)

    with h5py.File(path) as f:
        c = f["coords"][:]
        assert c.dtype == np.int32
        np.testing.assert_array_equal(c, np.asarray(coords, dtype=np.int32))
        p = f["passports"][:]
        assert p.dtype == np.dtype("S160")
        assert p[0].decode() == "slideA__x0_y0_rw128_rh128_lv1_mag40_tmag20_total3"
        assert p[1].decode() == "slideA__x512_y0_rw128_rh128_lv1_mag40_tmag20_total3"
        assert f.attrs["patch_size"] == 256
        assert f.attrs["patch_size_level0"] == 512
        assert f.attrs["level0_magnification"] == 40
        assert f.attrs["target_magnification"] == 20
        assert f.attrs["overlap"] == 0
        assert f.attrs["level0_width"] == 10000
        assert f.attrs["level0_height"] == 8000
        assert f.attrs["wsi_path"] == "/data/slideA.svs"
        assert f.attrs["passport_format"] == PASSPORT_FORMAT
        assert f.attrs["passport_version"] == 2
        assert f.attrs["num_patches"] == 3
        assert f.attrs["filename"] == "slideA.svs"
        assert f.attrs["mpp"] == 0.25
        assert "creation_date" in f.attrs
    datasets, attrs = read_h5(path)
    np.testing.assert_array_equal(datasets["coords"], np.asarray(coords, dtype=np.int32))
    assert set(attrs) == set(H5PatchWriter(**_kwargs())._file_attrs()) | {"num_patches"}


def test_passport_na_for_zero_mags(tmp_path: Path):
    out = _both(tmp_path, "write_coords", _entries([(1, 2, 3, 4, 0)]), level0_mag=0, target_mag=0)
    with h5py.File(out["port"][1]) as f:
        assert f["passports"][0].decode() == "slideA__x1_y2_rw3_rh4_lv0_magna_tmagna_total1"
    _assert_same_h5(out["jax"][1], out["port"][1])


@pytest.mark.parametrize("n", [0, 1, 2500])
def test_write_coords_sizes_match_jax(tmp_path: Path, n):
    rng = np.random.default_rng(n)
    coords = rng.integers(0, 100_000, size=(n, 5)).tolist()
    out = _both(tmp_path, "write_coords", _entries(coords))
    assert out["port"][0][0] == out["jax"][0][0] == n
    _assert_same_h5(out["jax"][1], out["port"][1])


def test_long_stem_widens_passports_as_jax(tmp_path: Path):
    out = _both(tmp_path, "write_coords", _entries([(1, 2, 3, 4, 0), (5, 6, 7, 8, 0)]),
                slide_stem="s" * 180)
    _assert_same_h5(out["jax"][1], out["port"][1])
    with h5py.File(out["port"][1]) as f:
        assert f["passports"].dtype.itemsize > 160
        assert f["passports"][1].decode().endswith("_mag40_tmag20_total2")


def test_slide_metadata_attrs_match_jax(tmp_path: Path):
    extra = {"filename": "a.svs", "mpp": 0.2521, "magnification": 40, "vendor": "aperio",
             "institution": "Zürich", "stain": "H&E"}
    out = _both(tmp_path, "write_coords", _entries([(1, 2, 3, 4, 0)]), extra_file_attrs=extra)
    _assert_same_h5(out["jax"][1], out["port"][1])


def test_write_coords_and_images(tmp_path: Path):
    patch = np.full((16, 16, 3), 128, dtype=np.uint8)
    entries = [(0, 0, 16, 16, 0, patch), (256, 0, 16, 16, 0, patch)]
    out = _both(tmp_path, "write_coords_and_images", entries, "imgs")
    (total, _), path = out["port"]
    assert total == 2
    img_dir = tmp_path / "port" / "imgs"
    assert (img_dir / "slideA_x0_y0.png").exists()
    assert (img_dir / "slideA_x256_y0.png").exists()
    _assert_same_h5(out["jax"][1], path)
    jax_imgs = tmp_path / "jax" / "imgs"
    assert sorted(p.name for p in img_dir.iterdir()) == sorted(p.name for p in jax_imgs.iterdir())
    for p in img_dir.iterdir():
        assert p.read_bytes() == (jax_imgs / p.name).read_bytes()


def test_png_export_failure_does_not_abort_slide(tmp_path: Path, monkeypatch):
    """A failing per-patch PNG save logs and continues: coords are already
    committed, so the slide must still complete."""

    def boom(patch_arr, out_path):
        raise OSError("disk full")

    monkeypatch.setattr(storage_mod, "save_patch_png", boom)
    w = H5PatchWriter(**_kwargs())
    out = tmp_path / "s.h5"
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    patch = np.zeros((8, 8, 3), dtype=np.uint8)
    entries = [(0, 0, 512, 512, 0, patch), (512, 0, 512, 512, 0, patch)]
    total, _ = w.write_coords_and_images(out, entries, img_dir, batch=4)
    assert total == 2
    with h5py.File(out) as f:
        assert f["coords"].shape[0] == 2
    assert list(img_dir.iterdir()) == []


def test_crash_mid_iteration_leaves_no_partial_h5(tmp_path: Path):
    target = tmp_path / "s.h5"

    def exploding_entries():
        yield (0, 0, 64, 64, 0, None)
        raise RuntimeError("boom mid-iteration")

    with pytest.raises(RuntimeError):
        H5PatchWriter(**_kwargs()).write_coords(target, exploding_entries(), batch=4)
    assert list(tmp_path.iterdir()) == []


# --- content filters of slow mode --------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_black_white_filters_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        kind = rng.integers(4)
        if kind == 0:  # near-black
            patch = rng.integers(0, 60, size=(32, 32, 3), dtype=np.uint8)
        elif kind == 1:  # near-white, low saturation
            base = rng.integers(190, 256, size=(32, 32, 1))
            patch = np.clip(base + rng.integers(-4, 5, size=(32, 32, 3)), 0, 255).astype(np.uint8)
        else:
            patch = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        rgb_thresh, sat_thresh = int(rng.integers(10, 80)), int(rng.integers(2, 30))
        frac = float(rng.uniform(0.3, 0.9))
        assert port_image.is_black_patch(patch, rgb_thresh, frac) == jax_image.is_black_patch(
            patch, rgb_thresh, frac)
        assert port_image.is_white_patch(patch, sat_thresh, frac) == jax_image.is_white_patch(
            patch, sat_thresh, frac)
        np.testing.assert_array_equal(port_image.rgb_to_gray_u8(patch), jax_image.rgb_to_gray_u8(patch))
        for got, want in zip(port_image.rgb_to_sat_val_u8(patch), jax_image.rgb_to_sat_val_u8(patch)):
            np.testing.assert_array_equal(got, want)
    gray = rng.integers(0, 256, size=(16, 16), dtype=np.uint8)
    assert port_image.is_black_patch(gray) == jax_image.is_black_patch(gray)
