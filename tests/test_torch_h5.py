"""The port's own HDF5 writer (atlaspatch_tpu_torch/utils/h5.py) against the
JAX package's AtomicH5, which writes through h5py.

The same content goes through both writers; h5py then reads both files, and
they must agree exactly: dataset names, dtypes, shapes and bytes; attribute
names, Python types, dtypes and values (tolerance: none, every comparison is
exact). ``read_h5`` must read the port's files as h5py does. The staging
lifecycle is held to what tests/test_storage.py requires of the JAX class.
Datasets in a group (``features/<name>``) with attributes are held against
the JAX class's nested ``put_all``, and ``add_datasets`` (a dataset added to a
published file by one staged rewrite) to h5py's reading of the file before.
"""

import os
import warnings
from pathlib import Path

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from atlaspatch_tpu.utils.h5 import AtomicH5 as JaxAtomicH5
from atlaspatch_tpu_torch.utils import h5 as port_h5
from atlaspatch_tpu_torch.utils.h5 import AtomicH5, add_datasets, encode_attr, lookup3, read_h5, read_h5_tree
from torch_port_helpers import h5_view

# every value kind the JAX writer's scalar fast path (_write_attr_fast) handles,
# plus the two encode_attr conversions
ATTRS = {
    "a_str": "hello/world",
    "a_empty": "",
    "a_unicode": "Zürich — ✓",
    "a_int": 7,
    "a_neg": -(2**40),
    "a_float": 0.25,
    "a_nan": float("nan"),
    "a_np_i8": np.int8(-3),
    "a_np_i16": np.int16(-300),
    "a_np_i32": np.int32(9),
    "a_np_i64": np.int64(2**50),
    "a_np_u8": np.uint8(250),
    "a_np_u16": np.uint16(60000),
    "a_np_u32": np.uint32(4_000_000_000),
    "a_np_u64": np.uint64(2**63 + 5),
    "a_np_f16": np.float16(1.5),
    "a_np_f32": np.float32(0.1),
    "a_np_f64": np.float64(-2.5e300),
    "a_none": None,
    "a_dict": {"k": 1, "nested": {"x": [1, 2]}},
}


def _passports(n: int, stem: str = "slideA") -> np.ndarray:
    rows = [f"{stem}__x{i}_y{2 * i}_rw128_rh128_lv1_mag40_tmag20_total{n}" for i in range(n)]
    width = max(160, max((len(r) for r in rows), default=0))
    return np.array(rows, dtype=f"S{width}") if rows else np.empty((0,), "S160")


def _write_both(tmp_path: Path, datasets: dict, attrs: dict, name: str = "s.h5"):
    jax_path, port_path = tmp_path / "jax" / name, tmp_path / "port" / name
    jax_path.parent.mkdir(exist_ok=True)
    port_path.parent.mkdir(exist_ok=True)
    with JaxAtomicH5(jax_path) as store:
        for key, arr in datasets.items():
            store.put_all(key, arr)
        store.set_attrs(attrs)
    with AtomicH5(port_path) as store:
        for key, arr in datasets.items():
            store.put_all(key, arr)
        store.set_attrs(attrs)
    return jax_path, port_path


def _same_attr_values(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        (ta, da, va), (tb, db, vb) = a[key], b[key]
        assert ta is tb and da == db, (key, ta, tb, da, db)
        assert va == vb or (va != va and vb != vb), (key, va, vb)  # nan == nan here


def _assert_same_files(jax_path: Path, port_path: Path) -> None:
    jd, ja = h5_view(jax_path, skip=())
    pd, pa = h5_view(port_path, skip=())
    assert jd == pd
    _same_attr_values(ja, pa)


def _assert_read_h5_agrees(path: Path) -> None:
    datasets, attrs = read_h5(path)
    hd, ha = h5_view(path, skip=())
    assert {k: (v.dtype, v.shape, v.tobytes()) for k, v in datasets.items()} == hd
    _same_attr_values({k: (type(v), getattr(v, "dtype", None), v) for k, v in attrs.items()}, ha)


@pytest.mark.parametrize("n", [0, 1, 4099])
def test_coordinate_files_match_the_jax_writer(tmp_path, n):
    rng = np.random.default_rng(n)
    coords = rng.integers(-(2**31), 2**31 - 1, size=(n, 5), dtype=np.int64).astype(np.int32)
    datasets = {"coords": coords, "passports": _passports(n)}
    attrs = dict(ATTRS, num_patches=n)
    jax_path, port_path = _write_both(tmp_path, datasets, attrs)
    _assert_same_files(jax_path, port_path)
    _assert_read_h5_agrees(port_path)
    got, _ = read_h5(port_path)
    assert got["coords"].shape == (n, 5) and got["passports"].dtype == np.dtype("S160")


def test_long_stem_widens_passports(tmp_path):
    passports = _passports(3, stem="s" * 200)
    assert passports.dtype.itemsize > 160
    jax_path, port_path = _write_both(
        tmp_path, {"coords": np.zeros((3, 5), np.int32), "passports": passports}, {"n": 3}
    )
    _assert_same_files(jax_path, port_path)
    with h5py.File(port_path) as f:
        assert f["passports"].dtype == passports.dtype
        assert f["passports"][2] == passports[2]


@pytest.mark.parametrize(
    "dtype", ["<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4", "<u8", "<f2", "<f4", "<f8",
              ">i4", ">f8", "S7"]
)
def test_dataset_dtypes_match_the_jax_writer(tmp_path, dtype):
    rng = np.random.default_rng(0)
    if dtype.startswith("S"):
        arr = np.array([bytes(rng.integers(97, 123, 7, dtype=np.uint8)) for _ in range(6)], dtype)
    else:
        arr = rng.normal(0, 100, size=(3, 2, 4)).astype(dtype)
    jax_path, port_path = _write_both(tmp_path, {"x": arr}, {})
    _assert_same_files(jax_path, port_path)
    _assert_read_h5_agrees(port_path)


def test_many_attributes_and_no_datasets(tmp_path):
    attrs = {f"k{i:03d}": (i if i % 3 else f"v{i}") for i in range(150)}
    jax_path, port_path = _write_both(tmp_path, {}, attrs)
    _assert_same_files(jax_path, port_path)
    _assert_read_h5_agrees(port_path)


def test_large_string_attributes_grow_the_heap(tmp_path):
    attrs = {f"big{i}": "x" * 3000 + str(i) for i in range(4)}
    attrs["json"] = {"rows": list(range(2000))}
    jax_path, port_path = _write_both(tmp_path, {"c": np.arange(3, dtype=np.int32)}, attrs)
    _assert_same_files(jax_path, port_path)
    _assert_read_h5_agrees(port_path)


def test_h5py_opens_without_a_diagnostic(tmp_path, capfd):
    _, port_path = _write_both(
        tmp_path, {"coords": np.ones((5, 5), np.int32), "passports": _passports(5)}, ATTRS
    )
    capfd.readouterr()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with h5py.File(port_path, "r") as f:
            f.visit(lambda name: None)
            dict(f.attrs)
            f["coords"][()]
    out, err = capfd.readouterr()
    assert "HDF5-DIAG" not in out + err


def test_superblock_and_headers_are_checksummed(tmp_path):
    _, port_path = _write_both(tmp_path, {"coords": np.ones((2, 5), np.int32)}, {"a": 1})
    raw = port_path.read_bytes()
    assert int.from_bytes(raw[28:36], "little") == len(raw)  # end-of-file address
    assert int.from_bytes(raw[44:48], "little") == lookup3(raw[:44])
    bad = bytearray(raw)
    bad[60] ^= 0xFF  # inside the root object header
    port_path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="checksum"):
        read_h5(port_path)


def test_lookup3_matches_the_hdf5_library(tmp_path):
    """The checksums h5py's library writes on the superblock and on every
    version-2 object header, for files of several sizes and header lengths."""
    for n in range(6):
        path = tmp_path / f"lib{n}.h5"
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("x", data=np.arange(n * 7, dtype=np.int16))
            f.attrs["s" * (n + 1)] = "v" * (10 * n)
        raw = path.read_bytes()
        assert int.from_bytes(raw[44:48], "little") == lookup3(raw[:44])
        headers = 0
        at = raw.find(b"OHDR")
        while at >= 0:
            flags = raw[at + 5]
            p = at + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            end = p + width + int.from_bytes(raw[p : p + width], "little")
            assert int.from_bytes(raw[end : end + 4], "little") == lookup3(raw[at:end])
            headers += 1
            at = raw.find(b"OHDR", end)
        assert headers == 2
    # the test vectors of lookup3.c's self-test (hashlittle, initval 0)
    assert lookup3(b"") == 0xDEADBEEF
    assert lookup3(b"Four score and seven years ago") == 0x17770551


def test_read_h5_refuses_other_layouts(tmp_path):
    path = tmp_path / "lib.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4, dtype=np.int32))
        f.attrs["a"] = 1
    with pytest.raises(ValueError):
        read_h5(path)
    legacy = tmp_path / "legacy.h5"
    with h5py.File(legacy, "w") as f:
        f.create_dataset("x", data=np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError):
        read_h5(legacy)
    (tmp_path / "junk.h5").write_bytes(b"not an hdf5 file at all" * 4)
    with pytest.raises(ValueError):
        read_h5(tmp_path / "junk.h5")


# --- staging lifecycle (tests/test_storage.py:37-62 for the JAX class) -------------
def _stage_files(d: Path) -> list[Path]:
    return sorted(d.glob(".stage-*"))


def test_publish_renames_the_stage_onto_the_target(tmp_path):
    target = tmp_path / "out.h5"
    store = AtomicH5(target)
    store.put_all("a", np.arange(6, dtype=np.int32).reshape(3, 2))
    store.set_attrs({"k": {"nested": 1}, "n": None})
    assert not target.exists() and len(_stage_files(tmp_path)) == 1
    name = _stage_files(tmp_path)[0].name
    assert name.startswith(f".stage-{os.getpid():x}-") and name.endswith("-out.h5")
    assert store.live
    store.publish()
    assert not store.live and target.exists()
    with h5py.File(target) as f:
        assert f["a"].shape == (3, 2)
        assert f.attrs["k"] == '{"nested": 1}'
        assert f.attrs["n"] == "None"
    assert list(tmp_path.glob(".*")) == []
    store.publish()  # a second publish is a no-op


def test_discard_leaves_nothing(tmp_path):
    target = tmp_path / "out.h5"
    store = AtomicH5(target)
    store.put_all("a", np.ones((3, 2), dtype=np.float32))
    store.discard()
    assert not target.exists() and not store.live
    assert list(tmp_path.glob(".*")) == []
    store.discard()


def test_exception_inside_with_discards_and_keeps_an_old_target(tmp_path):
    target = tmp_path / "out.h5"
    with AtomicH5(target) as store:
        store.put_all("a", np.arange(3, dtype=np.int32))
    before = target.read_bytes()
    with pytest.raises(RuntimeError, match="boom"):
        with AtomicH5(target) as store:
            store.put_all("a", np.arange(5, dtype=np.int32))
            raise RuntimeError("boom")
    assert target.read_bytes() == before
    assert list(tmp_path.glob(".*")) == []


@pytest.mark.parametrize("where", ["write", "close"])
def test_failed_write_or_close_never_publishes(tmp_path, monkeypatch, where):
    target = tmp_path / "out.h5"
    store = AtomicH5(target)
    store.put_all("a", np.arange(5, dtype=np.int32))
    real = getattr(os, where)
    calls = []

    def failing(fd, *args):
        calls.append(fd)
        if where == "close":
            real(fd)
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(port_h5.os, where, failing)
    with pytest.raises(OSError):
        store.publish()
    monkeypatch.setattr(port_h5.os, where, real)
    assert calls and not target.exists() and not store.live
    assert list(tmp_path.glob(".*")) == []


# --- refusals ------------------------------------------------------------------------
@pytest.mark.parametrize(
    "value", [True, np.bool_(False), np.array([1, 2]), b"raw", [1], 1 + 2j, np.complex64(1)]
)
def test_unsupported_attribute_values_raise_type_error(tmp_path, value):
    store = AtomicH5(tmp_path / "out.h5")
    with pytest.raises(TypeError):
        store.set_attrs({"a": value})
    store.discard()


def test_nul_in_a_string_attribute_raises_value_error_in_both(tmp_path):
    for cls in (JaxAtomicH5, AtomicH5):
        store = cls(tmp_path / f"{cls.__module__}.h5")
        with pytest.raises(ValueError):
            store.set_attrs({"a": "x\0y"})
        store.discard()


@pytest.mark.parametrize("name", ["grp/inner", "ünïcode", "", "."])
def test_nested_or_non_ascii_dataset_names_raise_value_error(tmp_path, name):
    store = AtomicH5(tmp_path / "out.h5")
    with pytest.raises(ValueError):
        store.put_all(name, np.arange(3, dtype=np.int32))
    store.discard()


@pytest.mark.parametrize(
    "arr", [np.array(["a", "bb"], dtype=object), np.array(["a"], dtype="U3"),
            np.array([True]), np.zeros(2, np.complex64)],
    ids=["object", "unicode", "bool", "complex"],
)
def test_unsupported_dataset_dtypes_raise_type_error(tmp_path, arr):
    store = AtomicH5(tmp_path / "out.h5")
    with pytest.raises(TypeError):
        store.put_all("x", arr)
    store.discard()


def test_duplicate_dataset_raises(tmp_path):
    store = AtomicH5(tmp_path / "out.h5")
    store.put_all("x", np.arange(3))
    with pytest.raises(ValueError):
        store.put_all("x", np.arange(3))
    store.discard()


def test_encode_attr_matches_the_jax_package():
    from atlaspatch_tpu.utils.h5 import encode_attr as jax_encode_attr

    for value in ATTRS.values():
        want, got = jax_encode_attr(value), encode_attr(value)
        assert type(want) is type(got) and (want == got or want != want)


# --- random content ------------------------------------------------------------------
_scalar = st.one_of(
    st.text(st.characters(exclude_characters="\0"), max_size=40),
    st.integers(-(2**63), 2**63 - 1),
    st.floats(allow_nan=False, width=64),
    st.integers(0, 255).map(np.uint8),
    st.integers(-(2**31), 2**31 - 1).map(np.int32),
    st.floats(allow_nan=False, width=32).map(np.float32),
    st.none(),
    st.dictionaries(st.text(max_size=5), st.integers(), max_size=3),
)
_attr_sets = st.dictionaries(
    st.text(st.characters(codec="ascii", exclude_characters="\0"), min_size=1, max_size=20),
    _scalar, max_size=12,
)
_arrays = st.tuples(
    st.lists(st.integers(0, 9), min_size=1, max_size=3),
    st.sampled_from(["<i4", "<i8", "<u2", "<f4", "<f8", "S5", "S160"]),
    st.integers(0, 2**32 - 1),
)


def _utf8_encodable(text: str) -> bool:
    try:
        text.encode("utf-8")
    except UnicodeEncodeError:
        return False
    return True


def _assert_both_refuse(tmp: Path, datasets: dict, attrs: dict) -> None:
    """HDF5 holds attribute strings as UTF-8, which cannot hold a lone
    surrogate: the JAX writer refuses such a value, and so must the port, with
    the same error and no file, published or staged, left by either."""
    for writer, sub in ((JaxAtomicH5, "jax"), (AtomicH5, "port")):
        path = tmp / sub / "s.h5"
        path.parent.mkdir()
        with pytest.raises(UnicodeEncodeError):
            with writer(path) as store:
                for key, arr in datasets.items():
                    store.put_all(key, arr)
                store.set_attrs(attrs)
        assert os.listdir(path.parent) == []


def test_lone_surrogate_attr_is_refused_like_the_jax_writer(tmp_path):
    _assert_both_refuse(tmp_path, {"coords": np.zeros((2, 5), np.int32)}, {"a_str": "ok", "bad": "x\ud800"})


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(attrs=_attr_sets, arrays=st.lists(_arrays, max_size=3))
def test_random_shapes_and_attr_sets_match_the_jax_writer(tmp_path_factory, attrs, arrays):
    tmp = tmp_path_factory.mktemp("h5")
    datasets = {}
    for i, (shape, dtype, seed) in enumerate(arrays):
        rng = np.random.default_rng(seed)
        if dtype.startswith("S"):
            arr = rng.integers(32, 127, size=(*shape, int(dtype[1:])), dtype=np.uint8)
            arr = arr.view(dtype).reshape(shape)
        else:
            arr = (rng.normal(0, 1e3, size=shape)).astype(dtype)
        datasets[f"d{i}"] = arr
    if any(isinstance(v, str) and not _utf8_encodable(v) for v in attrs.values()):
        _assert_both_refuse(tmp, datasets, attrs)
        return
    jax_path, port_path = _write_both(tmp, datasets, attrs)
    _assert_same_files(jax_path, port_path)
    _assert_read_h5_agrees(port_path)


# --- groups, dataset attributes and adding to a published file ---------------------
def h5_tree_view(path) -> dict:
    """Every dataset (dtype, shape, bytes, attrs) and group by path, and the
    file attrs, as h5py reads them."""
    out: dict = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                attrs = {k: (type(v), getattr(v, "dtype", None), v) for k, v in obj.attrs.items()}
                out[name] = (obj.dtype, obj.shape, obj[()].tobytes(), attrs)
            else:
                out[name] = "group"
        f.visititems(visit)
        out["/"] = {k: (type(v), getattr(v, "dtype", None), v) for k, v in f.attrs.items()}
    return out


FEATURE_ATTRS = {"name": "vit_l_16", "embedding_dim": 1024, "scale": np.float32(0.5), "note": None}


def _write_nested(store, rng):
    """Into the port's store: what the JAX test writes as features/<name> paths."""
    store.put_all("coords", rng.integers(0, 9, (6, 5)).astype(np.int32))
    store.put_all("vit_l_16", rng.normal(size=(6, 4)).astype(np.float32), FEATURE_ATTRS, group="features")
    store.put_all("empty", np.zeros((0, 7), np.float32), {"embedding_dim": 7}, group="features")
    store.set_attrs({"num_patches": 6, "creation_date": "2026-01-01T00:00:00+00:00"})


def test_groups_and_dataset_attrs_match_the_jax_writer(tmp_path):
    jax_path, port_path = tmp_path / "jax.h5", tmp_path / "port.h5"
    with JaxAtomicH5(jax_path) as store:
        rng = np.random.default_rng(0)
        store.put_all("coords", rng.integers(0, 9, (6, 5)).astype(np.int32))
        store.put_all("features/vit_l_16", rng.normal(size=(6, 4)).astype(np.float32), FEATURE_ATTRS)
        store.put_all("features/empty", np.zeros((0, 7), np.float32), {"embedding_dim": 7})
        store.set_attrs({"num_patches": 6, "creation_date": "2026-01-01T00:00:00+00:00"})
    with AtomicH5(port_path) as store:
        _write_nested(store, np.random.default_rng(0))
    jax_view, port_view = h5_tree_view(jax_path), h5_tree_view(port_path)
    assert jax_view.keys() == port_view.keys() == {"/", "coords", "features", "features/vit_l_16",
                                                   "features/empty"}
    for key in jax_view:
        if key == "/" or jax_view[key] == "group":
            assert key == "/" or port_view[key] == "group", key
            continue
        (jd, js, jb, ja), (pd, ps, pb, pa) = jax_view[key], port_view[key]
        assert (jd, js, jb) == (pd, ps, pb), key
        _same_attr_values(ja, pa)
    _same_attr_values(jax_view["/"], port_view["/"])
    tree = read_h5_tree(port_path)
    assert list(tree.datasets) == ["coords", "features/vit_l_16", "features/empty"]
    assert tree.dataset_attrs["features/vit_l_16"]["embedding_dim"] == 1024
    assert "features/empty" in tree.dataset_attrs and "coords" not in tree.dataset_attrs
    shapes = read_h5_tree(port_path, data=False).datasets
    assert {k: (v.shape, v.dtype) for k, v in shapes.items()} == {
        k: (v.shape, v.dtype) for k, v in tree.datasets.items()}


def test_group_names_are_checked(tmp_path):
    store = AtomicH5(tmp_path / "out.h5")
    store.put_all("coords", np.arange(3))
    for group in ("a/b", "", "ünï"):
        with pytest.raises(ValueError):
            store.put_all("x", np.arange(3), group=group)
    with pytest.raises(ValueError, match="already exists"):
        store.put_all("x", np.arange(3), group="coords")  # a dataset of that name
    store.put_all("x", np.arange(3), group="g")
    with pytest.raises(ValueError, match="already exists"):
        store.put_all("g", np.arange(3))  # a group of that name
    with pytest.raises(ValueError, match="already exists"):
        store.put_all("x", np.arange(3), group="g")
    store.discard()


def test_add_datasets_keeps_everything_and_publishes_once(tmp_path):
    target = tmp_path / "slide.h5"
    with AtomicH5(target) as store:
        _write_nested(store, np.random.default_rng(1))
        store.set_attrs(ATTRS)
    before = h5_tree_view(target)
    new = np.random.default_rng(2).normal(size=(6, 3)).astype(np.float32)
    add_datasets(target, {"toy": new}, group="features", attrs={"toy": {"name": "toy", "embedding_dim": 3}})
    after = h5_tree_view(target)
    assert set(after) == set(before) | {"features/toy"}
    for key in before:
        if key == "/":
            _same_attr_values(before[key], after[key])
        elif before[key] == "group":
            assert after[key] == "group"
        else:
            assert before[key][:3] == after[key][:3], key
            _same_attr_values(before[key][3], after[key][3])
    assert after["features/toy"][2] == new.tobytes()
    assert list(tmp_path.iterdir()) == [target]
    _assert_no_diagnostic(target)


def _assert_no_diagnostic(path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with h5py.File(path, "r") as f:
            f.visit(lambda name: None)


def test_add_datasets_refusal_leaves_the_file_as_it_was(tmp_path, monkeypatch):
    target = tmp_path / "slide.h5"
    with AtomicH5(target) as store:
        _write_nested(store, np.random.default_rng(3))
    before = target.read_bytes()
    with pytest.raises(ValueError, match="already exists"):
        add_datasets(target, {"ok": np.ones((6, 2), np.float32), "vit_l_16": np.ones((6, 2), np.float32)},
                     group="features")
    with pytest.raises(TypeError):
        add_datasets(target, {"bad": np.ones(2, np.complex64)}, group="features")

    def failing(fd, *args):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(port_h5.os, "write", failing)
    with pytest.raises(OSError):
        add_datasets(target, {"ok": np.ones((6, 2), np.float32)}, group="features")
    monkeypatch.undo()
    assert target.read_bytes() == before
    assert list(tmp_path.iterdir()) == [target]


def test_add_datasets_to_a_file_of_another_writer_raises(tmp_path):
    lib = tmp_path / "lib.h5"
    with h5py.File(lib, "w") as f:
        f.create_dataset("coords", data=np.zeros((2, 5), np.int32))
    before = lib.read_bytes()
    with pytest.raises(ValueError, match="not a file of this HDF5 writer"):
        add_datasets(lib, {"x": np.ones((2, 2), np.float32)}, group="features")
    assert lib.read_bytes() == before and list(tmp_path.iterdir()) == [lib]


@settings(max_examples=15, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(attrs=_attr_sets, arrays=st.lists(_arrays, min_size=1, max_size=3), ds_attrs=_attr_sets)
def test_random_groups_round_trip_through_read_h5_tree(tmp_path_factory, attrs, arrays, ds_attrs):
    tmp = tmp_path_factory.mktemp("h5g")
    jax_path, port_path = tmp / "jax.h5", tmp / "port.h5"
    with JaxAtomicH5(jax_path) as jstore, AtomicH5(port_path) as pstore:
        for i, (shape, dtype, seed) in enumerate(arrays):
            rng = np.random.default_rng(seed)
            arr = rng.integers(32, 127, size=shape).astype("S1" if dtype.startswith("S") else dtype)
            group = "features" if i % 2 else None
            jstore.put_all(f"{group}/d{i}" if group else f"d{i}", arr, ds_attrs)
            pstore.put_all(f"d{i}", arr, ds_attrs, group=group)
        jstore.set_attrs(attrs)
        pstore.set_attrs(attrs)
    jview, pview = h5_tree_view(jax_path), h5_tree_view(port_path)
    assert jview.keys() == pview.keys()
    for key in jview:
        if key == "/":
            _same_attr_values(jview[key], pview[key])
        elif jview[key] != "group":
            assert jview[key][:3] == pview[key][:3]
            _same_attr_values(jview[key][3], pview[key][3])
    tree = read_h5_tree(port_path)
    for key, arr in tree.datasets.items():
        assert pview[key][:3] == (arr.dtype, arr.shape, arr.tobytes())
