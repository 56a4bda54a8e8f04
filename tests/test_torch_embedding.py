"""The port's feature embedding (services/feature_embedding.py), its H5 feature
appends (services/storage.py) and completeness probes (utils/features.py)
against the JAX package's, on the CPU.

The scenarios of tests/test_slide_major_embedding.py and the feature cases of
tests/test_storage.py run in both packages on the same PNG slides, with the
same deterministic numpy encoders (tests/test_slide_major_embedding.py), each
package's runner and fake segmentation (tests/test_torch_runner.py). The
features, their attrs, the failures and the feature sets must be equal
(tolerance: none, the encoders are numpy). Files are read as h5py reads them.
"""

import importlib
import threading
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest

from atlaspatch_tpu_torch.utils.h5 import AtomicH5, add_datasets, read_h5_tree
from test_torch_runner import PACKAGES, _cfg, _runner, _slides
from test_torch_runner import _pkg as runner_pkg
from tests.test_slide_major_embedding import (
    CasedEncoder,
    FlakyEncoder,
    MalformedEncoder,
    ToyEncoder,
    ToyEncoder2,
)


def _pkg(name: str) -> SimpleNamespace:
    """test_torch_runner's modules of one package, and the embedding ones."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        **vars(runner_pkg(name)), name=name, embedding=mod("services.feature_embedding"),
        registry=mod("models.encoders.registry"), features=mod("utils.features"),
    )


PKGS = {name: _pkg(name) for name in PACKAGES}
JAX, PORT = PKGS[PACKAGES[0]], PKGS[PACKAGES[1]]


def _registry(pkg, *encoders):
    reg = pkg.registry.PatchFeatureExtractorRegistry()
    for enc in encoders:
        reg.register(enc.name, enc)
    return reg


def _feat_cfg(pkg, names, batch=16):
    return pkg.config.FeatureExtractionConfig(
        extractors=list(names), batch_size=batch, device="cpu", precision="float32"
    )


def _extract(pkg, slide_dir, out, feat_cfg):
    cfg = _cfg(pkg, slide_dir, out, features=feat_cfg)
    results, failures = _runner(pkg, cfg).run()
    assert failures == []
    return cfg, sorted(results, key=lambda r: r.slide.stem)


def _service(pkg, cfg, feat_cfg, *encoders):
    return pkg.embedding.PatchFeatureEmbeddingService(
        cfg.extraction, cfg.output, feat_cfg, registry=_registry(pkg, *encoders)
    )


def _features(path) -> dict:
    """{name: (values, attrs)} under features/, as h5py reads them."""
    with h5py.File(path, "r") as f:
        if "features" not in f:
            return {}
        return {name: (ds[()], dict(ds.attrs)) for name, ds in f["features"].items()}


def _same_features(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for name in a:
        (va, aa), (vb, ab) = a[name], b[name]
        assert va.dtype == vb.dtype == np.float32 and va.tobytes() == vb.tobytes(), name
        assert aa.keys() == ab.keys() and all(aa[k] == ab[k] for k in aa), name


def _scenario(tmp_path, slide_dir, names, encoders, *, batch=16, prepare=None):
    """Run extraction + embed_all in both packages; {pkg name: (results, failures)}."""
    got = {}
    for pkg in PKGS.values():
        feat_cfg = _feat_cfg(pkg, names, batch)
        cfg, results = _extract(pkg, slide_dir, tmp_path / pkg.name, feat_cfg)
        if prepare is not None:
            prepare(pkg, results)
        fails = _service(pkg, cfg, feat_cfg, *encoders).embed_all(
            results, wsi_loader=pkg.loader.DefaultWSILoader())
        got[pkg.name] = (results, fails)
    (jr, jf), (pr, pf) = got[JAX.name], got[PORT.name]
    assert [(s.stem, type(e).__name__) for s, e in pf] == [(s.stem, type(e).__name__) for s, e in jf]
    for a, b in zip(jr, pr):
        assert (a.slide.stem, a.num_patches) == (b.slide.stem, b.num_patches)
        assert a.metadata.get("feature_sets") == b.metadata.get("feature_sets")
        _same_features(_features(a.h5_path), _features(b.h5_path))
    return pr, pf


@pytest.fixture
def slide_dir(tmp_path: Path) -> Path:
    return _slides(tmp_path, n=2)


def _count_patch_reads(monkeypatch):
    counter = {"patches": 0}
    lock = threading.Lock()
    cls = PORT.embedding.PatchFeatureEmbeddingService
    orig = cls._read_patch_block

    def counting(self, wsi, coords):
        with lock:
            counter["patches"] += len(coords)
        return orig(self, wsi, coords)

    monkeypatch.setattr(cls, "_read_patch_block", counting)
    return counter


# --- service scenarios ---------------------------------------------------------------
def test_slide_major_matches_extractor_major_bitexact(slide_dir, tmp_path, monkeypatch):
    counter = _count_patch_reads(monkeypatch)
    monkeypatch.setenv("ATLASPATCH_SLIDE_MAJOR", "0")
    em, fails = _scenario(tmp_path / "em", slide_dir, ["toy", "toy2"], (ToyEncoder, ToyEncoder2), batch=8)
    assert fails == []
    reads_em, counter["patches"] = counter["patches"], 0
    monkeypatch.setenv("ATLASPATCH_SLIDE_MAJOR", "1")
    sm, fails = _scenario(tmp_path / "sm", slide_dir, ["toy", "toy2"], (ToyEncoder, ToyEncoder2), batch=8)
    assert fails == []
    total = sum(r.num_patches for r in sm)
    assert total > 0 and counter["patches"] == total and reads_em == 2 * total
    for a, b in zip(em, sm):
        _same_features(_features(a.h5_path), _features(b.h5_path))
        assert b.metadata["feature_sets"] == ["toy", "toy2"]
        feats = _features(b.h5_path)
        assert feats["toy"][0].shape == (b.num_patches, 8)
        assert feats["toy"][1] == {"name": "toy", "embedding_dim": 8}


@pytest.mark.parametrize("prefetch", ["1", "0"])
def test_slide_prefetch_modes_match(slide_dir, tmp_path, monkeypatch, prefetch):
    monkeypatch.setenv("ATLASPATCH_SLIDE_PREFETCH", prefetch)
    _, fails = _scenario(tmp_path, slide_dir, ["toy"], (ToyEncoder,), batch=4)
    assert fails == []


def test_io_block_width_is_feature_invariant(slide_dir, tmp_path, monkeypatch):
    call_sizes: list[int] = []
    orig = ToyEncoder.extract_batch

    def spying(self, patches, *, batch_size=None):
        call_sizes.append(len(patches))
        return orig(self, patches, batch_size=batch_size)

    monkeypatch.setattr(ToyEncoder, "extract_batch", spying)
    monkeypatch.setenv("ATLASPATCH_EMBED_BLOCK_CHUNKS", "1")
    narrow, _ = _scenario(tmp_path / "narrow", slide_dir, ["toy"], (ToyEncoder,), batch=4)
    assert max(call_sizes) <= 4
    call_sizes.clear()
    monkeypatch.setenv("ATLASPATCH_EMBED_BLOCK_CHUNKS", "4")
    wide, _ = _scenario(tmp_path / "wide", slide_dir, ["toy"], (ToyEncoder,), batch=4)
    assert max(call_sizes) > 4
    for a, b in zip(narrow, wide):
        _same_features(_features(a.h5_path), _features(b.h5_path))


def test_block_rows_are_read_once_per_service(slide_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("ATLASPATCH_EMBED_BLOCK_CHUNKS", "3")
    feat_cfg = _feat_cfg(PORT, ["toy"], batch=4)
    cfg = _cfg(PORT, slide_dir, tmp_path / "out", features=feat_cfg)
    svc = _service(PORT, cfg, feat_cfg, ToyEncoder)
    monkeypatch.setenv("ATLASPATCH_EMBED_BLOCK_CHUNKS", "9")
    assert svc._block_rows == 12


def test_mid_slide_failure_isolated(slide_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("ATLASPATCH_EMBED_BLOCK_CHUNKS", "1")

    def reset(pkg, results):
        FlakyEncoder.calls = 0

    results, fails = _scenario(tmp_path, slide_dir, ["toy", "flaky"], (ToyEncoder, FlakyEncoder),
                               batch=4, prepare=reset)
    assert len(fails) == 2 and all("flaky" in str(e) for _s, e in fails)
    for res in results:
        assert set(_features(res.h5_path)) == {"toy"}
        assert res.metadata["feature_sets"] == ["toy"]


def test_model_creation_failure_isolated(slide_dir, tmp_path):
    results, fails = _scenario(tmp_path, slide_dir, ["toy", "missing-model"], (ToyEncoder,))
    assert len(fails) == len(results) and all(isinstance(e, KeyError) for _s, e in fails)
    for res in results:
        assert set(_features(res.h5_path)) == {"toy"}


def test_malformed_output_isolated(slide_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("ATLASPATCH_EMBED_BLOCK_CHUNKS", "1")

    def reset(pkg, results):
        MalformedEncoder.calls = 0

    results, fails = _scenario(tmp_path, slide_dir, ["toy", "malformed"], (ToyEncoder, MalformedEncoder),
                               batch=4, prepare=reset)
    assert len(fails) == 2
    for res in results:
        assert set(_features(res.h5_path)) == {"toy"}


def test_dataset_name_case_preserved(slide_dir, tmp_path):
    results, fails = _scenario(tmp_path, slide_dir, ["myenc", "toy"], (ToyEncoder, CasedEncoder))
    assert fails == []
    for res in results:
        assert set(_features(res.h5_path)) == {"MyEnc", "toy"}


def test_resume_over_partial_sets_and_idempotent_rerun(slide_dir, tmp_path):
    def precomplete_first(pkg, results):
        feat_cfg = _feat_cfg(pkg, ["toy"])
        cfg = _cfg(pkg, slide_dir, results[0].h5_path.parent.parent, features=feat_cfg)
        svc = _service(pkg, cfg, feat_cfg, ToyEncoder)
        assert svc.embed_all(results[:1], wsi_loader=pkg.loader.DefaultWSILoader()) == []

    results, fails = _scenario(tmp_path, slide_dir, ["toy", "toy2"], (ToyEncoder, ToyEncoder2),
                               prepare=precomplete_first)
    assert fails == []
    for res in results:
        assert set(_features(res.h5_path)) == {"toy", "toy2"}
    mtimes = [r.h5_path.stat().st_mtime_ns for r in results]
    feat_cfg = _feat_cfg(PORT, ["toy", "toy2"])
    cfg = _cfg(PORT, slide_dir, results[0].h5_path.parent.parent, features=feat_cfg)

    class Refuse(ToyEncoder):
        def extract_batch(self, patches, *, batch_size=None):
            raise AssertionError("a complete feature was embedded again")

    again = _service(PORT, cfg, feat_cfg, Refuse, ToyEncoder2)
    assert again.embed_all(results, wsi_loader=PORT.loader.DefaultWSILoader()) == []
    assert [r.h5_path.stat().st_mtime_ns for r in results] == mtimes


def test_partial_dataset_fails_only_the_collider(slide_dir, tmp_path):
    def plant_stale_rows(pkg, results):
        bad = results[0].h5_path
        if pkg is JAX:
            with h5py.File(bad, "a") as f:
                f.require_group("features").create_dataset(
                    "toy", data=np.zeros((1, 8), np.float32), maxshape=(None, 8))
        else:  # the port's own writer
            add_datasets(bad, {"toy": np.zeros((1, 8), np.float32)}, group="features")

    results, fails = _scenario(tmp_path, slide_dir, ["toy", "toy2"], (ToyEncoder, ToyEncoder2),
                               prepare=plant_stale_rows)
    assert len(fails) == 1 and "already exists" in str(fails[0][1])
    feats = _features(results[0].h5_path)
    assert feats["toy"][0].shape == (1, 8)
    assert feats["toy2"][0].shape == (results[0].num_patches, 4)  # the survivor landed
    assert set(_features(results[1].h5_path)) == {"toy", "toy2"}


def test_concurrent_writers_dedupe_via_locks(slide_dir, tmp_path):
    feat_cfg = _feat_cfg(PORT, ["toy", "toy2"], batch=4)
    cfg, results = _extract(PORT, slide_dir, tmp_path / "out", feat_cfg)
    fails: dict[int, list] = {}
    barrier = threading.Barrier(2)

    def run(idx):
        svc = _service(PORT, cfg, feat_cfg, ToyEncoder, ToyEncoder2)
        barrier.wait()
        fails[idx] = svc.embed_all(results, wsi_loader=PORT.loader.DefaultWSILoader())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fails == {0: [], 1: []}
    for res in results:
        feats = _features(res.h5_path)
        assert feats["toy"][0].shape == (res.num_patches, 8)
        assert feats["toy2"][0].shape == (res.num_patches, 4)
    leftovers = [p.name for p in results[0].h5_path.parent.iterdir() if not p.name.endswith(".h5")]
    assert leftovers == []


def test_embed_features_single_slide(slide_dir, tmp_path):
    feat_cfg = _feat_cfg(PORT, ["toy"])
    cfg, results = _extract(PORT, slide_dir, tmp_path / "out", feat_cfg)
    svc = _service(PORT, cfg, feat_cfg, ToyEncoder)
    wsi = PORT.loader.DefaultWSILoader().open(results[0].slide)
    res = svc.embed_features(results[0], wsi=wsi)
    assert res.metadata["feature_sets"] == ["toy"]
    assert _features(res.h5_path)["toy"][0].shape == (res.num_patches, 8)


def test_service_refusals(tmp_path, slide_dir):
    cfg = _cfg(PORT, slide_dir, tmp_path / "out")
    # int8 is served now: on the CPU it resolves to float32, as in the JAX package
    int8 = PORT.config.FeatureExtractionConfig(extractors=["toy"], device="cpu", precision="int8")
    svc = PORT.embedding.PatchFeatureEmbeddingService(cfg.extraction, cfg.output, int8, registry=_registry(PORT))
    assert svc.compute_dtype == JAX.embedding.resolve_feature_dtype("cpu", "int8") == "float32"
    plugin = tmp_path / "plugin.py"
    plugin.write_text("")
    plugins = PORT.config.FeatureExtractionConfig(extractors=["toy"], device="cpu", plugins=[plugin])
    # plugins load now; a module without the registration hook is refused
    with pytest.raises(AttributeError, match="register_feature_extractors"):
        PORT.embedding.PatchFeatureEmbeddingService(cfg.extraction, cfg.output, plugins)


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
@pytest.mark.parametrize("precision", ["float32", "float16", "bfloat16", "int8", "BFloat16"])
def test_resolve_feature_dtype_matches(device, precision):
    assert PORT.embedding.resolve_feature_dtype(device, precision) == \
        JAX.embedding.resolve_feature_dtype(device, precision)


# --- utils.features ------------------------------------------------------------------
@pytest.mark.parametrize("raw", ["a, B", "b a", "", "a a", "x", "A,b,,c"])
def test_parse_feature_list_matches(raw):
    choices = ["a", "B", "c"]

    def outcome(fn):
        try:
            return fn(raw, choices=choices)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(PORT.features.parse_feature_list) == outcome(JAX.features.parse_feature_list)


def _coords_file(path: Path, n: int, *, jax_writer: bool) -> Path:
    if jax_writer:
        with h5py.File(path, "w") as f:
            f.create_dataset("coords", data=np.zeros((n, 5), np.int32))
    else:
        with AtomicH5(path) as store:
            store.put_all("coords", np.zeros((n, 5), np.int32))
    return path


def test_existing_and_missing_features_match(tmp_path):
    files = {}
    for pkg in PKGS.values():
        p = _coords_file(tmp_path / f"{pkg.name}.h5", 6, jax_writer=pkg is JAX)
        writer = _writer(pkg)
        writer.append_features(output_path=p, feature_name="Done", feature_fn=lambda s, e: np.ones((e - s, 2)),
                               num_rows=6, feature_batch=4)
        writer.append_features(output_path=p, feature_name="short", feature_fn=lambda s, e: np.ones((e - s, 2)),
                               num_rows=3, feature_batch=4)
        files[pkg.name] = p
    for total in (None, 6, 3, 7):
        got = [pkg.features.get_existing_features(files[pkg.name], expected_total=total)
               for pkg in PKGS.values()]
        assert got[0] == got[1], total
        got = [pkg.features.missing_features(files[pkg.name], ["DONE", "short", "new"], expected_total=total)
               for pkg in PKGS.values()]
        assert got[0] == got[1], total
    assert PORT.features.get_existing_features(tmp_path / "absent.h5") == set()


def test_unreadable_h5_has_no_features_and_is_reprocessed(tmp_path, slide_dir):
    """An H5 the port's reader cannot read (one written by h5py) counts as
    holding no feature, and the runner reprocesses its slide, as the JAX
    package does with a file h5py cannot read."""
    lib = _coords_file(tmp_path / "lib.h5", 4, jax_writer=True)
    with h5py.File(lib, "a") as f:
        f.create_dataset("features/toy", data=np.ones((4, 8), np.float32))
    assert JAX.features.get_existing_features(lib) == {"toy"}
    assert PORT.features.get_existing_features(lib) == set()

    feat_cfg = _feat_cfg(PORT, ["toy"])
    cfg, results = _extract(PORT, slide_dir, tmp_path / "out", feat_cfg)
    h5 = results[0].h5_path
    coords = read_h5_tree(h5).datasets["coords"]
    with h5py.File(h5, "w") as f:  # the same slide's output, written by h5py
        f.create_dataset("coords", data=coords)
        f.attrs["num_patches"] = len(coords)
    runner = _runner(PORT, cfg)
    assert runner._build_existing_result(results[0].slide, h5) is None
    again, failures = runner.run()  # slide0 reprocessed; slide1's coords reused (toy missing)
    assert failures == [] and sorted(r.slide.stem for r in again) == ["slide0", "slide1"]
    assert read_h5_tree(h5).datasets["coords"].tobytes() == coords.tobytes()  # rewritten by the port


# --- storage: append_features_multi --------------------------------------------------
def _writer(pkg):
    return pkg.storage.H5PatchWriter(
        chunk_rows=8, patch_size=32, patch_size_level0=32, level0_mag=20,
        target_mag=20, level0_wh=(64, 64), overlap=0, slide_stem="s", wsi_path="s.png",
    )


def _both_files(tmp_path, n):
    tmp_path.mkdir(parents=True, exist_ok=True)
    return {pkg.name: _coords_file(tmp_path / f"{pkg.name}.h5", n, jax_writer=pkg is JAX)
            for pkg in PKGS.values()}


def _append_both(tmp_path, n, **kw):
    files = _both_files(tmp_path, n)
    out = {}
    for pkg in PKGS.values():
        try:
            out[pkg.name] = _writer(pkg).append_features_multi(output_path=files[pkg.name], **kw)
        except Exception as e:  # noqa: BLE001 — compared below
            out[pkg.name] = (type(e).__name__, str(e).split(" in ")[0])
    assert out[JAX.name] == out[PORT.name]
    jf, pf = _features(files[JAX.name]), _features(files[PORT.name])
    _same_features(jf, pf)
    return out[PORT.name], files[PORT.name]


def test_append_features_multi_roundtrip(tmp_path):
    blocks = []

    def block_fn(start, stop):
        blocks.append((start, stop))
        n = stop - start
        return {"a": np.full((n, 3), start, np.float32), "b": np.full((n, 2), -start, np.float32)}

    written, path = _append_both(tmp_path, 10, feature_names=["a", "b"], block_fn=block_fn,
                                 num_rows=10, feature_batch=4, expected_total=10,
                                 feature_attrs={"a": {"name": "a", "embedding_dim": 3}})
    assert written == {"a": 10, "b": 10}
    assert blocks == [(0, 4), (4, 8), (8, 10)] * 2
    feats = _features(path)
    assert feats["a"][0][5, 0] == 4 and feats["a"][1] == {"name": "a", "embedding_dim": 3}


def test_append_features_multi_drop_keeps_survivor(tmp_path):
    def block_fn(start, stop):
        n = stop - start
        out = {"a": np.ones((n, 3), np.float32)}
        if start == 0:
            out["b"] = np.ones((n, 2), np.float32)
        return out

    written, path = _append_both(tmp_path, 10, feature_names=["a", "b"], block_fn=block_fn,
                                 num_rows=10, feature_batch=4, expected_total=10)
    assert written == {"a": 10} and set(_features(path)) == {"a"}


@pytest.mark.parametrize("fault", ["raise", "not_2d", "short", "dim", "unknown", "total"])
def test_append_features_multi_error_leaves_the_file_as_it_was(tmp_path, fault):
    def block_fn(start, stop):
        n = stop - start
        if start >= 8 and fault == "raise":
            raise RuntimeError("boom")
        a = np.ones((n, 3), np.float32)
        if start >= 8:
            a = {"not_2d": np.ones(n), "short": a[1:], "dim": np.ones((n, 4)), "unknown": a,
                 "total": a}[fault]
        out = {"a": a, "b": np.ones((n, 2), np.float32)}
        if start >= 8 and fault == "unknown":
            out["c"] = a
        return out

    files = _both_files(tmp_path, 10)
    before = files[PORT.name].read_bytes()
    errors = []
    for pkg in PKGS.values():
        with pytest.raises((RuntimeError, ValueError)) as info:
            _writer(pkg).append_features_multi(
                output_path=files[pkg.name], feature_names=["a", "b"], block_fn=block_fn, num_rows=10,
                feature_batch=4, expected_total=11 if fault == "total" else 10)
        errors.append((info.type, str(info.value)))
    assert errors[0] == errors[1]
    assert files[PORT.name].read_bytes() == before
    assert list(tmp_path.glob(".stage-*")) == []
    with h5py.File(files[JAX.name]) as f:
        assert list(f["features"]) == []  # the JAX writer leaves an empty group


def test_append_features_multi_rejects_growth_duplicates_and_existing(tmp_path):
    out, _ = _append_both(tmp_path / "dup", 4, feature_names=["a", "a"], block_fn=lambda s, e: {},
                          num_rows=4, feature_batch=4)
    assert out[0] == "ValueError" and "Duplicate" in out[1]

    def growing(start, stop):
        return {"a": np.ones((stop - start, 3), np.float32), "c": np.ones((stop - start, 3), np.float32)}

    out, _ = _append_both(tmp_path / "grow", 4, feature_names=["a"], block_fn=growing, num_rows=4,
                          feature_batch=4)
    assert out[0] == "ValueError" and "unknown" in out[1]

    files = _both_files(tmp_path / "exists", 4)
    for pkg in PKGS.values():
        _writer(pkg).append_features(output_path=files[pkg.name], feature_name="a",
                                     feature_fn=lambda s, e: np.ones((e - s, 3)), num_rows=4, feature_batch=4)
        with pytest.raises(ValueError, match="already exists"):
            _writer(pkg).append_features(output_path=files[pkg.name], feature_name="a",
                                         feature_fn=lambda s, e: np.ones((e - s, 3)), num_rows=4,
                                         feature_batch=4)


@pytest.mark.parametrize("seed", range(12))
def test_append_features_multi_randomized_drop_patterns(tmp_path, seed):
    rng = np.random.default_rng(seed)
    num_rows = int(rng.integers(0, 40))
    batch = int(rng.integers(1, 8))
    dims = {f"f{i}": int(rng.integers(1, 9)) for i in range(int(rng.integers(1, 5)))}
    n_blocks = -(-num_rows // batch) if num_rows else 0
    drop_at = {name: (int(rng.integers(0, n_blocks)) if n_blocks and rng.random() < 0.4 else n_blocks)
               for name in dims}

    def block_fn(start, stop):
        return {n: np.full((stop - start, dims[n]), start + int(n[1:]) % 7, np.float32)
                for n in dims if start // batch < drop_at[n]}

    written, path = _append_both(
        tmp_path, num_rows, feature_names=list(dims), block_fn=block_fn, num_rows=num_rows,
        feature_batch=batch, feature_attrs={n: {"embedding_dim": d} for n, d in dims.items()},
        expected_total=num_rows)
    survivors = {n for n in dims if drop_at[n] >= n_blocks}
    assert set(written) == survivors == set(_features(path))


def test_append_features_multi_zero_rows_uses_attr_dim(tmp_path):
    written, path = _append_both(tmp_path, 0, feature_names=["a"], block_fn=lambda s, e: {},
                                 num_rows=0, feature_batch=4,
                                 feature_attrs={"a": {"embedding_dim": 7}}, expected_total=0)
    assert written == {"a": 0} and _features(path)["a"][0].shape == (0, 7)
    out, _ = _append_both(tmp_path / "no_dim", 0, feature_names=["a"], block_fn=lambda s, e: {},
                          num_rows=0, feature_batch=4)
    assert out[0] == "ValueError" and "embedding_dim" in out[1]


def test_append_keeps_every_old_dataset_and_attr(slide_dir, tmp_path):
    """h5py reads the appended file with every dataset and attr of the runner's
    file unchanged, creation_date included, and the new features/<name>."""
    feat_cfg = _feat_cfg(PORT, ["toy", "toy2"], batch=4)
    cfg, results = _extract(PORT, slide_dir, tmp_path / "out", feat_cfg)

    def snapshot(path):
        with h5py.File(path, "r") as f:
            data = {k: (f[k].dtype, f[k][()].tobytes()) for k in ("coords", "passports")}
            return data, {k: (type(v), v) for k, v in f.attrs.items()}

    before = [snapshot(r.h5_path) for r in results]
    toy_only = _feat_cfg(PORT, ["toy"], batch=4)
    first = _service(PORT, cfg, toy_only, ToyEncoder)  # one append, then a second on top
    assert first.embed_all(results, wsi_loader=PORT.loader.DefaultWSILoader()) == []
    both = _service(PORT, cfg, feat_cfg, ToyEncoder, ToyEncoder2)
    assert both.embed_all(results, wsi_loader=PORT.loader.DefaultWSILoader()) == []
    for res, (data, attrs) in zip(results, before):
        after_data, after_attrs = snapshot(res.h5_path)
        assert after_data == data
        assert after_attrs.keys() == attrs.keys()
        assert all(after_attrs[k][0] is attrs[k][0] and after_attrs[k][1] == attrs[k][1] for k in attrs)
        with h5py.File(res.h5_path, "r") as f:
            assert sorted(f) == ["coords", "features", "passports"]
            assert sorted(f["features"]) == ["toy", "toy2"]
            assert f["features/toy2"].shape == (res.num_patches, 4)
            assert f["features/toy2"].dtype == np.float32
            assert dict(f["features/toy2"].attrs) == {"name": "toy2", "embedding_dim": 4}
