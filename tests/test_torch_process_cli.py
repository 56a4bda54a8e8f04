"""``process`` in the port's command line (atlaspatch_tpu_torch/cli.py) against
the JAX package's, with a zoo CNN and a feature plugin.

One module fixture runs, through each CLI with ``--device cpu`` over the same
two PNG slides (miniature SAM2, one shared weight archive):
``segment-and-get-coords``, then ``process --feature-extractors "resnet18
toy_pool"`` on the same output, which reuses the coordinates. resnet18's
weights are one torchvision-layout ``.pth`` (numpy from a seed) in
ATLASPATCH_WEIGHTS_DIR that both zoos find; ``toy_pool`` comes from a plugin
module per package (``--feature-plugin``), both computing one numpy-defined
function (8x8 mean pooling of the normalized 32x32 image, a fixed 48x8
projection, tanh) by each package's contract: a Flax-style apply function and
params in the JAX package, an ``nn.Module`` on (B, 3, H, W) in the port.

  * the same stdout lines;
  * ``process`` leaves every dataset and file attr that segmentation wrote
    as it was, in both packages;
  * where a slide's coordinates agree, both features match the JAX
    package's: float32 on the CPU, max-abs within 1e-4, with the same
    dataset attrs.

``process --feature-precision int8`` on the segmented output (a copy made
before the float run) gives the JAX CLI's lines and H5 files: on the CPU
both packages resolve int8 to float32.

Without the model: a plugin module without the hook raises the JAX package's
error type, and a precision neither CLI offers is refused before any slide
is touched.
"""

import importlib
import shutil

import h5py
import numpy as np
import pytest

from atlaspatch_tpu.models.encoders.resnet import RESNET_SPECS
from torch_port_helpers import (
    CLI_PACKAGES,
    invoke_cli,
    shared_cli_weights,
    stdout_lines,
    torchvision_cnn_sd,
    write_png_slides,
)

TOL = 1e-4  # float32, CPU, max-abs
FEATURES = {"resnet18": 512, "toy_pool": 8}

_PROJECTION = "np.random.default_rng(0).normal(0.0, 0.5, (48, 8)).astype(np.float32)"
PLUGINS = {
    "atlaspatch_tpu": f"""
import jax.numpy as jnp
import numpy as np

from atlaspatch_tpu.models.encoders.custom import CustomEncoderComponents, register_custom_encoder
from atlaspatch_tpu.models.encoders.engine import PreprocessSpec

W = {_PROJECTION}


def apply(params, x):
    pooled = x.reshape(x.shape[0], 4, 8, 4, 8, 3).mean(axis=(2, 4)).reshape(x.shape[0], 48)
    return jnp.tanh(pooled @ params["w"])


def register_feature_extractors(registry, device, dtype, num_workers):
    def loader(device, dtype):
        return CustomEncoderComponents(preprocess=PreprocessSpec(crop=32, resize=32, mode="square"),
                                       apply_fn=apply, params={{"w": W}})

    register_custom_encoder(registry=registry, name="toy_pool", embedding_dim=8, loader=loader,
                            device=None, dtype=dtype, num_workers=num_workers)
""",
    "atlaspatch_tpu_torch": f"""
import numpy as np
import torch

from atlaspatch_tpu_torch.models.encoders.custom import CustomEncoderComponents, register_custom_encoder
from atlaspatch_tpu_torch.models.encoders.engine import PreprocessSpec

W = {_PROJECTION}


class ToyPool(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(W))

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        pooled = x.reshape(x.shape[0], 4, 8, 4, 8, 3).mean(dim=(2, 4)).reshape(x.shape[0], 48)
        return torch.tanh(pooled @ self.w)


def register_feature_extractors(registry, device, dtype, num_workers):
    def loader(device, dtype):
        return CustomEncoderComponents(preprocess=PreprocessSpec(crop=32, resize=32, mode="square"),
                                       model=ToyPool())

    register_custom_encoder(registry=registry, name="toy_pool", embedding_dim=8, loader=loader,
                            device=device, dtype=dtype, num_workers=num_workers)
""",
}


def _h5(path) -> tuple[dict, dict, dict]:
    """Datasets {path: (dtype, shape, bytes)}, dataset attrs and file attrs
    (all but creation_date) as h5py reads them."""
    datasets, dataset_attrs = {}, {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            arr = obj[()]
            datasets[name] = (arr.dtype, arr.shape, arr.tobytes())
            dataset_attrs[name] = dict(obj.attrs)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
        attrs = {k: f.attrs[k] for k in f.attrs if k != "creation_date"}
    return datasets, dataset_attrs, attrs


def _feature_args(slides, out, csv, plugin, *extra):
    return ["process", slides, "--output", out, "--patch-size", "256", "--target-mag", "20",
            "--device", "cpu", "--mpp-csv", csv, "--feature-plugin", plugin, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("process")
    slides, csv = write_png_slides(tmp, {"s0": 0, "s1": 1}, {"s0": 0.5, "s1": 0.5})
    record = {}
    with pytest.MonkeyPatch.context() as mp:
        shared_cli_weights(mp, tmp)
        import torch

        torch.save(torchvision_cnn_sd("resnet", RESNET_SPECS["resnet18"], seed=21),
                   tmp / "weights" / "resnet18.pth")
        for pkg in CLI_PACKAGES:
            out = tmp / f"out-{pkg}"
            plugin = tmp / f"plugin_{pkg}.py"
            plugin.write_text(PLUGINS[pkg])
            seg = invoke_cli(pkg, ["segment-and-get-coords", slides, "--output", out, "--patch-size", "256",
                                   "--target-mag", "20", "--device", "cpu", "--mpp-csv", csv],
                             catch_exceptions=False)
            before = {s: _h5(out / "patches" / f"{s}.h5") for s in ("s0", "s1")}
            out_int8 = tmp / f"out-int8-{pkg}"
            shutil.copytree(out, out_int8)
            proc = invoke_cli(pkg, _feature_args(slides, out, csv, plugin, "--feature-extractors",
                                                 "resnet18 toy_pool", "--verbose"), catch_exceptions=False)
            after = {s: _h5(out / "patches" / f"{s}.h5") for s in ("s0", "s1")}
            int8 = invoke_cli(pkg, _feature_args(slides, out_int8, csv, plugin, "--feature-extractors", "toy_pool",
                                                 "--feature-precision", "int8"), catch_exceptions=False)
            record[pkg] = {"out": out, "seg": seg, "process": proc, "before": before, "after": after,
                           "int8": int8, "out_int8": out_int8,
                           "after_int8": {s: _h5(out_int8 / "patches" / f"{s}.h5") for s in ("s0", "s1")}}
    return record


def test_process_prints_the_same_lines(runs):
    results = [runs[pkg]["process"] for pkg in CLI_PACKAGES]
    assert [r.exit_code for r in results] == [0, 0], results[1].output
    want, got = (sorted(stdout_lines(runs[pkg]["process"], runs[pkg]["out"])) for pkg in CLI_PACKAGES)
    assert "Completed 2 slide(s), failures: 0" in want
    assert got == want


def test_process_int8_matches_the_jax_cli(runs):
    results = [runs[pkg]["int8"] for pkg in CLI_PACKAGES]
    assert [r.exit_code for r in results] == [0, 0], results[1].output
    want, got = (stdout_lines(runs[pkg]["int8"], runs[pkg]["out_int8"]) for pkg in CLI_PACKAGES)
    assert "Completed 2 slide(s), failures: 0" in want
    assert sorted(got) == sorted(want)
    compared = 0
    for stem in ("s0", "s1"):
        (want_h5, want_attrs, want_file), (got_h5, got_attrs, got_file) = (
            runs[pkg]["after_int8"][stem] for pkg in CLI_PACKAGES)
        assert sorted(got_h5) == sorted(want_h5) and got_file == want_file
        if got_h5["coords"] != want_h5["coords"]:
            continue
        assert got_attrs["features/toy_pool"] == want_attrs["features/toy_pool"]
        (wdt, wshape, wbytes), (gdt, gshape, gbytes) = want_h5["features/toy_pool"], got_h5["features/toy_pool"]
        assert wdt == gdt == np.float32 and wshape == gshape
        assert np.abs(np.frombuffer(gbytes, np.float32) - np.frombuffer(wbytes, np.float32)).max() <= TOL
        compared += 1
    assert compared, "no slide's coordinates agree"


@pytest.mark.parametrize("pkg", CLI_PACKAGES)
def test_process_leaves_coords_and_attrs_unchanged(runs, pkg):
    for stem, (data, _dattrs, attrs) in runs[pkg]["before"].items():
        after, _dattrs_after, attrs_after = runs[pkg]["after"][stem]
        assert {k: v for k, v in after.items() if not k.startswith("features/")} == data
        assert attrs_after == attrs
        assert data["coords"][1][0] > 0, f"{stem}: no patch"


@pytest.mark.parametrize("name", list(FEATURES))
def test_features_match_jax(runs, name):
    compared = 0
    for stem in ("s0", "s1"):
        (want, want_attrs, _), (got, got_attrs, _) = (runs[pkg]["after"][stem] for pkg in CLI_PACKAGES)
        if got["coords"] != want["coords"]:
            continue  # the masks differed (slice 1's bar); nothing to compare row by row
        key = f"features/{name}"
        assert got_attrs[key] == want_attrs[key] == {"name": name, "embedding_dim": FEATURES[name]}
        (wdt, wshape, wbytes), (gdt, gshape, gbytes) = want[key], got[key]
        assert wdt == gdt == np.float32 and wshape == gshape == (want["coords"][1][0], FEATURES[name])
        diff = np.abs(np.frombuffer(gbytes, np.float32) - np.frombuffer(wbytes, np.float32))
        assert diff.max() <= TOL
        compared += 1
    assert compared, "no slide's coordinates agree"


def test_plugin_without_the_hook_raises_the_jax_error_type(tmp_path):
    slides, csv = write_png_slides(tmp_path, {"s0": 0}, {"s0": 0.5})
    plugin = tmp_path / "empty_plugin.py"
    plugin.write_text("VALUE = 1\n")
    errors = []
    for pkg in CLI_PACKAGES:
        out = tmp_path / f"out-{pkg}"
        result = invoke_cli(pkg, _feature_args(slides, out, csv, plugin, "--feature-extractors", "resnet18"))
        errors.append(type(result.exception))
        assert "register_feature_extractors" in str(result.exception)
        assert not (out / "patches").exists()
    assert errors == [AttributeError, AttributeError]


def test_int8_is_refused_before_any_slide(tmp_path, monkeypatch):
    slides, csv = write_png_slides(tmp_path, {"s0": 0}, {"s0": 0.5})
    plugin = tmp_path / "plugin.py"
    plugin.write_text(PLUGINS[CLI_PACKAGES[1]])
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    called = []
    service = importlib.import_module(f"{CLI_PACKAGES[1]}.services.segmentation").SAM2SegmentationService
    monkeypatch.setattr(service, "__init__", lambda *a, **k: called.append(1))
    # int8 is served now (runs_int8 below): it passes the feature service's build
    # and reaches segmentation; a precision neither CLI offers is refused before any slide
    result = invoke_cli(CLI_PACKAGES[1], _feature_args(slides, tmp_path / "o", csv, plugin, "--feature-extractors",
                                                       "toy_pool", "--feature-precision", "int8"))
    assert called == [1], result.output
    called.clear()
    result = invoke_cli(CLI_PACKAGES[1], _feature_args(slides, tmp_path / "o2", csv, plugin, "--feature-extractors",
                                                       "toy_pool", "--feature-precision", "int4"))
    assert result.exit_code == 2 and "int4" in result.output
    assert called == [] and not (tmp_path / "o2" / "patches").exists()
