"""The port's weight tools (atlaspatch_tpu_torch/tools/{verify_weights,
drift_check,convert_weights}.py and the ``verify-weights`` command) against the
JAX package's.

One weights directory serves both packages: upstream-layout checkpoints
(``tests/upstream_layouts.py`` shapes from the JAX towers, seeded values from
``tests/upstream_values.py::fill``) saved as ``.pt``, ``.pth`` and F32
``.safetensors``, a ``.npz`` archive of the Flax tree, one checkpoint with
a tensor's shape cut, one of the wrong tower, and names without a file.
``run_preflight`` gives the JAX tool's (name, status) rows on it, with and
without the forward smoke (on the CPU), and so does ``verify-weights``
through both command lines, with the same exit codes; without a card the
port's default device stops with the usage error naming ``--device cpu``.
``drift_check``'s patches are the JAX tool's bytes, and its snapshot of a
checkpoint on the CPU matches the JAX snapshot by ``compare``.
``convert_weights`` writes archives equal, key for key and bit for bit, to
the JAX tool's.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from atlaspatch_tpu.models.encoders import zoo as jax_zoo
from atlaspatch_tpu.tools import convert_weights as jax_convert
from atlaspatch_tpu.tools import drift_check as jax_drift
from atlaspatch_tpu.tools import verify_weights as jax_verify
from atlaspatch_tpu_torch.tools import convert_weights, drift_check, verify_weights
from tests.upstream_layouts import synth_state_dict
from upstream_values import fill
from torch_port_helpers import free_tmp_path, invoke_cli  # noqa: F401 (free_tmp_path: autouse)

NAMES = ["resnet18", "lunit_vit_small_patch16_dino", "dinov2_small", "chief-ctranspath",
         "resnet34", "vit_b_32", "resnet50"]
# the forward smoke runs the JAX towers op by op: the slow Swin and DINOv2 stay out
SMOKE_NAMES = [n for n in NAMES if n not in ("dinov2_small", "chief-ctranspath")]


def _upstream(name: str, seed: int) -> dict:
    """``name``'s full-size checkpoint in its upstream layout, seeded values."""
    ref = jax_zoo.ENTRIES[name]
    size = ref.preprocess.crop
    target = jax.eval_shape(lambda: jax_zoo._model_for(ref).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)))["params"]
    return fill(synth_state_dict(ref, jax.tree.map(lambda x: x, target)), seed)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    torch.save({k: torch.from_numpy(v) for k, v in _upstream("resnet18", 1).items()}, d / "resnet18.pt")
    save_file(_upstream("lunit_vit_small_patch16_dino", 2), str(d / "lunit_vit_small_patch16_dino.safetensors"))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in _upstream("chief-ctranspath", 3).items()}},
               d / "chief-ctranspath.pth")
    tree = jax_zoo._convert(jax_zoo.ENTRIES["dinov2_small"], _upstream("dinov2_small", 4))
    np.savez(d / "dinov2_small.npz", **jax_convert._flatten(tree))
    bad = {k: torch.from_numpy(v) for k, v in _upstream("resnet34", 5).items()}
    bad["layer2.1.conv2.weight"] = bad["layer2.1.conv2.weight"][:, :-1]  # one tensor's shape cut
    torch.save(bad, d / "resnet34.pt")
    shutil.copy(d / "resnet18.pt", d / "vit_b_32.pt")  # a checkpoint of the wrong tower
    yield d  # resnet50: no file
    shutil.rmtree(d)


@pytest.fixture(autouse=True)
def _no_hf_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)


def _rows(results) -> list[tuple[str, str]]:
    return [(r.name, r.status) for r in results]


@pytest.mark.parametrize("smoke", [False, True], ids=["no_smoke", "smoke"])
def test_preflight_rows_are_the_jax_ones(weights_dir, smoke):
    names = SMOKE_NAMES if smoke else NAMES
    ours, theirs = [], []
    got = verify_weights.run_preflight(weights_dir, names=names, smoke=smoke, include_sam2=False,
                                       device="cpu", report=ours.append)
    want = jax_verify.run_preflight(weights_dir, names=names, smoke=smoke, include_sam2=False,
                                    report=theirs.append)
    rows = [("resnet18", "PASS"), ("lunit_vit_small_patch16_dino", "PASS"), ("dinov2_small", "PASS"),
            ("chief-ctranspath", "PASS"), ("resnet34", "FAIL"), ("vit_b_32", "FAIL"), ("resnet50", "SKIP")]
    assert _rows(got) == _rows(want) == [r for r in rows if r[0] in names]
    n_pass = sum(r[1] == "PASS" for r in _rows(got))
    assert ours[-1] == theirs[-1] == f"preflight: {n_pass} PASS, 2 FAIL, 1 SKIP"
    by_name = {r.name: r for r in got}
    assert "layer2.1.conv2.weight" in by_name["resnet34"].detail and "shape" in by_name["resnet34"].detail
    for name, detail in [(r.name, r.detail) for r in want if r.status == "PASS"]:
        assert by_name[name].detail == detail, name  # params counted the same, same message
    assert all(line.startswith(("PASS", "FAIL", "SKIP", "preflight:")) for line in ours)


def test_preflight_unknown_name_and_the_environment(weights_dir, monkeypatch):
    with pytest.raises(ValueError, match="unknown encoder"):
        verify_weights.run_preflight(weights_dir, names=["not_a_model"], report=lambda _s: None)
    monkeypatch.setenv("ATLASPATCH_WEIGHTS_DIR", "/elsewhere")
    verify_weights.run_preflight(weights_dir, names=["resnet50"], device="cpu", report=lambda _s: None)
    assert os.environ["ATLASPATCH_WEIGHTS_DIR"] == "/elsewhere"


def test_sam2_rows_are_the_jax_ones(tmp_path):
    """hiera-tiny's tree passes; the miniature config's fails (the JAX tool
    by its shape diffs, the port's converter on the blocks it lacks)."""
    from atlaspatch_tpu.models.sam2.config import SAM2Config
    from atlaspatch_tpu.models.sam2.model import init_params

    rows = {}
    for cfg_name, file in (("tiny", "sam2_hiera_tiny.npz"), ("test_tiny", "sam2_wrong.npz")):
        shapes = jax.eval_shape(lambda: init_params(getattr(SAM2Config, cfg_name)()))
        np.savez(tmp_path / file, **jax_convert._flatten(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)))
        got = verify_weights.verify_sam2(tmp_path / file, smoke=False, device="cpu")
        want = jax_verify.verify_sam2(tmp_path / file, smoke=False)
        rows[file] = (got.status, want.status)
    assert rows == {"sam2_hiera_tiny.npz": ("PASS", "PASS"), "sam2_wrong.npz": ("FAIL", "FAIL")}


def _cli_rows(result) -> list[tuple[str, str]]:
    return [(ln.split()[1], ln.split()[0]) for ln in result.stdout.splitlines()
            if ln.startswith(("PASS", "FAIL", "SKIP"))]


@pytest.mark.parametrize("names,code", [("resnet18,dinov2_small,resnet50", 0), (",".join(NAMES), 1)])
def test_verify_weights_command_in_both_clis(weights_dir, names, code):
    args = ["verify-weights", weights_dir, "--names", names, "--no-smoke", "--no-sam2"]
    want = invoke_cli("atlaspatch_tpu", args)
    got = invoke_cli("atlaspatch_tpu_torch", [*args, "--device", "cpu"])
    assert (got.exit_code, want.exit_code) == (code, code), got.output
    assert _cli_rows(got) == _cli_rows(want) and len(_cli_rows(got)) == names.count(",") + 1
    assert got.stdout.splitlines()[-1] == want.stdout.splitlines()[-1]


def test_verify_weights_without_a_card(weights_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result = invoke_cli("atlaspatch_tpu_torch", ["verify-weights", weights_dir, "--names", "resnet18"])
    assert result.exit_code == 2 and "--device cpu" in result.output
    assert "PASS" not in result.output
    bad = invoke_cli("atlaspatch_tpu_torch", ["verify-weights", weights_dir, "--device", "tpu"])
    assert bad.exit_code == 2 and "TPU" in bad.output


def test_drift_patches_are_the_jax_bytes():
    ours, theirs = drift_check.make_patches(), jax_drift.make_patches()
    assert ours.dtype == theirs.dtype == np.uint8 and ours.tobytes() == theirs.tobytes()
    assert (drift_check.N_PATCHES, drift_check.PATCH_PX, drift_check.SEED) == \
        (jax_drift.N_PATCHES, jax_drift.PATCH_PX, jax_drift.SEED)


def test_drift_snapshot_and_compare_on_the_cpu(weights_dir, tmp_path, monkeypatch):
    """The port's snapshot of resnet18 from the shared checkpoint, with the
    JAX package's snapshot standing in for the reference side."""
    monkeypatch.setenv("ATLASPATCH_WEIGHTS_DIR", str(weights_dir))
    monkeypatch.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
    assert drift_check.snapshot(tmp_path, ["resnet18", "resnet50"], device="cpu") == 1  # resnet50 has no file
    assert jax_drift.snapshot(tmp_path / "jax", ["resnet18"], device="cpu") == 0
    assert np.load(tmp_path / "patches.npy").tobytes() == drift_check.make_patches().tobytes()
    shutil.copy(tmp_path / "jax" / "resnet18.ours.npy", tmp_path / "resnet18.ref.npy")
    assert drift_check.compare(tmp_path, tolerance=1e-3) == 0
    assert drift_check.main(["compare", str(tmp_path)]) == 0
    np.save(tmp_path / "resnet18.ref.npy", np.load(tmp_path / "resnet18.ref.npy") * 1.01)
    assert drift_check.compare(tmp_path, tolerance=1e-3) == 1
    (tmp_path / "resnet18.ref.npy").unlink()
    assert drift_check.compare(tmp_path, tolerance=1e-3) == 0  # no reference: SKIP


def _same_archive(a: Path, b: Path) -> None:
    with np.load(a) as x, np.load(b) as y:
        assert list(x.keys()) == list(y.keys())
        for key in x.keys():
            assert x[key].dtype == y[key].dtype and np.array_equal(x[key], y[key]), key


@pytest.mark.parametrize("name", ["resnet18", "convnext_tiny", "lunit_vit_small_patch16_dino",
                                  "dinov2_small", "dinov3_vits16", "chief-ctranspath"])
def test_convert_weights_archives_equal_the_jax_ones(name, tmp_path):
    src = tmp_path / f"{name}.pt"
    torch.save({k: torch.from_numpy(v) for k, v in _upstream(name, 6).items()}, src)
    ours = convert_weights.convert_encoder(name, src, tmp_path / "ours")
    theirs = jax_convert.convert_encoder(name, src, tmp_path / "jax")
    assert ours.name == theirs.name == f"{name}.npz"
    _same_archive(ours, theirs)


def test_convert_weights_sam2_and_the_command(tmp_path, capsys):
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.model import init_params

    src = tmp_path / "model.pth"
    torch.save(init_params(SAM2Config.tiny(), seed=3).state_dict(), src)
    convert_weights.main(["sam2", str(src), "--out", str(tmp_path / "ours")])
    assert capsys.readouterr().out.strip() == f"wrote {tmp_path / 'ours' / 'sam2_hiera_tiny.npz'}"
    theirs = jax_convert.convert_sam2(src, tmp_path / "jax")
    _same_archive(tmp_path / "ours" / "sam2_hiera_tiny.npz", theirs)
