"""The PyTorch port stands alone: no JAX, Flax, optax or orbax, nothing of atlaspatch_tpu.

``atlaspatch_tpu_torch`` starts with ``atlaspatch_tpu``, so the checks match
the top-level module name exactly, never by prefix. Pillow, OpenCV, h5py and
click may be absent where the port runs on the card, so every port module
must also import without them; the command line (``atlaspatch_tpu_torch.cli``)
is built of click commands, so it alone may import click.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "atlaspatch_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "atlaspatch_tpu"}
# modules the device and geometry path must not need at import time
ABSENT_ON_CARD = {"PIL", "cv2", "h5py", "click"}
CLI = "atlaspatch_tpu_torch.cli"  # imports click, and nothing else of ABSENT_ON_CARD


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT)))
def test_no_forbidden_import_in_source(path):
    assert not _imported_top_levels(path) & FORBIDDEN


def test_every_port_module_imports_with_jax_and_host_libraries_blocked():
    blocked = sorted(FORBIDDEN | ABSENT_ON_CARD)
    script = f"""
import importlib, sys

BLOCKED = {blocked!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
# a site hook may have imported some of them already: forget them, so that
# any later import goes through the finder
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]
for mod in {[m for m in _port_modules() if m != CLI]!r}:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
BLOCKED.remove("click")
importlib.import_module({CLI!r})
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", script],
        cwd=PORT.parent,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_service_refuses_cuda_without_a_card(monkeypatch):
    import torch

    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SAM2SegmentationService(device="cuda")


@pytest.mark.parametrize(
    "spec,want",
    [("cpu", "cpu"), ("CUDA", "cuda"), ("cuda:1", "cuda:1"), ("gpu", "cuda"), ("gpu:0", "cuda:0")],
)
def test_normalize_device(spec, want):
    from atlaspatch_tpu_torch.core.config import normalize_device

    assert normalize_device(spec) == want


@pytest.mark.parametrize("spec", ["tpu", "cuda:x", "mps"])
def test_normalize_device_rejects(spec):
    from atlaspatch_tpu_torch.core.config import normalize_device

    with pytest.raises(ValueError):
        normalize_device(spec)


def test_segmentation_config_defaults_to_the_card():
    from atlaspatch_tpu_torch.core.config import SegmentationConfig

    assert SegmentationConfig().validated().device == "cuda"


def test_the_int8_and_device_op_modules_are_checked():
    """The modules of the int8 serving mode and the device ops are among
    those the checks above import and parse."""
    mods = _port_modules()
    for mod in ("ops.int8", "ops.filters", "ops.resize", "models.encoders.vit"):
        assert f"atlaspatch_tpu_torch.{mod}" in mods
