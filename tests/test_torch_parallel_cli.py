"""``process --seg-data-parallel --feature-parallel tensor`` and
``--feature-parallel tensor --feature-precision int8`` on 8 CPU "devices"
(``local_devices`` patched) against one device (see
``tests/test_torch_parallel.py`` for the setting and the bars).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from atlaspatch_tpu_torch.parallel import mesh
from torch_parallel_helpers import _cpus
from torch_port_helpers import free_tmp_path  # noqa: F401


# ---------------------------------------------------------------- the command line
@pytest.fixture
def mesh_cli(tmp_path, monkeypatch):
    """The port's CLI with test_tiny SAM2 (random weights) and vit_l_32 cut
    to depth 2 (full width: 16 heads split 8 ways)."""
    from atlaspatch_tpu_torch.models.encoders import zoo
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from torch_port_helpers import write_png_slides

    monkeypatch.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    entry = zoo.ENTRIES["vit_l_32"]
    monkeypatch.setitem(zoo.ENTRIES, "vit_l_32", dataclasses.replace(entry, spec=dataclasses.replace(entry.spec,
                                                                                                      depth=2)))
    return write_png_slides(tmp_path, {"s0": 0, "s1": 1}, {"s0": 0.5, "s1": 0.5})


def _process(slides, csv, out, *extra):
    from torch_port_helpers import invoke_cli

    return invoke_cli("atlaspatch_tpu_torch", [
        "process", slides, "--output", out, "--patch-size", "64", "--target-mag", "20", "--device", "cpu",
        "--seg-batch-size", "8", "--feature-extractors", "vit_l_32", "--feature-batch-size", "16",
        "--mpp-csv", csv, "--verbose", *extra])


def test_process_on_an_8_device_mesh_matches_one_device(mesh_cli, tmp_path, monkeypatch):
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    slides, csv = mesh_cli
    result = _process(slides, csv, tmp_path / "single")
    assert result.exit_code == 0 and "failures: 0" in result.output, result.output
    built = []
    init = SAM2SegmentationService.__init__

    def record(self, cfg, *a, mesh=None, **kw):
        built.append(mesh)
        init(self, cfg, *a, mesh=mesh, **kw)

    monkeypatch.setattr(SAM2SegmentationService, "__init__", record)
    monkeypatch.setattr(mesh, "local_devices", lambda kind="cuda": _cpus(8))
    result = _process(slides, csv, tmp_path / "mesh", "--seg-data-parallel", "--feature-parallel", "tensor")
    assert result.exit_code == 0 and "failures: 0" in result.output, result.output
    assert built[0].shape == {"data": 8, "model": 1}
    for stem in ("s0", "s1"):
        a = read_h5(tmp_path / "single" / "patches" / f"{stem}.h5")[0]
        b = read_h5(tmp_path / "mesh" / "patches" / f"{stem}.h5")[0]
        ca, cb = a["coords"], b["coords"]
        assert ca.shape[0] > 0 and ca.tobytes() == cb.tobytes()
        fa, fb = a["features/vit_l_32"], b["features/vit_l_32"]
        assert fa.shape == fb.shape == (ca.shape[0], 1024)
        assert np.isfinite(fa).all() and np.isfinite(fb).all()
        cos = np.sum(fa * fb, -1) / (np.linalg.norm(fa, axis=-1) * np.linalg.norm(fb, axis=-1))
        assert cos.min() > 0.9999, f"{stem}: min cosine {cos.min()}"


def test_tensor_parallel_int8_is_refused_before_any_slide(mesh_cli, tmp_path, monkeypatch):
    """Named when tensor-parallel int8 was refused: ``process --feature-parallel
    tensor --feature-precision int8`` on 8 CPU "devices" (one (1, 8) mesh)
    gives one device's coordinates byte for byte and its int8 features bit
    for bit. On the CPU ``int8`` resolves to float32, as in the JAX package;
    here it is held at int8 so the W8A8 shards run (their plain versions)."""
    from atlaspatch_tpu_torch.models.encoders.vit import RowParallel
    from atlaspatch_tpu_torch.services import feature_embedding
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    slides, csv = mesh_cli
    monkeypatch.setattr(feature_embedding, "resolve_feature_dtype", lambda device, precision: precision)
    result = _process(slides, csv, tmp_path / "one", "--feature-precision", "int8")
    assert result.exit_code == 0 and "failures: 0" in result.output, result.output
    built = []
    shard = RowParallel._int8_forward

    def record(self, x):
        built.append(len(self.shards))
        return shard(self, x)

    monkeypatch.setattr(RowParallel, "_int8_forward", record)
    monkeypatch.setattr(mesh, "local_devices", lambda kind="cuda": _cpus(8))
    result = _process(slides, csv, tmp_path / "o", "--feature-parallel", "tensor", "--feature-precision", "int8")
    assert result.exit_code == 0 and "failures: 0" in result.output, result.output
    assert built and set(built) == {8}
    for stem in ("s0", "s1"):
        a = read_h5(tmp_path / "one" / "patches" / f"{stem}.h5")[0]
        b = read_h5(tmp_path / "o" / "patches" / f"{stem}.h5")[0]
        assert a["coords"].shape[0] > 0 and a["coords"].tobytes() == b["coords"].tobytes()
        fa, fb = a["features/vit_l_32"], b["features/vit_l_32"]
        assert fa.shape == (a["coords"].shape[0], 1024) and np.isfinite(fa).all()
        np.testing.assert_array_equal(fb, fa)
