"""The port's out-of-process fuzz campaign (``atlaspatch_tpu_torch/tools/fuzz_decoders.py``)
against the reference's (``tools/fuzz_decoders.py``).

The two tools must build the same corpus, byte for byte, and mutate it the
same way seed for seed, so that a finding of either replays through the other
with ``--formats X --seed S --cases 1``. The port's tool runs as a subprocess
with JAX, Flax and the JAX package refused at import, and writes the
reference's ``summary.json``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from atlaspatch_tpu_torch.tools import fuzz_decoders as port_tool

REPO = Path(__file__).resolve().parent.parent
SEEDS = 200


def _reference_tool():
    spec = importlib.util.spec_from_file_location("reference_fuzz_decoders", REPO / "tools" / "fuzz_decoders.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(port corpus, reference corpus), each built in its own directory."""
    port_root, ref_root = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("reference")
    return (port_root, port_tool.build_corpus(port_root)), (ref_root, _reference_tool().build_corpus(ref_root))


def test_corpus_is_the_reference_tools_byte_for_byte(corpora):
    (port_root, port), (ref_root, ref) = corpora
    assert list(port) == list(ref) and len(port) == 24

    def rel(root, paths):
        return tuple(p.relative_to(root) for p in paths)

    assert {k: rel(port_root, v) for k, v in port.items()} == {k: rel(ref_root, v) for k, v in ref.items()}
    files = sorted(p.relative_to(port_root) for p in port_root.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ref_root) for p in ref_root.rglob("*") if p.is_file())
    for f in files:
        assert (port_root / f).read_bytes() == (ref_root / f).read_bytes(), f


def test_mutations_are_the_reference_tools_seed_for_seed(corpora):
    (_, port), _ = corpora
    ref_tool = _reference_tool()
    for name, (_, target) in port.items():
        original = target.read_bytes()
        for seed in range(SEEDS):
            got = port_tool._mutate(np.random.default_rng(seed), original)
            assert got == ref_tool._mutate(np.random.default_rng(seed), original), (name, seed)


REFUSE_JAX = """
import runpy, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "atlaspatch_tpu"):
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Refuse())
for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "atlaspatch_tpu")]:
    del sys.modules[name]
sys.argv = ["fuzz_decoders", *sys.argv[1:]]
runpy.run_module("atlaspatch_tpu_torch.tools.fuzz_decoders", run_name="__main__")
"""


def test_campaign_runs_out_of_process_without_jax(tmp_path):
    formats = ["svs_jpeg", "mirax_index", "dicom"]
    proc = subprocess.run(
        [sys.executable, "-c", REFUSE_JAX, "--cases", "20", "--formats", ",".join(formats), "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [r["format"] for r in summary] == formats
    assert all(r["cases"] == 20 and r["crashes"] == [] and r["soft_hangs"] == 0 for r in summary)
    assert "TOTAL: 60 cases, 0 crash/hard-hang findings, 0 soft hangs" in proc.stdout


def test_a_crashing_case_is_attributed_to_its_seed(tmp_path, monkeypatch):
    """A child that dies by signal is a finding with the seed it was on, its
    input is copied out, and the campaign resumes after it."""
    import faulthandler
    import os
    import signal

    target = tmp_path / "slide.svs"
    target.write_bytes(b"II*\x00" + bytes(64))
    report = tmp_path / "report"
    report.mkdir()
    real = port_tool.run_case

    def crash_on_seed_7(open_path):
        if Path(report / "s.status").read_text() == "7":
            faulthandler.disable()  # the child dies quietly
            os.kill(os.getpid(), signal.SIGSEGV)
        return real(open_path)

    monkeypatch.setattr(port_tool, "run_case", crash_on_seed_7)
    monkeypatch.setattr(port_tool, "BATCH", 5)
    result = port_tool.fuzz_format("s", target, target, 12, 0, report)
    assert result["cases"] == 12 and result["crashes"] == [{"kind": "crash", "seed": "7", "exitcode": -11}]
    assert (report / "s.crash.7").read_bytes() == port_tool._mutate(np.random.default_rng(7), b"II*\x00" + bytes(64))
    assert target.read_bytes() == b"II*\x00" + bytes(64)


def test_the_import_rule_covers_the_tool():
    from tests import test_torch_import as rule

    assert "atlaspatch_tpu_torch.tools.fuzz_decoders" in rule._port_modules()
    assert not rule._imported_top_levels(Path(port_tool.__file__)) & rule.FORBIDDEN
