"""What the benchmark loads: never JAX or the JAX package, and the reference
nothing of the program; nothing reads the JAX package's bench or tools."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench import harness

REHEARSE = """
import json, sys
sys.path.insert(0, {root!r})
import pytest
from pathlib import Path
from portbench import harness
from portbench.tests import rehearsal

def main():
    mp = pytest.MonkeyPatch()
    cache = Path({cache!r})
    for cell in ("embed.virchow2_bf16",):
        ctx = rehearsal.embed_context(cell, mp, cache=cache, seconds=0.5)
        harness.traffic_module(ctx.workload["traffic"]["kind"]).run(ctx)
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))

if __name__ == "__main__":
    main()
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.reference import flops, geometry, slide, vit
from portbench import harness
flops.vit_flops_per_patch(harness.config("virchow2"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(script: str, tmp_path) -> set[str]:
    path = tmp_path / "probe.py"
    path.write_text(script)
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_traffic_rehearsal_loads_jax(tmp_path):
    loaded = _top_level(REHEARSE.format(root=str(harness.ROOT), cache=str(tmp_path / "cohort")), tmp_path)
    assert "atlaspatch_tpu_torch" in loaded  # the traffic modules did run the port
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)
    assert not loaded & {"bench", "chip_smoke", "tools"}


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    loaded = _top_level(REFERENCE.format(root=str(harness.ROOT)), tmp_path)
    assert "torch" in loaded
    assert not loaded & ({"atlaspatch_tpu_torch", "bench", "chip_smoke", "tools"} | set(harness.FORBIDDEN))


def test_no_source_names_the_jax_package_or_its_bench():
    for path in harness.BENCH.rglob("*.py"):
        if "tests" in path.relative_to(harness.BENCH).parts:
            continue
        text = path.read_text()
        for word in ("import jax", "from jax", "import flax", "atlaspatch_tpu.", "atlaspatch_tpu ",
                     "bench.py", "chip_smoke", "BENCH_r", "from tools", "import tools"):
            assert word not in text, (path, word)
