"""BENCHMARK.json against the benchmark's rules, and every cell's files
found by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return harness.manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) <= 64 * 1024
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    assert spec["paths"] == ["portbench"] and all(PATH.match(p) for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(spec):
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
    assert {"setup_s"} <= {m["name"] for m in spec["end_to_end"]}
    assert next(m for m in spec["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_every_cell_is_found_by_name(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        cell = harness.workload(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert (harness.ROOT / configs[w["config"]]["file"]).is_file()
        assert harness.config(w["config"])["name"] == w["config"]
        assert callable(harness.traffic_module(cell["traffic"]["kind"]).run)
        reported = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        layers = [m for m in spec["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in {r["name"] for r in reported}
    for m in spec["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)
        assert e2e[m["moves"]]
    used = {w["config"] for w in spec["workloads"]}
    assert used == set(configs)


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path, monkeypatch, spec):
    """A copy of the benchmark with one more cell, configuration and metric,
    each a new file and a BENCHMARK.json entry: the harness finds them all."""
    bench = tmp_path / "portbench"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    cell = json.loads((bench / "workloads" / "embed.virchow2_bf16.json").read_text())
    cell.update(name="embed.virchow2_bf16_b64", config="virchow2_copy", why="batch 64")
    cell["traffic"]["feature_batch_size"] = 64
    (bench / "workloads" / "embed.virchow2_bf16_b64.json").write_text(json.dumps(cell))
    cfg = json.loads((bench / "configs" / "virchow2.json").read_text())
    (bench / "configs" / "virchow2_copy.json").write_text(json.dumps({**cfg, "name": "virchow2_copy"}))
    (bench / "metrics" / "rows_forwarded.py").write_text(
        "def read(layer):\n    return layer.get('counts', {}).get('rows')\n")
    new = json.loads(json.dumps(spec))
    new["configs"].append({**new["configs"][0], "name": "virchow2_copy", "file": "portbench/configs/virchow2_copy.json"})
    new["workloads"].append({"name": "embed.virchow2_bf16_b64", "config": "virchow2_copy",
                             "traffic": "process_existing_coords_bf16_b64", "chips": 1, "why": "batch 64"})
    new["per_layer"].append({"name": "rows_forwarded", "unit": "rows", "better": "higher",
                             "source": "program_counter", "layer": "ViT", "moves": "patches_per_s",
                             "workloads": ["embed.virchow2_bf16_b64"]})
    for m in new["end_to_end"]:
        if m["name"] == "patches_per_s":
            m["workloads"].append("embed.virchow2_bf16_b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    got = harness.workload("embed.virchow2_bf16_b64")
    assert got["traffic"]["feature_batch_size"] == 64
    assert harness.config(got["config"])["hidden_size"] == cfg["hidden_size"]
    assert harness.metric_module("rows_forwarded").read({"counts": {"rows": 64}}) == 64
    assert harness.traffic_module(got["traffic"]["kind"]).__file__.startswith(str(bench))
    test_every_cell_is_found_by_name(harness.manifest())
