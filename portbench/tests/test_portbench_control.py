"""On the card, at each cell's own size: the control that the cell's
workload names (one precision below the cell's; see ``readings.py``) fails
one of the cell's limits on three seeds, and a sound short run of the
program keeps within all of them. Skips without a card."""

from __future__ import annotations

import pytest

from portbench import harness, readings

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEEDS = (2310000001, 2310000002, 2310000003)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    limits = harness.workload(cell)["traffic"]["limits"]
    for seed in SEEDS:
        got = readings.control_reading(cell, seed, 6.0)
        assert any(got[k] > limits[k] for k in limits if k in got), (seed, got, limits)
    program = readings.program_reading(cell, SEEDS[0] + 100, 6.0)
    assert all(program[k] <= limits.get(k, 0) for k in program), (program, limits)
