"""The checks of every cell on the card, at the cell's own size: on three
seeds the program's readings stay under each limit, and the control (the
reference in fp8 in the program's place) and every fault that a training
cell can have fail at least one of them.  Marked ``gpu``; run on the card
with ``python -m pytest -m gpu bench/tests``."""

from __future__ import annotations

import pytest

from bench import calibrate, faults, harness

SEEDS = (4100000001, 4100000002, 4100000003)


def _cells():
    spec = harness.benchmark_spec()
    return [w["name"] for w in spec["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _cells())
def test_program_passes_and_control_fails(cuda, name):
    cell = harness.resolve_cell(harness.benchmark_spec(), name)
    limits = cell["limits"]
    for seed in SEEDS:
        got = calibrate.readings(cell, seed, 2.0, control=True)
        assert all(got["program"][k] <= limits[k] for k in limits), got
        assert any(got["control"][k] > limits[k] for k in limits), got


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["half_batch", "labels_altered"])
def test_training_faults_fail(cuda, fault):
    name = "deepseek_moe_16b.train_stage"
    cell = harness.resolve_cell(harness.benchmark_spec(), name)
    assert fault in faults.FAULTS[cell["traffic"]["kind"]]
    for seed in SEEDS:
        got = calibrate.readings(cell, seed, 1.0, control=False, fault=fault)
        assert any(got["program"][k] > v for k, v in cell["limits"].items())
