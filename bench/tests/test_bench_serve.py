"""The serving cell at smoke size on the CPU, through the kernels' plain
paths: a run is judged correct against the float32 reference, and comes
out not correct with the control (the reference in fp8) in the program's
place and with each fault the cell can have planted in its timed path."""

from __future__ import annotations

import itertools

import pytest
import torch

from bench import faults
from bench import run as R
from bench.kinds import serve_closed
from bench.program import reference_module
from bench.reference import weights as W
from bench.tests.conftest import smoke_cell

# program readings at this size stay under 0.008, the control's over
# 0.03 (bench/calibrate.py on the CPU, seeds 1-6)
LIMITS = {"served_token_gap_max": 0.02}
SEED = 4
BATCHES = 12


@pytest.fixture
def steady_clock(monkeypatch):
    """A clock that moves one second a reading, so that a window of
    BATCHES seconds serves the same batches on any host."""
    ticks = itertools.count()
    monkeypatch.setattr(serve_closed, "now", lambda: float(next(ticks)) / 3)


def run_once(prepare=None, trace=0):
    cell = smoke_cell("serve_closed", LIMITS)
    cell["spec"] = {"end_to_end": [{"name": "ttft_p95_ms", "unit": "ms"},
                                   {"name": "serve_tokens_per_s",
                                    "unit": "tokens/s"}],
                    "per_layer": [{"name": "prefill_mfu", "unit": "%"}]}
    args = R.parse(["--workload", "smoke", "--seed", str(SEED), "--seconds",
                    str(BATCHES), "--trace", str(trace)])
    return R.execute(args, cell, "cpu", prepare)


def test_plain_paths_are_correct(steady_clock):
    out = run_once()
    assert out["correct"] is True
    assert out["attempted"] == 2 * BATCHES
    assert set(out["metrics"]) == {"ttft_p95_ms", "serve_tokens_per_s"}
    check = out["check"]["served_token_gap_max"]
    assert check["value"] <= check["limit"] == LIMITS["served_token_gap_max"]


def test_large_seed_draws_the_same_inputs():
    cell = smoke_cell("serve_closed", LIMITS)
    big = 2 ** 62 + 12345
    assert serve_closed.plan(cell["traffic"], 7) == [40, 72, 40] * 2 + [40]
    specs = reference_module(cell["config"]).specs(
        cell["config"]["model"])
    a = W.make_weights(specs, big, "cpu")
    b = W.make_weights(specs, big, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["serve_closed"]))
def test_control_and_faults_are_not_correct(steady_clock, fault):
    out = run_once(prepare=lambda drv: faults.plant("serve_closed", fault,
                                                    drv))
    assert out["correct"] is False
    check = out["check"]["served_token_gap_max"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("kind", ["profiler", "events"])
def test_traced_run_reads_the_timeline(kind):
    cell = smoke_cell("serve_closed", LIMITS)
    cell["config"]["trace"] = kind
    cell["spec"] = {"end_to_end": [],
                    "per_layer": [{"name": "prefill_mfu", "unit": "%"}]}
    args = R.parse(["--workload", "smoke", "--seed", str(SEED), "--seconds",
                    "0.5", "--trace", "1"])
    out = R.execute(args, cell, "cpu")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"prefill_mfu"}
    ops = dict(out["breakdown"]["device_ops"])
    assert "K5 ssd_scan_chunked" in ops and "K2 flash_attention_bhsd" in ops
    assert out["breakdown"]["idle_gaps"]
