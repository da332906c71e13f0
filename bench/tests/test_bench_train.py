"""The training cell at smoke size on the CPU, through the kernels' plain
paths: a run is judged correct against the float32 reference, and comes
out not correct with each fault the cell can have planted in its step
(one chip: no exchange between chips to leave out)."""

from __future__ import annotations

import itertools

import pytest

from bench import faults
from bench import run as R
from bench.kinds import train_steps
from bench.tests.conftest import smoke_cell

# program readings at this size: loss 1e-4, gradients 0.04, changes 0.004
# at most (CPU, seeds 5 and 2**40 + 7); the limits sit between those and
# the faults' readings
LIMITS = {"loss_rel_gap_max": 1e-3, "grad_norm_gap_max": 0.12,
          "change_norm_gap_max": 0.04}
SEED = 11
STEPS = 4


@pytest.fixture
def steady_clock(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(train_steps, "now", lambda: float(next(ticks)))


def run_once(prepare=None):
    cell = smoke_cell("train_steps", LIMITS)
    cell["spec"] = {"end_to_end": [{"name": "train_tokens_per_s",
                                    "unit": "tokens/s"}],
                    "per_layer": []}
    args = R.parse(["--workload", "smoke", "--seed", str(SEED), "--seconds",
                    str(STEPS), "--trace", "0"])
    return R.execute(args, cell, "cpu", prepare)


def test_plain_paths_are_correct(steady_clock):
    out = run_once()
    assert out["correct"] is True, out["check"]
    assert out["attempted"] == 2 * (STEPS - 1)   # a clock reading a step
    assert set(out["metrics"]) == {"train_tokens_per_s"}


def test_batches_differ_row_by_row_and_repeat_by_seed():
    t = smoke_cell("train_steps", LIMITS)["traffic"]
    a = train_steps.batches(t, 128, 2 ** 62 + 1, 3)
    b = train_steps.batches(t, 128, 2 ** 62 + 1, 3)
    assert all((x["tokens"] == y["tokens"]).all() for x, y in zip(a, b))
    rows = [tuple(r) for x in a for r in x["tokens"]]
    assert len(set(rows)) == len(rows)
    assert (a[0]["labels"][:, :-1] == a[0]["tokens"][:, 1:]).all()


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["train_steps"]))
def test_faults_are_not_correct(steady_clock, fault):
    out = run_once(prepare=lambda drv: faults.plant("train_steps", fault,
                                                    drv))
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["check"].values())


def test_traced_run_reads_the_timeline():
    cell = smoke_cell("train_steps", LIMITS)
    cell["spec"] = {"end_to_end": [],
                    "per_layer": [{"name": "train_mfu", "unit": "%"},
                                  {"name": "k2_roofline.train", "unit": "%"},
                                  {"name": "k34_roofline", "unit": "%"}]}
    args = R.parse(["--workload", "smoke", "--seed", str(SEED), "--seconds",
                    "0.5", "--trace", "1"])
    out = R.execute(args, cell, "cpu")
    assert out["correct"] is True
    # the kernels' launch counters move on the card only: no roofline here
    assert set(out["metrics"]) == {"train_mfu"}
    ops = dict(out["breakdown"]["device_ops"])
    assert "K2 flash_attention_bhsd" in ops
    assert "K3+K4 flash_attention_bwd_bhsd" in ops
