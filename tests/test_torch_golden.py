"""The port reproduces the reference's golden TinyLlama facts (CPU).

``tests/fixtures/torch/golden_tinyllama_systolic.json`` is written from the
JAX reference by ``tests/make_torch_golden.py``.  Here the port runs the
2-layer entry on the CPU: session counts, capacity fractions, and the
lifetime_scan entry point (plain version on a CPU tensor) on the session's
own traces.  ``chip_smoke.py`` holds the CUDA kernel to the same file on
the GPU, at 2 and 22 layers.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import ProfileSession
from repro_torch.kernels.lifetime_scan.ops import lifetime_histogram
from repro_torch.workloads import get_workload

GOLDEN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_tinyllama_systolic.json"


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_file_has_both_depths(golden):
    assert golden["run"] == {"arch": "tinyllama_1_1b",
                             "backend": "systolic", "seq": 128, "pe": 128,
                             "dataflow": "ws"}
    assert golden["entries"]["2"]["n_events"] == 3_050_496
    for entry in golden["entries"].values():
        subs = entry["subpartitions"]
        assert sorted(subs) == ["filter", "ifmap", "ofmap"]
        assert entry["n_events"] == sum(
            s["n_reads"] + s["n_writes"] for s in subs.values())
        for s in subs.values():
            assert len(s["hist"]) == 64 and sum(s["hist"]) == s["live"]
            assert s["live"] + s["orphans"] == s["n_lifetimes"]


def test_port_reproduces_two_layer_entry(golden):
    want = golden["entries"]["2"]
    run = golden["run"]
    workload, cfg = get_workload(run["arch"]).with_params(
        seq=run["seq"], n_layers=2).build(run["backend"])
    session = ProfileSession(run["backend"], device="cpu")
    session.profile(workload, rows=run["pe"], cols=run["pe"],
                    dataflow=run["dataflow"], **cfg)
    report = session.analyze().compose().report()
    trace = session.trace
    assert trace.n_events == want["n_events"]
    for sub, name in enumerate(trace.names):
        g = want["subpartitions"][name]
        rep = report["subpartitions"][name]
        for key in ("n_reads", "n_writes", "n_lifetimes", "unique_addrs"):
            assert rep[key] == g[key], (name, key)
        assert rep["composition"]["devices"] == g["composition_devices"]
        assert rep["composition"]["capacity_fractions"] == \
            g["capacity_fractions"]
        t_sub = trace.select(sub)
        hist, stats = lifetime_histogram(
            t_sub.time_cycles, t_sub.addr, t_sub.is_write, device="cpu")
        np.testing.assert_array_equal(hist.numpy(), g["hist"])
        assert stats.tolist() == [g["live"], g["orphans"], g["sum_lt"],
                                  g["max_lt"], g["n_reads"], g["n_writes"],
                                  0, 0]
