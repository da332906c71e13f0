"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import re

import pytest

from bench import harness
from bench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "bench/run.py"]
    assert spec["paths"] == ["bench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells at this length fits in 43200 s
    rs = spec["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys(spec):
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_every_file_it_names_is_found(spec):
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    for w in spec["workloads"]:
        cell = harness.resolve_cell(spec, w["name"])
        kind = cell["traffic"]["kind"]
        assert (ROOT / "bench" / "kinds" / f"{kind}.py").is_file()
        assert set(cell["limits"]) and all(
            isinstance(v, float) for v in cell["limits"].values())
        for section in ("end_to_end", "per_layer"):
            for m in harness.cell_metrics(spec, w["name"], section):
                assert callable(harness.reader(m["name"]))


def test_metrics_per_cell(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in spec["workloads"]:
        mine = {m["name"] for m in harness.cell_metrics(spec, w["name"],
                                                        "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        per = harness.cell_metrics(spec, w["name"], "per_layer")
        assert per
        for m in per:
            assert m["moves"] in mine
            assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for m in spec["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_reduced_keys_are_the_configuration_files_own(spec):
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg or k in cfg["model"] for k in c["reduced"])
        assert cfg.get("trace", "profiler") in ("profiler", "events")
