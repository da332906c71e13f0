"""Shared pieces of the dry-run tests (``tests/test_torch_dryrun.py``,
``tests/test_torch_dryrun_multipod.py``): the grid's shapes cut to a smoke
config's size, one arch per family, the fixtures that keep the pytest
worker free of process groups and meshes, and the checks every ``ok`` cell
must pass."""

from __future__ import annotations

import pytest
import torch.distributed as dist

from repro_torch.configs.base import ShapeCell, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, roofline

# the grid's shapes cut to a smoke config's size: the batch still splits
# over both meshes' batch axes, long_500k keeps its batch of one
SMALL = {"train_4k": ShapeCell("train_4k", "train", 32, 32),
         "prefill_32k": ShapeCell("prefill_32k", "prefill", 64, 32),
         "decode_32k": ShapeCell("decode_32k", "decode", 64, 32),
         "long_500k": ShapeCell("long_500k", "decode", 128, 1)}
FAMILIES = {"dense": "tinyllama_1_1b", "moe": "phi3_5_moe",
            "ssm": "mamba2_130m", "hybrid": "zamba2_2_7b",
            "vlm": "internvl2_1b", "audio": "whisper_small"}


@pytest.fixture(autouse=True)
def clean_world():
    shd.set_mesh(None)
    assert not dist.is_initialized()
    yield
    try:
        assert not dist.is_initialized()
        assert shd.get_mesh() is None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shd.set_mesh(None)


@pytest.fixture
def smoke(monkeypatch):
    """The dry-run on smoke configs at the ``SMALL`` shapes."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)


def check_ok(rec, shape_name, multi_pod):
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    chips = 512 if multi_pod else 256
    mem = rec["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "alias_size_in_bytes"}
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    assert 0 <= mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]
    hc = rec["hlo_cost"]
    assert hc["dot_flops"] > 0 and hc["n_dot_sites"] > 0
    assert hc["bytes"] > 0 and rec["scan_multiplicities"] == {}
    assert rec["cost"]["flops"] >= hc["dot_flops"]
    coll = rec["collectives"]
    assert set(coll["by_kind"]) == set(roofline.COLLECTIVES)
    assert coll["total_bytes"] == sum(coll["by_kind"].values())
    r = rec["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["step_lower_bound_s"] == max(r["compute_s"], r["memory_s"],
                                          r["collective_s"])
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops"] / chips / rec["cost"]["flops"])
    assert rec["lower_s"] > 0 and "compile_s" not in rec
    if shape_name == "train_4k":
        assert coll["total_bytes"] > 0 and coll["count"] > 0
        assert mem["alias_size_in_bytes"] > 0     # params, optimizer state
