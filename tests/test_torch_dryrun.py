"""``launch/dryrun.py`` on the CPU: each family's smoke config on the
16x16 production mesh, over a fake world of 256 ranks held in this one
process (``compat.fake_world``) and meta DTensors; the 2x16x16 cells are in
``tests/test_torch_dryrun_multipod.py`` (shared pieces:
``tests/dryrun_cells.py``).

The reference compiles a cell on 512 virtual host devices, which does not
fit the suite, so what needs no compile is held against it: ``n_params``,
``model_flops`` and the skipped cells for every arch x shape (through the
golden file ``golden_dryrun.json``, which ``chip_smoke.py`` reads too),
``OPT_FLAG_FIELDS`` and the cell file names.  The cells run at small
shapes (``SMALL``; the production meshes, the fake world and the step code
are the ones the card runs).  Per-device counting is held on a fake (2, 2)
mesh: the smoke TinyLlama train step's matmul FLOPs fall between 1/4 and
1/2 of its count without a mesh, where a count of global shapes would
read about 1.

No test leaves a process group or a mesh behind (``clean_world``); the
group is made and destroyed by ``fake_world`` in a ``finally``.
"""

import ast
import dataclasses
import json
import math
import os
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from dryrun_cells import (FAMILIES, SMALL, check_ok,  # noqa: F401
                          clean_world, smoke)
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeCell,
                                      get_config, shape_applicable)
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.steps import abstract_params
from repro_torch.models.api import build

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "torch" / "golden_dryrun.json"


def test_n_params_model_flops_and_skips_equal_the_golden_file():
    golden = json.loads(GOLDEN.read_text())["cells"]
    assert set(golden) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = abstract_params(build(cfg, device="meta"))
        n = sum(math.prod(s.shape) for s in params.values())
        assert set(golden[arch]) == set(SHAPES)
        for name, shape in SHAPES.items():
            want = golden[arch][name]
            assert want["n_params"] == n, (arch, name)
            assert want["model_flops"] == roofline.model_flops(cfg, shape)
            assert want["applicable"] == shape_applicable(cfg, shape)
            if not want["applicable"]:
                rec = dryrun.run_cell(arch, name, False, device="cpu")
                assert rec["status"] == "skipped" and "reason" in rec
    assert not dist.is_initialized()


def test_opt_flags_and_cell_names_are_the_references():
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    tree = ast.parse(src)
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and getattr(node.targets[0], "id", "") == "OPT_FLAG_FIELDS")
    assert dryrun.OPT_FLAG_FIELDS == ref
    cfg = dryrun._apply_opt_flags(get_config("tinyllama_1_1b"),
                                  ("qchunk", "nofsdp", "noremat"))
    assert cfg.attn_impl == "qchunk" and cfg.remat is False
    with pytest.raises(ValueError, match="unknown opt flag"):
        dryrun._apply_opt_flags(cfg, ("fast",))
    path = dryrun.cell_path("tinyllama_1_1b", "train_4k", True,
                            ("save_proj", "bf16probs"))
    assert os.path.basename(path) == \
        "tinyllama_1_1b.train_4k.mp.bf16probs.save_proj.json"
    assert os.path.basename(os.path.dirname(path)) == "dryrun_results_torch"
    assert os.path.basename(dryrun.cell_path(
        "mamba2_130m", "long_500k", False)) == "mamba2_130m.long_500k.sp.json"


def test_run_cell_without_a_device_raises_where_there_is_no_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell("tinyllama_1_1b", "train_4k", False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "tinyllama_1_1b"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_each_family_runs_on_the_single_pod_mesh(smoke, family, shape_name):
    rec = dryrun.run_cell(FAMILIES[family], shape_name, False, device="cpu")
    check_ok(rec, shape_name, False)
    assert rec["n_params"] == sum(
        math.prod(s.shape) for s in abstract_params(build(
            get_config(FAMILIES[family], smoke=True),
            device="meta")).values())


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_2_7b"])
def test_long_context_decode_splits_the_sequence(smoke, arch):
    rec = dryrun.run_cell(arch, "long_500k", False, device="cpu")
    check_ok(rec, "long_500k", False)


@pytest.mark.parametrize("flags", [("qchunk", "bf16probs"), ("moe_local",),
                                   ("nofsdp", "ce_recompute")])
def test_opt_flag_cells_run(smoke, monkeypatch, flags):
    arch = "tinyllama_1_1b"
    if "moe_local" in flags:
        # the expert-parallel dispatch needs whole experts on each of the
        # 16 model ranks; the smoke config has 4
        arch = "phi3_5_moe"
        monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
            get_config(a, smoke=True), moe_experts=16))
    rec = dryrun.run_cell(arch, "train_4k", False, flags, device="cpu")
    check_ok(rec, "train_4k", False)
    assert rec["opt_flags"] == list(flags)


def test_per_device_flops_of_a_2x2_mesh(monkeypatch):
    cfg = get_config("tinyllama_1_1b", smoke=True)
    shape = ShapeCell("t", "train", 64, 8)
    alone = dryrun.record_cell(cfg, shape, 1)
    with compat.fake_world(4):
        try:
            mesh = compat.make_mesh((2, 2), ("data", "model"), "cpu")
            shd.set_mesh(mesh)
            meshed = dryrun.record_cell(cfg, shape, 4)
        finally:
            shd.set_mesh(None)
    assert not dist.is_initialized()
    assert alone["collectives"]["total_bytes"] == 0
    assert meshed["collectives"]["total_bytes"] > 0
    ratio = meshed["hlo_cost"]["dot_flops"] / alone["hlo_cost"]["dot_flops"]
    assert 0.25 <= ratio <= 0.5, ratio
    assert meshed["n_params"] == alone["n_params"]
    assert meshed["memory"]["argument_size_in_bytes"] < \
        alone["memory"]["argument_size_in_bytes"]


def test_a_failing_cell_leaves_no_group_and_no_mesh(smoke, monkeypatch):
    def broken(*args, **kwargs):
        assert dist.is_initialized() and shd.get_mesh() is not None
        raise ValueError("sharding bug")
    monkeypatch.setattr(dryrun, "build", broken)
    rec = dryrun.run_cell("tinyllama_1_1b", "train_4k", True, device="cpu")
    assert rec["status"] == "failed"
    assert rec["error"] == "ValueError: sharding bug"
    assert "sharding bug" in rec["traceback"]
    assert not dist.is_initialized() and shd.get_mesh() is None
    with compat.fake_world(256):
        assert dist.get_world_size() == 256
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="already exists"):
        with compat.fake_world(4):
            with compat.fake_world(4):
                pass
    assert not dist.is_initialized()


def test_main_caches_cells_and_exits_1_on_a_failure(smoke, monkeypatch,
                                                    tmp_path, capsys):
    monkeypatch.setattr(dryrun, "RESULT_DIR", str(tmp_path))
    argv = ["--arch", "tinyllama_1_1b", "--multi-pod", "single",
            "--device", "cpu"]
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert "3 ok / 1 skipped / 0 failed" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"tinyllama_1_1b.{s}.sp.json" for s in SMALL)
    rec = json.loads((tmp_path / "tinyllama_1_1b.train_4k.sp.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"

    def never(*args, **kwargs):
        raise AssertionError("a cached cell ran again")
    monkeypatch.setattr(dryrun, "run_cell", never)
    assert dryrun.main(argv) == 0
    monkeypatch.setattr(dryrun, "run_cell", lambda a, s, mp, o, device:
                        {"arch": a, "shape": s, "mesh": "16x16",
                         "status": "failed", "error": "E: x"})
    assert dryrun.main(argv[:4] + ["--shape", "train_4k", "--force"],
                       device="cpu") == 1
    assert "FAIL" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_jobs_run_uncached_cells_in_workers_longest_first(smoke, monkeypatch,
                                                          tmp_path, capsys):
    monkeypatch.setattr(dryrun, "RESULT_DIR", str(tmp_path))
    ran = []

    def worker(cell, opt_flags, device):
        ran.append(cell)
        arch, shape_name, mp = cell
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if mp else "16x16", "status": "failed",
               "error": "E: stub"}
        with open(dryrun.cell_path(arch, shape_name, mp), "w") as f:
            json.dump(rec, f)
    monkeypatch.setattr(dryrun, "_run_worker", worker)
    argv = ["--arch", "tinyllama_1_1b", "--jobs", "3", "--device", "cpu"]
    assert dryrun.main(argv) == 1
    assert "0 ok / 2 skipped / 6 failed" in capsys.readouterr().out
    assert [c[1] for c in ran] == ["prefill_32k"] * 2 + ["train_4k"] * 2 + \
        ["decode_32k"] * 2              # long_500k skipped, no worker
    ran.clear()
    assert dryrun.main(argv) == 1       # every cell cached: no worker
    assert ran == []


def test_a_worker_that_times_out_leaves_a_failed_cell(smoke, monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(dryrun, "RESULT_DIR", str(tmp_path))
    seen = {}

    def run(argv, **kwargs):
        seen.update(argv=argv, **kwargs)
        raise dryrun.subprocess.TimeoutExpired(argv, kwargs["timeout"])
    monkeypatch.setattr(dryrun.subprocess, "run", run)
    dryrun._run_worker(("mamba2_130m", "train_4k", True), ("nofsdp",),
                       torch.device("cpu"))
    assert seen["timeout"] == dryrun.CELL_TIMEOUT_S
    assert seen["argv"][1:4] == ["-m", "repro_torch.launch.dryrun", "--arch"]
    assert "--force" in seen["argv"] and "nofsdp" in seen["argv"]
    rec = json.loads(Path(dryrun.cell_path(
        "mamba2_130m", "train_4k", True, ("nofsdp",))).read_text())
    assert rec["status"] == "failed" and "timed out" in rec["error"]
