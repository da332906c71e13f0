"""The port's campaign orchestrator against the JAX reference (CPU).

Planning (jobs, skipped cells, cache keys), a cold ``polybench-2mm`` x
``systolic,gpu`` run whose artifacts and aggregate equal the reference's
(integers exactly, floats within 1e-9 relative; the port composes with its
default ``engine="torch"``, the reference with ``"numpy"``), warm reruns,
resume, recorded failures, the ``ProfileSession.campaign`` classmethod, the
``campaign`` CLI's ``--dry-run`` and ``--status``, and the registry-size
MLPerf + PolyBench campaign against ``tests/fixtures/torch/
golden_campaign.json`` (what ``chip_smoke.py`` holds the card to).
Everything runs in this process with ``device="cpu"``; the tests that start
worker processes are in ``tests/test_torch_cluster_process.py``.
"""

import hashlib
import json
import math
import types
from pathlib import Path

import pytest
import torch

from repro.launch.campaign import CampaignRunner as RefRunner
from repro_torch.__main__ import main as port_cli
from repro_torch.core import ProfileSession as PortSession
from repro_torch.kernels import _build
from repro_torch.launch import campaign as port_campaign
from repro_torch.launch.campaign import (CampaignRunner, campaign_facts,
                                         compare_campaign_facts)

RTOL = 1e-9
TINY_2MM = {"ni": 24, "nj": 20, "nk": 16, "nl": 28}
SMALL_AXES = {"mixes": (0.0, 1.0), "retention_scales": (1.0,),
              "per_mix": False}
GOLDEN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_campaign.json"


def _kw(tmp_path, **kw):
    defaults = dict(
        workloads="polybench-2mm", backends=("systolic", "gpu"),
        jobs=2, cache_dir=str(tmp_path / "cache"),
        params={"polybench-2mm": TINY_2MM},
        backend_cfg={"systolic": {"rows": 16, "cols": 16}},
        sweep_axes=SMALL_AXES)
    defaults.update(kw)
    return defaults


def _runner(tmp_path, **kw):
    kw = _kw(tmp_path, **kw)
    kw.setdefault("device", "cpu")
    return CampaignRunner(kw.pop("workloads"), kw.pop("backends"), **kw)


def _ref_runner(tmp_path, **kw):
    kw = _kw(tmp_path, **kw)
    return RefRunner(kw.pop("workloads"), kw.pop("backends"), **kw)


def assert_close(got, want, path="artifact"):
    """Ints, bools and strings exactly; floats within RTOL relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        if math.isfinite(want):
            assert got == pytest.approx(want, rel=RTOL, abs=0.0), path
        else:
            assert got == want or (math.isnan(got) and math.isnan(want)), \
                path
    else:
        assert type(got) is type(want) and got == want, path


# ---------------------------------------------------------------------------
# planning + cache keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workloads", [
    "polybench-2mm,polybench-2DConv", "suite:mlperf,suite:polybench",
    "all"])
def test_plan_and_skipped_equal_the_reference(tmp_path, workloads):
    runner = _runner(tmp_path, workloads=workloads,
                     backends=("systolic", "gpu", "opstream"))
    ref = _ref_runner(tmp_path, workloads=workloads,
                      backends=("systolic", "gpu", "opstream"))
    jobs, ref_jobs = runner.plan(), ref.plan()
    if workloads == "all":
        # the reference also lowers the archs to tpu_graph (ROADMAP A10)
        # and carries a tpu_smoke param for it (D5)
        ref_jobs = [j for j in ref_jobs if j.backend != "tpu_graph"]
        assert [(j.workload, j.backend) for j in jobs] == \
            [(j.workload, j.backend) for j in ref_jobs]
    else:
        assert [(j.workload, j.backend, j.params, j.cfg) for j in jobs] \
            == [(j.workload, j.backend, j.params, j.cfg) for j in ref_jobs]
    assert runner.skipped == ref.skipped
    assert len({j.key for j in jobs}) == len(jobs)
    assert not {j.key for j in jobs} & {j.key for j in ref.plan()}


def test_cache_key_is_the_reference_payload_plus_the_package(tmp_path,
                                                             monkeypatch):
    from repro.launch import campaign as ref_campaign
    seen = []

    class _Sha:
        def __init__(self, data):
            seen.append(data)
            self._h = hashlib.sha256(data)

        def hexdigest(self):
            return self._h.hexdigest()

    monkeypatch.setattr(ref_campaign, "hashlib",
                        types.SimpleNamespace(sha256=_Sha))
    ref_jobs = _ref_runner(tmp_path).plan()
    monkeypatch.undo()
    jobs = _runner(tmp_path).plan()
    for job, ref_job, data in zip(jobs, ref_jobs, seen, strict=True):
        payload = {**json.loads(data), "package": "repro_torch"}
        assert job.key == hashlib.sha256(json.dumps(
            payload, sort_keys=True, default=repr).encode()).hexdigest()
        assert job.key != ref_job.key


def test_cache_key_sensitivity(tmp_path):
    base = {j.label: j.key for j in _runner(tmp_path).plan()}
    p2 = _runner(tmp_path,
                 params={"polybench-2mm": {**TINY_2MM, "ni": 32}}).plan()
    assert all(base[j.label] != j.key for j in p2)
    c2 = _runner(tmp_path,
                 backend_cfg={"systolic": {"rows": 32, "cols": 32}}).plan()
    changed = {j.label: j.key for j in c2}
    assert changed["polybench-2mm@systolic"] != \
        base["polybench-2mm@systolic"]
    assert changed["polybench-2mm@cachesim"] == \
        base["polybench-2mm@cachesim"]
    for kw in ({"policy": "refresh-aware"}, {"retention_bins": (1e-6,)},
               {"sweep_axes": None}, {"devices": ("SRAM", "Si-GCRAM")}):
        assert all(base[j.label] != j.key
                   for j in _runner(tmp_path, **kw).plan()), kw
    # neither the engine nor the device is a key component
    for kw in ({"engine": "numpy"}, {"device": "cuda"}):
        assert {j.label: j.key
                for j in _runner(tmp_path, **kw).plan()} == base, kw


def test_engine_and_scheduler_are_validated(tmp_path):
    from repro_torch.compose.engine import ENGINES
    assert port_campaign.ENGINES == ENGINES == ("numpy", "torch")
    assert _runner(tmp_path).engine == "torch"
    for engine in ("jax", "bogus"):
        with pytest.raises(ValueError, match="engine must be one of"):
            _runner(tmp_path, engine=engine)
    with pytest.raises(ValueError, match="scheduler"):
        _runner(tmp_path, scheduler="bogus")


def test_planning_needs_no_card_and_running_needs_one(tmp_path,
                                                      monkeypatch, capsys):
    """No CUDA device: planning, ``--dry-run`` and ``--status`` work with
    the default device (and load no kernel library, initialise no CUDA
    context); running the campaign or preparing a process store raises."""
    def _forbidden(*a, **k):
        raise AssertionError("planning reached the kernels or the card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "init", _forbidden)
    monkeypatch.setattr(torch.cuda, "_lazy_init", _forbidden)
    monkeypatch.setattr(_build, "load_library", _forbidden)
    runner = _runner(tmp_path, device=None)
    assert len(runner.plan()) == 2
    assert port_cli(["campaign", "--dry-run"]) == 0
    assert "campaign dry-run ok: 4 job(s)" in capsys.readouterr().out
    (tmp_path / "cache").mkdir()
    assert port_cli(["campaign", "--status", str(tmp_path / "cache")]) == 0
    assert "status: 0/0 done" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        _runner(tmp_path, device=None, scheduler="process").prepare_store()


# ---------------------------------------------------------------------------
# end to end: cold run against the reference, warm cache, resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("campaign")
    port = _runner(tmp).run()
    ref = _ref_runner(tmp_path_factory.mktemp("reference")).run()
    return tmp, port, ref


def test_cold_run_artifacts_equal_the_reference(campaign):
    _, port, ref = campaign
    assert port.executed == 2 and port.cache_hits == 0 and port.failed == 0
    assert [j.label for j in port.jobs] == \
        ["polybench-2mm@systolic", "polybench-2mm@cachesim"]
    for got, want in zip(port.artifacts, ref.artifacts, strict=True):
        assert got["key"] != want["key"]
        assert_close({**got, "key": None}, {**want, "key": None})
    assert compare_campaign_facts(
        campaign_facts(port.artifacts, port.aggregate),
        campaign_facts(ref.artifacts, ref.aggregate)) <= RTOL


def test_cold_run_aggregate_equals_the_reference(campaign):
    tmp, port, ref = campaign
    assert_close(port.aggregate["aggregate"], ref.aggregate["aggregate"])
    assert_close(port.aggregate["suite_frontiers"],
                 ref.aggregate["suite_frontiers"])
    drop = ("key", "cache_dir")
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in port.aggregate["jobs"]] == \
        [{k: v for k, v in r.items() if k not in drop}
         for r in ref.aggregate["jobs"]]
    assert {k: v for k, v in port.aggregate["campaign"].items()
            if k != "cache_dir"} == \
        {k: v for k, v in ref.aggregate["campaign"].items()
         if k != "cache_dir"}
    assert port.csv_rows() == ref.csv_rows()
    json.dumps(port.aggregate)
    for job in port.jobs:
        assert json.loads((tmp / "cache" / f"{job.key}.json").read_text()) \
            == port.artifacts[port.jobs.index(job)]


def test_warm_rerun_executes_nothing(campaign, monkeypatch):
    tmp, first, _ = campaign

    def _boom(self, job):
        raise AssertionError("a job ran on a warm cache")
    monkeypatch.setattr(CampaignRunner, "_execute", _boom)
    second = _runner(tmp).run()
    assert second.executed == 0 and second.cache_hits == 2
    assert second.failed == 0
    assert json.dumps(second.aggregate["aggregate"], sort_keys=True) == \
        json.dumps(first.aggregate["aggregate"], sort_keys=True)
    assert json.dumps(second.aggregate["suite_frontiers"],
                      sort_keys=True) == \
        json.dumps(first.aggregate["suite_frontiers"], sort_keys=True)


def test_resume_after_partial_cache(campaign):
    tmp, first, _ = campaign
    evicted = tmp / "cache" / f"{first.jobs[0].key}.json"
    want = evicted.read_bytes()
    evicted.unlink()
    result = _runner(tmp).run()
    assert result.executed == 1 and result.cache_hits == 1
    assert evicted.read_bytes() == want      # recomputed byte for byte


def test_profile_session_campaign_classmethod(campaign):
    tmp, _, _ = campaign
    kw = _kw(tmp)
    result = PortSession.campaign(kw.pop("workloads"), kw.pop("backends"),
                                  device="cpu", **kw)
    assert result.cache_hits == 2 and result.executed == 0


def test_campaign_without_cache_dir_still_aggregates(tmp_path):
    result = _runner(tmp_path, cache_dir=None, backends=("systolic",),
                     sweep_axes=None, jobs=1).run()
    assert result.executed == 1
    assert result.aggregate["suite_frontiers"] == {}
    assert result.aggregate["aggregate"]["systolic"]


def test_failed_job_recorded_not_propagated(tmp_path, monkeypatch):
    real = CampaignRunner._execute

    def flaky(self, job):
        if job.workload == "polybench-2mm":
            raise RuntimeError("injected backend fault")
        return real(self, job)
    monkeypatch.setattr(CampaignRunner, "_execute", flaky)
    kw = dict(workloads="polybench-2mm,polybench-3mm",
              backends=("systolic",),
              params={"polybench-2mm": TINY_2MM,
                      "polybench-3mm": {"ni": 16, "nj": 16, "nk": 16,
                                        "nl": 16, "nm": 16}})
    result = _runner(tmp_path, **kw).run()
    assert result.failed == 1
    errs = dict(zip((j.workload for j in result.jobs), result.errors))
    assert "injected backend fault" in errs["polybench-2mm"]
    assert errs["polybench-3mm"] is None
    agg = result.aggregate
    assert agg["campaign"]["failed"] == 1
    for entry in agg["aggregate"]["systolic"].values():
        assert set(entry["per_workload"]) == {"polybench-3mm"}
    rows = {r["workload"]: r for r in agg["jobs"]}
    assert "injected backend fault" in rows["polybench-2mm"]["error"]
    assert rows["polybench-2mm"]["accesses"] == 0
    failed_key = next(j.key for j in result.jobs
                      if j.workload == "polybench-2mm")
    assert not (tmp_path / "cache" / f"{failed_key}.json").exists()
    assert not (tmp_path / "cache" / f"{failed_key}.json.lock").exists()
    monkeypatch.setattr(CampaignRunner, "_execute", real)
    healed = _runner(tmp_path, **kw).run()
    assert healed.failed == 0
    assert healed.executed == 1 and healed.cache_hits == 1


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_dry_run_and_status(tmp_path, capsys):
    assert port_cli(["campaign", "--dry-run", "--scheduler", "process",
                     "--cache-dir", ""]) == 0
    out = capsys.readouterr().out
    assert "scheduler=process" in out and "tinyllama_1_1b" in out
    assert "campaign dry-run ok: 4 job(s), 0 cached" in out
    runner = _runner(tmp_path, scheduler="process")
    store, ledger, _ = runner.prepare_store()
    ledger.acquire("w-status")
    assert port_cli(["campaign", "--status", store.root]) == 0
    out = capsys.readouterr().out
    assert "2 job(s)" in out and "w-status" in out
    assert "1 leased, 1 pending" in out


# ---------------------------------------------------------------------------
# the paper's MLPerf + PolyBench campaign at registry parameters
# ---------------------------------------------------------------------------

def test_registry_campaign_equals_the_golden_file(tmp_path):
    """The campaign ``chip_smoke.py`` runs on the card, here on the CPU
    with four threads: every job, its facts and the aggregate equal the
    reference's golden file."""
    golden = json.loads(GOLDEN.read_text())
    run = golden["run"]
    runner = CampaignRunner(run["workloads"], run["backends"], jobs=4,
                            cache_dir=str(tmp_path / "cache"),
                            device="cpu")
    assert runner.sweep_axes == {**run["sweep_axes"],
                                 "mixes": tuple(run["sweep_axes"]["mixes"]),
                                 "retention_scales": tuple(
                                     run["sweep_axes"]["retention_scales"])}
    result = runner.run()
    assert result.failed == 0 and result.executed == len(run["jobs"]) == 21
    assert [j.label for j in result.jobs] == run["jobs"]
    worst = compare_campaign_facts(
        campaign_facts(result.artifacts, result.aggregate),
        {"jobs": golden["jobs"], "aggregate": golden["aggregate"]})
    assert worst <= RTOL
