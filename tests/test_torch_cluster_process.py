"""The port's process scheduler, with real worker processes (CPU).

Three tests start processes, each with a time limit on every call and
wait: the process scheduler's artifacts are byte-identical to the thread
scheduler's; a worker killed with SIGKILL mid-job costs only its job, and
the resumed campaign equals a clean run; and ``python -m repro_torch
campaign --device cpu`` writes the reference's artifacts.  The workers run
on the campaign's device (``device="cpu"`` in the store's manifest) and
import no JAX.  No lease is left to expire in real time: after the kill,
the survivor runs in this process with the ledger's clock moved past the
lease.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro.launch.campaign import CampaignRunner as RefRunner
from repro_torch.cluster import JobLedger
from repro_torch.cluster import ledger as ledger_mod
from repro_torch.cluster.worker import run_worker
from repro_torch.launch.campaign import CampaignRunner
from repro_torch.runtime.fault_tolerance import CampaignSupervisor
from test_torch_campaign import assert_close
from test_torch_cluster import Clock

SRC = Path(__file__).resolve().parents[1] / "src"
TINY = {"polybench-2mm": {"ni": 24, "nj": 20, "nk": 16, "nl": 28},
        "polybench-3mm": {"ni": 16, "nj": 16, "nk": 16, "nl": 16,
                          "nm": 16}}
SMALL_AXES = {"mixes": (0.0, 1.0), "retention_scales": (1.0,),
              "per_mix": False}
LEASE_TTL = 30.0
TIMEOUT_S = 600


def _runner(cache_dir, backends=("systolic",), **kw):
    defaults = dict(
        jobs=2, cache_dir=str(cache_dir), params=TINY,
        backend_cfg={"systolic": {"rows": 16, "cols": 16}},
        sweep_axes=SMALL_AXES, device="cpu", lease_ttl_s=LEASE_TTL)
    defaults.update(kw)
    return CampaignRunner("polybench-2mm,polybench-3mm", backends,
                          **defaults)


@pytest.fixture
def bounded_supervisor(monkeypatch):
    """The process scheduler's supervision loop with a time limit."""
    monkeypatch.setattr(CampaignSupervisor, "run", functools.partialmethod(
        CampaignSupervisor.run, timeout_s=TIMEOUT_S))


def _same_bytes(dir_a, dir_b, jobs):
    for job in jobs:
        a = (Path(dir_a) / f"{job.key}.json").read_bytes()
        b = (Path(dir_b) / f"{job.key}.json").read_bytes()
        assert a == b, f"artifact {job.label} differs"


def test_process_artifacts_byte_identical_to_thread(tmp_path,
                                                    bounded_supervisor):
    backends = ("systolic", "gpu")
    thread = _runner(tmp_path / "thread", backends).run()
    process = _runner(tmp_path / "process", backends,
                      scheduler="process").run()
    assert process.scheduler == "process"
    assert process.executed == 4 and process.failed == 0
    m = process.metrics
    assert m["worker_deaths"] == 0 and m["worker_exit_codes"] == [0, 0]
    for job_metrics in m["jobs"].values():
        assert job_metrics["state"] == "done"
    assert [j.key for j in thread.jobs] == [j.key for j in process.jobs]
    _same_bytes(tmp_path / "thread", tmp_path / "process", thread.jobs)
    for section in ("aggregate", "suite_frontiers"):
        assert json.dumps(thread.aggregate[section], sort_keys=True) == \
            json.dumps(process.aggregate[section], sort_keys=True)
    manifest = json.loads((tmp_path / "process" / "campaign.json")
                          .read_text())
    assert manifest["device"] == "cpu" and manifest["engine"] == "torch"
    again = _runner(tmp_path / "process", backends,
                    scheduler="process").run()
    assert again.executed == 0 and again.cache_hits == 4
    assert again.metrics["worker_exit_codes"] == []   # nothing to spawn


def test_killed_worker_costs_only_its_job(tmp_path, bounded_supervisor,
                                          monkeypatch):
    runner = _runner(tmp_path / "store", scheduler="process")
    store, ledger, n_new = runner.prepare_store()
    assert n_new == 2
    env = {**os.environ, "PYTHONPATH": str(SRC),
           "GAINSIGHT_WORKER_FAULT": "sleep-after-acquire:600"}
    victim = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "worker", "--store",
         store.root, "--worker-id", "victim", "--lease-ttl",
         str(LEASE_TTL), "--poll", "0.05"], env=env)
    try:
        deadline = time.monotonic() + TIMEOUT_S
        victim_key = None
        while victim_key is None and time.monotonic() < deadline \
                and victim.poll() is None:
            leased = [k for k, r in ledger.snapshot().items()
                      if r.state == "leased" and r.worker == "victim"]
            victim_key = leased[0] if leased else None
            time.sleep(0.05)
        assert victim_key, "the victim never leased a job"
    finally:
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=60)

    # the survivor, with the ledger's clock past the victim's lease
    later = Clock()
    later.offset = LEASE_TTL + 1.0
    monkeypatch.setattr(ledger_mod, "time", later)
    tally = run_worker(store.root, worker_id="survivor",
                       lease_ttl_s=LEASE_TTL, poll_s=0.05)
    assert tally["done"] == 2 and tally["failed"] == 0
    snap = JobLedger(store.root).snapshot()
    assert all(r.state == "done" and r.worker == "survivor"
               for r in snap.values())
    assert snap[victim_key].leases >= 2          # leased again
    assert snap[victim_key].error is None        # cleared on done

    resumed = _runner(tmp_path / "store", scheduler="process").run()
    assert resumed.executed == 0 and resumed.cache_hits == 2
    clean = _runner(tmp_path / "clean", jobs=1).run()
    _same_bytes(tmp_path / "store", tmp_path / "clean", clean.jobs)
    for section in ("aggregate", "suite_frontiers"):
        assert json.dumps(resumed.aggregate[section], sort_keys=True) == \
            json.dumps(clean.aggregate[section], sort_keys=True)


def test_cli_campaign_on_the_cpu_writes_the_reference_artifacts(tmp_path):
    """``python -m repro_torch campaign --workloads polybench-2mm
    --backends systolic,gpu --device cpu`` at registry parameters: exit 0,
    and every artifact equals the reference's (integers exactly, floats
    within 1e-9 relative)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "campaign", "--workloads",
         "polybench-2mm", "--backends", "systolic,gpu", "--device", "cpu",
         "--cache-dir", str(tmp_path / "cache")],
        env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr
    assert "campaign: 2 job(s), 2 executed" in out.stdout
    report = json.loads((tmp_path / "cache" / "campaign_report.json")
                        .read_text())
    ref = RefRunner("polybench-2mm", "systolic,gpu", backend_cfg={
        "systolic": {"rows": 128, "cols": 128, "dataflow": "ws"}}).run()
    assert [(r["workload"], r["backend"]) for r in report["jobs"]] == \
        [(j.workload, j.backend) for j in ref.jobs]
    for row, want in zip(report["jobs"], ref.artifacts, strict=True):
        got = json.loads((tmp_path / "cache" / f"{row['key']}.json")
                         .read_text())
        assert_close({**got, "key": None}, {**want, "key": None})
    assert_close(report["aggregate"], ref.aggregate["aggregate"])
