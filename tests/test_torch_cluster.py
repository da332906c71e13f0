"""The port's campaign scheduler pieces, in one process (CPU).

The artifact store's write-if-absent ``put`` (race-free: exactly one
winner among racing threads, every round), its write locks, the job
ledger's lease / retry / quarantine state machine, the retry policy, the
campaign supervisor and the in-process worker loop.  No test sleeps to let
a lease, a lock or a backoff expire: the ledger and the store read the time
through their modules' ``time``, which the tests replace by a clock they
move forward.
"""

import json
import os
import sys
import threading
import time

import pytest
import torch

from repro_torch.cluster import ArtifactStore, JobLedger
from repro_torch.cluster import ledger as ledger_mod
from repro_torch.cluster import store as store_mod
from repro_torch.cluster.worker import run_worker
from repro_torch.launch.campaign import CampaignRunner
from repro_torch.runtime.fault_tolerance import (CampaignSupervisor,
                                                 RetryPolicy)

TINY_2MM = {"ni": 16, "nj": 16, "nk": 16, "nl": 16}


class Clock:
    """Wall and monotonic time ``offset`` seconds ahead of the real ones."""

    sleep = staticmethod(time.sleep)

    def __init__(self):
        self.offset = 0.0

    def time(self):
        return time.time() + self.offset

    def monotonic(self):
        return time.monotonic() + self.offset


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(ledger_mod, "time", c)
    monkeypatch.setattr(store_mod, "time", c)
    return c


def _jobs(*keys):
    return [{"key": k, "workload": f"wl-{k}", "backend": "systolic"}
            for k in keys]


# ---------------------------------------------------------------------------
# ArtifactStore
# ---------------------------------------------------------------------------

def test_store_put_is_write_if_absent(tmp_path):
    store = ArtifactStore(str(tmp_path))
    assert store.put("k", {"v": 1}) is True
    assert store.put("k", {"v": 2}) is False     # loser told, not clobbered
    assert store.load("k") == {"v": 1}
    assert (tmp_path / "k.json").read_bytes() == b'{"v": 1}'
    assert store.load("missing") is None
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_store_put_has_exactly_one_winner_every_round(tmp_path):
    """8 threads race one key, 200 times: each round exactly one put
    returns True, the file holds the winner's bytes (compact JSON), and no
    temp file is left behind."""
    store = ArtifactStore(str(tmp_path))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for rnd in range(200):
            key = f"k{rnd}"
            gate = threading.Barrier(8)
            results = []

            def writer(tag, key=key, gate=gate, results=results):
                gate.wait(timeout=30)
                results.append((tag, store.put(key, {"writer": tag,
                                                     "round": rnd})))

            threads = [threading.Thread(target=writer, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            winners = [tag for tag, won in results if won]
            assert len(results) == 8 and len(winners) == 1, (rnd, results)
            want = {"writer": winners[0], "round": rnd}
            assert (tmp_path / f"{key}.json").read_bytes() == \
                json.dumps(want).encode()
    finally:
        sys.setswitchinterval(old)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_store_write_lock_exclusive_and_stale_breaking(tmp_path, clock):
    store = ArtifactStore(str(tmp_path), lock_stale_s=60.0)
    assert store.acquire_write_lock("k", "a") is True
    assert store.acquire_write_lock("k", "b") is False
    store.release_write_lock("k")
    assert store.acquire_write_lock("k", "b") is True
    assert store.acquire_write_lock("k", "c") is False   # b is fresh
    clock.offset += 61.0                 # b crashed: its lock went stale
    assert store.acquire_write_lock("k", "c") is True
    assert json.loads((tmp_path / "k.json.lock").read_text())["owner"] \
        == "c"


def test_store_wait_for(tmp_path, clock):
    store = ArtifactStore(str(tmp_path))
    store.put("done", {"v": 1})
    assert store.wait_for("done", timeout_s=0.0) == {"v": 1}
    # the writer went away without an artifact: no waiting for the timeout
    assert store.wait_for("failed", timeout_s=3600.0) is None
    # a live lock and no artifact: returns None once the clock passes
    store.acquire_write_lock("slow", "other")
    waits = []

    def advance(s):
        waits.append(s)
        clock.offset += 10.0
    clock.sleep = advance
    assert store.wait_for("slow", timeout_s=25.0) is None
    assert len(waits) == 3


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

def test_retry_policy_backoff_and_budget():
    p = RetryPolicy(max_retries=3, backoff_base_s=0.5, backoff_cap_s=4.0)
    assert p.delay_s(1) == pytest.approx(0.5)
    assert p.delay_s(2) == pytest.approx(1.0)
    assert p.delay_s(3) == pytest.approx(2.0)
    assert p.delay_s(10) == pytest.approx(4.0)    # capped
    assert not p.exhausted(2)
    assert p.exhausted(3)


# ---------------------------------------------------------------------------
# JobLedger
# ---------------------------------------------------------------------------

def test_ledger_submit_is_idempotent_by_key(tmp_path):
    led = JobLedger(str(tmp_path))
    assert led.submit(_jobs("a", "b")) == 2
    assert led.submit(_jobs("a", "b", "c")) == 1   # only c is new
    assert led.counts() == {"pending": 3, "leased": 0, "done": 0,
                            "quarantined": 0}


def test_ledger_acquire_fifo_and_lease_lifecycle(tmp_path):
    led = JobLedger(str(tmp_path))
    led.submit(_jobs("a", "b"))
    r1 = led.acquire("w0")
    assert (r1.key, r1.state, r1.worker) == ("a", "leased", "w0")
    assert os.path.exists(os.path.join(led.store.lease_dir, "a.json"))
    assert led.acquire("w1").key == "b"
    assert led.acquire("w2") is None               # drained
    assert led.heartbeat("a", "w0") is True
    assert led.heartbeat("a", "not-the-holder") is False
    # completion is holder-guarded: a reclaimed/stolen lease can't land
    assert led.complete("a", "w1") is False
    assert led.complete("a", "w0", runtime_s=1.5) is True
    rec = led.snapshot()["a"]
    assert rec.state == "done" and rec.runtime_s == 1.5
    assert not os.path.exists(os.path.join(led.store.lease_dir, "a.json"))
    assert led.outstanding() == 1


def test_ledger_fail_requeues_with_backoff_then_quarantines(tmp_path,
                                                            clock):
    led = JobLedger(str(tmp_path),
                    retry=RetryPolicy(max_retries=2, backoff_base_s=5.0))
    led.submit(_jobs("a"))
    led.acquire("w0")
    assert led.fail("a", "w0", "boom-1") is True
    rec = led.snapshot()["a"]
    assert rec.state == "pending" and rec.attempts == 1
    assert rec.error == "boom-1"
    assert rec.not_before > clock.time() + 4.0     # backoff gate set
    assert led.acquire("w0") is None               # still backing off
    clock.offset += 6.0
    assert led.acquire("w0").key == "a"
    led.fail("a", "w0", "boom-2")                  # budget (2) spent
    rec = led.snapshot()["a"]
    assert rec.state == "quarantined" and rec.attempts == 2
    assert led.outstanding() == 0                  # terminal
    assert led.acquire("w0") is None


def test_ledger_reclaims_expired_leases_only(tmp_path, clock):
    led = JobLedger(str(tmp_path), lease_ttl_s=30.0)
    led.submit(_jobs("a", "b"))
    led.acquire("dead-worker")
    led.acquire("live-worker")
    clock.offset += 20.0
    assert led.heartbeat("b", "live-worker") is True
    assert led.reclaim_expired() == []             # a is 20 s old, not 30
    clock.offset += 20.0                           # a silent for 40 s
    assert led.heartbeat("b", "live-worker") is True
    assert led.reclaim_expired() == ["a"]
    snap = led.snapshot()
    assert snap["a"].state == "pending" and snap["a"].attempts == 1
    assert "lease expired" in snap["a"].error
    assert snap["b"].state == "leased"             # heartbeats kept it
    # the reclaimed holder's heartbeat now says the lease is gone
    assert led.heartbeat("a", "dead-worker") is False


def test_ledger_acquire_never_double_leases_under_contention(tmp_path):
    led = JobLedger(str(tmp_path))
    led.submit(_jobs(*[f"j{i}" for i in range(12)]))
    got, lock = [], threading.Lock()

    def grab(w):
        while True:
            rec = led.acquire(w)
            if rec is None:
                return
            with lock:
                got.append(rec.key)

    threads = [threading.Thread(target=grab, args=(f"w{i}",))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == sorted(f"j{i}" for i in range(12))   # no dupes


def test_ledger_survives_torn_trailing_write(tmp_path):
    led = JobLedger(str(tmp_path))
    led.submit(_jobs("a"))
    with open(led.store.ledger_path, "a") as f:
        f.write('{"event": "lease", "key": "a", "wor')   # killed mid-append
    snap = led.snapshot()
    assert snap["a"].state == "pending"            # torn line ignored
    assert led.acquire("w0").key == "a"


# ---------------------------------------------------------------------------
# CampaignSupervisor
# ---------------------------------------------------------------------------

class _FakeWorker:
    def __init__(self, exitcode=None):
        self.exitcode = exitcode

    def poll(self):
        return self.exitcode


def test_supervisor_respawns_dead_workers_once(tmp_path):
    led = JobLedger(str(tmp_path))
    led.submit(_jobs("a"))
    spawned = []

    def spawn(i):
        w = _FakeWorker()
        spawned.append(w)
        return w

    sup = CampaignSupervisor(led, spawn_worker=spawn, max_respawns=2)
    sup.add_worker(_FakeWorker(exitcode=-9))
    sup.tick()
    assert sup.worker_deaths == 1 and sup.respawns == 1
    assert len(spawned) == 1 and sup.workers == spawned
    sup.tick()                                     # same death not recounted
    assert sup.worker_deaths == 1 and sup.respawns == 1


def test_supervisor_run_raises_when_all_workers_dead(tmp_path):
    led = JobLedger(str(tmp_path))
    led.submit(_jobs("a"))
    sup = CampaignSupervisor(led, spawn_worker=None, poll_s=0.01)
    sup.add_worker(_FakeWorker(exitcode=1))
    with pytest.raises(RuntimeError, match="all campaign workers died"):
        sup.run()


def test_supervisor_reclaims_and_reports_metrics(tmp_path, clock):
    led = JobLedger(str(tmp_path), lease_ttl_s=30.0,
                    retry=RetryPolicy(backoff_base_s=2.0))
    led.submit(_jobs("a", "b"))
    led.acquire("w0")
    clock.offset += 31.0
    sup = CampaignSupervisor(led)
    assert sup.tick() == ["a"]
    clock.offset += 3.0                            # past a's backoff gate
    r1 = led.acquire("w1")                         # FIFO: a again
    assert r1.key == "a"
    led.complete("a", "w1", runtime_s=0.2)
    r2 = led.acquire("w1")
    assert r2.key == "b"
    led.complete("b", "w1", cache_hit=True, runtime_s=0.01)
    m = sup.run()
    assert m["reclaimed_leases"] == ["a"]
    assert m["worker_deaths"] == 0
    assert m["jobs"]["a"]["retries"] == 1 and m["jobs"]["a"]["leases"] == 2
    assert m["jobs"]["b"]["cache_hit"] is True
    assert m["jobs"]["a"]["queue_wait_s"] >= 0.0
    json.dumps(m)                                  # report-embeddable


# ---------------------------------------------------------------------------
# the worker loop (in-process, real tiny campaign on the CPU)
# ---------------------------------------------------------------------------

@pytest.fixture()
def tiny_runner(tmp_path):
    return CampaignRunner(
        "polybench-2mm", ("systolic",), cache_dir=str(tmp_path / "store"),
        params={"polybench-2mm": TINY_2MM},
        backend_cfg={"systolic": {"rows": 16, "cols": 16}},
        sweep_axes=None, scheduler="process", lease_ttl_s=30.0,
        device="cpu")


def test_worker_drains_store_and_writes_artifacts(tiny_runner):
    store, ledger, n = tiny_runner.prepare_store()
    assert n == 1
    assert store.read_manifest()["device"] == "cpu"
    assert store.read_manifest()["engine"] == "torch"
    tally = run_worker(store.root, worker_id="w-test", poll_s=0.02)
    assert tally == {"worker": "w-test", "done": 1, "cache_hits": 0,
                     "failed": 0}
    [rec] = ledger.snapshot().values()
    assert rec.state == "done" and rec.runtime_s > 0
    art = store.load(rec.key)
    assert art["workload"] == "polybench-2mm" and art["key"] == rec.key
    # the same bytes as the thread scheduler's artifact for this key
    thread = CampaignRunner(
        "polybench-2mm", ("systolic",),
        cache_dir=os.path.join(os.path.dirname(store.root), "thread"),
        params={"polybench-2mm": TINY_2MM},
        backend_cfg={"systolic": {"rows": 16, "cols": 16}},
        sweep_axes=None, device="cpu").run()
    with open(store.path(rec.key), "rb") as a, \
            open(os.path.join(thread.store_dir, f"{rec.key}.json"),
                 "rb") as b:
        assert a.read() == b.read()
    # a second worker finds nothing to do and exits immediately
    assert run_worker(store.root, worker_id="w-2")["done"] == 0


def test_worker_completes_preexisting_artifact_as_cache_hit(tiny_runner):
    store, ledger, _ = tiny_runner.prepare_store()
    [job] = tiny_runner.plan()
    store.put(job.key, {"workload": "polybench-2mm", "accesses": {},
                        "short_lived": {}, "sweep_points": [],
                        "backend": "systolic"})
    tally = run_worker(store.root, worker_id="w", poll_s=0.02)
    assert tally["done"] == 1 and tally["cache_hits"] == 1
    assert ledger.snapshot()[job.key].cache_hit is True


def test_worker_quarantines_poison_job_and_exits(tiny_runner, monkeypatch):
    tiny_runner.max_retries = 2
    store, ledger, _ = tiny_runner.prepare_store()

    def boom(self, job):
        raise RuntimeError("injected poison job")
    monkeypatch.setattr(CampaignRunner, "_execute", boom)

    tally = run_worker(store.root, worker_id="w", poll_s=0.02,
                       retry=RetryPolicy(max_retries=2, backoff_base_s=0.0))
    assert tally["failed"] == 2 and tally["done"] == 0
    [rec] = ledger.snapshot().values()
    assert rec.state == "quarantined" and rec.attempts == 2
    assert "injected poison job" in rec.error


def test_worker_raises_where_the_campaign_device_is_missing(tmp_path,
                                                            monkeypatch):
    """A worker runs on the manifest's device: a CUDA campaign's worker
    raises without a card before it leases anything, never runs on the
    CPU."""
    runner = CampaignRunner(
        "polybench-2mm", ("systolic",), cache_dir=str(tmp_path / "store"),
        params={"polybench-2mm": TINY_2MM}, sweep_axes=None,
        scheduler="process", device="cpu")
    store, ledger, _ = runner.prepare_store()
    store.write_manifest({**store.read_manifest(), "device": "cuda"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_worker(store.root, worker_id="w")
    assert ledger.counts()["pending"] == 1
    assert os.listdir(store.lease_dir) == []
