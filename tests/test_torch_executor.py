"""The port's fused sweep executor (``repro_torch.compose.executor``) on the
CPU, against the reference's executor tests.

Locked here (the matrix of ``tests/test_executor.py``):
  - every policy x grouped/ungrouped path matches the reference's NumPy
    oracle and its jax executor exactly on capacity fractions and to
    <=1e-9 relative on energy;
  - trace sizes below, at and above the reference's pow2 bucket edges
    (2048 lifetimes, 256 addresses) and candidate counts around its
    candidate bucket (8) are right with no buckets at all;
  - the host trace view is built once per ``(stats, raw)`` pair and its
    device residence once per view and device;
  - a 4-thread ``SweepRunner`` on the torch engine is bit-for-bit equal to
    the serial run;
  - the per-chunk entry ``run_chunk`` runs the same kernels and equals
    both the executor and the reference's per-chunk jax engine;
  - the Pareto anchor survives a family batch of uneven device counts.
The reference's compile-cache tests have no counterpart: the kernels take
runtime extents and are built once by nvcc (ROADMAP D21-D23).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.compose import evaluate as ref_evaluate
from repro.compose import jax_engine as ref_jax_engine
from repro.compose import policies as ref_policies
from repro.core.frontend import SubpartitionStats as RefStats
from repro.devices import get_device_family as ref_family
from repro.sweep import DeviceGrid as RefGrid
from repro.sweep import FamilyGrid as RefFamilyGrid
from repro.sweep import SweepRunner as RefRunner
from repro.sweep import pareto_frontier as ref_pareto_frontier
from repro_torch.compose import engine as compose_engine
from repro_torch.compose import executor, get_policy, policies, torch_engine
from repro_torch.compose.engine import evaluate
from repro_torch.core.frontend import SubpartitionStats
from repro_torch.devices import get_device_family
from repro_torch.sweep import (SRAM_ONLY_ID, DeviceGrid, FamilyGrid,
                               SweepRunner, pareto_frontier)

CLOCK = 1.0e9
POLICIES = ("refresh-free", "refresh-aware",
            "bank-quantized:refresh-free@8")


@dataclasses.dataclass
class _Raw:
    lifetime_cycles: np.ndarray
    addr: np.ndarray
    valid: np.ndarray


def _synth(n=4000, n_addr=311, seed=0, bits=256):
    """(reference stats, port stats, raw) as the reference's test builds
    them."""
    rng = np.random.RandomState(seed)
    lt_cycles = np.maximum(
        rng.lognormal(mean=6.5, sigma=2.0, size=n), 1.0).astype(np.int64)
    addr = rng.randint(0, n_addr, n).astype(np.int64)
    reads = rng.poisson(3.0, n).astype(np.float64)
    dur = float(lt_cycles.max()) / CLOCK
    fields = dict(
        name="syn", n_reads=int(reads.sum()), n_writes=n,
        n_unique_addrs=len(np.unique(addr)), duration_s=dur,
        write_freq_hz=n / dur, read_freq_hz=float(reads.sum()) / dur,
        lifetimes_s=lt_cycles / CLOCK,
        lifetime_bits=np.full(n, bits, np.float64),
        accesses_per_lifetime=reads + 1.0, orphan_fraction=0.0,
        block_bits=bits)
    return (RefStats(**fields), SubpartitionStats(**fields),
            _Raw(lt_cycles, addr, np.ones(n, bool)))


def _asym_devices(family):
    return (family("sram-gaincell-default").build()
            + family("sot-mram").build()[1:])


def _assert_matches(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert np.array_equal(a.capacity_fractions, b.capacity_fractions)
        if a.energy_j > 0:
            assert abs(a.energy_j - b.energy_j) <= 1e-9 * a.energy_j
        else:
            assert b.energy_j == a.energy_j


def _check(ref_cands, port_cands, ref_st, port_st, raw, policy,
           with_jax=False):
    got = evaluate(port_cands, port_st, raw=raw, clock_hz=CLOCK,
                   policy=policy, engine="torch", device="cpu")
    _assert_matches(ref_evaluate(ref_cands, ref_st, raw=raw, clock_hz=CLOCK,
                                 policy=policy), got)
    if with_jax:
        _assert_matches(ref_evaluate(ref_cands, ref_st, raw=raw,
                                     clock_hz=CLOCK, policy=policy,
                                     engine="jax"), got)


# ---------------------------------------------------------------------------
# equivalence: every policy x grouped/ungrouped path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("grouped", [True, False])
def test_fused_batch_matches_oracles_all_paths(policy, grouped):
    ref_st, port_st, raw = _synth(n=3000, n_addr=300)
    kw = dict(mixes=(0.0, 0.5, 1.0), retention_scales=(0.5, 1.0, 2.0),
              per_mix=True)
    _check([c.devices for c in RefGrid(**kw).candidates()],
           [c.devices for c in DeviceGrid(**kw).candidates()],
           ref_st, port_st, raw if grouped else None, policy, with_jax=True)


# ---------------------------------------------------------------------------
# the reference's bucket edges, with no buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_addr,n_cands",
                         [(2047, 255, 7), (2048, 256, 8), (2049, 257, 9),
                          (17, 3, 7)])
@pytest.mark.parametrize("policy", ["refresh-free", "refresh-aware"])
def test_sizes_at_reference_bucket_edges(n, n_addr, n_cands, policy):
    """Trace/address sizes just below, at and above the reference's pow2
    buckets (and a tiny trace), candidate lists of 7, 8 and 9 around its
    candidate bucket, uneven device counts: the kernels take the real
    extents, so there is nothing to mask."""
    ref_asym, asym = _asym_devices(ref_family), _asym_devices(
        get_device_family)

    def cands(a):
        sram = a[0]
        base = [tuple(a), tuple(a[:2]), (sram,), tuple(a[:3]),
                tuple(reversed(a)), tuple(a[1:]) + (sram,),
                tuple(a[:2][::-1]), tuple(a[2:]) + (sram,), (sram, a[1])]
        return base[:n_cands]

    ref_st, port_st, raw = _synth(n=n, n_addr=n_addr, seed=n)
    for use_raw in (raw, None):
        _check(cands(ref_asym), cands(asym), ref_st, port_st, use_raw,
               policy, with_jax=n == 2048)


# ---------------------------------------------------------------------------
# the default engine: the policy kernels on the named device
# ---------------------------------------------------------------------------

def test_default_engine_is_torch_on_the_given_device(monkeypatch):
    from repro_torch.kernels.compose_policy import kernel as k
    _, port_st, raw = _synth(n=500, n_addr=40, seed=2)
    cands = [c.devices for c in DeviceGrid(retention_scales=(0.5, 2.0),
                                           per_mix=True).candidates()]
    for policy, fn in (("refresh-free", k.policy_rf_plain),
                       ("refresh-aware", k.policy_ra_grouped_plain)):
        before = fn.calls
        got = evaluate(cands, port_st, raw=raw, clock_hz=CLOCK,
                       policy=policy, device="cpu")
        assert fn.calls == before + 1
        want = evaluate(cands, port_st, raw=raw, clock_hz=CLOCK,
                        policy=policy, engine="numpy")
        for g, w in zip(got, want):
            assert np.array_equal(g.capacity_fractions, w.capacity_fractions)
            assert g.energy_j == pytest.approx(w.energy_j, rel=1e-9, abs=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate(cands, port_st, raw=raw, clock_hz=CLOCK)


# ---------------------------------------------------------------------------
# residency: one host sort per (stats, raw), one upload per view and device
# ---------------------------------------------------------------------------

def test_trace_view_built_once_per_stats_raw_pair(monkeypatch):
    _, st, raw = _synth(n=2500, n_addr=200, seed=3)
    calls = {"n": 0}
    real = compose_engine._build_trace_view

    def spy(stats, raw_, clock_hz):
        calls["n"] += 1
        return real(stats, raw_, clock_hz)

    monkeypatch.setattr(compose_engine, "_build_trace_view", spy)
    grid = DeviceGrid(mixes=(0.0, 1.0), retention_scales=(1.0,),
                      per_mix=False)
    cands = [c.devices for c in grid.candidates()]
    # two policies, two grids, one (stats, raw) pair -> one view build
    evaluate(cands, st, raw=raw, clock_hz=CLOCK,
             policy="refresh-free", engine="torch", device="cpu")
    evaluate(cands[:2], st, raw=raw, clock_hz=CLOCK,
             policy="refresh-aware", engine="torch", device="cpu")
    assert calls["n"] == 1
    # a different trace is a different residence
    _, st2, raw2 = _synth(n=2500, n_addr=200, seed=4)
    evaluate(cands, st2, raw=raw2, clock_hz=CLOCK,
             policy="refresh-free", engine="torch", device="cpu")
    assert calls["n"] == 2


def test_residence_uploaded_once_per_view_and_device(monkeypatch):
    _, st, raw = _synth(n=1200, n_addr=90, seed=6)
    view = compose_engine.sorted_trace_view(st, raw, CLOCK)
    res = executor._residence_for(view, "cpu")
    assert executor._residence_for(view, torch.device("cpu")) is res
    uploads = {"n": 0}
    real = executor.TraceResidence._put

    def spy(self, a, *args):
        uploads["n"] += 1
        return real(self, a, *args)

    monkeypatch.setattr(executor.TraceResidence, "_put", spy)
    cands = [c.devices for c in DeviceGrid(per_mix=True).candidates()]
    for _ in range(2):
        for policy in ("refresh-free", "refresh-aware"):
            evaluate(cands, st, raw=raw, clock_hz=CLOCK, policy=policy,
                     engine="torch", device="cpu")
    # value side (4 arrays) and address side (6 arrays), once each; the
    # candidate matrices are not residence uploads
    assert uploads["n"] == 10
    arrays = res.addr_sorted(view)
    seg = view.seg
    starts = np.flatnonzero(np.concatenate([[True], seg[1:] != seg[:-1]]))
    assert torch.equal(arrays[3], torch.from_numpy(seg))
    np.testing.assert_array_equal(
        arrays[4].numpy(), np.add.reduceat(view.bits_addr, starts))


# ---------------------------------------------------------------------------
# thread-safety: 4-thread sweep == serial, bit for bit
# ---------------------------------------------------------------------------

class _FakeSession:
    """Duck-types the slice of ProfileSession that run_session uses."""

    def __init__(self, parts):
        self._stats = parts
        self._clock_hz = CLOCK

    def _require_analyzed(self):
        return None


@pytest.mark.parametrize("policy", ["refresh-free", "refresh-aware"])
def test_threaded_torch_sweep_is_bit_identical_to_serial(policy):
    parts = {}
    for i, (n, n_addr) in enumerate(
            [(2000, 150), (2600, 220), (1800, 90), (3100, 310)]):
        _, st, raw = _synth(n=n, n_addr=n_addr, seed=10 + i)
        parts[f"sub{i}"] = (st, raw)
    grid = DeviceGrid(mixes=(0.0, 1.0), retention_scales=(0.5, 2.0),
                      per_mix=True)
    serial = SweepRunner(grid, workers=1, engine="torch", policy=policy,
                         device="cpu").run_session(_FakeSession(parts))
    threaded = SweepRunner(grid, workers=4, engine="torch", policy=policy,
                           device="cpu").run_session(_FakeSession(parts))
    assert len(serial) == len(threaded) == len(grid) * 4
    for ps, pt in zip(serial.points, threaded.points):
        assert (ps.candidate, ps.subpartition) == (pt.candidate,
                                                   pt.subpartition)
        assert ps.composition.energy_j == pt.composition.energy_j
        assert np.array_equal(ps.composition.capacity_fractions,
                              pt.composition.capacity_fractions)


# ---------------------------------------------------------------------------
# run_chunk: the per-chunk entry runs the same kernels
# ---------------------------------------------------------------------------

def _batches(st, raw, cands, grouped):
    """The same PolicyBatch in both packages (the engine's padded device
    matrices), built as ``evaluate`` builds it."""
    devs = [sorted(ds, key=compose_engine._device_sort_key) for ds in cands]
    n_dev = np.array([len(d) for d in devs])
    d_max = int(n_dev.max())
    ret = np.full((len(devs), d_max), -np.inf)
    rfj = np.full((len(devs), d_max), np.inf)
    wfj = np.full((len(devs), d_max), np.inf)
    for c, ds in enumerate(devs):
        ret[c, :len(ds)] = [d.retention_at(st.write_freq_hz) for d in ds]
        rfj[c, :len(ds)] = [d.read_fj_per_bit for d in ds]
        wfj[c, :len(ds)] = [d.write_fj_per_bit for d in ds]
    groups = (compose_engine.address_groups(raw, CLOCK) if grouped
              else None)
    common = dict(ret_s=ret, read_fj=rfj, write_fj=wfj,
                  pad=np.arange(d_max)[None, :] >= n_dev[:, None],
                  fallback=(n_dev - 1)[:, None], lt_s=st.lifetimes_s,
                  reads=st.accesses_per_lifetime - 1.0,
                  bits=st.lifetime_bits)
    ref_groups = None if groups is None else ref_policies.AddressGroups(
        order=groups.order, starts=groups.starts, max_lt_s=groups.max_lt_s)
    return (policies.PolicyBatch(devs=tuple(devs), groups=groups, **common),
            ref_policies.PolicyBatch(devs=tuple(devs), groups=ref_groups,
                                     **common))


@pytest.mark.parametrize("policy", ["refresh-free", "refresh-aware"])
@pytest.mark.parametrize("grouped", [True, False])
def test_run_chunk_matches_executor_and_reference(policy, grouped):
    _, st, raw = _synth(n=1500, n_addr=120, seed=8)
    cands = [c.devices for c in DeviceGrid(
        retention_scales=(0.5, 1.0, 2.0), per_mix=True).candidates()]
    batch, ref_batch = _batches(st, raw, cands, grouped)
    pol = get_policy(policy)
    e, f = torch_engine.run_chunk(pol, batch, device="cpu")
    view = compose_engine.sorted_trace_view(st, raw if grouped else None,
                                            CLOCK)
    e2, f2 = executor.run_batch(pol, batch, view, "cpu")
    assert np.array_equal(e, e2) and np.array_equal(f, f2)
    ref_pol = ref_policies.get_policy(policy)
    re, rf = ref_jax_engine.run_chunk(ref_pol, ref_batch)
    assert np.array_equal(f, rf)
    np.testing.assert_allclose(e, re, rtol=1e-9, atol=0)


def test_run_chunk_validates_policy_and_device(monkeypatch):
    _, st, raw = _synth(n=100, n_addr=9, seed=1)
    batch, _ = _batches(st, raw, [c.devices for c in DeviceGrid()
                                  .candidates()], True)

    class Custom(policies.AssignmentPolicy):
        name = "custom"

    with pytest.raises(ValueError, match="no fused kernel"):
        torch_engine.run_chunk(Custom(), batch, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_engine.run_chunk(get_policy("refresh-free"), batch)


def test_ungrouped_slabs_bound_the_picks(monkeypatch):
    """The one slab left: a small picks budget cuts the ungrouped launch
    into candidate slabs with the same result."""
    _, st, _ = _synth(n=900, n_addr=50, seed=12)
    cands = [c.devices for c in DeviceGrid(
        mixes=(0.0, 0.5, 1.0), retention_scales=(0.5, 2.0),
        per_mix=True).candidates()]
    whole = evaluate(cands, st, clock_hz=CLOCK, policy="refresh-aware",
                     engine="torch", device="cpu")
    monkeypatch.setattr(executor, "_PICKS_BYTES", 2 * 900)
    slabs = evaluate(cands, st, clock_hz=CLOCK, policy="refresh-aware",
                     engine="torch", device="cpu")
    for a, b in zip(whole, slabs):
        assert a.energy_j == b.energy_j
        assert np.array_equal(a.capacity_fractions, b.capacity_fractions)


# ---------------------------------------------------------------------------
# the Pareto anchor on a family batch of uneven device counts
# ---------------------------------------------------------------------------

def test_pareto_anchor_survives_family_batch():
    ref_st, st, raw = _synth(n=2300, n_addr=180, seed=21)
    axes = {"delta": (40.0, 55.0, 70.0)}
    want = ref_pareto_frontier(RefRunner(
        RefFamilyGrid("sot-mram", axes=axes)).run_stats(
            ref_st, raw, clock_hz=CLOCK))
    for eng in ("numpy", "torch"):
        pts = SweepRunner(FamilyGrid("sot-mram", axes=axes), engine=eng,
                          device="cpu").run_stats(st, raw, clock_hz=CLOCK)
        fr = pareto_frontier(pts)
        assert fr.anchor is not None
        assert fr.anchor.candidate == SRAM_ONLY_ID
        assert fr.anchor.composition.area_vs_sram == 1.0
        assert [p.candidate for p in fr.points] == [p.candidate
                                                    for p in want.points]
        for a, b in zip(want.points, fr.points):
            assert np.array_equal(a.composition.capacity_fractions,
                                  b.composition.capacity_fractions)
