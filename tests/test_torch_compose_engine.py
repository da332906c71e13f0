"""The port's ``engine="torch"`` against the reference's engines, on the CPU.

The matrix of ``tests/test_jax_engine.py`` with the port in place of the
jax engine: three policies over seeds, grouped and ungrouped, random
grids, the asymmetric SOT-MRAM fixture and validation.  The port's torch
engine runs its policy kernels' plain versions here (``device="cpu"``).
Contract (the reference's for its jax engine): capacity fractions and bank
quantization bit-identical to the reference's ``engine="numpy"`` and
``engine="jax"``, energy within 1e-9 relative.  The port's own
``engine="numpy"`` equals the reference's bit for bit.

``test_f2_falsifying_example_is_reference_behaviour`` pins the example
that falsifies the reference's property
``test_refresh_aware_never_worse_than_refresh_free`` (ROADMAP F2): every
engine of both packages bills it the same ``energy_vs_sram`` of about
1.19, so it is the reference's accounting, not an engine's fault.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.compose import evaluate as ref_evaluate
from repro.core import compose as ref_compose
from repro.core import compute_stats as ref_compute_stats
from repro.core import lifetimes_of_trace as ref_lifetimes_of_trace
from repro.core import make_trace as ref_make_trace
from repro.core.frontend import SubpartitionStats as RefStats
from repro.devices import get_device_family as ref_family
from repro.sweep import DeviceGrid as RefGrid
from repro_torch.compose import evaluate
from repro_torch.compose.policies import (AssignmentPolicy,
                                          RefreshAwarePolicy, get_policy)
from repro_torch.compose.torch_engine import _base_policy
from repro_torch.core import compose, compute_stats, lifetimes_of_trace
from repro_torch.core import make_trace
from repro_torch.core.frontend import SubpartitionStats
from repro_torch.devices import get_device_family
from repro_torch.kernels.compose_policy import kernel as policy_kernel
from repro_torch.sweep import DeviceGrid

POLICIES = ("refresh-free", "refresh-aware", "bank-quantized")
CLOCK_HZ = 1.0e9
F2_ENERGY_VS_SRAM = 1.188445283018868   # reference numpy, seed 0, n 10


@dataclasses.dataclass
class _Raw:
    """compose(raw=...) duck type: per-lifetime address/cycle arrays."""
    lifetime_cycles: np.ndarray
    addr: np.ndarray
    valid: np.ndarray


def _synthetic(n=4000, seed=0, n_addr=311):
    """(reference stats, port stats, raw) with a lognormal lifetime spread
    crossing the gain-cell retentions, as the reference's test builds it."""
    rng = np.random.RandomState(seed)
    lt_cycles = rng.lognormal(mean=6.5, sigma=2.0, size=n).astype(np.int64)
    addr = rng.randint(0, n_addr, n).astype(np.int64)
    reads = rng.poisson(3.0, n).astype(np.float64)
    dur = float(lt_cycles.max()) / CLOCK_HZ
    fields = dict(
        name="syn", n_reads=int(reads.sum()), n_writes=n,
        n_unique_addrs=len(np.unique(addr)), duration_s=dur,
        write_freq_hz=n / dur, read_freq_hz=float(reads.sum()) / dur,
        lifetimes_s=lt_cycles / CLOCK_HZ,
        lifetime_bits=np.full(n, 256, np.float64),
        accesses_per_lifetime=reads + 1.0,
        orphan_fraction=0.0, block_bits=256)
    return (RefStats(**fields), SubpartitionStats(**fields),
            _Raw(lifetime_cycles=lt_cycles, addr=addr,
                 valid=np.ones(n, bool)))


def _grid_candidates(mixes=(0.0, 0.5, 1.0), retention_scales=(0.5, 1, 2),
                     **kw):
    """The same grid's candidates from both packages."""
    ref = RefGrid(mixes=mixes, retention_scales=retention_scales,
                  per_mix=True, **kw)
    port = DeviceGrid(mixes=mixes, retention_scales=retention_scales,
                      per_mix=True, **kw)
    return ([c.devices for c in ref.candidates()],
            [c.devices for c in port.candidates()])


def _assert_contract(want, got, what):
    """Capacity and quantization exactly, energy within 1e-9 relative."""
    assert len(want) == len(got), what
    for a, b in zip(want, got):
        assert abs(a.energy_j - b.energy_j) <= 1e-9 * abs(a.energy_j), \
            (what, a.energy_j, b.energy_j)
        # bit-identical, not approx: the quantization knife-edges
        # (ceil(frac * n_banks)) tolerate zero ulp of drift
        assert np.array_equal(a.capacity_fractions, b.capacity_fractions), \
            (what, a.capacity_fractions, b.capacity_fractions)
        assert a.quantization == b.quantization, what
        assert a.devices == b.devices, what
        assert a.policy == b.policy, what
        # the baselines: the torch engine sums Algorithm 1's refresh bits on
        # the retention pass, in another order than NumPy (ROADMAP D28)
        assert sorted(a.monolithic_energy_j) == sorted(b.monolithic_energy_j)
        for name, e in a.monolithic_energy_j.items():
            assert abs(e - b.monolithic_energy_j[name]) <= 1e-9 * abs(e), \
                (what, name)
        assert abs(a.energy_vs_sram - b.energy_vs_sram) <= \
            1e-9 * abs(a.energy_vs_sram), what


def _plain_calls():
    return tuple(f.calls for f in (policy_kernel.policy_rf_plain,
                                   policy_kernel.policy_ra_grouped_plain,
                                   policy_kernel.policy_ra_ungrouped_plain))


def _assert_engines_agree(cands, stats, raw, policy, with_jax=True):
    ref_cands, port_cands = cands
    ref_stats, port_stats = stats
    want = ref_evaluate(ref_cands, ref_stats, raw=raw, clock_hz=CLOCK_HZ,
                        policy=policy)
    port_numpy = evaluate(port_cands, port_stats, raw=raw,
                          clock_hz=CLOCK_HZ, policy=policy, engine="numpy")
    for a, b in zip(want, port_numpy):
        assert a.energy_j == b.energy_j
        assert np.array_equal(a.capacity_fractions, b.capacity_fractions)
    before = _plain_calls()
    got = evaluate(port_cands, port_stats, raw=raw, clock_hz=CLOCK_HZ,
                   policy=policy, engine="torch", device="cpu")
    assert sum(_plain_calls()) == sum(before) + 1   # one kernel call
    _assert_contract(want, got, f"{policy} vs reference numpy")
    if with_jax:
        jax_got = ref_evaluate(ref_cands, ref_stats, raw=raw,
                               clock_hz=CLOCK_HZ, policy=policy,
                               engine="jax")
        _assert_contract(jax_got, got, f"{policy} vs reference jax")


# ---------------------------------------------------------------------------
# randomized differential oracle, all three policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed,n,n_addr", [(0, 4000, 311), (1, 997, 13),
                                           (2, 2500, 77)])
def test_torch_matches_numpy_and_jax_grouped(policy, seed, n, n_addr):
    ref_stats, port_stats, raw = _synthetic(n=n, seed=seed, n_addr=n_addr)
    _assert_engines_agree(_grid_candidates(), (ref_stats, port_stats), raw,
                          policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_torch_matches_numpy_and_jax_ungrouped(policy):
    """No raw lifetimes -> the bits-weighted fallback (per-lifetime picks
    reduced on the host with the oracle's exact masked sums)."""
    ref_stats, port_stats, _ = _synthetic(seed=4)
    _assert_engines_agree(_grid_candidates(), (ref_stats, port_stats), None,
                          policy)


def test_torch_matches_numpy_random_grids():
    """Randomized device grids: scales drawn per trial, every engine
    stays locked across the whole candidate set."""
    rng = np.random.RandomState(11)
    ref_stats, port_stats, raw = _synthetic(seed=11)
    for trial in range(4):
        cands = _grid_candidates(
            mixes=tuple(np.round(rng.uniform(0, 1, 2), 3)),
            retention_scales=tuple(np.round(rng.uniform(0.3, 4, 2), 3)),
            area_scales=(float(np.round(rng.uniform(0.5, 2), 3)),),
            energy_scales=(float(np.round(rng.uniform(0.5, 2), 3)),))
        for policy in POLICIES:
            _assert_engines_agree(cands, (ref_stats, port_stats), raw,
                                  policy, with_jax=trial == 0)


@pytest.mark.parametrize("seed", [3, 17, 29, 41])
def test_torch_matches_numpy_on_drawn_grids(seed):
    """The reference's hypothesis property (1e-9 energy on random grids,
    with and without raw), on fixed draws."""
    rng = np.random.RandomState(seed)
    ref_stats, port_stats, raw = _synthetic(n=600, seed=seed % 50,
                                            n_addr=23)
    cands = _grid_candidates(
        mixes=(round(float(rng.uniform(0, 1)), 4),),
        retention_scales=(round(float(rng.uniform(0.25, 4)), 4),),
        energy_scales=(round(float(rng.uniform(0.5, 2)), 4),))
    for policy in POLICIES:
        _assert_engines_agree(cands, (ref_stats, port_stats),
                              raw if seed % 2 else None, policy,
                              with_jax=False)


def test_torch_matches_numpy_asymmetric_sot_mram():
    """Mixed SRAM + gain-cell + SOT-MRAM set: read_fj != write_fj
    exercises the per-operation billing seam symmetric grids never
    touch."""
    ref_asym = (ref_family("sram-gaincell-default").build()
                + ref_family("sot-mram").build()[1:])
    port_asym = (get_device_family("sram-gaincell-default").build()
                 + get_device_family("sot-mram").build()[1:])
    ref_stats, port_stats, raw = _synthetic(seed=7)
    for policy in POLICIES:
        _assert_engines_agree(([ref_asym, ref_asym], [port_asym, port_asym]),
                              (ref_stats, port_stats), raw, policy)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("grouped", [True, False])
def test_torch_baselines_come_from_the_retention_pass(policy, grouped,
                                                      monkeypatch):
    """The torch engine makes no ``analyze_energy`` call: each distinct
    retention's floor sum comes from one retention pass without address
    groups, is memoized with the trace view's residence, and bills every
    device of that retention."""
    from repro_torch.compose import engine as ce
    ref_stats, port_stats, raw = _synthetic(n=1500, seed=8, n_addr=53)
    raw = raw if grouped else None
    ref_cands, cands = _grid_candidates(area_scales=(0.5, 1.0),
                                        energy_scales=(0.5, 2.0))
    want = ref_evaluate(ref_cands, ref_stats, raw=raw, clock_hz=CLOCK_HZ,
                        policy=policy)
    calls = []
    real = ce.analyze_energy
    monkeypatch.setattr(ce, "analyze_energy",
                        lambda *a: calls.append(a) or real(*a))
    numpy_out = evaluate(cands, port_stats, raw=raw, clock_hz=CLOCK_HZ,
                         policy=policy, engine="numpy")
    assert calls              # the oracle's baselines pass over lifetimes
    del calls[:]
    passes = policy_kernel.policy_retention_plain.calls
    for _ in range(2):
        got = evaluate(cands, port_stats, raw=raw, clock_hz=CLOCK_HZ,
                       policy=policy, engine="torch", device="cpu")
        _assert_contract(want, got, f"{policy} vs reference numpy")
        _assert_contract(numpy_out, got, f"{policy} vs port numpy")
    assert calls == []
    # one floor pass on the first call; the second call finds the floor
    # sums in the memo; a grouped refresh-aware call also makes a pass for
    # its per-address sums each time
    base = _base_policy(get_policy(policy))
    grouped_ra = grouped and isinstance(base, RefreshAwarePolicy)
    assert policy_kernel.policy_retention_plain.calls == passes + 1 + (
        2 if grouped_ra else 0)


def test_torch_engine_validation():
    _, port_stats, raw = _synthetic(n=50, seed=9, n_addr=7)
    _, cands = _grid_candidates(mixes=(0.5,), retention_scales=(1.0,))
    with pytest.raises(ValueError, match="engine"):
        evaluate(cands, port_stats, raw=raw, clock_hz=CLOCK_HZ,
                 engine="cuda")
    with pytest.raises(ValueError, match="engine"):
        evaluate(cands, port_stats, raw=raw, clock_hz=CLOCK_HZ,
                 engine="jax")

    class Custom(AssignmentPolicy):
        name = "custom"

    with pytest.raises(ValueError, match="no fused kernel"):
        evaluate(cands, port_stats, raw=raw, clock_hz=CLOCK_HZ,
                 policy=Custom(), engine="torch", device="cpu")


def test_torch_engine_runs_on_the_card_or_raises(monkeypatch):
    """``engine="torch"``, the default, resolves ``device=None`` to the
    CUDA device and raises without one; ``device="cpu"`` is the explicit
    host run."""
    _, port_stats, raw = _synthetic(n=200, seed=5, n_addr=17)
    _, cands = _grid_candidates(mixes=(0.5,), retention_scales=(1.0,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(cands, port_stats, raw=raw, engine="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        compose(port_stats, raw=raw)
    # the NumPy engine needs no device
    assert len(evaluate(cands, port_stats, raw=raw,
                        engine="numpy")) == len(cands)
    assert len(evaluate(cands, port_stats, raw=raw, engine="torch",
                        device="cpu")) == len(cands)


# ---------------------------------------------------------------------------
# F2: the reference's falsified property, pinned as reference behaviour
# ---------------------------------------------------------------------------

def test_f2_falsifying_example_is_reference_behaviour():
    """RandomState(0), n 10, spread 7, built as the reference's property
    test builds it: refresh-aware bills ``energy_vs_sram`` of about 1.19
    (> 1, which that property forbids) on every engine of both packages,
    with and without raw lifetimes — the same number everywhere."""
    rng = np.random.RandomState(0)
    n, spread = 10, 7
    t = np.sort(rng.randint(0, 10 ** spread, n))
    a = rng.randint(0, 12, n)
    w = rng.rand(n) < 0.35
    ref_tr = ref_make_trace(t, a, w)
    ref_stats = ref_compute_stats(ref_tr, 0)
    ref_raw = ref_lifetimes_of_trace(ref_tr)
    tr = make_trace(t, a, w)
    stats = compute_stats(tr, 0, device="cpu")
    raw = lifetimes_of_trace(tr, device="cpu")
    got = {}
    for use_raw in (True, False):
        for engine in ("numpy", "jax"):
            comp = ref_compose(ref_stats, raw=ref_raw if use_raw else None,
                               clock_hz=ref_tr.clock_hz,
                               policy="refresh-aware", engine=engine)
            got[("reference", engine, use_raw)] = comp.energy_vs_sram
        for engine in ("numpy", "torch"):
            comp = compose(stats, raw=raw if use_raw else None,
                           clock_hz=tr.clock_hz, policy="refresh-aware",
                           engine=engine,
                           device="cpu" if engine == "torch" else None)
            got[("port", engine, use_raw)] = comp.energy_vs_sram
    for key, value in got.items():
        assert value == pytest.approx(F2_ENERGY_VS_SRAM, rel=1e-9, abs=0), \
            key
    assert got[("port", "numpy", True)] == \
        got[("reference", "numpy", True)] == F2_ENERGY_VS_SRAM
    assert F2_ENERGY_VS_SRAM > 1.0    # the property's bound, exceeded
