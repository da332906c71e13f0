"""The port's design-space sweep (``repro_torch.sweep``, ``ProfileSession.
sweep``, ``python -m repro_torch sweep``) against the reference, on the CPU.

The matrix of ``tests/test_sweep.py``, run in the port and held against
the reference on the same workloads: the grid (candidates, gain-cell
interpolation, validation), a degenerate sweep equal to ``compose()``, the
grid-batched engine equal to a per-candidate loop, the Pareto properties,
the session sweep and its report, thread-parallel determinism, the JSON and
CSV exports, ``run_geometries`` on the cache backend and the CLI dry run.
With ``engine="numpy"`` sweep points and frontiers equal the reference's
(integers, strings and capacity fractions exactly, other floats to 1e-12
relative, as ``tests/test_torch_pipeline.py`` holds the profiling path);
with ``engine="torch"`` they meet the engine contract (capacity exactly,
energy 1e-9 relative).
"""

import contextlib
import csv
import io
import json
import math

import numpy as np
import pytest
import torch

from repro.backends.cachesim import CacheConfig as RefCacheConfig
from repro.backends.systolic import GemmLayer as RefGemm
from repro.core import ProfileSession as RefSession
from repro.launch.sweep import main as ref_sweep_main
from repro.sweep import DeviceGrid as RefGrid
from repro.sweep import SweepRunner as RefRunner
from repro_torch.__main__ import main as port_cli
from repro_torch.backends.cachesim import CacheConfig
from repro_torch.backends.systolic import GemmLayer
from repro_torch.core import (DEFAULT_DEVICES, HYBRID_GCRAM, SI_GCRAM, SRAM,
                              ProfileSession, compose, compute_stats,
                              lifetimes_of_trace, make_trace)
from repro_torch.kernels.compose_policy import kernel as policy_kernel
from repro_torch.sweep import (SRAM_ONLY_ID, Candidate, DeviceGrid,
                               SweepRunner, dominates, gain_cell,
                               pareto_frontier)

RTOL = 1e-12
LAYERS = [("a", 48, 64, 64), ("b", 32, 48, 96)]
WIDE = dict(mixes=(0.0, 0.25, 0.5, 1.0), retention_scales=(0.25, 1.0, 4.0),
            area_scales=(0.9, 1.0), energy_scales=(0.8, 1.0), per_mix=True)


def assert_close(got, want, path="value", energy_rtol=RTOL):
    """Ints, strings and capacity fractions exactly; floats to RTOL
    (energies to ``energy_rtol``)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            if k in ("capacity_fractions", "unquantized_fractions"):
                assert got[k] == want[k], f"{path}.{k}"
            else:
                rtol = energy_rtol if "energy" in k else RTOL
                assert_close(got[k], want[k], f"{path}.{k}",
                             energy_rtol=rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]", energy_rtol)
    elif isinstance(want, float):
        if math.isfinite(want):
            assert got == pytest.approx(want, rel=energy_rtol, abs=0.0), \
                path
        else:
            assert got == want or (math.isnan(got) and math.isnan(want))
    else:
        assert got == want, path


def _assert_points(got, want, energy_rtol=RTOL):
    assert len(got) == len(want)
    for p, q in zip(got, want):
        assert_close(p.asdict(), q.asdict(), p.candidate, energy_rtol)


def _assert_compositions_identical(got, ref):
    assert got.devices == ref.devices
    assert np.array_equal(got.capacity_fractions, ref.capacity_fractions)
    assert got.energy_j == ref.energy_j
    assert got.energy_vs_sram == ref.energy_vs_sram
    assert got.monolithic_energy_j == ref.monolithic_energy_j
    assert got.area_um2 == ref.area_um2
    assert got.area_vs_sram == ref.area_vs_sram
    assert got.policy == ref.policy
    assert got.quantization == ref.quantization


@pytest.fixture(scope="module")
def sessions():
    """The same analyzed systolic workload in both packages."""
    ref = RefSession("systolic")
    ref.profile([RefGemm(*spec) for spec in LAYERS], rows=32, cols=32,
                dataflow="ws").analyze()
    port = ProfileSession("systolic", device="cpu")
    port.profile([GemmLayer(*spec) for spec in LAYERS], rows=32, cols=32,
                 dataflow="ws").analyze()
    return ref, port


@pytest.fixture(scope="module")
def analyzed_session(sessions):
    return sessions[1]


# ---------------------------------------------------------------------------
# DeviceGrid / gain_cell
# ---------------------------------------------------------------------------

def test_default_point_grid_is_default_devices():
    grid = DeviceGrid.default_point()
    assert len(grid) == 1
    (cand,) = grid.candidates()
    assert cand.devices == tuple(DEFAULT_DEVICES)


def test_gain_cell_endpoints_are_exact_paper_devices():
    assert gain_cell(0.0) is SI_GCRAM
    assert gain_cell(1.0) is HYBRID_GCRAM


def test_gain_cell_interpolation_is_monotone_and_bounded():
    mid = gain_cell(0.5)
    lo, hi = sorted([SI_GCRAM.area_um2_per_bit,
                     HYBRID_GCRAM.area_um2_per_bit])
    assert lo < mid.area_um2_per_bit < hi
    assert (SI_GCRAM.retention_s < mid.retention_s
            < HYBRID_GCRAM.retention_s)
    assert (SI_GCRAM.read_fj_per_bit < mid.read_fj_per_bit
            < HYBRID_GCRAM.read_fj_per_bit)
    assert np.isfinite(mid.retention_knee_hz)
    assert mid.retention_knee_hz > HYBRID_GCRAM.retention_knee_hz


def test_gain_cell_scales_apply():
    d = gain_cell(0.0, retention_scale=2.0, area_scale=0.5,
                  energy_scale=3.0)
    assert d.retention_s == pytest.approx(2 * SI_GCRAM.retention_s)
    assert d.area_um2_per_bit == pytest.approx(
        0.5 * SI_GCRAM.area_um2_per_bit)
    assert d.read_fj_per_bit == pytest.approx(3 * SI_GCRAM.read_fj_per_bit)


def test_gain_cell_validation():
    with pytest.raises(ValueError, match="mix"):
        gain_cell(1.5)
    with pytest.raises(ValueError, match="scales"):
        gain_cell(0.5, retention_scale=0.0)


def test_candidate_requires_sram():
    with pytest.raises(ValueError, match="SRAM"):
        Candidate(cid="bad", devices=(SI_GCRAM,), params={})


def test_grid_axes_must_be_nonempty():
    with pytest.raises(ValueError, match="mixes"):
        DeviceGrid(mixes=())


def test_grid_size_anchor_and_ids_equal_the_reference():
    grid = DeviceGrid(mixes=(0.0, 1.0), retention_scales=(0.5, 1.0, 2.0),
                      per_mix=True)
    assert len(grid) == 2 * 3 + 1
    cands = grid.candidates()
    assert cands[0].cid == SRAM_ONLY_ID
    assert cands[0].devices == (SRAM,)
    assert len(cands) == len(grid)
    assert len({c.cid for c in cands}) == len(cands)  # ids unique
    for kw in (dict(mixes=(0.0, 1.0), retention_scales=(0.5, 1.0, 2.0),
                    per_mix=True), WIDE, {}):
        ref = RefGrid(**kw).candidates()
        got = DeviceGrid(**kw).candidates()
        assert [c.cid for c in got] == [c.cid for c in ref]
        assert [c.params for c in got] == [c.params for c in ref]
        for a, b in zip(got, ref):
            assert [(d.name, d.retention_s, d.read_fj_per_bit,
                     d.write_fj_per_bit, d.area_um2_per_bit)
                    for d in a.devices] == \
                [(d.name, d.retention_s, d.read_fj_per_bit,
                  d.write_fj_per_bit, d.area_um2_per_bit) for d in b.devices]
        assert DeviceGrid(**kw).max_devices() == RefGrid(**kw).max_devices()


# ---------------------------------------------------------------------------
# degenerate sweep == compose(); batched == per-candidate loop
# ---------------------------------------------------------------------------

def test_degenerate_sweep_reproduces_compose(analyzed_session):
    s = analyzed_session
    runner = SweepRunner(DeviceGrid.default_point(), engine="numpy")
    for name, (st, raw) in s._stats.items():
        ref = compose(st, raw=raw, devices=DEFAULT_DEVICES,
                      clock_hz=s._clock_hz, engine="numpy")
        (pt,) = runner.run_stats(st, raw, clock_hz=s._clock_hz)
        _assert_compositions_identical(pt.composition, ref)


@pytest.mark.parametrize("policy", ["refresh-free", "refresh-aware",
                                    "bank-quantized:refresh-aware@8"])
def test_batched_equals_compose_loop_and_reference(sessions, policy):
    """The grid-batched engine call equals a per-candidate compose() loop
    for every policy, and its points equal the reference's sweep;
    engine="torch" meets the engine contract against both."""
    ref_s, s = sessions
    grid = DeviceGrid(**WIDE)
    for name, (st, raw) in s._stats.items():
        vec = SweepRunner(grid, policy=policy, engine="numpy").run_stats(
            st, raw, clock_hz=s._clock_hz)
        loop = [compose(st, raw=raw, devices=c.devices,
                        clock_hz=s._clock_hz, policy=policy, engine="numpy")
                for c in grid.candidates()]
        assert len(vec) == len(loop) == len(grid)
        for pv, ref in zip(vec, loop):
            assert pv.policy == ref.policy
            _assert_compositions_identical(pv.composition, ref)
        ref_st, ref_raw = ref_s._stats[name]
        want = RefRunner(RefGrid(**WIDE), policy=policy).run_stats(
            ref_st, ref_raw, clock_hz=ref_s._clock_hz)
        _assert_points(vec, want)
        fused = SweepRunner(grid, policy=policy, engine="torch",
                            device="cpu").run_stats(st, raw,
                                                    clock_hz=s._clock_hz)
        _assert_points(fused, want, energy_rtol=1e-9)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_sweep_without_raw_matches_compose(analyzed_session, engine):
    # bits-weighted capacity fallback (raw=None)
    s = analyzed_session
    st, _ = next(iter(s._stats.values()))
    grid = DeviceGrid(retention_scales=(0.5, 1.0))
    pts = SweepRunner(grid, engine=engine, device="cpu").run_stats(
        st, None, clock_hz=s._clock_hz)
    for cand, pt in zip(grid.candidates(), pts):
        ref = compose(st, raw=None, devices=cand.devices,
                      clock_hz=s._clock_hz, engine="numpy")
        if engine == "numpy":
            _assert_compositions_identical(pt.composition, ref)
        else:
            assert np.array_equal(pt.composition.capacity_fractions,
                                  ref.capacity_fractions)
            assert pt.composition.energy_j == pytest.approx(
                ref.energy_j, rel=1e-9, abs=0)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_sweep_empty_trace_matches_compose_empty_branch(engine):
    tr = make_trace([0, 5], [1, 1], [True, True], hit=[False, False])
    st = compute_stats(tr, 0, mode="cache", write_allocate=False,
                       device="cpu")
    raw = lifetimes_of_trace(tr.select(0), mode="cache",
                             write_allocate=False, device="cpu")
    assert len(st.lifetimes_s) == 0
    grid = DeviceGrid()
    pts = SweepRunner(grid, engine=engine, device="cpu").run_stats(
        st, raw, clock_hz=tr.clock_hz)
    for cand, pt in zip(grid.candidates(), pts):
        ref = compose(st, raw=raw, devices=cand.devices,
                      clock_hz=tr.clock_hz, engine="numpy")
        _assert_compositions_identical(pt.composition, ref)


# ---------------------------------------------------------------------------
# Pareto frontier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_points(analyzed_session):
    grid = DeviceGrid(mixes=(0.0, 0.5, 1.0),
                      retention_scales=(0.5, 1.0, 2.0),
                      energy_scales=(0.9, 1.0), per_mix=True)
    return SweepRunner(grid, engine="numpy").run_session(
        analyzed_session).points


def test_pareto_is_dominated_free(sweep_points):
    fr = pareto_frontier(
        [p for p in sweep_points if p.subpartition == "ifmap"])
    for p in fr.points:
        for q in fr.points:
            assert not dominates(p, q)


def test_pareto_is_deterministic(sweep_points):
    pts = [p for p in sweep_points if p.subpartition == "ifmap"]
    fr1 = pareto_frontier(pts)
    fr2 = pareto_frontier(list(reversed(pts)))
    rng = np.random.RandomState(0)
    shuffled = list(pts)
    rng.shuffle(shuffled)
    fr3 = pareto_frontier(shuffled)
    ids = [p.candidate for p in fr1.points]
    assert ids == [p.candidate for p in fr2.points]
    assert ids == [p.candidate for p in fr3.points]


def test_pareto_frontier_sorted_by_area(sweep_points):
    fr = pareto_frontier(
        [p for p in sweep_points if p.subpartition == "filter"])
    areas = [p.area_vs_sram for p in fr.points]
    energies = [p.energy_vs_sram for p in fr.points]
    assert areas == sorted(areas)
    assert energies == sorted(energies, reverse=True)


def test_pareto_includes_all_sram_anchor(sweep_points):
    for sub in ("ifmap", "filter", "ofmap"):
        fr = pareto_frontier(
            [p for p in sweep_points if p.subpartition == sub])
        assert fr.anchor is not None
        assert fr.anchor.candidate == SRAM_ONLY_ID
        assert fr.anchor.area_vs_sram == 1.0          # exact, by contract
        assert fr.anchor.composition.devices == ("SRAM",)
        assert fr.anchor.composition.capacity_fractions[0] == 1.0
        assert fr.asdict()["anchor"] == fr.anchor.asdict()


def test_pareto_counts(sweep_points):
    pts = [p for p in sweep_points if p.subpartition == "ifmap"]
    fr = pareto_frontier(pts)
    assert fr.n_total == len(pts)
    assert fr.n_dominated == len(pts) - len(fr.points)
    assert fr.best_area() is fr.points[0]
    assert fr.best_energy() is fr.points[-1]
    assert "frontier point(s)" in fr.summary()


# ---------------------------------------------------------------------------
# session integration, parallelism, exports
# ---------------------------------------------------------------------------

# the 73-candidate grid (289 real device slots, 24 distinct retentions)
WIDE_73 = dict(mixes=(0.0, 0.5, 1.0),
               retention_scales=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
               area_scales=(0.5, 1.0, 2.0), energy_scales=(0.5, 1.0, 2.0))


@pytest.mark.parametrize("policy", ["refresh-free", "refresh-aware",
                                    "bank-quantized"])
def test_wide_grid_baselines_come_from_the_retention_pass(
        sessions, policy, monkeypatch):
    """On the 2-layer sessions at the 73-candidate grid, the torch engine
    bills every monolithic baseline from the retention pass's floor sums,
    with no ``analyze_energy`` pass over the lifetimes: baselines and
    ``energy_vs_sram`` within 1e-9 of ``engine="numpy"`` and of the
    reference's engine (ROADMAP D28)."""
    from repro_torch.compose import engine as ce
    from repro_torch.core import frontend
    ref_s, s = sessions
    want_ref = ref_s.sweep(RefGrid(**WIDE_73), policy=policy,
                           attach=False).points
    want = s.sweep(DeviceGrid(**WIDE_73), policy=policy, engine="numpy",
                   attach=False).points
    calls = []

    def counted(fn):
        def wrapper(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ce, "analyze_energy", counted(ce.analyze_energy))
    monkeypatch.setattr(frontend, "analyze_energy",
                        counted(frontend.analyze_energy))
    monkeypatch.setattr(frontend, "analyze_refresh",
                        counted(frontend.analyze_refresh))
    got = s.sweep(DeviceGrid(**WIDE_73), policy=policy, engine="torch",
                  attach=False).points
    assert calls == []
    assert len(got) == len(want) == len(want_ref) == 3 * 73
    for g, n, r in zip(got, want, want_ref):
        assert (g.candidate, g.subpartition) == (r.candidate, r.subpartition)
        gc_, nc_, rc_ = g.composition, n.composition, r.composition
        assert sorted(gc_.monolithic_energy_j) == \
            sorted(rc_.monolithic_energy_j)
        for name, e in gc_.monolithic_energy_j.items():
            for other in (nc_, rc_):
                w = other.monolithic_energy_j[name]
                assert abs(e - w) <= 1e-9 * abs(w), (g.candidate, name)
        for other in (nc_, rc_):
            assert abs(gc_.energy_vs_sram - other.energy_vs_sram) <= \
                1e-9 * abs(other.energy_vs_sram)
        assert np.array_equal(gc_.capacity_fractions,
                              rc_.capacity_fractions)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_session_sweep_attaches_the_reference_frontiers(sessions, engine):
    ref_s, s = sessions
    kw = dict(mixes=(0.0, 0.5, 1.0), retention_scales=(0.5, 1.0, 2.0))
    ref_s.sweep(RefGrid(**kw), policy="refresh-aware")
    before = policy_kernel.policy_ra_grouped_plain.calls
    res = s.sweep(DeviceGrid(**kw), policy="refresh-aware", engine=engine)
    assert policy_kernel.policy_ra_grouped_plain.calls == before + 3 * (
        engine == "torch")
    report = s.report()
    assert set(report["sweep"]) == {"ifmap", "filter", "ofmap"}
    for entry in report["sweep"].values():
        assert entry["anchor"]["area_vs_sram"] == 1.0
        assert entry["n_total"] == len(DeviceGrid(**kw))
    json.dumps(report)  # report stays JSON-serializable
    assert len(res) == len(DeviceGrid(**kw)) * 3
    assert_close(report["sweep"], ref_s.report()["sweep"], "sweep",
                 energy_rtol=RTOL if engine == "numpy" else 1e-9)


def test_sweep_defaults_to_the_card_and_numpy_needs_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProfileSession("systolic").sweep()
    s = ProfileSession("systolic", device="cpu")
    s.profile([GemmLayer("g", 16, 16, 16)], rows=8, cols=8)
    assert len(s.sweep(DeviceGrid(), engine="torch")) == 3 * len(
        DeviceGrid())
    st, raw = next(iter(s._stats.values()))
    with pytest.raises(RuntimeError, match="CUDA"):
        SweepRunner().run_stats(st, raw)
    assert len(SweepRunner(engine="numpy").run_stats(st, raw)) == len(
        DeviceGrid())
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli(["sweep", "--backend", "systolic", "--dry-run"])


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_sweep_workers_deterministic(analyzed_session, engine):
    grid = DeviceGrid(retention_scales=(0.5, 1.0, 2.0))
    serial = SweepRunner(grid, workers=1, engine=engine,
                         device="cpu").run_session(analyzed_session)
    threaded = SweepRunner(grid, workers=4, engine=engine,
                           device="cpu").run_session(analyzed_session)
    assert len(serial) == len(threaded)
    for ps, pt_ in zip(serial.points, threaded.points):
        assert (ps.candidate, ps.subpartition) == (pt_.candidate,
                                                   pt_.subpartition)
        _assert_compositions_identical(ps.composition, pt_.composition)


def test_sweep_result_exports_equal_the_reference(sessions):
    ref_s, s = sessions
    res = SweepRunner(DeviceGrid(), engine="numpy").run_session(s)
    blob = res.to_json()
    json.dumps(blob)
    assert blob["n_points"] == len(res)
    assert set(blob["frontiers"]) == {"ifmap", "filter", "ofmap"}
    assert_close(blob, RefRunner(RefGrid()).run_session(ref_s).to_json())
    rows = res.csv_rows()
    assert rows[0].startswith(
        "geometry,subpartition,candidate,family,policy,")
    assert len(rows) == len(res) + 1
    parsed = list(csv.reader(rows[1:]))
    assert all(len(r) == 9 for r in parsed)  # comma-safe quoting
    assert all(r[4] == "refresh-free" for r in parsed)  # policy column
    flagged = {(r[1], r[2]) for r in parsed if r[7] == "1"}
    expect = {(sub, p.candidate)
              for (geom, sub), fr in res.frontiers().items()
              for p in fr.points}
    assert flagged == expect


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_run_geometries_tags_points_and_equals_the_reference(engine):
    def program(sb, ops):
        ops.transformer_ops(sb, d_model=32, n_heads=2, kv_heads=2, d_ff=64,
                            seq=8, n_layers=1)

    from repro.backends import opstream as ref_ops
    from repro_torch.backends import opstream as port_ops
    geoms = {"small": dict(size_kb=16, ways=2),
             "big": dict(size_kb=64, ways=4)}
    res = SweepRunner(DeviceGrid(), workers=2, engine=engine,
                      device="cpu").run_geometries(
        "cachesim", lambda sb: program(sb, port_ops),
        {k: {"l1": CacheConfig(**v)} for k, v in geoms.items()})
    assert {p.geometry for p in res.points} == {"small", "big"}
    keys = set(res.frontiers())
    assert ("small", "L1") in keys and ("big", "L2") in keys
    want = RefRunner(RefGrid(), workers=2).run_geometries(
        "cachesim", lambda sb: program(sb, ref_ops),
        {k: {"l1": RefCacheConfig(**v)} for k, v in geoms.items()})
    _assert_points(res.points, want.points,
                   energy_rtol=RTOL if engine == "numpy" else 1e-9)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["systolic", "gpu"])
def test_cli_sweep_dry_run_equals_the_reference(tmp_path, backend):
    outs = {}
    for who in ("reference", "numpy", "torch"):
        out, csv_out = tmp_path / f"{who}.json", tmp_path / f"{who}.csv"
        args = ["--backend", backend, "--dry-run", "--policy",
                "refresh-aware", "--out", str(out), "--csv", str(csv_out)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if who == "reference":
                ref_sweep_main(args)
            else:
                assert port_cli(["sweep", *args, "--engine", who,
                                 "--device", "cpu"]) == 0
        assert "sweep ok:" in buf.getvalue()
        outs[who] = json.loads(out.read_text())
        assert csv_out.read_text().startswith(
            "geometry,subpartition,candidate")
        for fr in outs[who]["frontiers"].values():
            assert fr["anchor"]["area_vs_sram"] == 1.0
    assert_close(outs["numpy"], outs["reference"])
    assert_close(outs["torch"], outs["reference"], energy_rtol=1e-9)


def test_cli_sweep_family_and_geometry_flags(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_cli(["sweep", "--dry-run", "--family", "sot-mram",
                         "--family-param", "delta=40,60", "--engine",
                         "torch", "--device", "cpu"]) == 0
        assert port_cli(["sweep", "--backend", "gpu", "--dry-run",
                         "--l1-geom", "16:2,64:4", "--workers", "2",
                         "--device", "cpu"]) == 0
    text = buf.getvalue()
    assert "family=sot-mram" in text and "l1_16kb_2w/L1" in text
    with pytest.raises(SystemExit):
        port_cli(["sweep", "--dry-run", "--family-param", "delta=40",
                  "--device", "cpu"])
