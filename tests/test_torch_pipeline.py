"""The ported slice as a whole against the JAX reference, on the CPU.

``ProfileSession`` (profile -> analyze -> compose -> report) runs in both
packages on the same workloads.  Report dicts must agree: integers,
strings and capacity fractions exactly, other floats to 1e-12 relative
(the tolerance the reference states for its own monolithic-vs-streaming
paths, whose float sums run in a different order).
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.backends import systolic as ref_systolic
from repro.core import ProfileSession as RefSession
from repro.core import TraceAccumulator as RefAccumulator
from repro.core import chunk_trace as ref_chunk_trace
from repro.core import make_trace as ref_make_trace
from repro.devices import get_device_family as ref_family
from repro.workloads import get_workload as ref_get_workload
from repro_torch.__main__ import main as port_cli
from repro_torch.backends import systolic as port_systolic
from repro_torch.convert import device_from_fields, trace_from_arrays
from repro_torch.core import ProfileSession as PortSession
from repro_torch.core import TraceAccumulator as PortAccumulator
from repro_torch.core import chunk_trace as port_chunk_trace
from repro_torch.devices import get_device_family as port_family
from repro_torch.launch.profile import main as port_profile_main
from repro_torch.workloads import get_workload as port_get_workload

RTOL = 1e-12
POLICIES = ["refresh-free", "refresh-aware", "bank-quantized",
            "bank-quantized:refresh-aware@8"]
LAYERS = [("a", 48, 40, 36), ("b", 24, 64, 32), ("c", 16, 16, 80)]


def assert_reports_equal(got, want, path="report"):
    """Ints, bools, strings and capacity fractions exactly; floats to RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            if k in ("capacity_fractions", "unquantized_fractions"):
                assert got[k] == want[k], f"{path}.{k}"
            else:
                assert_reports_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_reports_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        if math.isfinite(want):
            assert got == pytest.approx(want, rel=RTOL, abs=0.0), path
        else:
            assert got == want or (math.isnan(got) and math.isnan(want)), \
                path
    else:
        assert type(got) is type(want) and got == want, path


def _layers(mod):
    return [mod.GemmLayer(*spec) for spec in LAYERS]


@pytest.mark.parametrize("dataflow", ["ws", "is", "os"])
def test_systolic_trace_bit_identical(dataflow):
    """The host-side backend is the same code: same trace, same counters."""
    cfg = dict(rows=16, cols=16, dataflow=dataflow)
    tr_r, ks_r = ref_systolic.simulate(
        _layers(ref_systolic), ref_systolic.SystolicConfig(**cfg))
    tr_p, ks_p = port_systolic.simulate(
        _layers(port_systolic), port_systolic.SystolicConfig(**cfg))
    for f in ("time_cycles", "addr", "is_write", "hit", "subpartition"):
        got, want = getattr(tr_p, f), getattr(tr_r, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tr_p.clock_hz, tr_p.block_bits, tr_p.names) == \
        (tr_r.clock_hz, tr_r.block_bits, tr_r.names)
    assert ks_p == ks_r


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dataflow", ["ws", "is", "os"])
def test_session_report_equals_reference(dataflow, policy):
    cfg = dict(rows=16, cols=16, dataflow=dataflow, policy=policy)
    want = RefSession("systolic").run(_layers(ref_systolic), **cfg)
    got = PortSession("systolic", device="cpu").run(
        _layers(port_systolic), **cfg)
    assert_reports_equal(got, want)
    for sub in want["subpartitions"].values():
        assert sub["composition"]["policy"].startswith(policy.split("@")[0])


@pytest.mark.parametrize("policy", ["refresh-free", "refresh-aware"])
def test_streaming_equals_monolithic_and_reference(policy):
    cfg = dict(rows=16, cols=16, policy=policy)
    mono = PortSession("systolic", device="cpu").run(
        _layers(port_systolic), **cfg)
    stream = PortSession("systolic", device="cpu").run(
        _layers(port_systolic), chunk_events=257, **cfg)
    want = RefSession("systolic").run(
        _layers(ref_systolic), chunk_events=257, **cfg)
    assert_reports_equal(stream, want)
    assert_reports_equal(stream, mono)


@pytest.mark.parametrize("mode,write_allocate", [
    ("scratchpad", True), ("cache", True), ("cache", False)])
def test_accumulator_equals_reference(mode, write_allocate):
    rng = np.random.RandomState(21)
    n = 1500
    t = np.sort(rng.randint(0, 20_000, n)).astype(np.int64) + 2 ** 33
    a = rng.randint(0, 41, n).astype(np.int64) + 2 ** 31
    w = rng.rand(n) < 0.4
    h = rng.rand(n) < 0.7
    s = rng.randint(0, 2, n)
    names = ("L1", "L2")
    accs = []
    for Acc, chunker, trace in (
            (RefAccumulator, ref_chunk_trace,
             ref_make_trace(t, a, w, h, s, names=names)),
            (PortAccumulator, port_chunk_trace,
             trace_from_arrays(t, a, w, h, s, names=names))):
        acc = Acc(mode=mode, write_allocate=write_allocate)
        for chunk in chunker(trace, 97):
            acc.update(chunk)
        accs.append(acc)
    for sub in (0, 1):
        st_r, raw_r = accs[0].stats(sub)
        st_p, raw_p = accs[1].stats(sub)
        for f in ("lifetime_cycles", "n_reads", "start_cycles", "addr",
                  "valid", "orphan", "n_events"):
            np.testing.assert_array_equal(getattr(raw_p, f),
                                          getattr(raw_r, f), err_msg=f)
        assert_reports_equal(
            {k: v for k, v in dataclasses.asdict(st_p).items()
             if not isinstance(v, np.ndarray)},
            {k: v for k, v in dataclasses.asdict(st_r).items()
             if not isinstance(v, np.ndarray)})
        # the streaming fold agrees with the port's own monolithic path
        sess = PortSession.from_trace(
            trace_from_arrays(t, a, w, h, s, names=names), mode=mode,
            device="cpu").analyze(write_allocate=write_allocate)
        st_m, _ = sess.subpartition_stats(names[sub])
        assert (st_m.n_reads, st_m.n_writes, st_m.n_unique_addrs) == \
            (st_p.n_reads, st_p.n_writes, st_p.n_unique_addrs)
        assert sorted(st_m.lifetimes_s.tolist()) == \
            sorted(st_p.lifetimes_s.tolist())
        for ret in (1e-6, 1e-5):
            assert sess.short_lived_fraction(names[sub], ret) == \
                pytest.approx(accs[1].short_lived_fraction(sub, ret),
                              rel=RTOL)


def test_registry_workload_tinyllama_equals_reference():
    """The registry's tinyllama_1_1b lowering at full widths, seq=16."""
    spec_r = ref_get_workload("tinyllama_1_1b").with_params(seq=16)
    spec_p = port_get_workload("tinyllama_1_1b").with_params(seq=16)
    wl_r, cfg_r = spec_r.build("systolic")
    wl_p, cfg_p = spec_p.build("systolic")
    assert cfg_r == cfg_p == {}
    assert [dataclasses.astuple(g) for g in wl_p] == \
        [dataclasses.astuple(g) for g in wl_r]
    assert len(wl_p) == 12 and wl_p[0].N == 2048 + 2 * 4 * 64
    run = dict(rows=128, cols=128, dataflow="ws")
    want = RefSession("systolic").run(wl_r, **run)
    port = PortSession("systolic", device="cpu")
    got = port.run(wl_p, **run)
    assert_reports_equal(got, want)
    ref = RefSession("systolic")
    ref.profile(wl_r, **run).analyze()
    for name in want["subpartitions"]:
        for ret in (1e-6, 1e-5):
            assert port.short_lived_fraction(name, ret) == \
                ref.short_lived_fraction(name, ret)


@pytest.mark.parametrize("family,params", [
    ("sram-gaincell-default", {}), ("sot-mram", {}),
    ("sot-mram", {"delta": 14.0, "write_pulse_ns": 0.5}),
    ("gaincell", {"mixes": (0.25, 0.75), "retention_scale": 2.0})])
def test_device_families_and_compositions_equal(family, params):
    devs_r = ref_family(family).build(**params)
    devs_p = port_family(family).build(**params)
    carried = tuple(device_from_fields(dataclasses.asdict(d))
                    for d in devs_r)
    assert carried == devs_p
    for d_r, d_p in zip(devs_r, devs_p):
        for f_w in (0.0, 1e6, 5e8):
            assert d_p.retention_at(f_w) == d_r.retention_at(f_w)
    for policy in ("refresh-free", "refresh-aware"):
        want = RefSession("systolic", devices=devs_r).run(
            _layers(ref_systolic), rows=16, cols=16, policy=policy)
        got = PortSession("systolic", devices=devs_p, device="cpu").run(
            _layers(port_systolic), rows=16, cols=16, policy=policy)
        assert_reports_equal(got, want)


def test_what_is_not_ported_says_so():
    sess = PortSession("systolic", device="cpu")
    sess.profile(_layers(port_systolic), rows=16, cols=16)
    with pytest.raises(ValueError, match="numpy"):
        sess.compose(engine="jax")
    with pytest.raises(ValueError, match="no lowering for backend"):
        port_get_workload("tinyllama_1_1b").build("tpu")
    with pytest.raises(ValueError, match="unknown backend"):
        PortSession("tpu_graph", device="cpu")
    # campaign and worker are ported (tests/test_torch_campaign.py); the
    # contract analyzer is not
    assert port_cli(["check"]) == 2


def test_cli_dry_run_and_listings(capsys, tmp_path):
    assert port_cli(["profile", "--backend", "systolic", "--dry-run",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dry-run ok: backend=systolic" in out and "device=cpu" in out
    csv = tmp_path / "comp.csv"
    report = port_profile_main(
        ["--backend", "systolic", "--dry-run", "--device", "cpu",
         "--policy", "bank-quantized", "--csv", str(csv)])
    from repro.launch.profile import _dry_run as ref_dry_run
    assert_reports_equal(report, ref_dry_run("systolic",
                                             policy="bank-quantized"))
    assert csv.read_text().splitlines()[0].startswith("subpartition,policy")
    for cmd, needle in (("workloads", "tinyllama_1_1b"),
                        ("backends", "systolic"), ("devices", "sot-mram")):
        assert port_cli([cmd]) == 0
        assert needle in capsys.readouterr().out


def test_cli_profile_writes_same_report_as_reference(tmp_path, capsys):
    """``python -m repro_torch profile`` on a registry workload, monolithic
    and ``--chunk-events``: the JSON reports agree with the reference
    session's."""
    import json
    args = ["--arch", "polybench-2mm", "--backend", "systolic", "--pe",
            "32", "--dataflow", "os", "--device", "cpu"]
    out = tmp_path / "r.json"
    port_profile_main(args + ["--out", str(out)])
    wl, cfg = ref_get_workload("polybench-2mm").build("systolic")
    want = RefSession("systolic").run(wl, rows=32, cols=32, dataflow="os",
                                      **cfg)
    assert_reports_equal(json.loads(out.read_text()),
                         json.loads(json.dumps(want)))
    out_s = tmp_path / "s.json"
    port_profile_main(args + ["--chunk-events", "1000", "--out",
                              str(out_s)])
    assert_reports_equal(json.loads(out_s.read_text()),
                         json.loads(out.read_text()))
    assert "short-lived" in capsys.readouterr().out
