"""The port's GPU-cache profiling path against the JAX reference (CPU).

``repro_torch.backends.cachesim`` replays op streams through the L1/L2
hierarchy (the set-parallel replay on ``device="cpu"`` runs the
``cache_replay`` kernel's plain version); ``core/orphans.py`` and
``core/pka.py`` are Table 8's and Table 4's analyses; ``workloads/suites.py``
lowers the ``archs``, ``mlperf``, ``polybench`` and ``cnn`` workloads to op
programs.  Integer outputs must be bit-identical to the reference's and
floats equal to 1e-12 relative (the systolic path's contract,
``tests/test_torch_pipeline.py``); capacity fractions exactly.  The
2-layer TinyLlama run is also held against
``tests/fixtures/torch/golden_gpu_cachesim.json``.
"""

import dataclasses
import hashlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.backends import cachesim as ref_cs
from repro.core import ProfileSession as RefSession
from repro.core import orphans as ref_orphans
from repro.core import pka as ref_pka
from repro.core.api import get_backend as ref_backend
from repro.launch.profile import _dry_run as ref_dry_run
from repro.workloads import available_workloads as ref_workloads
from repro.workloads import get_workload as ref_get_workload
from repro_torch.backends import cachesim as port_cs
from repro_torch.core import ProfileSession as PortSession
from repro_torch.core import orphans as port_orphans
from repro_torch.core import pka as port_pka
from repro_torch.core.api import get_backend as port_backend
from repro_torch.kernels.cache_replay import (cache_replay_plain,
                                              cache_replay_sorted)
from repro_torch.launch.profile import main as port_profile_main
from repro_torch.workloads import available_workloads as port_workloads
from repro_torch.workloads import get_workload as port_get_workload

RTOL = 1e-12
GOLDEN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_gpu_cachesim.json"
FIELDS = ("time_cycles", "addr", "is_write", "hit", "subpartition")
SMALL = ref_cs.HierarchyConfig(l1=ref_cs.CacheConfig(size_kb=4, ways=4),
                               l2=ref_cs.CacheConfig(size_kb=32, ways=8))
SMALL_PORT = port_cs.HierarchyConfig(
    l1=port_cs.CacheConfig(size_kb=4, ways=4),
    l2=port_cs.CacheConfig(size_kb=32, ways=8))


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


def assert_traces_equal(got, want):
    for f in FIELDS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.clock_hz, got.block_bits, tuple(got.names)) == \
        (want.clock_hz, want.block_bits, tuple(want.names))


def random_stream(n=1500, seed=7, span=1 << 14):
    rng = np.random.RandomState(seed)
    return (np.arange(n, dtype=np.int64),
            (rng.randint(0, span, n) * 128).astype(np.int64),
            rng.rand(n) < 0.3)


@pytest.mark.parametrize("simulator", ["set_parallel", "scalar"])
@pytest.mark.parametrize("write_allocate", [True, False])
@pytest.mark.parametrize("geometry", ["default", "small"])
def test_simulate_hierarchy_trace_bit_equal(geometry, write_allocate,
                                            simulator):
    """Both levels, the composed L2 stream and the merged trace; the small
    geometry evicts (and writes back) often."""
    t, a, w = random_stream(span=1 << (14 if geometry == "default" else 9))
    base_r = ref_cs.HierarchyConfig() if geometry == "default" else SMALL
    base_p = port_cs.HierarchyConfig() if geometry == "default" \
        else SMALL_PORT
    want = ref_cs.simulate_hierarchy(
        t, a, w, dataclasses.replace(base_r, write_allocate=write_allocate))
    got = port_cs.simulate_hierarchy(
        t, a, w, dataclasses.replace(base_p, write_allocate=write_allocate,
                                     simulator=simulator), device="cpu")
    assert_traces_equal(got, want)
    n_l2 = int((np.asarray(got.subpartition) == 1).sum())
    assert n_l2 > 0 and int(np.asarray(got.hit).sum()) > 0


def test_two_replays_per_hierarchy_and_no_scalar():
    """The set-parallel path replays each level once through the kernel's
    wrapper (on the CPU its plain version) and never the scalar oracle."""
    t, a, w = random_stream()
    plain, scalar = cache_replay_plain.calls, port_cs._simulate_cache.calls
    port_cs.simulate_hierarchy(t, a, w, device="cpu")
    assert cache_replay_plain.calls == plain + 2
    assert port_cs._simulate_cache.calls == scalar
    port_cs.simulate_hierarchy(
        t, a, w, port_cs.HierarchyConfig(simulator="scalar"), device="cpu")
    assert cache_replay_plain.calls == plain + 2
    assert port_cs._simulate_cache.calls == scalar + 2
    assert cache_replay_sorted.launches == 0      # no CUDA launch here


def _programs(name, backend, **params):
    specs = []
    for get in (ref_get_workload, port_get_workload):
        spec = get(name)
        if params:
            spec = spec.with_params(**params)
        specs.append(spec.build(backend))
    return specs


@pytest.fixture(scope="module")
def tinyllama_gpu():
    """The 2-layer TinyLlama gpu run, reference and port (CPU)."""
    (wl_r, cfg_r), (wl_p, cfg_p) = _programs("tinyllama_1_1b", "gpu",
                                             n_layers=2)
    assert cfg_r == cfg_p == {"sample": 8}
    ref = RefSession("gpu")
    want = ref.run(wl_r, **cfg_r)
    port = PortSession("gpu", device="cpu")
    got = port.run(wl_p, **cfg_p)
    return ref, want, port, got


def test_tinyllama_gpu_report_equals_reference(tinyllama_gpu):
    ref, want, port, got = tinyllama_gpu
    assert_reports_equal(got, want)
    assert_traces_equal(port.trace, ref.trace)
    for name in ("L1", "L2"):
        for ret in (1e-6, 1e-5):
            assert port.short_lived_fraction(name, ret) == pytest.approx(
                ref.short_lived_fraction(name, ret), rel=RTOL)


def _digest(t_sub) -> str:
    h = hashlib.sha256()
    for arr, dt in ((t_sub.time_cycles, "<i8"), (t_sub.addr, "<i8"),
                    (t_sub.is_write, "u1"), (t_sub.hit, "u1")):
        h.update(np.ascontiguousarray(np.asarray(arr).astype(dt)).tobytes())
    return h.hexdigest()


def test_golden_file_entries():
    golden = json.loads(GOLDEN.read_text())
    mlperf = set(ref_workloads("mlperf"))
    assert set(golden["entries"]) == \
        {"tinyllama_1_1b@2", "tinyllama_1_1b@22"} | mlperf
    for key, entry in golden["entries"].items():
        subs = entry["subpartitions"]
        assert sorted(subs) == ["L1", "L2"], key
        assert entry["n_events"] == sum(s["n_events"] for s in
                                        subs.values())
        for s in subs.values():
            assert s["n_reads"] + s["n_writes"] == s["n_events"]
            assert len(s["hist"]) == 64 and sum(s["hist"]) == s["live"]
            assert s["live"] + s["orphans"] == s["n_lifetimes"]
            assert len(s["trace_sha256"]) == 64
    big = golden["entries"]["tinyllama_1_1b@22"]["subpartitions"]
    assert big["L1"]["n_events"] == 5_883_923
    assert big["L2"]["n_events"] == 4_706_102


def test_port_reproduces_two_layer_golden_entry(tinyllama_gpu):
    from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                       integer_edges)
    _, _, port, got = tinyllama_gpu
    want = json.loads(GOLDEN.read_text())["entries"]["tinyllama_1_1b@2"]
    trace = port.trace
    assert trace.n_events == want["n_events"]
    ie = integer_edges(default_edges())
    for sub, name in enumerate(trace.names):
        g, rep = want["subpartitions"][name], got["subpartitions"][name]
        t_sub = trace.select(sub)
        n_reads, n_writes = t_sub.counts()
        assert (t_sub.n_events, n_reads, n_writes,
                int(np.asarray(t_sub.hit).sum())) == \
            (g["n_events"], g["n_reads"], g["n_writes"], g["n_hits"])
        assert _digest(t_sub) == g["trace_sha256"], name
        for key in ("n_lifetimes", "unique_addrs"):
            assert rep[key] == g[key], (name, key)
        host = port.subpartition_stats(name)[1].numpy()
        lt = host.lifetime_cycles[~host.orphan]
        bins = np.searchsorted(ie, lt, side="right") - 1
        assert np.bincount(bins, minlength=64).tolist() == g["hist"]
        assert (len(lt), int(host.orphan.sum()), int(lt.sum()),
                int(lt.max())) == \
            (g["live"], g["orphans"], g["sum_lt"], g["max_lt"])
        assert rep["composition"]["devices"] == g["composition_devices"]
        assert rep["composition"]["capacity_fractions"] == \
            g["capacity_fractions"]
        assert port.short_lived_fraction(name, 1e-6) == pytest.approx(
            g["short_lived_fraction_1us"], rel=RTOL)


@pytest.mark.parametrize("backend", ["gpu", "opstream"])
def test_polybench_2mm_reports_equal_and_chunked(backend):
    (wl_r, cfg_r), (wl_p, cfg_p) = _programs("polybench-2mm", backend)
    assert cfg_r == cfg_p == {"sample": 1}
    want = RefSession(backend).run(wl_r, **cfg_r)
    got = PortSession(backend, device="cpu").run(wl_p, **cfg_p)
    assert_reports_equal(got, want)
    assert len(got["kernels"]) == 2
    chunked = PortSession(backend, device="cpu").run(
        wl_p, chunk_events=5000, **cfg_p)
    assert_reports_equal(chunked, got)


def test_opstream_tinyllama_report_equal():
    (wl_r, cfg_r), (wl_p, cfg_p) = _programs("tinyllama_1_1b", "opstream",
                                             n_layers=2)
    assert_reports_equal(PortSession("opstream", device="cpu").run(
        wl_p, **cfg_p), RefSession("opstream").run(wl_r, **cfg_r))


def test_chunked_gpu_trace_equals_monolithic():
    t, a, w = random_stream(n=3000, seed=3, span=1 << 10)
    backend = port_backend("gpu")
    mono = backend.run((t, a, w), device="cpu", config=SMALL_PORT)
    chunks = list(backend.run((t, a, w), device="cpu", config=SMALL_PORT,
                              chunk_events=700).chunks)
    assert len(chunks) == math.ceil(mono.trace.n_events / 700)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(c, f) for c in chunks]),
            getattr(mono.trace, f))
    want = PortSession.from_trace(mono.trace, mode="cache",
                                  device="cpu").analyze().compose().report()
    got = PortSession.from_chunks(iter(chunks), mode="cache",
                                  device="cpu").analyze().compose().report()
    assert_reports_equal(got, want)


@pytest.mark.parametrize("mode", ["cache", "scratchpad"])
def test_orphans_and_policy_ablation_equal(mode):
    t, a, w = random_stream(n=2500, seed=11, span=1 << 9)
    trace_r = ref_cs.simulate_hierarchy(t, a, w, SMALL)
    trace_p = port_cs.simulate_hierarchy(t, a, w, SMALL_PORT, device="cpu")
    for sub in (0, 1, 5):               # 5: an empty subpartition
        for wa in (True, False):
            got = port_orphans.orphaned_access_fraction(
                trace_p, sub, mode=mode, write_allocate=wa, device="cpu")
            want = ref_orphans.orphaned_access_fraction(
                trace_r, sub, mode=mode, write_allocate=wa)
            assert got == want, (sub, wa)
    for sub in (0, 1):
        got = port_orphans.policy_ablation(trace_p, sub, device="cpu")
        assert got == ref_orphans.policy_ablation(trace_r, sub)
        assert 0.0 < got["write_allocate"] < 1.0


@pytest.mark.parametrize("k,tol", [(None, 0.05), (None, 0.2), (3, 0.05),
                                   (1, 0.05)])
def test_select_kernels_equal(k, tol):
    """PKA on the per-kernel counters of a real op stream (Table 4)."""
    (wl_r, cfg_r), _ = _programs("bert-base-uncased", "opstream")
    kernels = ref_backend("opstream").run(wl_r, **cfg_r).kernels
    feats = np.array([[kk["reads"], kk["writes"], kk["flops"],
                       kk["cycles"]] for kk in kernels], np.float64)
    runtimes = np.array([kk["cycles"] for kk in kernels], np.float64)
    target = np.array([kk["writes"] for kk in kernels], np.float64)
    got = port_pka.select_kernels(feats, runtimes, target, k=k, tol=tol)
    want = ref_pka.select_kernels(feats, runtimes, target, k=k, tol=tol)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f.name)
    assert port_pka.weighted_estimate(got, target) == \
        ref_pka.weighted_estimate(want, target)


def _cache_workloads():
    return sorted(n for n in port_workloads()
                  if port_get_workload(n).supports("cachesim"))


def test_same_workloads_lower_to_the_cache_backends():
    """All of the reference's, the ten archs included: the port has every
    config module the reference has."""
    from repro_torch.configs.base import ARCH_IDS
    want = sorted(n for n in ref_workloads()
                  if ref_get_workload(n).supports("cachesim")
                  and (ref_get_workload(n).suite != "archs"
                       or n in ARCH_IDS))
    assert _cache_workloads() == want
    assert len(want) == 23


@pytest.mark.parametrize("name", _cache_workloads())
def test_cache_lowerings_bit_equal(name):
    """Every workload with a cachesim/opstream lowering: same op stream,
    same per-kernel counters, same run kwargs; the same content hash
    except where the archs params differ (ROADMAP D5)."""
    from repro.backends.opstream import StreamBuilder as RefBuilder
    from repro_torch.backends.opstream import StreamBuilder as PortBuilder
    params = {"seq": 32} if ref_get_workload(name).suite == "archs" else {}
    for backend in ("cachesim", "opstream", "gpu"):
        (wl_r, cfg_r), (wl_p, cfg_p) = _programs(name, backend, **params)
        assert cfg_p == cfg_r
        sb_r, sb_p = RefBuilder(**cfg_r), PortBuilder(**cfg_p)
        wl_r(sb_r)
        wl_p(sb_p)
        for g, w in zip(sb_p.finish(), sb_r.finish()):
            np.testing.assert_array_equal(g, w)
        assert [k.__dict__ for k in sb_p.kernels] == \
            [k.__dict__ for k in sb_r.kernels]
    spec_r, spec_p = ref_get_workload(name), port_get_workload(name)
    if spec_r.suite == "archs":
        assert spec_p.content_hash() != spec_r.content_hash()
    else:
        assert spec_p.content_hash() == spec_r.content_hash()


def test_simulator_selection_and_config_errors():
    stream = random_stream(n=600, seed=11, span=2048)
    rep_sp = PortSession("gpu", device="cpu").run(stream,
                                                  simulator="set_parallel")
    rep_sc = PortSession("gpu", device="cpu").run(stream,
                                                  simulator="scalar")
    assert rep_sp == rep_sc
    assert_reports_equal(rep_sp, RefSession("gpu").run(stream))
    backend = port_backend("cachesim")
    with pytest.raises(ValueError, match="not both"):
        backend.run(stream, config=port_cs.HierarchyConfig(),
                    simulator="scalar", device="cpu")
    with pytest.raises(ValueError, match="unknown simulator"):
        backend.run(stream, simulator="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown simulator"):
        port_cs._simulate_level(np.zeros(1, np.int64), np.zeros(1, bool),
                                port_cs.CacheConfig(), True, "bogus")


def test_cache_path_needs_a_device_without_cuda(capsys):
    """No CUDA device: the gpu session, the backend and the CLI raise
    unless the CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    stream = random_stream(n=50)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortSession("gpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_backend("gpu").run(stream)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cs.simulate_hierarchy(*stream)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_profile_main(["--backend", "gpu", "--dry-run"])
    port_profile_main(["--backend", "gpu", "--dry-run", "--device", "cpu"])
    assert "dry-run ok: backend=cachesim" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["gpu", "opstream"])
def test_dry_run_equals_reference(backend, capsys):
    got = port_profile_main(["--backend", backend, "--dry-run", "--device",
                             "cpu"])
    assert_reports_equal(got, ref_dry_run(backend))
    assert f"backend={'cachesim' if backend == 'gpu' else backend}" in \
        capsys.readouterr().out


def test_cli_gpu_report_and_profile_gpu(tmp_path, capsys):
    """``python -m repro_torch profile --backend gpu`` on a registry
    workload (monolithic and ``--chunk-events``) and the ``profile_gpu``
    helper against the reference's."""
    from repro.configs.base import get_config as ref_config
    from repro.launch.profile import profile_gpu as ref_profile_gpu
    from repro_torch.configs.base import get_config as port_config
    from repro_torch.launch.profile import profile_gpu
    out, out_s = tmp_path / "r.json", tmp_path / "s.json"
    args = ["--arch", "polybench-3mm", "--backend", "gpu", "--device", "cpu"]
    port_profile_main(args + ["--out", str(out)])
    port_profile_main(args + ["--chunk-events", "4000", "--out", str(out_s)])
    wl, cfg = ref_get_workload("polybench-3mm").build("gpu")
    want = json.loads(json.dumps(RefSession("gpu").run(wl, **cfg)))
    assert_reports_equal(json.loads(out.read_text()), want)
    assert_reports_equal(json.loads(out_s.read_text()), want)
    got = profile_gpu(port_config("mamba2_130m"), 16, None, device="cpu")
    want = ref_profile_gpu(ref_config("mamba2_130m"), 16, None)
    assert_reports_equal(got, want)
    assert "short-lived" in capsys.readouterr().out
