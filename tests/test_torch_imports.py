"""Import and device rules of the PyTorch port.

The port imports ``torch`` and ``numpy``, never ``jax`` and nothing of the
``repro`` reference package; its planning modules and command line import
neither torch nor numpy (the package root imports nothing); its entry
points default to the CUDA device and raise without one; a kernel wrapper
handed a CPU tensor runs the plain version and never asks for a compiler.
"""

import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.device import default_device, resolve_device

SRC = Path(__file__).resolve().parents[1] / "src"


def _submodules():
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return sorted(names)


def test_port_imports_neither_jax_nor_reference():
    mods = _submodules()
    for needed in ("repro_torch.core.api", "repro_torch.core.lifetime",
                   "repro_torch.kernels.lifetime_scan.kernel",
                   "repro_torch.kernels.lifetime_scan.ops",
                   "repro_torch.kernels.lifetime_scan.ref",
                   "repro_torch.kernels._build", "repro_torch.convert",
                   "repro_torch.backends.systolic",
                   "repro_torch.compose.engine",
                   "repro_torch.launch.profile", "repro_torch.__main__",
                   "repro_torch.configs.zamba2_2_7b",
                   "repro_torch.configs.mamba2_130m",
                   "repro_torch.kernels.flash_attention.kernel",
                   "repro_torch.kernels.flash_attention.ops",
                   "repro_torch.kernels.flash_attention.ref",
                   "repro_torch.kernels.ssd_scan.kernel",
                   "repro_torch.kernels.ssd_scan.ops",
                   "repro_torch.kernels.ssd_scan.ref",
                   "repro_torch.models.layers", "repro_torch.models.mamba2",
                   "repro_torch.models.hybrid",
                   "repro_torch.models.transformer",
                   "repro_torch.models.api", "repro_torch.launch.serve",
                   "repro_torch.kernels.flash_attention.kernel_bwd",
                   "repro_torch.optim", "repro_torch.optim.adamw",
                   "repro_torch.optim.compression", "repro_torch.data",
                   "repro_torch.data.pipeline", "repro_torch.checkpoint",
                   "repro_torch.checkpoint.manager", "repro_torch.runtime",
                   "repro_torch.runtime.fault_tolerance",
                   "repro_torch.launch.steps", "repro_torch.launch.train",
                   "repro_torch.backends.opstream",
                   "repro_torch.backends.cachesim",
                   "repro_torch.kernels.cache_replay",
                   "repro_torch.kernels.cache_replay.kernel",
                   "repro_torch.kernels.cache_replay.ops",
                   "repro_torch.core.orphans", "repro_torch.core.pka",
                   "repro_torch.kernels.compose_policy",
                   "repro_torch.kernels.compose_policy.kernel",
                   "repro_torch.kernels.compose_policy.ops",
                   "repro_torch.compose.executor",
                   "repro_torch.compose.torch_engine",
                   "repro_torch.sweep", "repro_torch.sweep.grid",
                   "repro_torch.sweep.pareto", "repro_torch.sweep.runner",
                   "repro_torch.launch.sweep", "repro_torch.analysis",
                   "repro_torch.analysis.atomic", "repro_torch.analysis.cli",
                   "repro_torch.analysis.context",
                   "repro_torch.analysis.dtypes",
                   "repro_torch.analysis.findings",
                   "repro_torch.analysis.imports",
                   "repro_torch.analysis.registry",
                   "repro_torch.analysis.schema"):
        assert needed in mods
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods:\n"
        "    if m != 'repro_torch.__main__':\n"
        "        importlib.import_module(m)\n"
        "import repro_torch.__main__\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.') or m == 'ml_dtypes')\n"
        "print(json.dumps({'bad': bad, 'torch': 'torch' in sys.modules}))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"bad": [], "torch": True}


def test_sources_never_name_the_reference_package_in_an_import():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not s.startswith(("import jax", "from jax",
                                         "import repro.", "from repro.",
                                         "import repro ", "from repro ",
                                         "import ml_dtypes",
                                         "from ml_dtypes")), \
                    f"{path}: {s}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch):
    from repro_torch.core import ProfileSession, extract_lifetimes
    from repro_torch.core.trace import make_trace
    from repro_torch.kernels.lifetime_scan.ops import lifetime_histogram
    from repro_torch.launch.profile import main as profile_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = np.arange(4)
    w = np.array([1, 0, 1, 0], bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProfileSession("systolic")
    with pytest.raises(RuntimeError, match="CUDA"):
        ProfileSession.from_trace(make_trace(t, t, w))
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_lifetimes(t, t, w, ~w)
    with pytest.raises(RuntimeError, match="CUDA"):
        lifetime_histogram(t, t, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_main(["--backend", "systolic", "--dry-run"])


def test_serving_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.api import build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("zamba2_2_7b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "zamba2_2_7b", "--smoke"])
    assert build(cfg, device="cpu").device == torch.device("cpu")


def _small_kernel_inputs():
    g = torch.Generator().manual_seed(0)
    fa = [torch.randn(1, 2, 5, 16, generator=g) for _ in range(3)]
    x = torch.randn(1, 8, 2, 4, generator=g)
    ssd = [x, torch.rand(1, 8, 2, generator=g), -torch.rand(2, generator=g),
           torch.randn(1, 8, 3, generator=g), torch.randn(1, 8, 3,
                                                          generator=g),
           torch.ones(2)]
    return fa, ssd


def test_new_kernel_wrappers_never_fall_back_from_a_device(monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device it does not run on raises, and without a compiler the launch
    raises too, rather than running the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    fa, ssd = _small_kernel_inputs()
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa_k.flash_attention_bhsd(*(t.to("meta") for t in fa))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd_k.ssd_scan_chunked(*(t.to("meta") for t in ssd), chunk=4)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: Path("/nonexistent") / f"{name}.so")
    for mod in (fa_k, ssd_k):
        mod._launcher.cache_clear()
        _build.load_library.cache_clear()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            mod._launcher()
        mod._launcher.cache_clear()


def test_backward_kernel_wrappers_never_fall_back(monkeypatch):
    """The flash-attention backward passes: a CPU tensor runs the plain
    version without asking for a compiler; any other device raises, and
    without a compiler the launch raises too."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd
    fa, _ = _small_kernel_inputs()
    o, lse = fa_k.flash_attention_plain(*fa, causal=True)

    def no_compiler(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    with monkeypatch.context() as m:
        m.setattr(_build, "load_library", no_compiler)
        bwd._launchers.cache_clear()
        before = (bwd.flash_attention_bwd_dq.launches,
                  bwd.flash_attention_bwd_dkv.launches)
        got = bwd.flash_attention_bwd_bhsd(*fa, o, lse, fa[0])
        want = bwd.flash_attention_bwd_plain(*fa, o, lse, fa[0])
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert (bwd.flash_attention_bwd_dq.launches,
                bwd.flash_attention_bwd_dkv.launches) == before
    meta = [t.to("meta") for t in (*fa, o, lse)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        bwd.flash_attention_bwd_bhsd(*meta[:5], meta[0])
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: Path("/nonexistent") / f"{name}.so")
    bwd._launchers.cache_clear()
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bwd._launchers()
    bwd._launchers.cache_clear()


def test_cpu_tensor_takes_plain_version_without_a_compiler(monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.kernels.lifetime_scan import kernel

    def no_compiler(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_compiler)
    monkeypatch.setattr(_build, "build", no_compiler)
    monkeypatch.setattr(_build, "find_nvcc", no_compiler)
    kernel._launcher.cache_clear()
    before = kernel.lifetime_scan_sorted.launches
    t = torch.tensor([0, 5, 9, 2])
    a = torch.tensor([1, 1, 1, 2])
    w = torch.tensor([True, False, False, True])
    e = torch.tensor([0, 4, 100])
    hist, stats = kernel.lifetime_scan_sorted(t, a, w, e)
    h_p, s_p = kernel.lifetime_scan_plain(t, a, w, e)
    assert hist.tolist() == h_p.tolist() == [0, 1]
    assert stats.tolist() == s_p.tolist() == [1, 1, 9, 9, 2, 2, 0, 0]
    assert kernel.lifetime_scan_sorted.launches == before   # no launch

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    fa_k._launcher.cache_clear()
    ssd_k._launcher.cache_clear()
    fa, ssd = _small_kernel_inputs()
    before = fa_k.flash_attention_bhsd.launches, \
        ssd_k.ssd_scan_chunked.launches
    o, lse = fa_k.flash_attention_bhsd(*fa, causal=True)
    o_p, lse_p = fa_k.flash_attention_plain(*fa, causal=True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    y = ssd_k.ssd_scan_chunked(*ssd, chunk=4)
    assert torch.equal(y, ssd_k.ssd_scan_plain(*ssd, chunk=4))
    assert (fa_k.flash_attention_bhsd.launches,
            ssd_k.ssd_scan_chunked.launches) == before


def test_cache_replay_wrapper_never_falls_back(monkeypatch):
    """B6: a CPU tensor runs the plain version without asking for a
    compiler and launches nothing; another device raises; without a
    compiler the launch raises; the cache backend resolves no device to
    the card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.cache_replay import kernel

    def no_compiler(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    packed = torch.tensor([6, 7, 2, 6], dtype=torch.int64)
    offsets = torch.tensor([0, 2], dtype=torch.int64)
    counts = torch.tensor([2, 2], dtype=torch.int64)
    with monkeypatch.context() as m:
        m.setattr(_build, "load_library", no_compiler)
        kernel._launcher.cache_clear()
        before = kernel.cache_replay_sorted.launches
        got = kernel.cache_replay_sorted(packed, offsets, counts, 2, True)
        assert got.tolist() == kernel.cache_replay_plain(
            packed, offsets, counts, 2, True).tolist() == [2, 1, 2, 2]
        assert kernel.cache_replay_sorted.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel.cache_replay_sorted(*(t.to("meta") for t in
                                     (packed, offsets, counts)), 2, True)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: Path("/nonexistent") / f"{name}.so")
    kernel._launcher.cache_clear()
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel._launcher()
    kernel._launcher.cache_clear()


def test_build_module_names_its_library_by_source_hash():
    from repro_torch.kernels import _build
    p = _build.library_path("lifetime_scan")
    assert p.parent == SRC.parent / "build" / "repro_torch_kernels"
    assert p.suffix == ".so" and p.name.startswith("lifetime_scan-")
    assert p == _build.library_path("lifetime_scan")        # deterministic
    entries = {"lifetime_scan": ["lifetime_scan"],
               "flash_attention_fwd": ["flash_attention_fwd"],
               "ssd_scan": ["ssd_scan"],
               "flash_attention_bwd": ["flash_attention_bwd_dq",
                                       "flash_attention_bwd_dkv"],
               "cache_replay": ["cache_replay"],
               "compose_policy": ["compose_policy_rf",
                                  "compose_policy_retention",
                                  "compose_policy_ra_candidates",
                                  "compose_policy_ra_decide"]}
    for name, fns in entries.items():
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for fn in fns:
            assert f'extern "C" int {fn}_launch' in src
        assert _build.library_path(name).name.startswith(f"{name}-")
    ignored = (SRC.parent / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_build_without_a_compiler_raises(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


# ---------------------------------------------------------------------------
# the package root imports nothing: planning runs without torch or numpy
# ---------------------------------------------------------------------------

#: the package root as it stood before it was made lazy: one module-level
#: import of ``repro_torch.device``, which imports torch
EAGER_ROOT = ('"""GainSight in PyTorch/CUDA."""\n\n'
              "from repro_torch.device import default_device, "
              "resolve_device\n\n"
              '__all__ = ["default_device", "resolve_device"]\n')

PLANNING = ("workloads", "devices", "cluster", "analysis",
            "launch.campaign", "compose", "__main__")


def test_an_eager_package_root_breaks_every_planning_contract(tmp_path):
    from repro_torch.analysis import AnalysisContext, ImportPurityRule
    shutil.copytree(SRC / "repro_torch", tmp_path / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    (tmp_path / "repro_torch" / "__init__.py").write_text(EAGER_ROOT)
    findings = ImportPurityRule().run(AnalysisContext(str(tmp_path)))
    assert sorted(f.message.split()[0] for f in findings) == sorted(
        f"repro_torch.{m}" for m in PLANNING)
    for f in findings:
        assert (f.path, f.line) == ("repro_torch/device.py", 10)
        assert "-> repro_torch -> repro_torch.device -> torch)" in f.message


def test_the_real_package_root_breaks_no_import_contract():
    from repro_torch.analysis import (AnalysisContext, ImportPurityRule,
                                      default_root)
    assert ImportPurityRule().run(AnalysisContext(default_root())) == []


def _run_blocked(blocked, package, *argv, timeout=240):
    """``python -m <package> <argv>`` with ``blocked`` modules unimportable
    (``sys.modules[name] = None``), from the repo's source root."""
    code = ("import runpy, sys\n"
            f"for name in {list(blocked)!r}:\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = [{package!r}, *{list(argv)!r}]\n"
            f"runpy.run_module({package!r}, run_name='__main__', "
            "alter_sys=True)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("cmd", ("devices", "workloads", "check"))
def test_planning_commands_run_without_torch_or_numpy(cmd):
    out = _run_blocked(("torch", "numpy"), "repro_torch", cmd)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip()
    if cmd == "check":
        assert "repro_torch check: clean (5 rule(s)" in out.stdout


def _listing_fields(text: str) -> list:
    """Each family's describe() line (name, version, aliases, parameter
    names) and each parameter's name and default; the help text of a
    parameter is worded differently in the two packages."""
    out = []
    for line in text.splitlines():
        if not line.startswith(" "):
            out.append(line)
        elif line.lstrip().startswith("--family-param "):
            out.append(line.split("  ")[2])
    return out


def test_devices_listing_matches_the_reference_with_frameworks_blocked():
    mine = _run_blocked(("torch", "numpy"), "repro_torch", "devices")
    theirs = _run_blocked(("jax", "numpy"), "repro", "devices")
    assert mine.returncode == theirs.returncode == 0, \
        (mine.stderr[-2000:], theirs.stderr[-2000:])
    fields = _listing_fields(mine.stdout)
    assert fields == _listing_fields(theirs.stdout)
    assert any("--family-param mixes=... (default 0:1)" in f for f in fields)


def test_campaign_dry_run_without_torch():
    out = _run_blocked(("torch",), "repro_torch", "campaign", "--dry-run")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "campaign dry-run ok" in out.stdout


def test_planning_imports_leave_torch_and_numpy_out():
    code = (
        "import importlib, json, sys\n"
        f"mods = {[f'repro_torch.{m}' for m in PLANNING if m != 'compose']!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "seen = {'planning': sorted(n for n in ('torch', 'numpy') "
        "if n in sys.modules)}\n"
        "import repro_torch.compose\n"
        "seen['compose'] = 'torch' in sys.modules\n"
        "import repro_torch\n"
        "seen['device'] = str(repro_torch.resolve_device('cpu'))\n"
        "seen['default'] = repro_torch.default_device.__module__\n"
        "print(json.dumps(seen))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "planning": [], "compose": False, "device": "cpu",
        "default": "repro_torch.device"}
