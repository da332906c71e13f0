"""Import and device rules of the PyTorch port.

The port imports ``torch`` and ``numpy``, never ``jax`` and nothing of the
``repro`` reference package; its entry points default to the CUDA device
and raise without one; a kernel wrapper handed a CPU tensor runs the plain
version and never asks for a compiler.
"""

import json
import os
import pkgutil
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
                   "repro_torch.launch.profile", "repro_torch.__main__"):
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
        "m.startswith('repro.'))\n"
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
                                         "import repro ", "from repro ")), \
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


def test_build_module_names_its_library_by_source_hash():
    from repro_torch.kernels import _build
    p = _build.library_path("lifetime_scan")
    assert p.parent == SRC.parent / "build" / "repro_torch_kernels"
    assert p.suffix == ".so" and p.name.startswith("lifetime_scan-")
    assert p == _build.library_path("lifetime_scan")        # deterministic
    src = (_build.CSRC_DIR / "lifetime_scan.cu").read_text()
    assert 'extern "C" int lifetime_scan_launch' in src
    ignored = (SRC.parent / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_build_without_a_compiler_raises(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
