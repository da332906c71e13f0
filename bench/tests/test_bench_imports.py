"""No module that a run loads has the top-level name of JAX, its
libraries or the JAX package (names compared whole: the port's own
package, whose name begins with the JAX package's, passes)."""

from __future__ import annotations

import subprocess
import sys

from bench import harness
from bench.tests.conftest import ROOT

LOADS = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import bench.run, bench.calibrate, bench.faults, bench.timeline
from bench import harness, program
from bench.kinds import serve_closed, train_steps
from bench.reference import zamba2, moe_lm, plain, weights
import repro_torch.launch.serve, repro_torch.launch.steps
import repro_torch.models.hybrid, repro_torch.models.transformer
for name in harness.BENCH.joinpath("metrics").glob("*.py"):
    if not name.stem.startswith("_"):
        harness.reader(name.stem)
print("found=" + ",".join(harness.forbidden_modules()))
"""


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                      "flax"]) == ["flax", "jax", "jaxlib",
                                                   "repro"]


def test_a_run_loads_no_forbidden_module():
    code = LOADS.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "USE_JAX": "0", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "found="
