"""What every cell's run shares: finding its files by name, the run's
record and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
configuration's file (``configs/<name>.json``) holds the model as it is
run; the mix's file (``traffic/<name>.json``) holds its parameters and the
``kind`` of driver that reads them (``kinds/<kind>.py``).  Every metric is
read by ``metrics/<name>.py`` from the run's record, and the limits that
decide ``correct`` are in ``checks/<cell>.json``.  So a later cell, mix,
metric or configuration is a new file and a new entry, and no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may load (compared whole: the port's
# own package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve_cell(spec: dict, name: str) -> dict:
    """The cell ``name`` with its configuration entry, the configuration's
    file, the mix's file and the limits of its check, all found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    work = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[work["config"]]
    return {"workload": work, "config_entry": entry,
            "config": load_json(ROOT / entry["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{work['traffic']}.json"),
            "limits": load_json(BENCH / "checks" / f"{name}.json")["limits"]}


def cell_metrics(spec: dict, name: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports: those that list it, and those that list no cell."""
    return [m for m in spec[section]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(run) -> float | None``, loaded by
    its path (a metric's name may hold dots)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics._read_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    return importlib.import_module(f"bench.kinds.{kind}")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), so that
    ``setup_s`` counts the interpreter's start and the imports too."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one that no run may load."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """One run of one cell: its inputs, and what its driver records for
    the metric readers and the check.

    ``records``: one dict per completed unit of work (request, step or
    session) with its host-clock times; ``trace``: the device timeline's
    summary (``timeline.Timeline.summary``) of the traced sub-window, or
    None;
    ``counts``: the program's own counters over that sub-window."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device, limits: dict | None = None):
        self.cfg = cfg
        self.traffic = traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace_on = bool(trace)
        self.device = device
        self.limits = limits or {}
        self.records: list = []
        self.setup_s = None
        self.window_s = None
        self.trace = None
        self.counts: dict = {}

    def metric(self, name: str):
        value = reader(name)(self)
        return None if value is None else float(value)


def seed_generator(seed: int, stream: int, device="cpu"):
    """A ``torch.Generator`` for one named stream of a run's draws: the
    seed (any whole number, larger than 64 bits too) folded with the
    stream's number, so the streams of one seed are independent."""
    import torch
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) \
        % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def device_sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def grow_segments(device) -> None:
    """Let the caching allocator grow its segments from here on
    (``expandable_segments``), so that the check's reference, which runs
    once the program is freed, is not refused memory that the program's
    freed blocks leave in pieces.  The timed window has run by then with
    the allocator as the program sets it."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def now() -> float:
    return time.perf_counter()


def kernel_seconds(run: Run, names) -> float | None:
    """Device seconds of the traced operations whose names start with one
    of ``names``; None where the run has no trace or none of them ran."""
    if run.trace is None:
        return None
    total = sum(s for n, s in run.trace["kernel_s"].items()
                if n.startswith(tuple(names)))
    return total if total > 0 else None


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

def device_info(count: int, trace: dict | None) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def check_lines(numbers: dict) -> list:
    """One line per number compared: its name, value and limit."""
    return [f"check {name}: {v['value']!r} (limit {v['limit']!r})"
            for name, v in numbers.items()]
