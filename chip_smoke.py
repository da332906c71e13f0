#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and no network; exits non-zero without a
GPU.  It builds the CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card, runs the profile CLI
and then the main path at the full width and depth of TinyLlama-1.1B
(``ProfileSession`` profile -> analyze -> compose, then the
``lifetime_scan`` entry point on the traces the session profiled), checks
the results against the session's own lifetimes and the golden file written
from the JAX reference, and times the kernel.

Output: the ``nvidia-smi`` name/power-limit line, then one JSON object per
phase (``device``, ``build``, ``kernel_check``, ``cli``, ``full``,
``kernels``), then ``{"ok": true, "device": {...}}`` as the last line.  Any
failed phase raises: nothing is caught, nothing falls back to the CPU or to
a plain version.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GOLDEN = ROOT / "tests" / "fixtures" / "torch" / \
    "golden_tinyllama_systolic.json"
FULL_LAYERS = 22                 # TinyLlama-1.1B's own depth
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published peak
# float32 outside the tensor cores peaks at 67 TFLOP/s counting a fused
# multiply-add as two; taken as 33.5e12 instructions/s for integer work
INT_OPS_PER_S = 33.5e12
KERNEL_SOURCE = "src/repro_torch/csrc/lifetime_scan.cu"
KERNEL_REPLACES = "src/repro/kernels/lifetime_scan/kernel.py:49"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, runs: int) -> list:
    """Per-run milliseconds of ``fn`` by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def random_sorted_trace(n, n_addrs, p_write, seed, torch, device):
    """A seeded random event stream on the card, sorted by (addr, time):
    times past 2**40, addresses at and above 2**31."""
    from repro_torch.core.lifetime import sort_by_addr_time
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    t = torch.randint(0, 10 * n + 1, (n,), generator=g, device=device,
                      dtype=torch.int64) + 2 ** 40
    a = torch.randint(0, n_addrs, (n,), generator=g, device=device,
                      dtype=torch.int64) * 3 + 2 ** 31
    w = torch.rand(n, generator=g, device=device) < p_write
    order = sort_by_addr_time(t, a)
    return t[order], a[order], w[order]


def phase_kernel_check(torch, device) -> dict:
    from repro_torch.kernels.lifetime_scan import kernel as k
    from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                       integer_edges)
    edges = torch.from_numpy(integer_edges(default_edges())).to(device)
    cases, max_err = 0, 0
    for n in (1, 257, 100_000, 10_000_000):
        for n_addrs in (3, max(4, n // 8)):
            for p_write in (0.05, 0.35, 0.95):
                t, a, w = random_sorted_trace(
                    n, n_addrs, p_write, seed=cases, torch=torch,
                    device=device)
                hist, stats = k.lifetime_scan_sorted(t, a, w, edges)
                torch.cuda.synchronize()
                hist_p, stats_p = k.lifetime_scan_plain(t, a, w, edges)
                err = max(int((hist - hist_p).abs().max()),
                          int((stats - stats_p).abs().max()))
                max_err = max(max_err, err)
                if err != 0:
                    raise AssertionError(
                        f"lifetime_scan kernel != plain version at n={n} "
                        f"n_addrs={n_addrs} p_write={p_write}: "
                        f"{stats.tolist()} vs {stats_p.tolist()}")
                if int(stats[0] + stats[1]) < 1 or \
                        int(stats[4] + stats[5]) != n:
                    raise AssertionError("kernel_check trace is degenerate")
                cases += 1
    emit("kernel_check", kernel="lifetime_scan", cases=cases,
         tolerance="exact (int64)", max_abs_err=max_err)
    return {"max_abs_err": max_err}


def check_report_against_golden(report, entry) -> int:
    """Counts and capacity fractions of a session report against one entry
    of the golden file; returns the number of events."""
    events = 0
    for name, g in entry["subpartitions"].items():
        rep = report["subpartitions"][name]
        for key in ("n_reads", "n_writes", "n_lifetimes", "unique_addrs"):
            if rep[key] != g[key]:
                raise AssertionError(
                    f"{name}.{key}: {rep[key]} != golden {g[key]}")
        comp = rep["composition"]
        if comp["devices"] != g["composition_devices"] or \
                comp["capacity_fractions"] != g["capacity_fractions"]:
            raise AssertionError(
                f"{name}: composition {comp['capacity_fractions']} != "
                f"golden {g['capacity_fractions']}")
        events += rep["n_reads"] + rep["n_writes"]
    if events != entry["n_events"]:
        raise AssertionError(
            f"{events} events, golden has {entry['n_events']}")
    return events


def phase_cli(golden) -> None:
    """The profile CLI on the card (2 layers, the registry default)."""
    from repro_torch.__main__ import main as cli_main
    out = ROOT / "build" / "chip_smoke_cli_report.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli_main(["profile", "--arch", "tinyllama_1_1b", "--backend",
                       "systolic", "--pe", "128", "--out", str(out)])
    if rc != 0:
        raise AssertionError(f"profile CLI returned {rc}")
    events = check_report_against_golden(json.loads(out.read_text()),
                                         golden["entries"]["2"])
    emit("cli", events=events, seconds=time.perf_counter() - t0,
         golden="n_layers=2 entry: counts and capacity fractions equal")


def phase_full(torch, np, device, golden) -> dict:
    """The main path at full width and depth; returns what the timing
    phase needs (launch count, the largest sorted subpartition)."""
    import math

    from repro_torch.core import ProfileSession
    from repro_torch.core.lifetime import (lifetimes_of_trace,
                                           sort_by_addr_time)
    from repro_torch.kernels.lifetime_scan import kernel as k
    from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                       integer_edges,
                                                       lifetime_histogram)
    from repro_torch.workloads import get_workload

    run = golden["run"]
    entry = golden["entries"][str(FULL_LAYERS)]
    ie = integer_edges(default_edges())

    torch.cuda.reset_peak_memory_stats()
    k.lifetime_scan_sorted.launches = 0          # main path starts here

    workload, cfg = get_workload(run["arch"]).with_params(
        seq=run["seq"], n_layers=FULL_LAYERS).build(run["backend"])
    session = ProfileSession(run["backend"])
    t0 = time.perf_counter()
    session.profile(workload, rows=run["pe"], cols=run["pe"],
                    dataflow=run["dataflow"], **cfg)
    t1 = time.perf_counter()
    session.analyze()           # ends with host copies: the card is idle
    t2 = time.perf_counter()
    session.compose()
    t3 = time.perf_counter()
    report = session.report()
    trace = session.trace

    kernel_s = extract_s = 0.0
    biggest = None
    for sub, name in enumerate(trace.names):
        t_sub = trace.select(sub)
        # the device share of analyze(), timed again on its own: copy to
        # the card, two sorts, segment reductions (analyze() also selects
        # the subpartition and builds its statistics on the host)
        te = time.perf_counter()
        lifetimes_of_trace(t_sub)
        torch.cuda.synchronize()
        extract_s += time.perf_counter() - te
        tk = time.perf_counter()
        hist, stats = lifetime_histogram(t_sub.time_cycles, t_sub.addr,
                                         t_sub.is_write)
        hist, stats = hist.cpu().numpy(), stats.cpu().tolist()
        kernel_s += time.perf_counter() - tk

        # against the session's own lifetimes, binned on the host
        _, raw = session.subpartition_stats(name)
        host = raw.numpy()
        lt = host.lifetime_cycles[~host.orphan]
        bins = np.searchsorted(ie, lt, side="right") - 1
        want_hist = np.bincount(bins[(bins >= 0) & (bins < len(ie) - 1)],
                                minlength=len(ie) - 1)
        n_reads, n_writes = t_sub.counts()
        want = [len(lt), int(host.orphan.sum()), int(lt.sum()),
                int(lt.max()) if len(lt) else 0, n_reads, n_writes, 0, 0]
        if stats != want or not np.array_equal(hist, want_hist):
            raise AssertionError(
                f"{name}: kernel stats {stats} != session {want}")
        # against the golden file of the JAX reference
        g = entry["subpartitions"][name]
        if stats != [g["live"], g["orphans"], g["sum_lt"], g["max_lt"],
                     g["n_reads"], g["n_writes"], 0, 0] or \
                hist.tolist() != g["hist"]:
            raise AssertionError(f"{name}: kernel result != golden file")
        if biggest is None or t_sub.n_events > biggest.n_events:
            biggest = t_sub

    launches = k.lifetime_scan_sorted.launches   # main path ends here
    check_report_against_golden(report, entry)
    for name, rep in report["subpartitions"].items():
        comp = rep["composition"]
        vals = [rep["duration_s"], rep["mean_lifetime_s"],
                comp["energy_vs_sram"], comp["area_vs_sram"]]
        if not all(math.isfinite(v) for v in vals) or \
                abs(sum(comp["capacity_fractions"]) - 1.0) > 1e-9:
            raise AssertionError(f"{name}: report is not finite/normalised")
    if launches < len(trace.names):
        raise AssertionError(
            f"lifetime_scan launched {launches} time(s) on the main path, "
            f"expected one per subpartition ({len(trace.names)})")

    emit("full", arch=run["arch"], n_layers=FULL_LAYERS, seq=run["seq"],
         pe=run["pe"], dataflow=run["dataflow"], events=trace.n_events,
         subpartition_events={n: int((trace.subpartition == i).sum())
                              for i, n in enumerate(trace.names)},
         host_profile_s=t1 - t0, analyze_s=t2 - t1,
         device_extract_s=extract_s, host_compose_s=t3 - t2,
         kernel_entry_s=kernel_s,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         lifetime_scan_launches=launches,
         golden=f"n_layers={FULL_LAYERS} entry: counts, histogram, "
                "sum_lt, max_lt and capacity fractions equal")

    t = torch.from_numpy(biggest.time_cycles).to(device)
    a = torch.from_numpy(biggest.addr).to(device)
    w = torch.from_numpy(biggest.is_write).to(device)
    order = sort_by_addr_time(t, a)
    return {"launches": launches,
            "sorted": (t[order], a[order], w[order]),
            "edges": torch.from_numpy(ie).to(device)}


def phase_kernels(torch, full, check) -> dict:
    from repro_torch.kernels.lifetime_scan import kernel as k
    t, a, w = full["sorted"]
    edges = full["edges"]
    n, n_bins = t.shape[0], edges.shape[0] - 1

    ms = statistics.median(cuda_ms(
        lambda: k.lifetime_scan_sorted(t, a, w, edges), runs=20))
    plain_ms = statistics.median(cuda_ms(
        lambda: k.lifetime_scan_plain(t, a, w, edges), runs=5))
    hist, stats = k.lifetime_scan_sorted(t, a, w, edges)
    n_segments = int(stats[0] + stats[1])
    live = int(stats[0])

    # bytes: every input read once, every output written once
    n_bytes = n * (8 + 8 + 1) + (n_bins + 1) * 8 + n_bins * 8 + 8 * 8
    # operations this data needs: two compares per event for the boundary,
    # one subtraction and a binary search over the edges per live segment,
    # one count per segment
    n_ops = 2 * n + live * (1 + (n_bins + 1).bit_length()) + n_segments
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT_OPS_PER_S * 1e3
    row = {
        "name": "lifetime_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": full["launches"],
        "max_abs_err": check["max_abs_err"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "events": n, "segments": n_segments, "bytes": n_bytes,
    }
    return {"kernels": [row]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.device import default_device
    from repro_torch.kernels import _build

    device = default_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    lib = _build.build("lifetime_scan")
    emit("build", kernels=["lifetime_scan"], seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in
                lib.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "spill" in ln])

    golden = json.loads(GOLDEN.read_text())
    check = phase_kernel_check(torch, device)
    phase_cli(golden)
    full = phase_full(torch, np, device, golden)
    kernels = phase_kernels(torch, full, check)
    print(json.dumps(kernels), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
