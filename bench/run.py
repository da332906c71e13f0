"""Run one cell of the benchmark once and print its result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``.  A run
loads the program, warms up every shape the mix sends (``setup_s``),
measures for ``--seconds`` seconds, reads the peak device memory, frees
the program, and checks what the window produced against the plain
reference.  With ``--trace 1`` it runs, before freeing the program, a
few further units under the device timeline (``timeline.py``) and reports
the cell's per-layer metrics, the device's busy seconds and a breakdown,
in place of the end-to-end metrics; a trace that slows those units by
more than ``MAX_TRACE_SLOWDOWN`` against the window's is refused.

The last line of standard output is one JSON object; the numbers that the
check compared, each beside its limit, are the last lines of standard
error and the result's last key.  Without a CUDA device, with fewer
devices than the cell asks for, or with JAX or the JAX package loaded, it
exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program inside the checkout, at
# fixed paths; no library may pull in JAX
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench import timeline as timelines  # noqa: E402

# how much slower the traced units may run than the window's units of the
# same shape before the trace is refused
MAX_TRACE_SLOWDOWN = 0.05


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(message: str) -> int:
    print(f"bench: {message}", file=sys.stderr)
    return 2


def execute(args, cell: dict, device="cuda", prepare=None) -> dict:
    """One run of ``cell`` (``harness.resolve_cell``'s dict with the
    benchmark's ``spec``); returns the result line's object.
    ``prepare(driver)``, before the set-up, is the tests' way to plant a
    fault in the timed path."""
    import torch
    run = harness.Run(cell["config"], cell["traffic"], args.seed,
                      args.seconds, args.trace, torch.device(device),
                      cell["limits"])
    drv = harness.driver(cell["traffic"]["kind"]).Driver(run)
    if prepare is not None:
        prepare(drv)
    drv.setup()
    harness.device_sync(device)
    run.setup_s = harness.process_age_s()
    next_unit = drv.window()
    harness.device_sync(device)
    memory_peak = (int(torch.cuda.max_memory_allocated())
                   if torch.device(device).type == "cuda" else 0)
    if run.trace_on:
        timeline = timelines.make(cell["config"].get("trace", "profiler"),
                                  device, drv.wrappers())
        drv.traced(timeline, next_unit)
        run.trace = timeline.summary()
        slowdown = run.counts["slowdown"]
        if run.device.type == "cuda" and (slowdown is None
                                          or slowdown > MAX_TRACE_SLOWDOWN):
            raise RuntimeError(
                f"the trace slowed the traced units by {slowdown} against "
                f"the window's (at most {MAX_TRACE_SLOWDOWN}): its readings "
                f"would measure the tracing")
        print(f"bench: the trace slowed its units by {slowdown}",
              file=sys.stderr)
    drv.free()
    harness.grow_segments(device)
    numbers = drv.check()
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    section = "per_layer" if run.trace_on else "end_to_end"
    metrics = {}
    for m in harness.cell_metrics(cell["spec"], cell["workload"]["name"],
                                  section):
        value = run.metric(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(r.get("rows", 1) for r in run.records)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": 0 if correct else attempted, "metrics": metrics}
    if torch.device(device).type == "cuda":
        result["device"] = harness.device_info(
            int(cell["workload"]["chips"]), run.trace)
        result["device"]["memory_peak_bytes"] = memory_peak
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    spec = harness.benchmark_spec()
    try:
        cell = harness.resolve_cell(spec, args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(str(e))
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} devices; "
                    f"{torch.cuda.device_count()} present")
    cell["spec"] = spec
    result = execute(args, cell)
    found = harness.forbidden_modules()
    if found:
        return fail(f"modules that no run may load are loaded: {found}")
    for line in harness.check_lines(result["check"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
