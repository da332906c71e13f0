"""Readings that the limits of a cell's check are set from.

  python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 \
      --seconds 8 [--control] [--fault NAME] [--out FILE]

For each seed, in one process: the cell's set-up and a short window at
its own load, then each number the check compares for the program (with
``--fault``, the program with that fault of ``faults.py`` planted) and,
with ``--control``, for the control (the reference in the next lower
precision put in the program's place).  One JSON line a seed.  The
benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the control runs a second reference after the first: keep the freed
# blocks usable for its larger tensors
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def readings(cell: dict, seed: int, seconds: float, control: bool,
             device="cuda", fault=None) -> dict:
    import torch

    from bench import faults
    run = harness.Run(cell["config"], cell["traffic"], seed, seconds, False,
                      torch.device(device), cell["limits"])
    drv = harness.driver(cell["traffic"]["kind"]).Driver(run)
    if fault:
        faults.plant(cell["traffic"]["kind"], fault, drv)
    drv.setup()
    drv.window()
    drv.free()
    out = {"seed": seed, "units": len(run.records), "fault": fault,
           "program": {k: v["value"] for k, v in drv.check().items()}}
    if control:
        out["control"] = drv.control()
    del drv
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None,
                    help="a fault of bench/faults.py planted in the program")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.resolve_cell(harness.benchmark_spec(), args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            line = json.dumps(readings(cell, seed, args.seconds,
                                       args.control, fault=args.fault))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
