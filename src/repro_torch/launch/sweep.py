"""Design-space sweep launcher: ``python -m repro_torch sweep``.

Profiles a workload once per cache geometry (or once, for scratchpad
backends), evaluates a ``DeviceGrid`` of candidate gain-cell device sets
over every subpartition with the batched sweep engine, and emits the
per-subpartition Pareto frontiers (console + optional JSON/CSV).

  PYTHONPATH=src python -m repro_torch sweep --backend systolic --dry-run \
      --engine torch
  PYTHONPATH=src python -m repro_torch sweep --backend systolic \
      --arch tinyllama_1_1b --seq 96 --mixes 0,0.5,1 \
      --retention-scales 0.5,1,2,4 --out sweep.json --csv sweep.csv
  PYTHONPATH=src python -m repro_torch sweep --backend gpu --seq 64 \
      --l1-geom 64:4,128:8 --workers 4
  PYTHONPATH=src python -m repro_torch sweep --backend systolic --dry-run \
      --family sot-mram --family-param delta=40,60,80
  PYTHONPATH=src python -m repro_torch sweep --dry-run --engine torch \
      --device cpu

``--family`` swaps the gain-cell ``DeviceGrid`` for a ``FamilyGrid``
over a registered device family (``python -m repro_torch devices`` lists
them); ``--family-param k=v1,v2`` sets its parameter axes (``:``
separates floats inside one list-valued point, e.g. ``mixes=0:1``).

Lifetime extraction, the cache replay and the composition (``--engine
torch``, the default; ``--engine numpy`` is the host oracle) run on the
CUDA device unless ``--device`` names another; without a CUDA device and
without ``--device cpu`` the command fails.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.compose.engine import ENGINES
from repro_torch.core import ProfileSession
from repro_torch.launch import parse_floats as _floats
from repro_torch.sweep import DeviceGrid, FamilyGrid, SweepRunner


def _grid_from_args(args):
    if args.family:
        from repro_torch.devices import (get_device_family,
                                         parse_family_params)
        fam = get_device_family(args.family)
        axes = parse_family_params(args.family_param or (), fam)
        return FamilyGrid(
            family=fam.name,
            axes=axes if args.family_param else None,
            include_sram_only=not args.no_sram_anchor,
        )
    if args.family_param:
        raise SystemExit("--family-param requires --family")
    return DeviceGrid(
        mixes=_floats(args.mixes),
        retention_scales=_floats(args.retention_scales),
        area_scales=_floats(args.area_scales),
        energy_scales=_floats(args.energy_scales),
        per_mix=args.per_mix,
        include_sram_only=not args.no_sram_anchor,
    )


def _geometries(args) -> dict | None:
    """``--l1-geom 64:4,128:8`` -> {label: backend-config overrides}."""
    if not args.l1_geom:
        return None
    from repro_torch.backends.cachesim import CacheConfig
    out = {}
    for spec in args.l1_geom.split(","):
        size_kb, ways = (int(v) for v in spec.split(":"))
        out[f"l1_{size_kb}kb_{ways}w"] = {
            "l1": CacheConfig(size_kb=size_kb, ways=ways)}
    return out


def _workload(args):
    """(workload, backend cfg) for the selected backend, lowered from
    the ``repro_torch.workloads`` registry (any registered name via
    ``--arch``)."""
    if args.dry_run:
        from repro_torch.backends.systolic import GemmLayer
        if args.backend == "systolic":
            return [GemmLayer("dry", 32, 32, 32)], {"rows": 16, "cols": 16}
        if args.backend in ("gpu", "cachesim", "opstream"):
            def program(sb):
                from repro_torch.backends.opstream import transformer_ops
                transformer_ops(sb, d_model=64, n_heads=2, kv_heads=2,
                                d_ff=128, seq=16, n_layers=1)
            return program, {}
        raise SystemExit(
            f"--dry-run supports systolic/gpu/cachesim/opstream, "
            f"not {args.backend!r}")
    from repro_torch.launch.profile import build_workload
    from repro_torch.workloads import get_workload
    workload, cfg = build_workload(args.arch, args.backend, seq=args.seq)
    if args.backend == "systolic":
        cfg.update(rows=args.pe, cols=args.pe, dataflow=args.dataflow)
    elif get_workload(args.arch).suite == "archs":
        cfg.pop("sample", None)       # sweep replays arch streams in full
    return workload, cfg


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch sweep",
        description="composition design-space sweep + Pareto frontier")
    ap.add_argument("--backend", default="systolic",
                    choices=["systolic", "gpu", "cachesim", "opstream",
                             "tpu", "tpu_graph"])
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--pe", type=int, default=128)
    ap.add_argument("--dataflow", default="ws", choices=["is", "ws", "os"])
    ap.add_argument("--mixes", default="0,0.5,1",
                    help="Si<->Hybrid interpolation points in [0,1]")
    ap.add_argument("--retention-scales", default="0.5,1,2")
    ap.add_argument("--area-scales", default="1")
    ap.add_argument("--energy-scales", default="1")
    ap.add_argument("--per-mix", action="store_true",
                    help="one candidate per mix flavor instead of one "
                         "combined device set per scale point")
    ap.add_argument("--no-sram-anchor", action="store_true",
                    help="drop the all-SRAM anchor candidate")
    ap.add_argument("--family", default=None,
                    help="sweep a registered device family instead of the "
                         "gain-cell grid (see `python -m repro_torch "
                         "devices`)")
    ap.add_argument("--family-param", action="append", default=None,
                    metavar="K=V1,V2",
                    help="family parameter axis (repeatable); ':' joins "
                         "floats inside one list-valued point")
    ap.add_argument("--l1-geom", default=None,
                    help="cache geometries to sweep, size_kb:ways pairs "
                         "(gpu/cachesim backends), e.g. 64:4,128:8")
    ap.add_argument("--workers", type=int, default=1,
                    help="threads for the outer subpartition/geometry loop")
    ap.add_argument("--policy", default="refresh-free",
                    help="assignment policy: refresh-free | refresh-aware"
                         " | bank-quantized[:<base>][@<n_banks>]")
    ap.add_argument("--engine", default="torch", choices=ENGINES,
                    help="composition evaluation backend (torch, the "
                         "default, runs the policy kernels on --device; "
                         "numpy is the oracle, ~1e-9 relative energy "
                         "apart)")
    ap.add_argument("--device", default=None,
                    help="torch device of the lifetime extraction, the "
                         "cache replay and --engine torch (default: the "
                         "CUDA device; fails without one)")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--csv", default=None, help="CSV output path")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny built-in workload; sweep smoke test")
    args = ap.parse_args(argv)

    grid = _grid_from_args(args)
    runner = SweepRunner(grid, workers=args.workers, policy=args.policy,
                         engine=args.engine, device=args.device)
    workload, cfg = _workload(args)
    geoms = _geometries(args)
    fam_tag = f" family={grid.family}" if args.family else ""
    print(f"sweep: backend={args.backend} grid={len(grid)} candidates"
          f"{fam_tag} (policy={runner.policy.name}, "
          f"engine={runner.engine}, workers={args.workers})")

    if geoms:
        if args.backend not in ("gpu", "cachesim"):
            raise SystemExit("--l1-geom needs the gpu/cachesim backend")
        result = runner.run_geometries(args.backend, workload, geoms,
                                       **cfg)
    else:
        session = ProfileSession(args.backend, device=args.device)
        session.profile(workload, **cfg).analyze()
        result = runner.run_session(session)

    for (geom, sub), frontier in result.frontiers().items():
        title = sub if geom is None else f"{geom}/{sub}"
        print(f"\n--- {title} ---")
        print(frontier.summary())
        if frontier.anchor is not None:
            print(f"  all-SRAM anchor: area_vs_sram="
                  f"{frontier.anchor.area_vs_sram:g} energy_vs_sram="
                  f"{frontier.anchor.energy_vs_sram:.4g}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(result.to_json(), f, indent=2)
        print(f"\njson -> {args.out}")
    if args.csv:
        with open(args.csv, "w") as f:
            f.write("\n".join(result.csv_rows()) + "\n")
        print(f"csv -> {args.csv}")
    print(f"\nsweep ok: {len(result)} points, "
          f"{sum(len(fr.points) for fr in result.frontiers().values())} "
          "on frontiers")
    return result


if __name__ == "__main__":
    main()
