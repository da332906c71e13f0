"""GainSight profiling launcher: the paper's workflow as a framework feature.

A thin CLI over :class:`repro_torch.core.ProfileSession` - for a given
*registered workload* (``repro_torch.workloads``), run the selected
registry backend, the analytical frontend, and the heterogeneous-memory
composition, and emit the report (JSON + console).

  PYTHONPATH=src python -m repro_torch profile --arch tinyllama_1_1b \
      --backend systolic --dataflow ws --pe 128
  PYTHONPATH=src python -m repro_torch profile --arch tinyllama_1_1b \
      --backend gpu --seq 128
  PYTHONPATH=src python -m repro_torch profile --arch polybench-2mm \
      --backend systolic
  PYTHONPATH=src python -m repro_torch profile --backend gpu --dry-run \
      --device cpu

Lifetime extraction, and the cache backend's set-parallel replay, run on
the CUDA device unless ``--device`` names another; without a CUDA device
and without ``--device cpu`` the command fails.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.backends.systolic import GemmLayer
from repro_torch.compose.engine import ENGINES
from repro_torch.core import ProfileSession
from repro_torch.devices import get_device_family
from repro_torch.workloads import get_workload
from repro_torch.workloads.suites import transformer_program

# The paper device set, resolved through the device-family registry.
_SRAM_DEV, SI_GCRAM, HYBRID_GCRAM = get_device_family(
    "sram-gaincell-default").build()


def _summarize(session: ProfileSession, out: str | None,
               csv_out: str | None = None) -> dict:
    """Console summary + composition entries + optional JSON/CSV dump."""
    report = session.report()
    print(json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "devices"}
         for k, v in report["subpartitions"].items()}, indent=1,
        default=str)[:1200])
    for name in report["subpartitions"]:
        comp = session.composition(name)
        f_si = session.short_lived_fraction(name, SI_GCRAM.retention_s)
        f_hy = session.short_lived_fraction(name, HYBRID_GCRAM.retention_s)
        print(f"{name}: short-lived {100 * f_si:.1f}% @Si-GC(1us) / "
              f"{100 * f_hy:.1f}% @Hy-GC(10us)   composition "
              f"{comp.summary()}")
    if out:
        session.report(out)
        print(f"report -> {out}")
    if csv_out:
        _write_composition_csv(session, csv_out)
    return report


def _write_composition_csv(session: ProfileSession, csv_out: str) -> None:
    """Machine-readable composition report."""
    from repro_torch.compose import composition_csv_rows
    comps = {name: session.composition(name)
             for name in session.report()["subpartitions"]}
    with open(csv_out, "w") as f:
        f.write("\n".join(composition_csv_rows(comps)) + "\n")
    print(f"csv -> {csv_out}")


def profile_gpu(cfg, seq, out, sample=8, chunk_events=None, device=None):
    """The cache-hierarchy ("gpu") backend on a config's decoder stack."""
    session = ProfileSession("gpu", device=device)
    session.profile(transformer_program(cfg, seq), sample=sample,
                    chunk_events=chunk_events)
    session.analyze().compose()
    return _summarize(session, out)


_DRY_SEQ = 16


def _dry_run(backend: str, policy: str = "refresh-free",
             engine: str = "numpy", csv_out: str | None = None,
             device=None) -> dict:
    """Minimal end-to-end pipeline smoke: tiny built-in workload."""
    session = ProfileSession(backend, device=device)
    name = session.backend.name
    if name == "systolic":
        session.profile([GemmLayer("dry", 32, 32, 32)], rows=16, cols=16)
    else:   # cachesim / opstream
        def program(sb):
            from repro_torch.backends.opstream import transformer_ops
            transformer_ops(sb, d_model=64, n_heads=2, kv_heads=2,
                            d_ff=128, seq=_DRY_SEQ, n_layers=1)
        session.profile(program)
    report = session.analyze().compose(policy=policy,
                                       engine=engine).report()
    subs = report["subpartitions"]
    events = sum(v["n_reads"] + v["n_writes"] for v in subs.values())
    print(f"dry-run ok: backend={name} subpartitions={sorted(subs)} "
          f"events={events} policy={policy} engine={engine} "
          f"device={session.device}")
    if csv_out:
        _write_composition_csv(session, csv_out)
    return report


def build_workload(arch: str, backend: str, *, seq: int | None = None):
    """Registry lowering for the CLI: ``(workload, backend_cfg)`` for any
    registered workload name, with ``seq`` applied when the spec has that
    param."""
    spec = get_workload(arch)
    if seq is not None and "seq" in spec.param_dict:
        spec = spec.with_params(seq=seq)
    return spec.build(backend)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch profile")
    ap.add_argument("--arch", default="tinyllama_1_1b",
                    help="registered workload name (see `python -m "
                         "repro_torch workloads`)")
    ap.add_argument("--backend", default="systolic",
                    choices=["systolic", "gpu", "cachesim", "opstream"],
                    help="registered backend (see `python -m repro_torch "
                         "backends`)")
    ap.add_argument("--dataflow", default="ws", choices=["is", "ws", "os"])
    ap.add_argument("--pe", type=int, default=128)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--out", default=None)
    ap.add_argument("--csv", default=None,
                    help="composition-report CSV path (subpartition,"
                         "policy,area_vs_sram,energy_vs_sram,"
                         "capacity_fractions)")
    ap.add_argument("--policy", default="refresh-free",
                    help="assignment policy: refresh-free | refresh-aware"
                         " | bank-quantized[:<base>][@<n_banks>]")
    ap.add_argument("--engine", default="numpy", choices=ENGINES,
                    help="composition evaluation backend")
    ap.add_argument("--chunk-events", type=int, default=None,
                    help="stream the trace to the frontend in chunks of "
                         "this many events (bounded-memory analysis)")
    ap.add_argument("--device", default=None,
                    help="torch device of the lifetime extraction and of "
                         "the cache replay (default: the CUDA device; fails "
                         "without one)")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny built-in workload; pipeline smoke test")
    args = ap.parse_args(argv)

    if args.dry_run:
        return _dry_run(args.backend, policy=args.policy,
                        engine=args.engine, csv_out=args.csv,
                        device=args.device)

    session = ProfileSession(args.backend, device=args.device)
    workload, cfg = build_workload(args.arch, args.backend, seq=args.seq)
    if args.backend == "systolic":
        cfg.update(rows=args.pe, cols=args.pe, dataflow=args.dataflow)
    if args.chunk_events:
        cfg["chunk_events"] = args.chunk_events
    session.profile(workload, **cfg)
    session.analyze().compose(policy=args.policy, engine=args.engine)
    return _summarize(session, args.out, args.csv)


if __name__ == "__main__":
    main()
