"""``python -m repro_torch``: the GainSight command-line front door.

Subcommands:

  profile    run a workload on a registry backend, analyze lifetimes on
             the CUDA device (``--device cpu`` for the host), and emit the
             heterogeneous-memory report (see ``repro_torch.launch.profile``
             for flags; ``--policy`` selects the assignment policy,
             ``--csv`` a machine-readable composition report,
             ``--chunk-events`` the streaming frontend, ``--dry-run`` runs
             a tiny built-in workload as a pipeline smoke test)
  workloads  list the registered workload specs (name, suite, backends):
             the ``archs``, ``mlperf``, ``polybench`` and ``cnn`` suites
  backends   list the registered profiling backends: ``systolic``,
             ``cachesim`` (alias ``gpu``: the L1/L2 cache replay, on the
             CUDA device) and ``opstream``
  sweep      profile a workload, evaluate a grid of candidate device sets
             over every subpartition and print the Pareto frontiers (see
             ``repro_torch.launch.sweep``: the default engine, ``torch``,
             runs the policy kernels and the monolithic baselines on the
             CUDA device, ``--engine numpy`` the host oracle, ``--dry-run``
             a tiny built-in workload)
  campaign   run N registered workloads x M backends through the full
             pipeline on the CUDA device (``--device cpu`` for the host)
             with a worker pool and an on-disk trace cache, and emit the
             cross-suite aggregate report (access-weighted short-lived
             fractions per backend per retention bin + suite-level Pareto
             frontiers; ``--scheduler process`` runs lease-based worker
             processes over a shared artifact store, ``--status DIR``
             prints a campaign ledger's state, and ``--dry-run`` prints
             the job plan without touching a backend or the device)
  worker     join an in-flight process-scheduled campaign: lease jobs
             from a shared artifact store (``--store DIR``), heartbeat,
             execute on the campaign's device, and write artifacts until
             the queue drains
  devices    list the registered device families (name, version,
             aliases, parameter schema)

``check`` of the reference CLI (the contract analyzer, ``analysis/``) is
not ported yet; it says so and returns 2.

Examples::

  PYTHONPATH=src python -m repro_torch profile --backend systolic \
      --arch tinyllama_1_1b --dataflow ws --pe 128
  PYTHONPATH=src python -m repro_torch profile --backend systolic \
      --dry-run --device cpu
  PYTHONPATH=src python -m repro_torch profile --backend gpu \
      --arch llama-3-8b
  PYTHONPATH=src python -m repro_torch profile --backend gpu --dry-run \
      --device cpu
  PYTHONPATH=src python -m repro_torch sweep --backend systolic --dry-run \
      --engine torch
  PYTHONPATH=src python -m repro_torch sweep --dry-run --engine torch \
      --device cpu
  PYTHONPATH=src python -m repro_torch campaign --workloads polybench-2mm \
      --backends systolic,gpu --device cpu
  PYTHONPATH=src python -m repro_torch campaign --workloads suite:mlperf \
      --backends systolic,gpu --scheduler process --jobs 2
  PYTHONPATH=src python -m repro_torch campaign --status .gainsight-cache
  PYTHONPATH=src python -m repro_torch campaign --dry-run
  PYTHONPATH=src python -m repro_torch worker --store .gainsight-cache
  PYTHONPATH=src python -m repro_torch workloads
  PYTHONPATH=src python -m repro_torch backends
  PYTHONPATH=src python -m repro_torch devices
"""

from __future__ import annotations

import sys

_USAGE = __doc__
_NOT_PORTED = ("check",)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "profile":
        from repro_torch.launch.profile import main as profile_main
        profile_main(rest)
        return 0
    if cmd == "sweep":
        from repro_torch.launch.sweep import main as sweep_main
        sweep_main(rest)
        return 0
    if cmd == "campaign":
        from repro_torch.launch.campaign import main as campaign_main
        campaign_main(rest)
        return 0
    if cmd == "worker":
        from repro_torch.cluster.worker import main as worker_main
        worker_main(rest)
        return 0
    if cmd in _NOT_PORTED:
        print(f"`{cmd}` is not ported to repro_torch yet (see ROADMAP.md, "
              "Queue A, A7: the contract analyzer, analysis/); use "
              "`python -m repro` for it", file=sys.stderr)
        return 2
    if cmd == "workloads":
        from repro_torch.workloads import available_workloads, get_workload
        for name in available_workloads():
            spec = get_workload(name)
            print(f"{spec.describe()}  {spec.description}")
        return 0
    if cmd == "backends":
        from repro_torch.core import available_backends, get_backend
        for name in available_backends():
            b = get_backend(name)
            doc = (b.__doc__ or "").strip().splitlines()
            print(f"{name:12s} mode={b.mode:10s} "
                  f"{doc[0] if doc else ''}")
        return 0
    if cmd == "devices":
        from repro_torch.devices import (available_device_families,
                                         get_device_family)
        for name in available_device_families():
            fam = get_device_family(name)
            print(fam.describe())
            print(f"    {fam.description}")
            for p in fam.params:
                default = (":".join(f"{v:g}" for v in p.default)
                           if isinstance(p.default, tuple)
                           else f"{p.default:g}")
                print(f"    --family-param {p.name}=... "
                      f"(default {default})  {p.doc}")
        return 0
    print(f"unknown command {cmd!r}\n\n{_USAGE}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
