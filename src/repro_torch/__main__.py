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
  devices    list the registered device families (name, version,
             aliases, parameter schema)

``sweep``, ``campaign``, ``worker`` and ``check`` of the reference CLI are
not ported yet; they say so and return 2.

Examples::

  PYTHONPATH=src python -m repro_torch profile --backend systolic \
      --arch tinyllama_1_1b --dataflow ws --pe 128
  PYTHONPATH=src python -m repro_torch profile --backend systolic \
      --dry-run --device cpu
  PYTHONPATH=src python -m repro_torch profile --backend gpu \
      --arch llama-3-8b
  PYTHONPATH=src python -m repro_torch profile --backend gpu --dry-run \
      --device cpu
  PYTHONPATH=src python -m repro_torch workloads
  PYTHONPATH=src python -m repro_torch backends
  PYTHONPATH=src python -m repro_torch devices
"""

from __future__ import annotations

import sys

_USAGE = __doc__
_NOT_PORTED = ("sweep", "campaign", "worker", "check")


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
    if cmd in _NOT_PORTED:
        print(f"`{cmd}` is not ported to repro_torch yet (see ROADMAP.md, "
              "Queue A); use `python -m repro` for it", file=sys.stderr)
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
