"""Retargetable hardware backends (paper §5).

Each backend executes (or models the execution of) a workload on a target
architecture and emits the canonical trace format of
``repro_torch.core.trace``, built with numpy on the host.  Backends
self-register with the ``repro_torch.core.api`` registry::

    from repro_torch.core import ProfileSession, get_backend

    get_backend("systolic")          # or "cachesim"/"gpu", "opstream"
    ProfileSession("systolic").run(workload, rows=128, cols=128)

(the CLI equivalent is ``python -m repro_torch profile --backend systolic``).

Built-in backends:

  systolic   - SCALE-Sim-style systolic array with is/ws/os dataflows (§5.2)
  cachesim   - set-associative L1/L2 data caches, write-allocate ablation
               (§5.1); registry alias "gpu".  Each level is replayed on the
               session's torch device by the ``cache_replay`` kernel
  opstream   - operator-level address-stream generation from model op graphs
               (replaces SASS capture)

The graph-walking ``tpu_graph`` backend of the reference package is not
ported yet (ROADMAP A10).
"""
