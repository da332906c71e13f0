"""Retargetable hardware backends (paper §5).

Each backend executes (or models the execution of) a workload on a target
architecture and emits the canonical trace format of
``repro_torch.core.trace``, built with numpy on the host.  Backends
self-register with the ``repro_torch.core.api`` registry::

    from repro_torch.core import ProfileSession, get_backend

    get_backend("systolic")
    ProfileSession("systolic").run(workload, rows=128, cols=128)

(the CLI equivalent is ``python -m repro_torch profile --backend systolic``).

Built-in backends:

  systolic   - SCALE-Sim-style systolic array with is/ws/os dataflows (§5.2)

The cache-hierarchy (``cachesim``/``gpu``), ``opstream`` and graph-walking
backends of the reference package are not ported yet.
"""
