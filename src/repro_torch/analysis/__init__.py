"""Static contract analysis over the port's own AST:
``python -m repro_torch check``.

The port of the reference's ``repro.analysis``.  GainSight's correctness
rests on architectural contracts that no single test file owns:
stdlib-only-at-import planning modules, the int64 end-to-end trace
contract, registry conformance, the ``SCHEMA_VERSION`` trace-cache key,
and the tmp-file+``os.replace`` / ``O_EXCL`` write discipline of the
distributed store.  This package
makes each of them machine-checkable: a pluggable set of AST rules runs
over the source tree (never importing it) and emits structured findings
with remediations, inline ``# repro: allow(<rule>)`` suppressions, a
committed-baseline mechanism, and ``--format json`` for CI artifacts.

Rules (the reference's five; see docs/API.md, "Architecture contracts"):

  import-purity         declared stdlib-only modules never transitively
                        import torch/numpy at module import time (the
                        search starts at the module's package ancestors
                        too: their ``__init__`` runs first)
  dtype-safety          time/addr trace arrays are constructed with an
                        explicit dtype and never narrowed to int32, by
                        numpy or by torch (``.to(torch.int32)``,
                        ``.int()``, ...)
  registry-conformance  @register_workload/@register_backend sites have
                        the required shape; no duplicate names or alias
                        collisions; the workload-side backend alias map
                        stays in sync with the backend registry
  schema-drift          an AST fingerprint of the trace-cache key
                        functions is pinned in schema_manifest.json;
                        changing the key without bumping SCHEMA_VERSION
                        fails the check
  atomic-write          cluster/ and checkpoint/ never write files with
                        a raw ``open(path, "w")`` outside the
                        tmp-file+rename / O_EXCL helpers

Import contract: this package is stdlib-only (it must run in CI and in
campaign planning environments without torch/numpy) — and declares
itself so in its own import-purity contract.  It imports nothing of the
reference package.
"""

from repro_torch.analysis.context import AnalysisContext, default_root
from repro_torch.analysis.findings import (Finding, filter_baseline,
                                           filter_suppressed,
                                           load_baseline, write_baseline)
from repro_torch.analysis.imports import ImportContract, ImportPurityRule
from repro_torch.analysis.dtypes import DtypeSafetyRule
from repro_torch.analysis.registry import RegistryConformanceRule
from repro_torch.analysis.schema import (SchemaDriftRule,
                                         update_schema_manifest)
from repro_torch.analysis.atomic import AtomicWriteRule


def default_rules():
    """The repo's rule set, in stable reporting order."""
    return (ImportPurityRule(), DtypeSafetyRule(),
            RegistryConformanceRule(), SchemaDriftRule(),
            AtomicWriteRule())


def run_check(root: str | None = None, rules=None,
              baseline: dict | None = None) -> list:
    """Run ``rules`` (default: all five) over the tree at ``root`` and
    return the surviving findings — suppressions and the baseline
    already applied, sorted for stable output."""
    ctx = AnalysisContext(default_root() if root is None else root)
    out: list = []
    for rule in (default_rules() if rules is None else rules):
        out.extend(rule.run(ctx))
    out = filter_suppressed(out, ctx)
    if baseline is not None:
        out = filter_baseline(out, baseline)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule, f.message))


__all__ = [
    "AnalysisContext", "AtomicWriteRule", "DtypeSafetyRule", "Finding",
    "ImportContract", "ImportPurityRule", "RegistryConformanceRule",
    "SchemaDriftRule", "default_root", "default_rules", "filter_baseline",
    "filter_suppressed", "load_baseline", "run_check",
    "update_schema_manifest", "write_baseline",
]
