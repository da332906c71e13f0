"""``python -m repro_torch check``: run the contract rules, report
findings.

Exit codes: 0 clean, 1 findings, 2 bad invocation.  ``--format json``
emits a machine-readable report (the CI job uploads it as an
artifact); ``--write-baseline`` snapshots current findings so a new
rule can land with existing debt ratcheted; ``--update-schema-manifest``
re-pins the trace-cache key fingerprints after a legitimate,
version-bumped key change.  The default baseline file is the port's own,
so the two packages, which share the root ``src/``, never overwrite each
other's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import (AnalysisContext, default_root,
                                  default_rules, filter_baseline,
                                  load_baseline, run_check,
                                  update_schema_manifest, write_baseline)

DEFAULT_BASELINE = ".repro-torch-check-baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch check",
        description="static contract analysis over the repo's own AST: "
                    "import purity, int64 dtype safety, registry "
                    "conformance, cache-key schema drift, atomic-write "
                    "discipline")
    ap.add_argument("--root", default=None,
                    help="analysis root: the directory containing the "
                         "`repro_torch/` package (default: the "
                         "running "
                         "package's own source tree)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all; "
                         "see --list-rules)")
    ap.add_argument("--format", default="text", choices=("text", "json"),
                    dest="fmt", help="finding output format")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="baseline file of known findings to subtract "
                         f"(default: <root>/{DEFAULT_BASELINE} when it "
                         "exists)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="snapshot current findings as the baseline and "
                         "exit 0")
    ap.add_argument("--update-schema-manifest", action="store_true",
                    help="re-pin the trace-cache key fingerprints "
                         "(after a SCHEMA_VERSION-bumped key change) "
                         "and exit")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule ids and exit")
    args = ap.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id:22s} {r.description}")
        return 0

    root = os.path.abspath(args.root) if args.root else default_root()
    try:
        ctx = AnalysisContext(root)
    except FileNotFoundError as e:
        print(f"repro_torch check: {e}", file=sys.stderr)
        return 2

    if args.update_schema_manifest:
        try:
            path = update_schema_manifest(ctx)
        except ValueError as e:
            print(f"repro_torch check: {e}", file=sys.stderr)
            return 2
        print(f"schema manifest pinned -> {path}")
        return 0

    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        by_id = {r.id: r for r in rules}
        unknown = sorted(wanted - set(by_id))
        if unknown:
            print(f"repro_torch check: unknown rule(s) {unknown}; "
                  f"available: {sorted(by_id)}", file=sys.stderr)
            return 2
        rules = tuple(by_id[i] for i in by_id if i in wanted)

    findings = run_check(root=root, rules=rules)

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    if args.write_baseline:
        write_baseline(findings, baseline_path)
        print(f"baseline of {len(findings)} finding(s) -> "
              f"{baseline_path}")
        return 0
    if args.baseline or os.path.exists(baseline_path):
        findings = filter_baseline(findings,
                                   load_baseline(baseline_path))

    if args.fmt == "json":
        print(json.dumps({
            "schema": 1,
            "root": root,
            "rules": [r.id for r in rules],
            "count": len(findings),
            "findings": [f.to_json() for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(f.format())
        n = len(findings)
        print(f"repro_torch check: {n} finding(s) across "
              f"{len({f.path for f in findings})} file(s)"
              if n else
              f"repro_torch check: clean ({len(rules)} rule(s), "
              f"root={root})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
