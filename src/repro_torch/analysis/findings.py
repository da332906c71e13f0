"""Findings, inline suppressions, and the committed-baseline mechanism.

A :class:`Finding` is one contract violation: rule id, root-relative
path, line, message, and a remediation the author can act on.  Its
*identity* for suppression/baseline purposes is ``(rule, path,
message)`` — deliberately line-free, so an unrelated edit moving a
known violation down a few lines neither un-suppresses it nor churns
the baseline.

Suppressions are inline comments, in the reference's syntax::

    lease = open(path, "w")   # repro: allow(atomic-write)

A suppression on line N covers findings on line N and line N+1 (the
comment-above-the-statement style).  Multiple rule ids may be listed:
``# repro: allow(atomic-write, dtype-safety)``.

A baseline file is a JSON snapshot of known findings
(``python -m repro_torch check --write-baseline``) that lets a new rule land
with existing debt ratcheted rather than fixed in one PR; entries match
on the same line-free identity.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(([^)]*)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a source location."""
    rule: str           # rule id, e.g. "atomic-write"
    path: str           # root-relative posix path, e.g. "repro_torch/cluster/ledger.py"
    line: int           # 1-based line of the offending node
    message: str        # what is wrong
    remediation: str = ""   # how to fix it

    @property
    def key(self) -> tuple:
        return (self.rule, self.path, self.message)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.remediation:
            out += f"\n    fix: {self.remediation}"
        return out


# ---------------------------------------------------------------------------
# inline suppressions
# ---------------------------------------------------------------------------

def suppressed_rules(ctx, path: str) -> dict:
    """``{line: {rule, ...}}`` of ``# repro: allow(...)`` comments in
    ``path`` (an absolute path into the analyzed tree)."""
    out: dict = {}
    for i, text in enumerate(ctx.source_lines(path), start=1):
        m = _ALLOW_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def filter_suppressed(findings: list, ctx) -> list:
    """Drop findings covered by an inline suppression on their line or
    the line above."""
    cache: dict = {}
    out = []
    for f in findings:
        abspath = os.path.join(ctx.root, f.path)
        if abspath not in cache:
            cache[abspath] = suppressed_rules(ctx, abspath)
        marks = cache[abspath]
        allowed = marks.get(f.line, set()) | marks.get(f.line - 1, set())
        if f.rule not in allowed:
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

BASELINE_SCHEMA = 1


def load_baseline(path: str) -> dict:
    """Baseline file -> ``{"keys": {(rule, path, message), ...}}``."""
    with open(path) as f:
        data = json.load(f)
    keys = {(e["rule"], e["path"], e["message"])
            for e in data.get("findings", ())}
    return {"keys": keys, "path": path}


def filter_baseline(findings: list, baseline: dict) -> list:
    return [f for f in findings if f.key not in baseline["keys"]]


def write_baseline(findings: list, path: str) -> None:
    """Snapshot ``findings`` as the new baseline (atomic write)."""
    payload = {
        "schema": BASELINE_SCHEMA,
        "findings": [
            {"rule": f.rule, "path": f.path, "message": f.message}
            for f in sorted(findings, key=lambda f: f.key)],
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
