"""schema-drift: the trace-cache key is pinned by AST fingerprint.

The campaign trace cache keys artifacts by
``CampaignRunner._key`` over ``WorkloadSpec.content_hash``, versioned
by ``SCHEMA_VERSION``.  The contract (docs/API.md, "trace-cache key
contract") is that any change to what feeds the key bumps the version
so stale artifacts can never be served against a new key scheme — a
silent drift poisons every warm campaign.  Nothing enforced that until
now: this rule pins a normalized AST fingerprint of each key-feeding
function in a checked-in manifest (``repro_torch/analysis/
schema_manifest.json``) next to the pinned ``SCHEMA_VERSION``:

  * fingerprints changed, version unchanged  -> drift (the bug);
  * version changed (or a legitimate key change already bumped it)
    but the manifest still pins the old state -> refresh the manifest
    with ``python -m repro_torch check --update-schema-manifest``.

Fingerprints hash ``ast.dump`` of the function body with docstrings
stripped and no position attributes, so comments, whitespace, and
moving the function around the file never trip the rule — only
semantic edits do.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import tempfile

from repro_torch.analysis.findings import Finding

RULE_ID = "schema-drift"

MANIFEST_REL = "repro_torch/analysis/schema_manifest.json"

#: (root-relative file, dotted qualname) of every function feeding the
#: campaign trace-cache key.  ``content_hash`` pins the reference's value;
#: ``_key`` the port's own (its payload adds ``"package"``).
PINNED_FUNCTIONS = (
    ("repro_torch/launch/campaign.py", "CampaignRunner._key"),
    ("repro_torch/workloads/spec.py", "WorkloadSpec.content_hash"),
)

VERSION_FILE = "repro_torch/launch/campaign.py"
VERSION_NAME = "SCHEMA_VERSION"


def _find_def(tree: ast.Module, qualname: str):
    node: ast.AST = tree
    for part in qualname.split("."):
        found = None
        for child in getattr(node, "body", ()):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)) and child.name == part:
                found = child
                break
        if found is None:
            return None
        node = found
    return node


def _strip_docstring(fn):
    body = list(fn.body)
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        body = body[1:]
    return body


def fingerprint(fn) -> str:
    """Position- and docstring-independent hash of a function def."""
    dump = ast.dump(ast.Module(body=_strip_docstring(fn),
                               type_ignores=[]),
                    include_attributes=False)
    return hashlib.sha256(dump.encode()).hexdigest()


def current_fingerprints(ctx) -> tuple:
    """``({pin_id: fingerprint|None}, {pin_id: line})`` for the pinned
    functions; None where a function is missing."""
    fps: dict = {}
    lines: dict = {}
    for rel, qual in PINNED_FUNCTIONS:
        pin = f"{rel}::{qual}"
        path = ctx.abs(rel)
        try:
            tree = ctx.ast_of(path)
        except (FileNotFoundError, OSError):
            fps[pin] = None
            lines[pin] = 1
            continue
        node = _find_def(tree, qual)
        fps[pin] = fingerprint(node) if node is not None else None
        lines[pin] = node.lineno if node is not None else 1
    return fps, lines


def current_schema_version(ctx):
    """The ``SCHEMA_VERSION`` int literal, or None."""
    try:
        tree = ctx.ast_of(ctx.abs(VERSION_FILE))
    except (FileNotFoundError, OSError):
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == VERSION_NAME
                        for t in node.targets) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            return node.value.value
    return None


def update_schema_manifest(ctx) -> str:
    """Re-pin the manifest to the tree's current state (atomic write);
    returns the manifest path."""
    fps, _ = current_fingerprints(ctx)
    missing = sorted(pin for pin, fp in fps.items() if fp is None)
    if missing:
        raise ValueError(
            f"cannot pin schema manifest: function(s) not found: "
            f"{missing}")
    version = current_schema_version(ctx)
    if version is None:
        raise ValueError(
            f"cannot pin schema manifest: no literal {VERSION_NAME} "
            f"in {VERSION_FILE}")
    path = ctx.abs(MANIFEST_REL)
    payload = {"schema_version": version, "fingerprints": fps}
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
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
    return path


class SchemaDriftRule:
    id = RULE_ID
    description = ("cache-key functions changed without a SCHEMA_VERSION "
                   "bump (or the pinned manifest is stale)")

    def run(self, ctx) -> list:
        # Trees without the campaign subsystem (fixture packages for
        # other rules) have nothing to pin: not a violation.
        if ctx.module_path("repro_torch.launch.campaign") is None:
            return []
        manifest_path = ctx.abs(MANIFEST_REL)
        rel_manifest = MANIFEST_REL
        fps, def_lines = current_fingerprints(ctx)
        version = current_schema_version(ctx)
        findings: list = []
        refresh = ("re-pin with `python -m repro_torch check "
                   "--update-schema-manifest` (after making sure "
                   "SCHEMA_VERSION reflects the key change)")
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return [Finding(
                rule=self.id, path=rel_manifest, line=1,
                message="schema manifest missing or unreadable: the "
                        "trace-cache key functions are unpinned",
                remediation=refresh)]
        pinned_fps = manifest.get("fingerprints", {})
        pinned_version = manifest.get("schema_version")
        for pin, fp in sorted(fps.items()):
            rel, qual = pin.split("::", 1)
            if fp is None:
                findings.append(Finding(
                    rule=self.id, path=rel, line=1,
                    message=(f"pinned cache-key function {qual} not "
                             f"found in {rel}"),
                    remediation="restore the function or update "
                                "PINNED_FUNCTIONS + the manifest"))
                continue
            if pin not in pinned_fps:
                findings.append(Finding(
                    rule=self.id, path=rel_manifest, line=1,
                    message=f"manifest has no fingerprint for {pin}",
                    remediation=refresh))
                continue
            if fp != pinned_fps[pin]:
                if version == pinned_version:
                    findings.append(Finding(
                        rule=self.id, path=rel,
                        line=def_lines[pin],
                        message=(f"{qual} (a trace-cache key function) "
                                 "changed but SCHEMA_VERSION is still "
                                 f"{version}: cached artifacts keyed by "
                                 "the old scheme would be served "
                                 "against the new one"),
                        remediation=(f"bump {VERSION_NAME} in "
                                     f"{VERSION_FILE}, then {refresh}")))
                else:
                    findings.append(Finding(
                        rule=self.id, path=rel_manifest, line=1,
                        message=(f"SCHEMA_VERSION bumped to {version} "
                                 f"but the manifest still pins "
                                 f"{qual}'s old fingerprint"),
                        remediation=refresh))
        if not findings and version != pinned_version:
            findings.append(Finding(
                rule=self.id, path=rel_manifest, line=1,
                message=(f"manifest pins schema_version "
                         f"{pinned_version} but {VERSION_FILE} declares "
                         f"{version}"),
                remediation=refresh))
        return findings
