"""atomic-write: cluster/ and checkpoint/ never tear files.

The distributed store's whole crash story rests on two write
idioms: *tmp-file + ``os.replace``* (readers never observe partials)
and *``O_EXCL`` create* (exactly one winner).  A raw
``open(path, "w")`` anywhere in ``repro_torch/cluster`` or
``repro_torch/checkpoint`` re-introduces torn reads: a reader (or a worker
racing a crash) can observe a half-written JSON file where every
consumer assumes rename-atomicity.

The rule flags ``open()`` calls with a literal write mode (``"w"``,
``"wb"``, ``"w+"``) unless the enclosing function also calls
``os.replace``/``os.rename`` (the tmp-dir/tmp-file protocols, where
the final publish is the rename).  Append mode is exempt: the ledger
is an append-only fsync'd log whose replay skips torn trailing lines
by design.  fd-based writes (``os.fdopen`` over ``mkstemp``/O_EXCL
fds) are not ``open()`` and never flagged: the port's store publishes
with ``os.link`` from such an fd-written temp file, so it needs no
special case.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

RULE_ID = "atomic-write"

DEFAULT_SCOPE = ("repro_torch/cluster/*.py",
                 "repro_torch/checkpoint/*.py")


def _write_mode(call: ast.Call) -> str | None:
    """The literal mode string when it starts a write ('w'...), else
    None.  A missing mode is read-mode: ignored."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
            and mode.value.startswith("w"):
        return mode.value
    return None


def _calls_rename(fn) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("replace", "rename") \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "os":
            return True
    return False


class AtomicWriteRule:
    id = RULE_ID
    description = ("raw open(path, 'w') writes in cluster/ and "
                   "checkpoint/ must route through tmp-file+rename or "
                   "O_EXCL helpers")

    def __init__(self, scope=DEFAULT_SCOPE):
        self.scope = tuple(scope)

    def run(self, ctx) -> list:
        findings: list = []
        for path in ctx.glob(*self.scope):
            tree = ctx.ast_of(path)
            # visit functions so each open() knows its enclosing def
            funcs = [n for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]
            covered: set = set()
            for fn in funcs:
                renames = _calls_rename(fn)
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Name) \
                            and node.func.id == "open":
                        covered.add(id(node))
                        mode = _write_mode(node)
                        if mode and not renames:
                            findings.append(self._finding(
                                ctx, path, node, mode))
            # module-level opens (no enclosing function)
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id == "open" \
                        and id(node) not in covered:
                    mode = _write_mode(node)
                    if mode:
                        findings.append(self._finding(
                            ctx, path, node, mode))
        return findings

    def _finding(self, ctx, path, node, mode) -> Finding:
        return Finding(
            rule=self.id, path=ctx.rel(path), line=node.lineno,
            message=(f"raw open(..., {mode!r}) write outside the "
                     "tmp-file+os.replace / O_EXCL discipline: a crash "
                     "mid-write leaves a torn file that concurrent "
                     "readers parse as truncated state"),
            remediation=("write to a tempfile.mkstemp file in the same "
                         "directory and os.replace() into place, or "
                         "create with os.open(..., O_CREAT|O_EXCL); "
                         "append-only fsync'd logs use mode 'a'"))
