"""import-purity: prove stdlib-only-at-import contracts over the AST.

Several subsystems promise to be cheap to import — campaign planning,
``--dry-run``/``--status``, and test collection all depend on it.  This
rule proves, statically and for *every* declared module, what a
subprocess probe asserting ``'torch' not in sys.modules`` shows for one
import order, with the full import chain in the finding.

The module-level import graph counts every import statement that
executes at import time: top-level statements, class bodies, ``try``/
``if`` blocks (conservatively both branches) — but not function bodies
(the lazy-import idiom the contracts are built on) and not
``if TYPE_CHECKING:`` blocks.  Importing ``repro_torch.a.b`` also executes
``repro_torch/__init__.py`` and ``repro_torch/a/__init__.py``, so internal
edges include existing package ancestors, and the search from a declared
module starts at its own ancestors too.  (The reference, a namespace
package without a root ``__init__``, reaches ancestors only through
another module's import edge, so a contract on a module with no internal
import, such as ``__main__``, never sees a root ``__init__``.)
"""

from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.findings import Finding

RULE_ID = "import-purity"


@dataclasses.dataclass(frozen=True)
class ImportContract:
    """One declared contract: ``module`` (and its submodules when
    ``recursive``) must not transitively import any ``banned``
    top-level external package at import time.

    ``exempt`` names submodules excluded from the contract — the
    designated lazy-import backends (e.g. the torch engine modules under
    ``repro_torch.compose``).  Exemption is *shallow*: an exempt module may
    import the banned package itself, but any covered module that
    imports an exempt module at module level still reaches the banned
    package through it and is flagged — the analyzer proves the exempt
    modules are only ever imported lazily."""
    module: str
    banned: tuple
    recursive: bool = False
    exempt: tuple = ()

    def covers(self, module: str) -> bool:
        if module in self.exempt:
            return False
        return module == self.module or (
            self.recursive and module.startswith(self.module + "."))


#: The port's declared stdlib-only-at-import surface: the reference's,
#: with torch banned where the reference bans jax.  compose.policies is
#: numpy+stdlib by design (campaign planning validates policy specs
#: without torch), so only torch is banned there.
DEFAULT_CONTRACTS = (
    ImportContract("repro_torch.workloads", ("torch", "numpy"),
                   recursive=True),
    ImportContract("repro_torch.devices", ("torch", "numpy"),
                   recursive=True),
    ImportContract("repro_torch.cluster", ("torch", "numpy"),
                   recursive=True),
    ImportContract("repro_torch.analysis", ("torch", "numpy"),
                   recursive=True),
    ImportContract("repro_torch.launch.campaign", ("torch", "numpy")),
    # recursive with the torch engine modules exempted: torch_engine and
    # executor are the only compose modules allowed to import torch at
    # import time (the engine package lazy-imports them only when
    # engine="torch" runs); everything else — policies, engine, types,
    # the package itself — stays torch-free at import
    ImportContract("repro_torch.compose", ("torch",), recursive=True,
                   exempt=("repro_torch.compose.torch_engine",
                           "repro_torch.compose.executor")),
    ImportContract("repro_torch.__main__", ("torch", "numpy")),
)


def _is_type_checking(test: ast.expr) -> bool:
    return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or (
        isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING")


def module_level_imports(ctx, path: str) -> list:
    """``(target, line)`` pairs for every import executed when ``path``
    is imported.  ``target`` is a dotted module name (internal) or the
    imported name as written (external)."""
    module = ctx.module_name(path)
    out: list = []

    def visit(stmts):
        for node in stmts:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    out.append((alias.name, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:      # relative: resolve against package
                    anchor = module.split(".")
                    if not path.endswith("__init__.py"):
                        anchor = anchor[:-1]
                    anchor = anchor[:len(anchor) - node.level + 1]
                    base = ".".join(anchor + ([base] if base else []))
                if base:
                    out.append((base, node.lineno))
                    # `from a.b import c` may bind submodule a.b.c
                    for alias in node.names:
                        sub = f"{base}.{alias.name}"
                        if ctx.module_path(sub) is not None:
                            out.append((sub, node.lineno))
            elif isinstance(node, ast.If):
                if _is_type_checking(node.test):
                    visit(node.orelse)
                else:
                    visit(node.body)
                    visit(node.orelse)
            elif isinstance(node, (ast.Try, ast.With)):
                visit(node.body)
                for h in getattr(node, "handlers", ()):
                    visit(h.body)
                visit(getattr(node, "orelse", ()))
                visit(getattr(node, "finalbody", ()))
            elif isinstance(node, ast.ClassDef):
                visit(node.body)    # class bodies run at import time
            # FunctionDef / AsyncFunctionDef bodies are lazy: skip
    visit(ctx.ast_of(path).body)
    return out


def _expand_internal(ctx, target: str):
    """A dotted internal target plus every existing package ancestor
    (their ``__init__`` modules execute on import)."""
    parts = target.split(".")
    for i in range(1, len(parts) + 1):
        mod = ".".join(parts[:i])
        if ctx.module_path(mod) is not None:
            yield mod


def build_import_graph(ctx) -> dict:
    """``{module: [(target_module_or_external, line), ...]}`` over every
    file in the tree.  Internal edges point at existing module names
    (ancestors included); external edges carry the top-level name."""
    graph: dict = {}
    for path in ctx.files():
        module = ctx.module_name(path)
        edges = []
        for target, line in module_level_imports(ctx, path):
            internal = list(_expand_internal(ctx, target))
            if internal:
                edges.extend((m, line) for m in internal)
            else:
                edges.append((target.split(".")[0], line))
        graph[module] = edges
    return graph


def _ancestors(graph: dict, module: str) -> list:
    """The package ancestors of ``module`` in the tree, outermost first:
    their ``__init__`` modules execute before it on import."""
    parts = module.split(".")
    return [a for a in (".".join(parts[:i]) for i in range(1, len(parts)))
            if a in graph]


def trace_banned_imports(ctx, graph: dict, start: str,
                         banned: tuple) -> list:
    """BFS the import graph from ``start``; for each reachable banned
    external, return ``(external, chain, line)`` where ``chain`` is the
    module path that reaches it and ``line`` the offending import line
    in the chain's last internal module.  ``start``'s package ancestors
    are edges of ``start`` after its own imports (line 0: no statement
    of ``start`` imports them)."""
    hits = []
    seen = {start}
    queue = [(start, (start,))]
    found = set()
    while queue:
        module, chain = queue.pop(0)
        edges = list(graph.get(module, ()))
        if module == start:
            edges += [(a, 0) for a in _ancestors(graph, start)]
        for target, line in edges:
            if target in graph:      # internal
                if target not in seen:
                    seen.add(target)
                    queue.append((target, chain + (target,)))
            elif target in banned and (target not in found):
                found.add(target)
                hits.append((target, chain, line))
    return hits


class ImportPurityRule:
    id = RULE_ID
    description = ("declared stdlib-only modules must not transitively "
                   "import torch/numpy at import time")

    def __init__(self, contracts=DEFAULT_CONTRACTS):
        self.contracts = tuple(contracts)

    def run(self, ctx) -> list:
        graph = build_import_graph(ctx)
        findings = []
        for contract in self.contracts:
            members = sorted(m for m in graph if contract.covers(m))
            reported: set = set()     # one finding per offending import
            for module in members:
                for ext, chain, line in trace_banned_imports(
                        ctx, graph, module, contract.banned):
                    if (chain[-1], line, ext) in reported:
                        continue
                    reported.add((chain[-1], line, ext))
                    # anchor at the import statement in the last
                    # internal module of the chain
                    last = ctx.module_path(chain[-1])
                    findings.append(Finding(
                        rule=self.id, path=ctx.rel(last), line=line,
                        message=(f"{module} transitively imports "
                                 f"{ext!r} at import time "
                                 f"(chain: {' -> '.join(chain)} -> "
                                 f"{ext}), violating its "
                                 "stdlib-only-at-import contract"),
                        remediation=(
                            "move the import inside the function that "
                            "needs it (lazy import), or drop the "
                            "dependency; planning/--dry-run paths must "
                            "stay importable without "
                            f"{ext}")))
        return findings
