"""registry-conformance: the workload/backend registries, checked at rest.

Both registries only validate at *import/registration time* — a
duplicate name silently wins, an alias that shadows a real name
silently redirects, and a builder with the wrong arity explodes only
when a campaign finally lowers it on a backend.  With the
device-family registry now joined (``repro_torch.devices``), this rule checks
every ``@register_workload`` / ``@register_backend`` /
``@register_device_family`` site statically:

  * literal names must be unique across the tree; aliases must not
    collide with names or other aliases (per registry namespace);
  * a workload builder takes ``(params, backend)`` — exactly two
    required positional parameters (extras must carry defaults, the
    closure-capture idiom);
  * a literal ``backends=()`` registration is unreachable in campaigns;
  * a backend class must define ``run`` and a ``mode`` attribute, and a
    ``name`` attribute when the decorator passes no literal name;
  * a device-family builder takes ``(params)`` — exactly one required
    positional — and family names/aliases share one lookup namespace
    (``get_device_family`` resolves aliases first);
  * the workload-side ``_BACKEND_ALIASES`` literal in
    ``workloads/spec.py`` (kept local so planning stays torch-free) must
    mirror the aliases the backend decorators actually declare — the
    two maps drifting apart means ``canonical_backend`` and
    ``get_backend`` disagree about what "gpu" is.

Dynamic registration through factory helpers (names held in variables)
is common and legitimate; non-literal names simply skip the uniqueness
checks.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

RULE_ID = "registry-conformance"

SPEC_ALIAS_FILE = "repro_torch/workloads/spec.py"


def _decorator_calls(node, name: str):
    for dec in getattr(node, "decorator_list", ()):
        if isinstance(dec, ast.Call):
            fn = dec.func
            target = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if target == name:
                yield dec


def _kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _literal_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _literal_str_seq(node) -> list | None:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = [_literal_str(e) for e in node.elts]
        return out if all(s is not None for s in out) else None
    return None


def _required_positionals(fn: ast.FunctionDef) -> int:
    args = fn.args
    n_named = len(args.posonlyargs) + len(args.args)
    return n_named - len(args.defaults)


class RegistryConformanceRule:
    id = RULE_ID
    description = ("@register_workload/@register_backend/"
                   "@register_device_family sites: required shape, "
                   "unique names, consistent alias maps")

    # ------------------------------------------------------------------
    def _check_workload_site(self, ctx, path, node, call, seen,
                             findings) -> None:
        rel, line = ctx.rel(path), call.lineno
        name = _literal_str(call.args[0]) if call.args else None
        if call.args and name is None and not isinstance(
                call.args[0], ast.Name):
            findings.append(Finding(
                rule=self.id, path=rel, line=line,
                message="register_workload name is neither a string "
                        "literal nor a variable",
                remediation="pass the workload name as a string literal "
                            "(or a loop variable in a factory helper)"))
        if name is not None:
            prev = seen["workloads"].get(name)
            if prev:
                findings.append(Finding(
                    rule=self.id, path=rel, line=line,
                    message=(f"duplicate workload registration "
                             f"{name!r} (first registered at {prev})"),
                    remediation="registry names must be unique; the "
                                "second registration silently replaces "
                                "the first"))
            else:
                seen["workloads"][name] = f"{rel}:{line}"
        aliases = _literal_str_seq(_kwarg(call, "aliases")) or []
        for alias in aliases:
            prev = seen["workload_aliases"].get(alias)
            if prev or alias in seen["workloads"]:
                findings.append(Finding(
                    rule=self.id, path=rel, line=line,
                    message=(f"workload alias {alias!r} collides with "
                             "an existing workload name or alias"),
                    remediation="aliases share the lookup namespace "
                                "with names; pick a distinct alias"))
            else:
                seen["workload_aliases"][alias] = f"{rel}:{line}"
        backends = _kwarg(call, "backends")
        lit_backends = _literal_str_seq(backends)
        if backends is None or lit_backends == []:
            findings.append(Finding(
                rule=self.id, path=rel, line=line,
                message=(f"workload {name or '<dynamic>'!r} registers "
                         "no backends: it can never run in a campaign"),
                remediation="declare the backends this spec lowers to, "
                            "e.g. backends=(\"systolic\", \"gpu\")"))
        if isinstance(node, ast.FunctionDef):
            req = _required_positionals(node)
            if req != 2:
                findings.append(Finding(
                    rule=self.id, path=rel, line=node.lineno,
                    message=(f"workload builder {node.name!r} takes "
                             f"{req} required positional parameter(s); "
                             "the registry calls builder(params, "
                             "backend)"),
                    remediation="use exactly (params, backend); extra "
                                "closure captures need defaults, e.g. "
                                "(params, backend, _arch=arch)"))

    # ------------------------------------------------------------------
    def _check_backend_site(self, ctx, path, node, call, seen,
                            findings) -> None:
        rel, line = ctx.rel(path), call.lineno
        name = _literal_str(call.args[0]) if call.args else None
        attrs = {}
        methods = set()
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            attrs[t.id] = stmt.value
                elif isinstance(stmt, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    methods.add(stmt.name)
        if name is None:
            name = _literal_str(attrs.get("name"))
            if name is None:
                findings.append(Finding(
                    rule=self.id, path=rel, line=line,
                    message="register_backend site has neither a "
                            "literal decorator name nor a literal "
                            "`name` class attribute",
                    remediation="pass the registry name to the "
                                "decorator or define `name = \"...\"`"))
        if name is not None:
            prev = seen["backends"].get(name)
            if prev:
                findings.append(Finding(
                    rule=self.id, path=rel, line=line,
                    message=(f"duplicate backend registration {name!r} "
                             f"(first registered at {prev})"),
                    remediation="backend registry names must be unique"))
            else:
                seen["backends"][name] = f"{rel}:{line}"
        for alias in _literal_str_seq(_kwarg(call, "aliases")) or []:
            prev = seen["backend_aliases"].get(alias)
            if prev or alias in seen["backends"]:
                findings.append(Finding(
                    rule=self.id, path=rel, line=line,
                    message=(f"backend alias {alias!r} collides with an "
                             "existing backend name or alias"),
                    remediation="aliases share the lookup namespace "
                                "with names; pick a distinct alias"))
            else:
                seen["backend_aliases"][alias] = (f"{rel}:{line}", name)
        if isinstance(node, ast.ClassDef):
            if "run" not in methods:
                findings.append(Finding(
                    rule=self.id, path=rel, line=node.lineno,
                    message=(f"backend class {node.name!r} defines no "
                             "run() method (Backend protocol: "
                             "run(workload, **cfg) -> ProfileResult)"),
                    remediation="implement run() or do not register "
                                "the class"))
            if "mode" not in attrs:
                findings.append(Finding(
                    rule=self.id, path=rel, line=node.lineno,
                    message=(f"backend class {node.name!r} defines no "
                             "`mode` attribute (\"scratchpad\" | "
                             "\"cache\"); ProfileSession.analyze() "
                             "reads it"),
                    remediation="declare mode as a class attribute"))

    # ------------------------------------------------------------------
    def _check_device_family_site(self, ctx, path, node, call, seen,
                                  findings) -> None:
        rel, line = ctx.rel(path), call.lineno
        name = _literal_str(call.args[0]) if call.args else None
        if call.args and name is None and not isinstance(
                call.args[0], ast.Name):
            findings.append(Finding(
                rule=self.id, path=rel, line=line,
                message="register_device_family name is neither a "
                        "string literal nor a variable",
                remediation="pass the family name as a string literal "
                            "(or a loop variable in a factory helper)"))
        if name is not None:
            prev = (seen["device_families"].get(name)
                    or seen["device_family_aliases"].get(name))
            if prev:
                findings.append(Finding(
                    rule=self.id, path=rel, line=line,
                    message=(f"duplicate device-family registration "
                             f"{name!r} (first registered at {prev})"),
                    remediation="family names and aliases share one "
                                "lookup namespace and must be unique; "
                                "register_device_family raises at "
                                "import, so this site is dead code"))
            else:
                seen["device_families"][name] = f"{rel}:{line}"
        for alias in _literal_str_seq(_kwarg(call, "aliases")) or []:
            prev = (seen["device_family_aliases"].get(alias)
                    or seen["device_families"].get(alias))
            if prev:
                findings.append(Finding(
                    rule=self.id, path=rel, line=line,
                    message=(f"device-family alias {alias!r} collides "
                             "with an existing family name or alias"),
                    remediation="aliases share the lookup namespace "
                                "with names; pick a distinct alias"))
            else:
                seen["device_family_aliases"][alias] = f"{rel}:{line}"
        if isinstance(node, ast.FunctionDef):
            req = _required_positionals(node)
            if req != 1:
                findings.append(Finding(
                    rule=self.id, path=rel, line=node.lineno,
                    message=(f"device-family builder {node.name!r} "
                             f"takes {req} required positional "
                             "parameter(s); the registry calls "
                             "builder(params)"),
                    remediation="use exactly (params); extra closure "
                                "captures need defaults, e.g. "
                                "(params, _base=base)"))

    # ------------------------------------------------------------------
    def _check_alias_map(self, ctx, seen, findings) -> None:
        """workloads/spec.py `_BACKEND_ALIASES` literal vs the aliases
        the backend decorators declare."""
        path = ctx.abs(SPEC_ALIAS_FILE)
        declared = {a: cname for a, (_, cname)
                    in seen["backend_aliases"].items()}
        try:
            tree = ctx.ast_of(path)
        except (FileNotFoundError, OSError):
            return
        for node in tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "_BACKEND_ALIASES"
                            for t in node.targets)
                    and isinstance(node.value, ast.Dict)):
                continue
            literal = {}
            for k, v in zip(node.value.keys, node.value.values):
                ks, vs = _literal_str(k), _literal_str(v)
                if ks is not None and vs is not None:
                    literal[ks] = vs
            rel, line = ctx.rel(path), node.lineno
            for alias, cname in sorted(declared.items()):
                if cname is not None and literal.get(alias) != cname:
                    findings.append(Finding(
                        rule=self.id, path=rel, line=line,
                        message=(f"_BACKEND_ALIASES is missing/stale "
                                 f"for alias {alias!r} -> {cname!r} "
                                 "declared by @register_backend: "
                                 "canonical_backend() and "
                                 "get_backend() would disagree"),
                        remediation="mirror every backend decorator "
                                    "alias in the literal map (kept "
                                    "local so planning stays torch-free)"))
            for alias, cname in sorted(literal.items()):
                if alias not in declared:
                    findings.append(Finding(
                        rule=self.id, path=rel, line=line,
                        message=(f"_BACKEND_ALIASES entry {alias!r} -> "
                                 f"{cname!r} has no matching "
                                 "@register_backend alias declaration"),
                        remediation="remove the stale entry or declare "
                                    "the alias on the backend"))

    # ------------------------------------------------------------------
    def run(self, ctx) -> list:
        findings: list = []
        seen = {"workloads": {}, "workload_aliases": {},
                "backends": {}, "backend_aliases": {},
                "device_families": {}, "device_family_aliases": {}}
        any_backend_sites = False
        for path in ctx.files():
            tree = ctx.ast_of(path)
            for node in ast.walk(tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                    continue
                for call in _decorator_calls(node, "register_workload"):
                    self._check_workload_site(ctx, path, node, call,
                                              seen, findings)
                for call in _decorator_calls(node, "register_backend"):
                    any_backend_sites = True
                    self._check_backend_site(ctx, path, node, call,
                                             seen, findings)
                for call in _decorator_calls(
                        node, "register_device_family"):
                    self._check_device_family_site(ctx, path, node,
                                                   call, seen, findings)
        if any_backend_sites:
            self._check_alias_map(ctx, seen, findings)
        return findings
