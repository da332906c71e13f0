"""The analysis context: file discovery, cached parsing, module naming.

An :class:`AnalysisContext` wraps one source tree — a directory whose
``repro_torch/`` subdirectory is the package to analyze.  For the repo
itself that is ``src/``; test fixtures point it at miniature trees under
``tests/fixtures/torch/analysis/``.  Rules only ever *parse* files (the
analyzed code is never imported), so a fixture tree may freely contain
deliberate contract violations.
"""

from __future__ import annotations

import ast
import os

PACKAGE = "repro_torch"


def default_root() -> str:
    """The source root of the running ``repro_torch`` package (its parent
    directory), so ``python -m repro_torch check`` analyzes itself."""
    import repro_torch
    # a regular package (its root __init__ imports nothing), located by
    # __file__ as repro_torch.launch.campaign does for worker spawning
    pkg_dir = os.path.dirname(os.path.abspath(repro_torch.__file__))
    return os.path.dirname(pkg_dir)


class AnalysisContext:
    """One analyzed tree + parse caches shared by every rule."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.pkg_dir = os.path.join(self.root, PACKAGE)
        if not os.path.isdir(self.pkg_dir):
            raise FileNotFoundError(
                f"no '{PACKAGE}/' package under analysis root {self.root}")
        self._ast: dict = {}
        self._lines: dict = {}
        self._files: list | None = None

    # -- discovery -----------------------------------------------------
    def files(self) -> list:
        """All ``.py`` files under the package, sorted, absolute."""
        if self._files is None:
            out = []
            for dirpath, dirnames, filenames in os.walk(self.pkg_dir):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
            self._files = out
        return self._files

    def rel(self, path: str) -> str:
        """Root-relative posix path (the identity used in findings)."""
        return os.path.relpath(path, self.root).replace(os.sep, "/")

    def abs(self, rel: str) -> str:
        return os.path.join(self.root, rel.replace("/", os.sep))

    def glob(self, *patterns: str) -> list:
        """Files whose root-relative path matches any shell pattern."""
        import fnmatch
        out = []
        for path in self.files():
            r = self.rel(path)
            if any(fnmatch.fnmatch(r, pat) for pat in patterns):
                out.append(path)
        return out

    # -- module naming -------------------------------------------------
    def module_name(self, path: str) -> str:
        """``repro_torch/a/b.py`` -> ``repro_torch.a.b``; ``__init__.py``
        names its package."""
        r = self.rel(path)
        assert r.endswith(".py")
        parts = r[:-3].split("/")
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def module_path(self, module: str) -> str | None:
        """Absolute file for a dotted module name, or None if the
        module does not exist in this tree (e.g. an external import or
        a namespace package with no ``__init__.py``).  Only names under
        ``repro_torch`` are internal: ``src/`` also holds the reference
        package ``repro``, whose modules are external here."""
        if module != PACKAGE and not module.startswith(PACKAGE + "."):
            return None
        base = os.path.join(self.root, *module.split("."))
        for cand in (base + ".py", os.path.join(base, "__init__.py")):
            if os.path.isfile(cand):
                return cand
        return None

    # -- parsing -------------------------------------------------------
    def ast_of(self, path: str) -> ast.Module:
        if path not in self._ast:
            with open(path, encoding="utf-8") as f:
                src = f.read()
            self._ast[path] = ast.parse(src, filename=path)
        return self._ast[path]

    def source_lines(self, path: str) -> list:
        if path not in self._lines:
            try:
                with open(path, encoding="utf-8") as f:
                    self._lines[path] = f.read().splitlines()
            except OSError:
                self._lines[path] = []
        return self._lines[path]
