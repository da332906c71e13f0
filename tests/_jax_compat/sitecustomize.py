"""Restore ``jax.experimental.enable_x64`` for the JAX reference package.

``repro`` imports ``enable_x64`` from ``jax.experimental``; newer jax
releases expose it only as ``jax.enable_x64``.  The reference package is
kept unmodified, so the alias is restored here.  ``tests/conftest.py`` runs
this file in the test process and puts its directory on ``PYTHONPATH``, so
that every interpreter the tests start (campaign workers, the command line)
loads it as ``sitecustomize`` and sees the same alias.

The alias is set when ``jax.experimental`` is first imported, not before: an
interpreter that never imports jax must stay free of it.
"""

import importlib.abc
import importlib.util
import sys


def _alias(module):
    jax = sys.modules.get("jax")
    if not hasattr(module, "enable_x64") and hasattr(jax, "enable_x64"):
        module.enable_x64 = jax.enable_x64


class _AliasOnImport(importlib.abc.MetaPathFinder):
    """Wraps the loader of ``jax.experimental`` to add the alias once."""

    def find_spec(self, name, path=None, target=None):
        if name != "jax.experimental":
            return None
        sys.meta_path.remove(self)
        spec = importlib.util.find_spec(name)
        if spec is None or spec.loader is None:
            return spec
        exec_module = spec.loader.exec_module

        def exec_then_alias(module):
            exec_module(module)
            _alias(module)

        spec.loader.exec_module = exec_then_alias
        return spec


if "jax.experimental" in sys.modules:
    _alias(sys.modules["jax.experimental"])
elif not any(isinstance(f, _AliasOnImport) for f in sys.meta_path):
    sys.meta_path.insert(0, _AliasOnImport())
