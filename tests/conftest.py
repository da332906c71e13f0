"""Test-process shim for the JAX reference package.

``repro`` imports ``enable_x64`` from ``jax.experimental``; newer jax
releases expose it only as ``jax.enable_x64``.  The reference package is
kept unmodified, so the alias is restored here, before any test module
imports ``repro``, and handed on to the interpreters the tests start
(see ``_jax_compat/sitecustomize.py``).
"""

import os
import runpy

_COMPAT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_jax_compat")

runpy.run_path(os.path.join(_COMPAT, "sitecustomize.py"))
if _COMPAT not in os.environ.get("PYTHONPATH", "").split(os.pathsep):
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.environ.get("PYTHONPATH"), _COMPAT) if p)
