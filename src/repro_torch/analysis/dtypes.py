"""dtype-safety: the int64 end-to-end trace contract, as a rule.

``Trace.time_cycles`` and ``Trace.addr`` are int64 by contract — cycle
stamps past 2**31 (~2.1 s at 1 GHz) and line addresses >= 2**31 are
real in any multi-step streamed workload, and the seed's int32 hot path
silently wrapped exactly those.  The overflow regression tests catch
the paths they happen to exercise; this rule checks the *construction
sites*, at every future diff:

  * a numpy/jnp or torch array construction bound to a time/addr-ish
    name (or passed as ``time_cycles=``/``addr=``/``start_cycles=``) must
    carry an explicit dtype — platform-dependent inference (or jax's
    default 32-bit mode for ``jnp.asarray``, or torch's float32 default
    for ``torch.zeros`` and the source's dtype for ``torch.as_tensor``)
    is exactly how int32 sneaks in.  ``torch.from_numpy`` and ``*_like``
    inherit their input's dtype and are exempt;
  * an explicit int32 dtype on such a value is a contract violation
    outright (``subpartition`` is int32 by schema; time/addr never), and
    so is narrowing one: ``.astype(int32)``, ``.to(torch.int32)``,
    ``.to(dtype=torch.int32)``, ``.type(torch.int32)`` or ``.int()``;
  * Python-list literals fed straight to ``Trace(time_cycles=...)``
    bypass the ``make_trace`` coercion and inherit inferred dtypes.

Scope: the trace schema and its producers/consumers —
``core/trace.py``, ``core/lifetime.py``, ``core/accumulate.py``, and
every backend.  (``kernels/`` is deliberately out of scope: the cache
replay's 32-bit step indices and the lifetime scan's limits are
documented device limits checked at run time.)
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.findings import Finding

RULE_ID = "dtype-safety"

DEFAULT_SCOPE = (
    "repro_torch/core/trace.py",
    "repro_torch/core/lifetime.py",
    "repro_torch/core/accumulate.py",
    "repro_torch/backends/*.py",
)

#: names that carry trace time/address payloads in the scoped files
_TARGET_RE = re.compile(r"(time|addr|cycle|line)", re.IGNORECASE)

#: trace-schema kwargs that must receive int64 arrays
_SCHEMA_KWARGS = {"time_cycles", "addr", "start_cycles"}

#: from-scratch / casting constructors whose dtype must be explicit.
#: (*_like and concatenate inherit dtype from their input: exempt.)
_CONSTRUCTORS = {"asarray", "array", "arange", "zeros", "ones", "empty",
                 "full"}

#: positional index of the dtype argument, where one exists
_DTYPE_POS = {"asarray": 1, "array": 1, "zeros": 1, "ones": 1,
              "empty": 1, "full": 2}

_ARRAY_MODULES = {"np", "numpy", "jnp"}

#: torch's constructors; their dtype is keyword-only
_TORCH_CONSTRUCTORS = {"tensor", "as_tensor", "asarray", "zeros", "ones",
                       "empty", "full", "arange"}


def _root_name(node: ast.expr) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_array_module(node: ast.expr) -> bool:
    # np.zeros / jnp.asarray / jax.numpy.asarray / numpy.arange
    if isinstance(node, ast.Name):
        return node.id in _ARRAY_MODULES
    if isinstance(node, ast.Attribute):
        return (isinstance(node.value, ast.Name)
                and node.value.id == "jax" and node.attr == "numpy")
    return False


def _is_torch(node: ast.expr) -> bool:
    return isinstance(node, ast.Name) and node.id == "torch"


def _constructor_of(call: ast.Call) -> str | None:
    """"zeros"/"asarray"/... when ``call`` is an array construction."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and (
            (_is_array_module(fn.value) and fn.attr in _CONSTRUCTORS)
            or (_is_torch(fn.value) and fn.attr in _TORCH_CONSTRUCTORS)):
        return fn.attr
    return None


def _dtype_arg(call: ast.Call, ctor: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    pos = None if _is_torch(call.func.value) else _DTYPE_POS.get(ctor)
    if pos is not None and len(call.args) > pos:
        return call.args[pos]
    return None


def _is_int32(node: ast.expr) -> bool:
    if isinstance(node, ast.Attribute) and (
            node.attr == "int32"
            or (node.attr == "int" and _is_torch(node.value))):
        return True
    if isinstance(node, ast.Name) and node.id == "int32":
        return True
    return isinstance(node, ast.Constant) and node.value == "int32"


def _narrowing(call: ast.Call) -> str | None:
    """``"astype(int32)"``/``"to(int32)"``/``"type(int32)"``/``"int()"``
    when ``call`` narrows its receiver to int32."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    dtypes = [kw.value for kw in call.keywords if kw.arg == "dtype"]
    if fn.attr == "astype" and call.args and _is_int32(call.args[0]):
        return "astype(int32)"
    if fn.attr == "to" and any(map(_is_int32, [*call.args, *dtypes])):
        return "to(int32)"
    if fn.attr == "type" and any(map(_is_int32, [*call.args[:1], *dtypes])):
        return "type(int32)"
    if fn.attr == "int" and not call.args and not call.keywords:
        return "int()"
    return None


def _literal_int_sequence(node: ast.expr) -> bool:
    return isinstance(node, (ast.List, ast.Tuple)) and any(
        isinstance(e, ast.Constant) and isinstance(e.value, int)
        for e in node.elts)


class DtypeSafetyRule:
    id = RULE_ID
    description = ("time/addr trace arrays need an explicit (non-int32) "
                   "dtype at every construction site")

    def __init__(self, scope=DEFAULT_SCOPE):
        self.scope = tuple(scope)

    # ------------------------------------------------------------------
    def _check_construction(self, ctx, path, call: ast.Call,
                            target: str, findings: list) -> None:
        ctor = _constructor_of(call)
        if ctor is None:
            return
        fn_text = f"{_root_name(call.func) or '?'}.{ctor}"
        dtype = _dtype_arg(call, ctor)
        if dtype is None and _is_torch(call.func.value):
            findings.append(Finding(
                rule=self.id, path=ctx.rel(path), line=call.lineno,
                message=(f"dtype-less {fn_text}() feeds {target!r}: "
                         "time/addr trace arrays are int64 by contract "
                         "and torch's inferred dtype (float32 for "
                         "zeros/ones/empty/full, the source's for "
                         "as_tensor/asarray) silently narrows them"),
                remediation=(f"pass an explicit dtype: "
                             f"{fn_text}(..., dtype=torch.int64)")))
        elif dtype is None:
            findings.append(Finding(
                rule=self.id, path=ctx.rel(path), line=call.lineno,
                message=(f"dtype-less {fn_text}() feeds {target!r}: "
                         "time/addr trace arrays are int64 by contract "
                         "and inferred dtypes (or jax's 32-bit default) "
                         "silently narrow them"),
                remediation=(f"pass an explicit dtype: "
                             f"{fn_text}(..., dtype=np.int64) "
                             "(jnp.int64 under enable_x64 for jnp)")))
        elif _is_int32(dtype):
            findings.append(Finding(
                rule=self.id, path=ctx.rel(path), line=call.lineno,
                message=(f"{fn_text}(dtype=int32) feeds {target!r}: "
                         "int32 wraps cycle stamps past 2**31 and "
                         "aliases large addresses (the seed bug the "
                         "int64 contract exists for)"),
                remediation="use int64 for time/addr payloads "
                            "(int32 is reserved for `subpartition`)"))

    # ------------------------------------------------------------------
    def run(self, ctx) -> list:
        findings: list = []
        for path in ctx.glob(*self.scope):
            tree = ctx.ast_of(path)
            for node in ast.walk(tree):
                # A. assignments to time/addr-ish names
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    names = [t.id if isinstance(t, ast.Name) else t.attr
                             for t in targets
                             if isinstance(t, (ast.Name, ast.Attribute))]
                    value = node.value
                    if value is None or not isinstance(value, ast.Call):
                        continue
                    for name in names:
                        if _TARGET_RE.search(name):
                            self._check_construction(
                                ctx, path, value, name, findings)
                            break
                # B/C. schema kwargs in calls + int32 narrowing
                elif isinstance(node, ast.Call):
                    fn = node.func
                    callee = fn.attr if isinstance(fn, ast.Attribute) \
                        else (fn.id if isinstance(fn, ast.Name) else None)
                    for kw in node.keywords:
                        if kw.arg not in _SCHEMA_KWARGS:
                            continue
                        if isinstance(kw.value, ast.Call):
                            self._check_construction(
                                ctx, path, kw.value, kw.arg, findings)
                        elif callee == "Trace" and \
                                _literal_int_sequence(kw.value):
                            findings.append(Finding(
                                rule=self.id, path=ctx.rel(path),
                                line=kw.value.lineno,
                                message=(
                                    f"Python int literals feed "
                                    f"Trace({kw.arg}=...): the raw "
                                    "constructor performs no coercion, "
                                    "so the array inherits an inferred "
                                    "dtype"),
                                remediation=(
                                    "route through make_trace() (which "
                                    "coerces to int64) or wrap in "
                                    "np.asarray(..., dtype=np.int64)")))
                    # .astype(int32) / .to(torch.int32) / .int() on a
                    # time/addr-ish expression
                    narrow = _narrowing(node)
                    if narrow:
                        root = _root_name(fn.value)
                        if root and _TARGET_RE.search(root):
                            findings.append(Finding(
                                rule=self.id, path=ctx.rel(path),
                                line=node.lineno,
                                message=(f"{root}.{narrow} narrows "
                                         "a time/addr payload below the "
                                         "int64 contract"),
                                remediation="keep time/addr arrays int64 "
                                            "end-to-end"))
        return findings
