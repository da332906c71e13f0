"""Sharding rules: DP/FSDP/TP/EP/SP over a named ``DeviceMesh``.

Models annotate parameters and activations with *logical* axis sentinels;
the launcher resolves them onto mesh axes:

  BATCH  -> ("pod", "data") on the multi-pod mesh, ("data",) single-pod
  FSDP   -> "data"   (parameter sharding over the data axis)
  MODEL  -> "model"  (tensor/expert parallelism)
  SEQ    -> "data"   (sequence parallelism for long-context decode)

A template (one sentinel or None per tensor dim) resolves to DTensor
placements, one per mesh dim: ``Shard(d)`` on each mesh axis that splits
tensor dim d, ``Replicate()`` elsewhere.  A compound entry such as
``("pod", "data")`` shards one tensor dim over several mesh axes, major to
minor, which is DTensor's order for mesh dims taken left to right.

Resolution is process-global (set once by the launcher before the model
runs); when no mesh is configured every function is a no-op, so tests and
single-device runs are untouched.  DTensor's propagation then plays the
part of GSPMD's: ``constrain`` redistributes an activation, and the ops in
between follow their DTensor sharding rules.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

BATCH = "BATCH"
FSDP = "FSDP"
MODEL = "MODEL"
SEQ = "SEQ"

_STATE: dict = {"mesh": None, "multi_pod": False, "fsdp": True, "depth": 0}


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def full(x):
    """The whole tensor of a DTensor (a collective), or ``x`` itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def distribute_local(tensor, mesh: DeviceMesh, placements):
    """``distribute_tensor`` of a tensor that every rank holds whole (the
    same values): each rank keeps its own shard, nothing is sent."""
    return distribute_tensor(tensor, mesh, placements, src_data_rank=None)


class Sharding(NamedTuple):
    """A mesh and one placement per mesh dim (the reference's
    ``NamedSharding``)."""
    mesh: DeviceMesh
    placements: tuple


def set_mesh(mesh: Optional[DeviceMesh], multi_pod: bool = False,
             fsdp: bool = True) -> None:
    _STATE["mesh"] = mesh
    _STATE["multi_pod"] = multi_pod
    _STATE["fsdp"] = fsdp


def get_mesh() -> Optional[DeviceMesh]:
    return _STATE["mesh"]


def axis_names() -> tuple:
    """The mesh's axis names; without a mesh the production mesh's."""
    mesh = _STATE["mesh"]
    if mesh is not None:
        return tuple(mesh.mesh_dim_names)
    return (("pod", "data", "model") if _STATE["multi_pod"]
            else ("data", "model"))


def logical_axes(template) -> tuple:
    """Per tensor dim, the tuple of mesh axes that split it, or None: the
    entries of the reference's ``PartitionSpec`` (a single axis as a
    1-tuple)."""
    multi_pod = _STATE["multi_pod"]
    out = []
    for t in template:
        if t is None:
            out.append(None)
        elif t == BATCH:
            out.append(("pod", "data") if multi_pod else ("data",))
        elif t == FSDP:
            out.append(("data",) if _STATE["fsdp"] else None)
        elif t in (MODEL, SEQ):
            out.append(("model",) if t == MODEL else ("data",))
        elif isinstance(t, tuple):  # compound, e.g. (BATCH, MODEL)
            sub = []
            for u in t:
                r = logical_axes((u,))[0]
                if r is not None:
                    sub.extend(r)
            out.append(tuple(sub) if sub else None)
        else:
            out.append((t,))
    return tuple(out)


def _placements(axes: tuple) -> tuple:
    names = axis_names()
    pl = [Replicate()] * len(names)
    for d, entry in enumerate(axes):
        last = -1
        for a in entry or ():
            i = names.index(a)
            if i <= last or pl[i] != Replicate():
                raise ValueError(
                    f"axes {entry} of tensor dim {d} are not in the mesh's "
                    f"major-to-minor order {names}, or reuse an axis")
            pl[i], last = Shard(d), i
    return tuple(pl)


def resolve(template) -> tuple:
    """Placements, one per mesh dim, of a logical template."""
    return _placements(logical_axes(template))


def _axis_size(mesh: DeviceMesh, entry) -> int:
    out = 1
    for a in entry or ():
        out *= mesh.size(mesh.mesh_dim_names.index(a))
    return out


def axis_size(name: str) -> int:
    """The extent of mesh axis ``name`` (1 without a mesh or axis)."""
    mesh = _STATE["mesh"]
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def _fitted(mesh, shape, template) -> tuple:
    """``resolve`` with every axis whose extent does not divide its tensor
    dim replicated (the reference's divisibility rule; no uneven shards)."""
    axes = tuple(None if e is None or shape[i] % _axis_size(mesh, e)
                 else e for i, e in enumerate(logical_axes(template)))
    return _placements(axes)


def named_sharding(template) -> Optional[Sharding]:
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    return Sharding(mesh, resolve(template))


def fitted_sharding(shape, template) -> Optional[Sharding]:
    """``named_sharding`` under the divisibility rule for ``shape``."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    return Sharding(mesh, _fitted(mesh, tuple(shape), template))


def constrain(x, template):
    """Redistribute a DTensor activation to a logical template (no-op
    without a mesh, and on a plain tensor: a rank's local shard inside
    ``local_map``).

    Divisibility-aware: axes whose dimension doesn't divide by the mesh
    extent are replicated instead (e.g. kv_heads=4 on a 16-way model axis).
    """
    mesh = _STATE["mesh"]
    if mesh is None or not is_dtensor(x):
        return x
    pl = _fitted(mesh, tuple(x.shape), template)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def place(x, template):
    """A tensor that every rank holds whole, as a DTensor placed by
    ``template`` (divisibility rule); ``x`` itself without a mesh."""
    mesh = _STATE["mesh"]
    if mesh is None or is_dtensor(x):
        return x
    return distribute_local(x, mesh, _fitted(mesh, tuple(x.shape), template))


def cache_template(ndim: int, shard_seq: bool = False) -> tuple:
    """The logical template of a decode-cache leaf by its rank (the
    reference's ``cache_specs_templates`` rule): a 5-D leaf (an [L, B, S,
    KV, hd] attention cache) has its batch over BATCH and dim 3 over
    MODEL, or with ``shard_seq`` (long-context decode) its dim 2 over SEQ
    in place of the batch; a 4-D or 3-D leaf has its batch over BATCH.
    The rule gives the 5-D SSM state the same; its constructor keeps the
    state's dim 3 whole (``mamba2.SSM_STATE_TEMPLATE``)."""
    if ndim == 5:
        return ((None, None, SEQ, MODEL, None) if shard_seq
                else (None, BATCH, None, MODEL, None))
    if ndim in (3, 4):
        return (None, BATCH) + (None,) * (ndim - 2)
    return (None,) * ndim


def place_cache(x):
    """A decode-cache leaf that every rank holds whole (zeros), placed by
    ``cache_template`` of its rank; ``x`` itself without a mesh."""
    return place(x, cache_template(x.dim()))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(spec_tree: Any):
    """Resolve a tree (nested dicts) of templates into ``Sharding``s, or
    None without a mesh."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    return _tree_map(lambda t: Sharding(mesh, resolve(t)), spec_tree)


def tree_shardings_for(shapes_tree, spec_tree):
    """Like ``tree_shardings``, but drops axes that don't divide the
    concrete leaf dimensions (``shapes_tree`` mirrors ``spec_tree``; leaves
    have ``.shape``)."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    return _tree_map(
        lambda t, s: Sharding(mesh, _fitted(mesh, tuple(s.shape), t)),
        spec_tree, shapes_tree)


def replicated() -> Optional[Sharding]:
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    return Sharding(mesh, (Replicate(),) * mesh.ndim)


@contextlib.contextmanager
def context():
    """The context the model's code runs in under a mesh: plain tensors
    that meet a DTensor (positions, masks, accumulators, all built whole
    on every rank) count as replicated.  Without a mesh, nothing.
    Re-entrant: DTensor's ``implicit_replication`` switches the rule off
    when any nesting of it exits, so only the outermost enters it."""
    if _STATE["mesh"] is None or _STATE["depth"]:
        yield
        return
    _STATE["depth"] = 1
    try:
        with implicit_replication():
            yield
    finally:
        _STATE["depth"] = 0


class _GradAsPlaced(torch.autograd.Function):
    """The identity; the backward redistributes the gradient to the
    placements its input had in the forward."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if is_dtensor(grad) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def grad_as_placed(x):
    """``x``, whose gradient is redistributed to ``x``'s own placements
    (a no-op off the mesh).  DTensor leaves a gradient placed as its rules
    produce it, e.g. split over ``model`` on the contracted dim of the
    matmul that consumed ``x``; when ``x`` merged heads (or experts) that
    the ``model`` shards would cut, the merge's backward view cannot split
    that shard, which torch 2.11's view rule refuses (ROADMAP D58)."""
    return _GradAsPlaced.apply(x) if is_dtensor(x) else x


class _Psum(torch.autograd.Function):
    """SUM all-reduce of a rank's local addend over a process group; the
    result is replicated, so each addend's gradient is the result's."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x, axis: str):
    """The reference's ``psum`` over mesh axis ``axis`` of a local tensor
    (inside ``local_map``): one all-reduce, differentiable."""
    return _Psum.apply(x, _STATE["mesh"].get_group(axis))
