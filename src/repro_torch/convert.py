"""Carry state between the reference package and this one.

For the profiling pipeline the state both packages must agree on is the
trace and the device models; for the models it is the parameter tree.
These functions take plain arrays and dicts (the fields of a reference
``Trace``, ``dataclasses.asdict`` of a reference ``DeviceModel``, a
reference parameter tree as nested dicts of numpy arrays) and import
nothing of the reference package, so a test can feed both packages the
same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.devices import DeviceModel
from repro_torch.core.lifetime import LifetimeStats
from repro_torch.core.trace import Trace, make_trace

# the reference's stacked per-layer groups: a module's ``<group>.<i>.<leaf>``
# parameter is row i of the tree's ``<group>/<leaf>``
STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers")


def trace_from_arrays(time_cycles, addr, is_write, hit=None,
                      subpartition=None, names=("mem",),
                      clock_hz: float = 1.0e9,
                      block_bits: int = 1024) -> Trace:
    """This package's ``Trace`` from the fields of any trace, as arrays."""
    return make_trace(
        np.asarray(time_cycles), np.asarray(addr), np.asarray(is_write),
        hit=None if hit is None else np.asarray(hit),
        subpartition=None if subpartition is None
        else np.asarray(subpartition),
        clock_hz=float(clock_hz), block_bits=int(block_bits),
        names=tuple(names))


def device_from_fields(fields: dict) -> DeviceModel:
    """This package's ``DeviceModel`` from ``dataclasses.asdict`` of one."""
    return DeviceModel(**fields)


def lifetime_stats_to_numpy(stats: LifetimeStats) -> dict:
    """Every field of a ``LifetimeStats`` (padded to ``n_events``, as the
    reference lays them out) as numpy arrays on the host."""
    return {name: getattr(stats, name).cpu().numpy()
            for name in ("lifetime_cycles", "n_reads", "start_cycles",
                         "addr", "valid", "orphan", "seg_id_per_event")}


def load_reference_params(model: torch.nn.Module, tree: dict) -> None:
    """Copy a reference parameter tree into ``model`` in place.

    ``tree`` mirrors the reference's params: nested dicts of numpy arrays,
    with the per-layer leaves of each stacked group (``STACKED``: the
    ``layers`` of every family, an MoE config's ``dense_layers``, Whisper's
    ``enc_layers`` and ``dec_layers``) stacked under the group's name with a
    leading ``[n_layers]`` axis, at any depth (``layers/in_proj`` of the
    Mamba-2 stack, ``layers/attn/wq`` of the dense LM,
    ``layers/moe/shared/w_up``); leaf ``i`` of ``tree["layers"][a][b]``
    goes to ``model.layers[i].a.b``.  Each leaf is
    cast to its parameter's dtype: numpy has no bfloat16, so a caller hands
    bf16 leaves over as float32, and the cast back is exact.  Raises
    ``KeyError``/``ValueError`` on a missing or extra leaf or a shape
    mismatch."""
    used = set()
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] in STACKED:
            key = (parts[0], *parts[2:])
            arr = np.asarray(_leaf(tree, key))[int(parts[1])]
        else:
            key = tuple(parts)
            arr = np.asarray(_leaf(tree, key))
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != "
                             f"{tuple(param.shape)}")
        used.add(key)
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(arr)).to(
                param.dtype))
    leaves = set(_paths(tree))
    if leaves != used:
        raise KeyError(f"reference leaves not in the model: "
                       f"{sorted(leaves - used)}; model parameters not in "
                       f"the tree: {sorted(used - leaves)}")


def export_params(model) -> dict:
    """The inverse of :func:`load_reference_params`: the parameters of
    ``model`` (a module, or a mapping of parameter names to tensors such as
    their gradients or optimizer moments) as a tree of float32 numpy arrays
    in the reference's layout, per-layer leaves stacked under their group's
    name (``STACKED``; bf16 widens to float32 exactly)."""
    named = (model.named_parameters() if isinstance(model, torch.nn.Module)
             else model.items())
    tree: dict = {}
    stacked: dict = {}
    for name, param in named:
        parts = name.split(".")
        arr = param.detach().float().cpu().numpy()
        if parts[0] in STACKED:
            stacked.setdefault((parts[0], *parts[2:]),
                               {})[int(parts[1])] = arr
        else:
            _put(tree, tuple(parts), arr)
    for key, rows in stacked.items():
        _put(tree, key, np.stack([rows[i] for i in range(len(rows))]))
    return tree


def _leaf(tree, path):
    node = tree
    for part in path:
        node = node[part]
    return node


def _put(tree, path, value):
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def _paths(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def tree_from_flat(flat, prefix: str = "param:", model=None) -> dict:
    """``{"<prefix>a/b/c": array}`` (as a golden ``.npz`` stores a
    parameter tree) -> nested dicts ``{"a": {"b": {"c": array}}}``.  With
    ``model``, a top-level leaf stored cut to its leading rows (Whisper's
    32768-row ``dec_pos``, of which a smoke run reads the first few) is
    padded with zeros to the model's shape: rows no run reads."""
    tree: dict = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(flat[key])
    shapes = dict(model.named_parameters()) if model is not None else {}
    for name, leaf in tree.items():
        if name in shapes and not isinstance(leaf, dict):
            rows = shapes[name].shape[0] - leaf.shape[0]
            if rows > 0:
                tree[name] = np.pad(leaf, [(0, rows)] + [(0, 0)] *
                                    (leaf.ndim - 1))
    return tree
