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
    with the per-layer leaves stacked as ``tree["layers"][name]`` of shape
    ``[n_layers, ...]``; they are unstacked into ``model.layers[i]``.  Each
    leaf is cast to its parameter's dtype: numpy has no bfloat16, so a
    caller hands bf16 leaves over as float32, and the cast back is exact.
    Raises ``KeyError``/``ValueError`` on a missing or extra leaf or a shape
    mismatch."""
    used = set()
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            key = ("layers", parts[2])
            arr = np.asarray(tree["layers"][parts[2]])[int(parts[1])]
        else:
            node = tree
            for part in parts:
                node = node[part]
            key, arr = tuple(parts), np.asarray(node)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != "
                             f"{tuple(param.shape)}")
        used.add(key)
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(arr)).to(
                param.dtype))
    leaves = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            leaves.add(path[:2] if path[0] == "layers" else path)
    walk(tree, ())
    if leaves != used:
        raise KeyError(f"reference leaves not in the model: "
                       f"{sorted(leaves - used)}; model parameters not in "
                       f"the tree: {sorted(used - leaves)}")


def tree_from_flat(flat, prefix: str = "param:") -> dict:
    """``{"<prefix>a/b/c": array}`` (as a golden ``.npz`` stores a
    parameter tree) -> nested dicts ``{"a": {"b": {"c": array}}}``."""
    tree: dict = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(flat[key])
    return tree
