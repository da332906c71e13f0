"""The mesh maker, the process group it may own, and one DTensor op.

``make_mesh`` builds a named ``DeviceMesh`` over the process group.  When
no group exists and the world is one process, it makes one (gloo on the
CPU, NCCL on the card, over an in-process store) and records that it did,
so the caller that asked can destroy it (``destroy_owned_group``).  It
never makes a group for a world larger than one: there the launcher
initialises it (``init_world``, from ``torchrun``'s environment).

``fake_world`` holds a world of n ranks in this one process over torch's
fake process group, for the dry-run (ROADMAP D-entry on the fake group).

``pad`` zero-pads a DTensor where torch 2.11's own rule fails (D47).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

__all__ = ["make_mesh", "init_world", "destroy_owned_group",
           "fake_world", "pad"]

_OWNED = {"group": False}


def pad(x, pads):
    """``F.pad(x, pads)`` with zeros.  A DTensor is padded by concatenating
    zero blocks (replicated) instead: torch 2.11's sharding rule for
    ``constant_pad_nd`` returns a spec with one placement on a 2-D mesh,
    which the next view rejects."""
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(x, pads)
    for i in range(len(pads) // 2):
        dim = x.dim() - 1 - i
        before, after = pads[2 * i], pads[2 * i + 1]
        parts = []
        for n in (before, 0, after):
            if n == 0:
                continue
            shape = list(x.shape)
            shape[dim] = n
            parts.append(torch.zeros(shape, dtype=x.dtype, device=x.device))
        if parts:
            parts.insert(1 if before else 0, x)
            x = torch.cat(parts, dim=dim)
    return x


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_world(device_type: str) -> bool:
    """Initialise the default process group when there is none; True when
    this call made it.  A world of one (no ``WORLD_SIZE`` above 1 in the
    environment) gets an in-process store; a larger world is
    ``torchrun``'s, read from its environment (``env://``)."""
    if dist.is_initialized():
        return False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if world == 1:
        dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                                rank=0, world_size=1)
    else:
        dist.init_process_group(_backend(device_type), init_method="env://")
    _OWNED["group"] = True
    return True


def make_mesh(shape, names, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over the default
    process group.  Without a group, a world of one gets one (recorded for
    ``destroy_owned_group``); a larger world raises."""
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) != 1:
            raise RuntimeError(
                "make_mesh: no process group for a world of "
                f"{os.environ['WORLD_SIZE']} processes; start them with "
                "torchrun and initialise torch.distributed (init_world)")
        init_world(device_type)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def destroy_owned_group() -> bool:
    """Destroy the default process group if ``make_mesh``/``init_world``
    made it; True when it did."""
    if not _OWNED["group"]:
        return False
    _OWNED["group"] = False
    if dist.is_initialized():
        dist.destroy_process_group()
    return True


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks, this process rank 0, over
    torch's fake process group (``torch.testing._internal.distributed.
    fake_pg``): collectives return without moving data, so one process
    can build the production meshes (``launch.mesh.world_size()`` reads
    ``n``) and run a step on meta DTensors.  The group is destroyed on
    exit, also after an error; an existing group raises."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
