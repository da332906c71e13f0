"""Production and host mesh construction.

Defined as functions (never module-level constants), so importing this
module touches no process group or device state.  ``set_up_mesh`` and
``tear_down_mesh`` are the launchers' ``--mesh``.  A torch mesh holds one
process per device: the production meshes need a world of 256 (one pod,
(16, 16) ``("data", "model")``) or 512 processes (two pods, (2, 16, 16)
with ``"pod"``), started by ``torchrun``; the host mesh takes whatever
world there is.
"""

from __future__ import annotations

import math
import os


def world_size() -> int:
    """Processes in the default group, else ``WORLD_SIZE`` (1 unset)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    from repro_torch.distributed.compat import make_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = world_size()
    if n != math.prod(shape):
        raise RuntimeError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh {shape} needs {math.prod(shape)} processes, one per "
            f"device (torchrun); this world has {n}")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(preferred_model: int = 1, device_type: str = "cuda"):
    """Mesh over whatever world exists (tests / single host)."""
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.runtime.elastic import choose_mesh_shape
    shape, names = choose_mesh_shape(world_size(), preferred_model)
    return make_mesh(shape, names, device_type)


def set_up_mesh(kind: str, device) -> None:
    """The launchers' ``--mesh``: join or make the process group
    (``compat.init_world``) and configure the mesh ``kind`` (``host``,
    ``single``, ``multi``) for ``sharding``; ``none`` does nothing."""
    if kind == "none":
        return
    from repro_torch.distributed import compat, sharding
    device_type = device.type
    compat.init_world(device_type)
    if kind == "host":
        sharding.set_mesh(make_host_mesh(device_type=device_type))
    else:
        multi = kind == "multi"
        sharding.set_mesh(make_production_mesh(multi_pod=multi,
                                               device_type=device_type),
                          multi_pod=multi)


def tear_down_mesh() -> None:
    """Forget the mesh and destroy the process group if ``set_up_mesh``
    made it."""
    from repro_torch.distributed import compat, sharding
    sharding.set_mesh(None)
    compat.destroy_owned_group()
