"""Elastic scaling: re-mesh on device-count change.

When hosts join or leave, the job restarts with a new device count N.
``choose_mesh_shape`` picks the (data, model) factorization closest to the
configured model-parallel degree that divides N; the checkpoint manager
then restores states onto the new mesh (leaves are stored whole, so
``restore(..., shardings=...)`` with the new placements is the entire
re-shard).
"""

from __future__ import annotations


def choose_mesh_shape(n_devices: int, preferred_model: int = 16,
                      multi_pod_size: int | None = None):
    """Returns (shape, axis_names) for the largest usable mesh.

    multi_pod_size: devices per pod; when given and n_devices spans
    multiple full pods, a leading 'pod' axis is emitted.
    """
    if multi_pod_size and n_devices > multi_pod_size and \
            n_devices % multi_pod_size == 0:
        pods = n_devices // multi_pod_size
        inner, names = choose_mesh_shape(multi_pod_size, preferred_model)
        return (pods,) + inner, ("pod",) + names

    # largest divisor of n_devices that is <= preferred_model
    model = 1
    for m in range(min(preferred_model, n_devices), 0, -1):
        if n_devices % m == 0:
            model = m
            break
    return (n_devices // model, model), ("data", "model")
