"""Mesh construction, PyTorch port.

``make_production_mesh`` is a function (never a module-level constant), so
importing this module touches no process group. The JAX package's
production meshes are TPU v5e pods: 16×16 (``data``, ``model``) and
2×16×16 (``pod``, ``data``, ``model``). Here a mesh is a ``DeviceMesh``
over the ranks of the process group, so the same shapes need 256 (or
512) ranks, and raise in a world of another size. The dry run builds them
in one process as rank 0 of a fake world of that size
(``runtime.compat.init_fake_world``).

On H100s the shapes keep their names and sizes (the sharding rules,
``dryrun._local_bytes`` and ``analysis.analytic_memory_bytes`` read
them): 256 cards are 32 DGX nodes of 8, and the 16-wide ``model`` axis
(the inner one, consecutive ranks) spans two 8-card NVLink nodes, so its
collectives cross InfiniBand (``analysis.LINK_BW``); ``data`` (and
``pod``) run between nodes.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.runtime.compat import ensure_host_devices, make_mesh_compat


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The 16x16 (or 2x16x16) mesh over a process group of 256 (or 512)
    ranks; raises ``ValueError`` in a smaller world (a process without a
    group is a world of one)."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks, this world has {world}")
    return make_mesh_compat(shape, axes, device_type=device_type)


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              *, device_type: Optional[str] = None):
    """Arbitrary mesh (elastic restarts re-mesh through this). A mesh of
    one rank starts a one-rank process group where none exists
    (``runtime.compat.ensure_host_devices``)."""
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    if math.prod(shape) == 1:
        ensure_host_devices(1)
    return make_mesh_compat(shape, axes, device_type=device_type)


def single_device_mesh(*, device_type: Optional[str] = None):
    return make_mesh((1, 1), ("data", "model"), device_type=device_type)
