"""Mesh construction and local multi-rank runs, PyTorch port.

Port of the parts of ``repro.runtime.compat`` the sharded placement needs:

* ``make_mesh_compat(shape, axes)``, the counterpart of
  ``jax.make_mesh``: a ``DeviceMesh`` of the given shape and dim names over
  the process group that already exists. JAX builds a mesh over the
  devices it sees and fails loudly when their count does not match; here
  the ranks of the group are the devices, and a world size other than
  the product of ``shape`` raises.
* ``run_gloo_ranks(n, target, args)``, the counterpart of
  ``ensure_host_devices``: where JAX emulates ``n`` host devices in one
  process, the port starts ``n`` processes, each a rank of a ``gloo``
  process group that meets at a ``file://`` store in a fresh temporary
  directory (never a TCP port), and runs ``target(*args)`` on each.
"""
from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str], *,
                     device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over the
    default process group, which must exist and hold exactly
    ``prod(shape)`` ranks. ``device_type``: 'cuda' or 'cpu' (default
    CUDA, which must exist)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh_compat{shape} needs a process group: call "
            "torch.distributed.init_process_group (or run_gloo_ranks) first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a mesh of shape {shape} needs {math.prod(shape)} ranks, the "
            f"process group has {world}: pass mesh= to restore onto another "
            "layout")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device_type='cpu' for a mesh of CPU "
                "ranks")
        device_type = "cuda"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


#: Seconds a rank waits for the others to join and at each collective.
PG_TIMEOUT_S = 120.0


def _gloo_rank(rank: int, n: int, store: str, target, args) -> None:
    """One spawned rank: join the group, run ``target(*args)``, leave.
    Ranks above 0 print nothing to stdout (errors still reach stderr)."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(0)  # ranks on one host share its card
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=n, rank=rank,
                                timeout=timedelta(seconds=PG_TIMEOUT_S))
        try:
            target(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()


def run_gloo_ranks(n: int, target, args=(), *,
                   timeout: float = 600.0) -> None:
    """Run ``target(*args)`` on ``n`` gloo ranks (spawned processes; see
    the module docstring). ``target`` must be importable by the children
    (a module-level function); it reads its rank from
    ``torch.distributed.get_rank()``. Only rank 0 prints to stdout. Waits
    at most ``timeout`` seconds, stops every process it started, and
    raises ``RuntimeError`` with the exit codes unless every rank exited
    0."""
    import multiprocessing

    d = tempfile.mkdtemp(prefix="repro_torch_gloo_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, n, os.path.join(d, "store"), target,
                               tuple(args)))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(d, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if codes != [0] * n:
        raise RuntimeError(f"gloo ranks exited with {codes}")
