"""Mesh construction, local multi-rank runs and feature detection,
PyTorch port of ``repro.runtime.compat``.

The JAX package's policy holds (DESIGN.md §6): feature-detect, never
version-parse; degrade to the old default; one choke point for meshes.

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
* ``ensure_host_devices(n)``: a process group of ``n`` ranks for this
  process: where none exists and ``n == 1``, a one-rank group (``gloo``
  over an in-memory store); ``n`` ranks in one process do not exist in
  torch, so more raises (start them with ``run_gloo_ranks``).
* ``init_fake_world(n)``, the counterpart of the dry run's
  ``--xla_force_host_platform_device_count=512``: this process becomes
  rank 0 of a process group of ``n`` ranks whose collectives move
  nothing (torch's ``fake`` backend), so the production meshes can be
  built, and a step traced on them, in one process.
* ``HAS_AXIS_TYPE``, ``mesh_axis_types_kwargs`` and ``shard_map_norep``:
  the names of JAX features, kept with their torch meaning in their
  docstrings.
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

#: Seconds a rank waits for the others to join and at each collective.
PG_TIMEOUT_S = 120.0

#: JAX's ``AxisType`` (explicit/auto sharding per mesh axis) has no torch
#: counterpart: every ``DeviceMesh`` dim behaves as JAX's old implicit
#: default (placements are explicit per tensor, nothing is propagated).
HAS_AXIS_TYPE = False
AXIS_TYPE_AUTO = None

def mesh_axis_types_kwargs(n_axes: int) -> dict:
    """kwargs marking ``n_axes`` mesh axes as Auto where supported: ``{}``
    always, since ``init_device_mesh`` takes no axis types (see
    ``HAS_AXIS_TYPE``)."""
    del n_axes
    return {}


def shard_map_norep(f, *, mesh, in_specs, out_specs):
    """``f`` run on each rank's local shards: torch's ``local_map``
    (``in_specs`` / ``out_specs`` as placements), where this torch has it.
    JAX's replication checker, which the name turns off, has no torch
    counterpart. Raises ``NotImplementedError`` on a torch without
    ``local_map``."""
    try:
        from torch.distributed.tensor.experimental import local_map
    except ImportError:
        raise NotImplementedError(
            "this torch has no torch.distributed.tensor.experimental."
            "local_map") from None
    return local_map(f, out_placements=out_specs, in_placements=in_specs,
                     device_mesh=mesh)


def ensure_host_devices(n: int) -> bool:
    """Make sure this process is a rank of a process group of ``n`` ranks
    (the JAX function makes ``n`` host devices visible by a re-exec). With
    no group and ``n == 1`` it starts a one-rank ``gloo`` group over an
    in-memory store (no file, no port) and returns True (the caller may
    ``destroy_process_group`` it); with a group of ``n`` ranks it
    returns False; anything else raises (``run_gloo_ranks`` starts ``n``
    ranks)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != n:
            raise RuntimeError(f"the process group has {world} ranks, not "
                               f"{n}")
        return False
    if n != 1:
        raise RuntimeError(
            f"{n} ranks need {n} processes: start them with run_gloo_ranks "
            "(or torch.distributed.init_process_group in each)")
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0, timeout=timedelta(seconds=PG_TIMEOUT_S))
    return True


def init_fake_world(n: int) -> None:
    """Make this process rank 0 of a process group of ``n`` ranks on
    torch's ``fake`` backend (``torch.testing._internal.distributed.
    fake_pg``): every collective returns at once and moves no data, so a
    ``DeviceMesh`` of ``n`` ranks, and meta-device ``DTensor``s on it,
    exist in one process. Nothing computed under it may be read as a
    number: a collective's result holds whatever its input held (or
    nothing, on the meta device). What it is for is shapes, placements,
    the operations a rank runs and the collectives it issues.

    A process holds one default group, so this raises where one exists
    (start the fake world in a process of its own), and raises where this
    torch has no ``fake`` backend: it never goes on with a smaller
    world. Feature-detected (DESIGN.md §6): the backend must register
    under the name ``fake``."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "this process already holds a process group of "
            f"{dist.get_world_size()} ranks: run the fake world of {n} "
            "ranks in a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError:
        FakeStore = None
    if FakeStore is None or "fake" not in dist.Backend.backend_list:
        raise RuntimeError(
            "this torch has no 'fake' process-group backend "
            "(torch.testing._internal.distributed.fake_pg): a fake world of "
            f"{n} ranks cannot be built")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))


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
