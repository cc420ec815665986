"""Column-sharded rank-k Cholesky modification over a ``DeviceMesh``.

Port of ``repro.core.distributed``. A factor too large for one device is
column-sharded over a mesh axis: each rank holds an ``(n, w_loc)`` strip of
columns (a ``DTensor`` sharded on its last dim, the counterpart of JAX's
``P(None, axis)``; ``(B, n, w_loc)`` of every member of a fleet,
``P(None, None, axis)``). The paper's CPU/GPU split maps onto the ranks:

* the *diagonal phase* (serial, O(P² k)) runs on every rank from the
  stacked ``(P+k, P)`` block ``[D_p; V^T_p]``, which its owner contributes
  to one ``all_reduce`` over the axis while the other ranks add zeros (one
  collective per panel; for a fleet one of ``(B, P+k, P)``, never B);
* the *panel phase* is parallel over the shards: each rank transforms the
  rows of its own columns.

Three strategies share that decomposition:

* ``fused`` (default): a *chain phase* runs every diagonal pass (the
  ``diag_block`` kernel) and the evolution of V^T, then ONE
  ``panel_apply_sharded`` launch per shard applies every tile;
* ``gemm`` / ``paper``: per panel, the diagonal pass and one panel apply
  over the local strip (the cascade's kernels, ``kernels/ops.py``).

On CUDA tensors the kernels launch (a rank above 32 runs as ceil(k / 32)
passes, a panel above 256 at its largest divisor of at most 256, as the
other routes do); on CPU tensors their plain versions run. The rank's
device is the mesh's: ``"cuda"`` (the current CUDA device) or ``"cpu"``.
Several ranks may share one card; with the ``gloo`` backend the blocks that
cross between ranks are staged through host memory explicitly.

A tuple ``axis`` linearises its mesh dims row-major in the order it lists
them, as the JAX package does; a ``DTensor`` shards one tensor dim over
several mesh dims in the mesh's own dim order, so a tuple out of that
order shards over the mesh with its dims permuted into the tuple's order
(``_layout``), which is the result's ``device_mesh``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.core.precision import Precision
from repro_torch.kernels.sharded import STRATEGIES

AxisNames = Union[str, Sequence[str]]


# ---------------------------------------------------------------------------
# Mesh helpers: the counterparts of the JAX package's axis_tuple and
# _combined_axis_index, and of placing / gathering a sharded array.
# ---------------------------------------------------------------------------


def axis_tuple(axis: AxisNames):
    """Canonical tuple form of a mesh-axis binding (str, tuple, or list)."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _layout(mesh, axes):
    """``(mesh', dims)``: the mesh to shard ``axes`` over and their dim
    indices in it, ascending. Shards are numbered row-major over ``axes`` in
    the order given (the JAX package's ``_combined_axis_index``), and a
    ``DTensor`` sharded over several mesh dims numbers them in the mesh's
    order; so for a tuple axis out of the mesh's order, ``mesh'`` is the
    mesh with those dims permuted into the axis's order (built once per
    mesh and order: building it creates process groups, a collective every
    rank makes). Raises unless each axis is a distinct dim of ``mesh``."""
    names = tuple(mesh.mesh_dim_names or ())
    missing = [ax for ax in axes if ax not in names]
    if missing or not axes or len(set(axes)) != len(axes):
        raise ValueError(f"axis {axes} must name dims of the mesh, each "
                         f"once; its dims are {names}")
    dims = [names.index(ax) for ax in axes]
    slots = sorted(dims)
    if dims == slots:
        return mesh, dims
    perm = list(range(mesh.ndim))
    for slot, d in zip(slots, dims):
        perm[slot] = d
    return _permuted(mesh, tuple(perm)), slots


@functools.cache
def _permuted(mesh, perm):
    from torch.distributed.device_mesh import DeviceMesh

    names = mesh.mesh_dim_names
    return DeviceMesh(mesh.device_type, mesh.mesh.permute(perm),
                      mesh_dim_names=tuple(names[p] for p in perm))


def n_shards(mesh, axis: AxisNames) -> int:
    """Number of column shards along ``axis`` (a product over a tuple)."""
    mesh, dims = _layout(mesh, axis_tuple(axis))
    return math.prod(mesh.size(d) for d in dims)


def shard_index(mesh, axis: AxisNames) -> int:
    """This rank's shard index along ``axis``: its coordinates on the
    axis's mesh dims, linearised row-major in the axis's order."""
    mesh, dims = _layout(mesh, axis_tuple(axis))
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _placements(mesh, axes, ndim):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(ndim - 1) if name in axes else Replicate()
            for name in mesh.mesh_dim_names]


def is_sharded(x) -> bool:
    """True for a ``DTensor`` (a factor sharded over a mesh)."""
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _staged(op, x, group):
    """Run the in-place collective ``op(x, group=group)``; under ``gloo``
    a CUDA tensor goes through a host copy."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        op(host, group=group)
        x.copy_(host)
    else:
        op(x, group=group)


def _all_reduce(x, mesh, dims, op=None):
    """In-place all_reduce (default SUM) of ``x`` over the mesh dims
    ``dims``: one collective per dim of more than one rank (exact for the
    owner-masked blocks, whose other contributions are zeros)."""
    op = dist.ReduceOp.SUM if op is None else op
    for d in dims:
        if mesh.size(d) > 1:
            _staged(lambda t, group: dist.all_reduce(t, op=op, group=group),
                    x, mesh.get_group(d))


def _all_gather_last(x, mesh, d):
    """Concatenate ``x`` of every rank along mesh dim ``d`` on the last
    tensor dim, in the order of the ranks' coordinates on ``d``."""
    size = mesh.size(d)
    if size == 1:
        return x
    group = mesh.get_group(d)
    src = x.contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1).to(x.device)


def gather(x):
    """The whole tensor of a column-sharded ``DTensor`` on every rank (a
    collective: every rank of the mesh calls it); anything else as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    last = x.ndim - 1
    out = x.to_local()
    for d in reversed(range(mesh.ndim)):
        pl = x.placements[d]
        if isinstance(pl, Shard):
            if pl.dim not in (-1, last):
                raise ValueError(f"gather takes column-sharded tensors, got "
                                 f"placements {x.placements}")
            out = _all_gather_last(out, mesh, d)
        elif not pl.is_replicate():
            raise ValueError(f"gather takes sharded or replicated dims, got "
                             f"placements {x.placements}")
    return out


def place_like(whole, like):
    """``whole`` (the same on every rank) laid out as the ``DTensor``
    ``like``: its mesh and placements, each rank keeping its own part of
    every sharded dim (the mesh's dims taken in order, as a ``DTensor``
    splits them), with no communication. Anything but a ``DTensor``
    ``like`` passes ``whole`` as it is."""
    if not is_sharded(like):
        return whole
    from torch.distributed.tensor import DTensor, Shard

    mesh = like.device_mesh
    loc = whole
    for d, pl in enumerate(like.placements):
        if isinstance(pl, Shard):
            loc = loc.chunk(mesh.size(d), dim=pl.dim)[mesh.get_local_rank(d)]
        elif not pl.is_replicate():
            raise ValueError(f"place_like takes sharded or replicated dims, "
                             f"got placements {like.placements}")
    return DTensor.from_local(loc.contiguous(), mesh, list(like.placements),
                              run_check=False, shape=whole.shape,
                              stride=whole.stride())


def shard(L, mesh, axis: AxisNames = "model"):
    """``L`` column-sharded over ``axis`` of ``mesh``, as a ``DTensor``.

    A whole tensor is the same on every rank (a replicated value, as a
    global array is in JAX): each rank keeps its own columns, with no
    communication. A ``DTensor`` already laid out so passes as it is; one
    laid out otherwise is gathered first."""
    from torch.distributed.tensor import DTensor

    axes = axis_tuple(axis)
    mesh, _ = _layout(mesh, axes)
    want = _placements(mesh, axes, L.ndim)
    if is_sharded(L):
        if L.device_mesh == mesh and list(L.placements) == want:
            return L
        L = gather(L)
    n = L.shape[-1]
    parts = n_shards(mesh, axes)
    if n % parts:
        raise ValueError(f"n={n} must divide over {parts} column shards")
    w = n // parts
    me = shard_index(mesh, axes)
    loc = L.to(mesh_device(mesh))[..., me * w:(me + 1) * w].contiguous()
    full = torch.Size(L.shape)
    return DTensor.from_local(loc, mesh, want, run_check=False, shape=full,
                              stride=torch.empty(full, device="meta").stride())


# ---------------------------------------------------------------------------
# The driver.
# ---------------------------------------------------------------------------


def chol_update_sharded(
    L,
    V,
    *,
    sigma: int = 1,
    mesh,
    axis: AxisNames = "model",
    panel: int = 256,
    strategy: str = "fused",
    lowering: Optional[str] = "auto",
    interpret: Optional[bool] = None,
    precision=None,
):
    """Rank-k up/down-date of a column-sharded factor (or stacked fleet).

    Every rank of the mesh calls it with the same arguments.

    Args:
      L: (n, n) upper factor, a ``DTensor`` sharded on its last dim over
        ``axis`` (a whole tensor is sharded first, ``shard``), or a fleet
        ``(B, n, n)``, each member sharded alike.
      V: (n, k) modification, the same on every rank; ``(B, n, k)`` (or
        ``(B, n)``) for a fleet.
      sigma: +1 / -1.
      mesh: the ``torch.distributed.device_mesh.DeviceMesh`` holding
        ``axis``; its device type is where the ranks compute.
      axis: mesh dim name (or tuple of names) the columns are sharded over.
      panel: row-panel size; must divide the per-rank column count.
      strategy: 'fused' (one ``panel_apply_sharded`` launch per shard,
        default), 'gemm' (per-panel transform GEMM) or 'paper'
        (element-wise).
      lowering: None/'auto'/'portable'/'mosaic' (one kernel; the name
        labels the panel-phase launches).
      interpret: None picks by device; True asks for the plain versions,
        which run on CPU tensors only (on CUDA it raises).
      precision: storage/accum policy (DESIGN.md §8). The shard, the
        running V^T and the gathered blocks move in the storage dtype; the
        gathered blocks are cast to the accumulation dtype BEFORE the
        diagonal pass, which runs there.

    Returns:
      The updated factor, a ``DTensor`` with the same sharding, in the
      storage dtype.
    """
    from repro_torch.core.backends import default_interpret, resolve_lowering
    from repro_torch.kernels._launch import (accum_for, kernel_panel,
                                             rank_groups)

    if sigma not in (1, -1):
        raise ValueError("sigma must be +1 or -1")
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got "
                         f"{strategy!r}")
    lowering = resolve_lowering(lowering)
    precision = Precision.parse(precision)
    axes = axis_tuple(axis)
    mesh, dims = _layout(mesh, axes)
    batched = L.ndim == 3
    n = L.shape[-1]
    V = gather(V)
    if batched:
        if V.ndim == 2:
            V = V[:, :, None]
        if tuple(V.shape[:2]) != (L.shape[0], n):
            raise ValueError(f"V must be (B, n, k) matching L "
                             f"{tuple(L.shape)}, got {tuple(V.shape)}")
    k = V.shape[-1] if V.ndim == L.ndim else 1
    parts = n_shards(mesh, axes)
    if n % parts:
        raise ValueError(f"n={n} must divide over {parts} column shards")
    w_loc = n // parts
    if panel > w_loc or w_loc % panel:
        raise ValueError(f"panel={panel} must divide the per-device column "
                         f"count {w_loc}")
    if n % panel:
        raise ValueError(f"n={n} must be a multiple of panel={panel}")
    Ld = shard(L, mesh, axes)
    L_loc = Ld.to_local()
    dev = L_loc.device
    if interpret is None:
        interpret = default_interpret(dev)
    if dev.type == "cuda" and interpret:
        raise ValueError("interpret=True asks for the plain versions, which "
                         "run only on CPU tensors; use a CPU mesh or drop "
                         "interpret")
    me = shard_index(mesh, axes)
    V = V.reshape(L.shape[:-2] + (n, k)).to(dev)
    if precision is not None:
        L_loc = precision.cast_storage(L_loc)
        V = precision.cast_storage(V)
    accum_dtype = None if precision is None else precision.accum
    acc = accum_for(L_loc.dtype, accum_dtype)
    vt = V.to(L_loc.dtype).mT[..., me * w_loc:(me + 1) * w_loc]
    kw = dict(sigma=sigma, mesh=mesh, dims=dims, w_loc=w_loc, me=me,
              acc=acc)
    if dev.type == "cuda":
        # One launch takes P <= 256 and k <= 32: the panel's divisor, and
        # a full pass per column group of V.
        passes, kp = rank_groups(k), kernel_panel(panel)
    else:
        passes, kp = [slice(0, k)], panel
    for g in passes:
        vt_g = vt[..., g, :].contiguous()
        if strategy == "fused":
            L_loc = _sharded_update_fused(L_loc, vt_g, panel=kp,
                                          lowering=lowering, **kw)
        else:
            L_loc = _sharded_update_perpanel(L_loc.clone(), vt_g, panel=kp,
                                             strategy=strategy, **kw)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(L_loc, mesh, list(Ld.placements),
                              run_check=False, shape=Ld.shape,
                              stride=Ld.stride())


def _gather_diag(L_loc, vt, p, *, panel, w_loc, me, mesh, dims):
    """The stacked ``[D_p; V^T_p]`` block, ``(..., P+k, P)`` in storage,
    on every rank: its owner's copy summed with the others' zeros."""
    k = vt.shape[-2]
    r0 = p * panel
    owner, loc_r0 = divmod(r0, w_loc)
    blk = L_loc.new_zeros(L_loc.shape[:-2] + (panel + k, panel))
    if owner == me:
        blk[..., :panel, :] = L_loc[..., r0:r0 + panel,
                                    loc_r0:loc_r0 + panel]
        blk[..., panel:, :] = vt[..., loc_r0:loc_r0 + panel]
    _all_reduce(blk, mesh, dims)
    return blk


def _chain_phase(L_loc, vt, *, sigma, panel, w_loc, me, mesh, dims, acc):
    """The chain phase of one shard (or fleet shard): per panel the
    diagonal pass on the gathered block (the ``diag_block`` kernel on CUDA)
    and the step of the running V^T. Row panels of L are never written
    here, so every read is of the ORIGINAL factor; the only sequential
    state is vt. Returns ``(T_stack, D_stack, vt_stack)``."""
    from repro_torch.kernels import cholupdate as _k

    lead = L_loc.shape[:-2]
    n_panels = L_loc.shape[-2] // panel
    k = vt.shape[-2]
    pk = panel + k
    # T rows padded to whole 16-byte pieces, which the kernel reads whole.
    T_buf = L_loc.new_empty(lead + (n_panels, pk, -(-pk // 4) * 4),
                            dtype=acc)
    D_stack = L_loc.new_empty(lead + (n_panels, panel, panel), dtype=acc)
    vt_stack = L_loc.new_empty(lead + (n_panels, k, w_loc))
    owned = range(me * w_loc, (me + 1) * w_loc)
    for p in range(n_panels):
        r0 = p * panel
        # The gather moved storage bytes; the diagonal pass runs in the
        # accumulation dtype: upcast before it.
        blk = _gather_diag(L_loc, vt, p, panel=panel, w_loc=w_loc, me=me,
                           mesh=mesh, dims=dims).to(acc)
        D, vtd = blk[..., :panel, :], blk[..., panel:, :]
        _, _, T = _k.diag_block_(D, vtd, sigma=sigma, accum_dtype=acc)
        T_buf[..., p, :, :pk] = T
        D_stack[..., p, :, :] = torch.triu(D)
        vt_stack[..., p, :, :] = vt  # the V^T entering panel p
        R = L_loc[..., r0:r0 + panel, :].to(acc)
        vt = (T[..., panel:, :panel] @ R
              + T[..., panel:, panel:] @ vt.to(acc)).to(vt.dtype)
        if r0 in owned:
            # The block's own columns are annihilated.
            vt[..., r0 - owned.start:r0 - owned.start + panel] = 0
    return T_buf[..., :pk], D_stack, vt_stack


def _sharded_update_fused(L_loc, vt, *, sigma, panel, w_loc, me, mesh, dims,
                          acc, lowering):
    """Chain phase, then the whole panel phase in ONE launch per shard."""
    from repro_torch.kernels import sharded as _sharded

    T_stack, D_stack, vt_stack = _chain_phase(
        L_loc, vt, sigma=sigma, panel=panel, w_loc=w_loc, me=me, mesh=mesh,
        dims=dims, acc=acc)
    return _sharded.panel_apply_sharded(
        L_loc, T_stack, D_stack, vt_stack, tile_off=me * (w_loc // panel),
        panel=panel, accum_dtype=acc, interpret=not L_loc.is_cuda,
        lowering=lowering)


def _sharded_update_perpanel(L_loc, vt, *, sigma, panel, w_loc, me, mesh,
                             dims, strategy, acc):
    """Per panel: the diagonal pass on the gathered block, one panel apply
    over the local strip (the cascade's hooks, in place), and the stitch of
    the block's own columns. Finalized columns hold zeros in the active
    rows, which every apply maps to zeros, so every rank does the same
    work."""
    from repro_torch.kernels import ops as _ops

    diag_fn, apply_fn = _ops._hooks(strategy, 512, acc)
    n_panels = L_loc.shape[-2] // panel
    for p in range(n_panels):
        r0 = p * panel
        owner, loc_r0 = divmod(r0, w_loc)
        blk = _gather_diag(L_loc, vt, p, panel=panel, w_loc=w_loc, me=me,
                           mesh=mesh, dims=dims).to(acc)
        D, c, s, T = diag_fn(blk[..., :panel, :], blk[..., panel:, :],
                             sigma)
        apply_fn(L_loc[..., r0:r0 + panel, :], vt, c, s, T, sigma)
        if owner == me:
            L_loc[..., r0:r0 + panel, loc_r0:loc_r0 + panel] = torch.triu(D)
            vt[..., loc_r0:loc_r0 + panel] = 0
    return L_loc


def _owned_diagonal(L, mesh, axes):
    """The diagonal entries of the columns this rank owns of the sharded
    factor ``L``, ``(..., w_loc)``, read shard-locally (``mesh`` laid out
    by ``_layout``)."""
    loc = shard(L, mesh, axes).to_local()
    w = loc.shape[-1]
    j = torch.arange(w, device=loc.device)
    return loc[..., shard_index(mesh, axes) * w + j, j]


def diagonal(L, *, mesh, axis: AxisNames = "model"):
    """The diagonal of the sharded factor ``L`` (per fleet member) on every
    rank: each rank reads the entries of its own columns, and one
    ``all_gather`` per mesh dim of the axis joins them, O(n) bytes; the
    factor itself is never gathered."""
    axes = axis_tuple(axis)
    mesh, dims = _layout(mesh, axes)
    d = _owned_diagonal(L, mesh, axes)
    # Innermost dim first: the shard index is row-major over the dims.
    for dim in reversed(dims):
        d = _all_gather_last(d, mesh, dim)
    return d


def diag_verdict(L, *, mesh, axis: AxisNames = "model"):
    """Per fleet member (or scalar): every diagonal entry of the sharded
    factor ``L`` finite and positive. Each rank checks the entries of the
    columns it owns; a MIN all_reduce over the axis makes one verdict."""
    axes = axis_tuple(axis)
    mesh, dims = _layout(mesh, axes)
    d = _owned_diagonal(L, mesh, axes)
    ok = (torch.isfinite(d) & (d > 0)).all(dim=-1).to(torch.int32)
    _all_reduce(ok, mesh, dims, op=dist.ReduceOp.MIN)
    return ok.bool()


def where_sharded(ok, new, old, *, mesh, axis: AxisNames = "model"):
    """``new`` where ``ok`` (per fleet member) else ``old``, shard by
    shard; both are sharded alike first."""
    from torch.distributed.tensor import DTensor

    mesh, _ = _layout(mesh, axis_tuple(axis))
    new, old = shard(new, mesh, axis), shard(old, mesh, axis)
    mask = ok[..., None, None] if new.ndim == 3 else ok
    loc = torch.where(mask, new.to_local(), old.to_local())
    return DTensor.from_local(loc, mesh, list(new.placements),
                              run_check=False, shape=new.shape,
                              stride=new.stride())
