"""Logical-axis -> mesh-axis lowering (DP / FSDP / TP / EP policies),
PyTorch port: the same rules, lowered to ``DTensor`` placements.

Every parameter carries a tuple of logical axis names (models/layers.py).
``logical_to_spec`` lowers one to the placements of a ``DeviceMesh``: one
``Shard(dim)`` or ``Replicate()`` per mesh dim, the mesh dims in the
mesh's order (so a tensor dim sharded over ``('pod', 'data')`` is split
over pod first, as the JAX package's ``PartitionSpec`` splits it). A
dimension whose size does not divide the mesh axes it is given is
replicated instead, and the event recorded (the 24-head llama3.2 /
56-head arctic exceptions).

Policies:
* TP   — 'heads', 'kv_heads', 'mlp', 'expert_mlp', 'vocab', 'heads_mlp'
         shard over the model axis.
* EP   — 'experts' shards over the model axis; when the expert count does
         not divide (mixtral 8e), experts replicate and 'expert_mlp' still
         shards (TP-within-expert).
* FSDP — with ``cfg.fsdp``, the 'embed' axis of weight matrices shards
         over the data axes.
* DP   — batch shards over ('pod', 'data').

A mesh is a ``DeviceMesh`` (its ``mesh_dim_names`` are the axes) or any
object whose ``shape`` is a dict {axis: size} in mesh order (the tests'
``FakeMesh``). ``partition_spec`` maps placements back to the JAX
package's ``PartitionSpec`` entries, so that the two can be compared.

``set_batch_axes`` and ``constrain_batch_dim`` are the JAX package's
layout hints to XLA's sharding propagation inside the model code. Here
``constrain_batch_dim`` places a ``DTensor`` explicitly (batch on the
ambient batch axes, every other mesh axis replicated) and returns a plain
tensor unchanged, as the JAX function does without a mesh in context;
``gather_dims`` places an operand before a reshape ``DTensor`` cannot
propagate through a sharded dim.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

# logical axis -> role
_TP_AXES = ("heads", "kv_heads", "mlp", "expert_mlp", "vocab", "heads_mlp")
_EP_AXES = ("experts",)
_FSDP_AXES = ("embed",)

_BATCH_AXES: Tuple[str, ...] = ("data",)


def set_batch_axes(axes: Tuple[str, ...]):
    """Record the ambient batch axes (read by nothing in the port: see the
    module docstring)."""
    global _BATCH_AXES
    _BATCH_AXES = tuple(axes)


def constrain_dims(x, dim_axes):
    """An XLA layout hint in the JAX package, which nothing in the models
    calls; the identity here."""
    del dim_axes
    return x


def constrain_batch_dim(x, dim: int, keep=()):
    """Pin dimension ``dim`` of a ``DTensor`` to the ambient batch axes
    (``set_batch_axes``), as the JAX package pins it with
    ``with_sharding_constraint``: ``Shard(dim)`` on each batch mesh axis,
    every other mesh axis replicated (a partial sum reduced, any other
    shard gathered) but where it shards one of the dims ``keep``.
    ``DTensor`` has no "unconstrained" placement to leave the other axes
    to, and its greedy propagation, left alone, turns a partial sum into a
    shard of whatever dim is cheapest (the sequence, the embedding), which
    later ops cannot propagate; ``keep`` names the dims whose shards the
    caller takes as they come (the loss's vocabulary). A plain tensor, a
    dim the batch axes do not divide, or no ambient axes on the tensor's
    mesh: returned as it is (the JAX function's no-op without a mesh)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names or ()
    axes = [a for a in _BATCH_AXES if a in names]
    sizes = dict(zip(names, tuple(x.device_mesh.shape)))
    size = 1
    for a in axes:
        size *= sizes[a]
    if not axes or x.shape[dim] % size:
        return x
    kept = {d % x.ndim for d in keep}
    pls = tuple(Shard(dim % x.ndim) if a in axes
                else pl if type(pl) is Shard and pl.dim % x.ndim in kept
                else Replicate() for a, pl in zip(names, x.placements))
    if tuple(x.placements) == pls:
        return x
    return x.redistribute(x.device_mesh, pls)


def _shards(pl) -> bool:
    """True for a placement that splits a tensor dim: ``Shard``, or the
    strided shard a reshape of a sharded dim leaves (not a ``Shard``
    subclass in every torch)."""
    return isinstance(pl, Shard) or (type(pl).__name__ == "_StridedShard"
                                     and hasattr(pl, "dim"))


def sharded_dims(x) -> set:
    """The dims a ``DTensor`` shards (none for a plain tensor)."""
    return {pl.dim % x.ndim for pl in getattr(x, "placements", ())
            if _shards(pl)}


def gather_dims(x, dims):
    """``x`` with none of ``dims`` sharded: a ``DTensor`` sharded on one
    of them (``Shard`` or a strided shard left by a reshape) is
    redistributed to replicate over those mesh dims, every other placement
    kept; a plain tensor is returned as it is. The model code places its
    operands so before a reshape that ``DTensor`` cannot propagate through
    a sharded dim (splitting the sequence into attention blocks)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    pls = [Replicate() if _shards(pl) and pl.dim in dims else pl
           for pl in x.placements]
    if pls == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pls)


def reduce_partial(x):
    """``x`` with every partial placement reduced (replicated over its
    mesh dims), the shards kept; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    pls = [Replicate() if pl.is_partial() else pl for pl in x.placements]
    if pls == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pls)


def add_rows_replicated(buf, index, src):
    """``buf.index_add(0, index, src)`` for ``DTensor`` ``index`` / ``src``
    (``buf`` plain): both gathered whole and reduced, the add run on the
    local tensors, the result a replicated ``DTensor`` on their mesh
    (differentiable through ``to_local`` / ``from_local``)."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        return reduce_partial(gather_dims(t, range(t.ndim)))

    index, src = whole(index), whole(src)
    mesh = src.device_mesh
    out = buf.to(src.to_local().device).index_add(
        0, index.to_local(), src.to_local())
    return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _GatherGrad(torch.autograd.Function):
    """Autograd identity whose backward gathers dims of the gradient (and,
    with ``reduce``, reduces its partial sums)."""

    @staticmethod
    def forward(ctx, x, dims, reduce):
        ctx.dims, ctx.reduce = dims, reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = gather_dims(g, ctx.dims)
        return (reduce_partial(g) if ctx.reduce else g), None, None


class _PlaceGrad(torch.autograd.Function):
    """Autograd identity whose backward places the gradient as the input
    was placed."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def place_grad_like(x):
    """``x``, whose gradient (a ``DTensor``) reaches the ops before this
    point placed as ``x`` is: where a reduction's backward hands back a
    gradient replicated over a dim that ``x`` shards, it is sliced to the
    shards locally before an elementwise backward would gather ``x``'s
    operands instead. A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _PlaceGrad.apply(x)


def gather_grad_dims(x, dims, *, reduce: bool = False):
    """``x``, whose gradient (a ``DTensor``) reaches the ops before this
    point with none of ``dims`` sharded (``gather_dims`` in the backward)
    and, with ``reduce``, no partial sum left (``reduce_partial``): where
    an earlier op's backward cannot place the gradient as it arrives (a
    reshape's backward splitting a sharded dim). A plain tensor is
    returned as it is."""
    from torch.distributed.tensor import DTensor

    dims = tuple(dims)
    if not isinstance(x, DTensor) or not x.requires_grad or not (
            dims or reduce):
        return x
    return _GatherGrad.apply(x, dims, reduce)


def _view_groups(src, dst):
    """The groups of a reshape from ``src`` to ``dst``: (input dims, output
    dims) pairs, each the fewest contiguous dims of equal product."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        ins, outs, pi, pj = [], [], 1, 1
        if i < len(src):
            ins.append(i)
            pi, i = src[i], i + 1
        if j < len(dst):
            outs.append(j)
            pj, j = dst[j], j + 1
        while pi != pj:
            if pi < pj:
                ins.append(i)
                pi, i = pi * src[i], i + 1
            else:
                outs.append(j)
                pj, j = pj * dst[j], j + 1
        groups.append((ins, outs))
    return groups


def reshape_gathers(x, shape) -> set:
    """The dims of ``DTensor`` ``x`` that ``reshape(x, shape)`` gathers: a
    sharded dim that the reshape merges behind another dim, or splits with
    a first factor its shards do not divide (32 heads over a 16-wide axis
    into 8 KV groups of 4), or a strided shard in any dim the reshape
    changes. Every other shard stays and moves to its output dim, which
    every torch places with no collective."""
    n_of, strided = {}, set()
    for n, pl in zip(x.device_mesh.shape, x.placements):
        if _shards(pl):
            d = pl.dim % x.ndim
            n_of[d] = n_of.get(d, 1) * n
            if type(pl) is not Shard:
                strided.add(d)
    gather = set()
    for ins, outs in _view_groups(tuple(x.shape), tuple(shape)):
        ins = [d for d in ins if x.shape[d] != 1]
        outs = [d for d in outs if shape[d] != 1]
        if len(ins) == 1 and len(outs) == 1:
            continue
        for d in ins:
            if d in n_of and (d in strided or d != ins[0]
                              or x.shape[d] % n_of[d]
                              or shape[outs[0]] % n_of[d]):
                gather.add(d)
    return gather


def reshape(x, shape):
    """``x.reshape(shape)``; a ``DTensor`` first gathers the dims of
    ``reshape_gathers``, so that its view has one placement in every
    torch; a plain tensor reshapes as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return gather_dims(x, reshape_gathers(x, shape)).reshape(shape)


def axis_sizes(mesh) -> dict:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or of a mesh
    whose ``shape`` is already that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _mesh_axes_size(mesh, names: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for name in names:
        n *= sizes[name]
    return n


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def model_axes(mesh) -> Tuple[str, ...]:
    return ("model",) if "model" in axis_sizes(mesh) else ()


def _placements(dims, mesh) -> tuple:
    """Placements (one per mesh dim) from ``dims``: each tensor dim's
    tuple of mesh axes (empty for replicated)."""
    shard_of = {}
    for d, axes in enumerate(dims):
        for a in axes:
            shard_of[a] = d
    return tuple(Shard(shard_of[a]) if a in shard_of else Replicate()
                 for a in axis_sizes(mesh))


def logical_to_spec(
    axes: Tuple[Optional[str], ...],
    shape: Tuple[int, ...],
    mesh,
    *,
    fsdp: bool = False,
    policy: str = "tp",
    notes: Optional[list] = None,
) -> tuple:
    """Lower one parameter's logical axes to placements on ``mesh``.

    policy='tp' (default): TP/EP over the model axis, optional FSDP over
    the data axes. policy='dp': no TP — every device is a data shard and
    params fully shard (ZeRO-3) over data+model.
    """
    tp = model_axes(mesh)
    dp = data_axes(mesh)
    if policy == "dp":
        tp = ()
        dp = data_axes(mesh) + model_axes(mesh)
        fsdp = True
    dims = []
    used = set()
    for ax, dim in zip(axes, shape):
        assign: Tuple[str, ...] = ()
        if ax in _TP_AXES or ax in _EP_AXES:
            assign = tp
        elif ax in _FSDP_AXES and fsdp:
            assign = dp
        if assign and any(a in used for a in assign):
            assign = ()  # one mesh axis may shard only one tensor dim
        if assign:
            size = _mesh_axes_size(mesh, assign)
            if dim % size != 0:
                if notes is not None:
                    notes.append((ax, dim, size))
                assign = ()
        dims.append(assign)
        used.update(assign)
    return _placements(dims, mesh)


def partition_spec(placements, mesh, ndim: int) -> tuple:
    """The JAX package's ``PartitionSpec`` entries of ``placements``: per
    tensor dim None, an axis name, or a tuple of names (mesh order)."""
    dims = [[] for _ in range(ndim)]
    for name, pl in zip(axis_sizes(mesh), placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d))
                 for d in dims)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _map2(fn, axes_tree, values_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree, values_tree)
    return {k: _map2(fn, axes_tree[k], values_tree[k]) for k in axes_tree}


def param_specs(axes_tree, values_tree, mesh, *, fsdp=False, policy="tp"):
    """Placements for a whole parameter tree (the JAX package's values
    tree and its axes tree); returns (specs_tree, notes)."""
    notes: list = []
    specs = _map2(lambda a, v: logical_to_spec(
        a, tuple(v.shape), mesh, fsdp=fsdp, policy=policy, notes=notes),
        axes_tree, values_tree)
    return specs, notes


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of one tensor on it (the JAX package's
    ``NamedSharding``)."""
    mesh: object
    placements: tuple

    def place(self, x):
        """``x`` (a tensor, or a ``DTensor`` gathered whole first) as a
        ``DTensor`` with these placements."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(x, DTensor):
            x = x.full_tensor()
        return distribute_tensor(x.to(self.mesh.device_type), self.mesh,
                                 list(self.placements))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_shardings(axes_tree, values_tree, mesh, *, fsdp=False):
    specs, notes = param_specs(axes_tree, values_tree, mesh, fsdp=fsdp)
    return _tree_map(lambda s: NamedSharding(mesh, s), specs), notes


def batch_spec(mesh, ndim: int, *, batch_axis: int = 0) -> tuple:
    """Shard the batch dimension over the data axes, rest replicated."""
    dims = [()] * ndim
    dims[batch_axis] = data_axes(mesh)
    return _placements(dims, mesh)


#: Cache array name -> (batch axis index, head axis index or None).
_CACHE_DIMS = {
    "k": (1, 3), "v": (1, 3), "xk": (1, 3), "xv": (1, 3),
    "sk": (1, 3), "sv": (1, 3),
    "shift_t": (1, None), "shift_c": (1, None),
    "S": (1, 2), "h": (1, 2), "conv": (1, None),
}


def cache_specs(cache_tree, cfg, mesh):
    """Decode-cache placements: batch over the data axes when divisible,
    KV heads over the model axis; SSM states: heads over model. Replicate
    otherwise."""
    del cfg
    tp = model_axes(mesh)
    dp = data_axes(mesh)
    dp_size = _mesh_axes_size(mesh, dp) if dp else 1
    tp_size = _mesh_axes_size(mesh, tp) if tp else 1

    def spec_for(name, leaf):
        dims = [()] * leaf.ndim
        if leaf.ndim and name in _CACHE_DIMS:
            b_ax, h_ax = _CACHE_DIMS[name]
            if dp and leaf.shape[b_ax] % dp_size == 0:
                dims[b_ax] = dp
            if h_ax is not None and tp and leaf.shape[h_ax] % tp_size == 0:
                dims[h_ax] = tp
        return _placements(dims, mesh)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec_for(name, tree)

    return walk(cache_tree, "")
