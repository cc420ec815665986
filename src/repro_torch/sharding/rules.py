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

The model code places its model-parallel products itself, where
``DTensor`` would place them op by op: each row-parallel output is
all-reduced once (``reduce_rows``) and the input gradient of the
column-parallel products once (``copy_to_columns``); attention runs rank
by rank on local tensors (``local_attention``, with
``kv_heads_for_queries`` / ``repeat_kv_heads`` for KV heads the model axis
does not divide); the MoE's expert-parallel dispatch gathers rows
(``all_gather_rows``, ``whole_rows``) and sums its partial outputs into
the token shards (``sum_into``).
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


def gather_dims(x, dims, mesh_dims=None):
    """``x`` with none of ``dims`` sharded: a ``DTensor`` sharded on one
    of them (``Shard`` or a strided shard left by a reshape) is
    redistributed to replicate over those mesh dims (only over
    ``mesh_dims`` where given), every other placement kept; a plain
    tensor is returned as it is. The model code places its operands so
    before a reshape that ``DTensor`` cannot propagate through a sharded
    dim (splitting the sequence into attention blocks)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    pls = [Replicate() if _shards(pl) and pl.dim in dims
           and (mesh_dims is None or i in mesh_dims) else pl
           for i, pl in enumerate(x.placements)]
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


class _ReduceRows(torch.autograd.Function):
    """Megatron's conjugate ``g``: the forward all-reduces the partial
    sums, the backward hands the (replicated) gradient back as it is, each
    summand's gradient being the sum's."""

    @staticmethod
    def forward(ctx, x):
        return reduce_partial(x)

    @staticmethod
    def backward(ctx, g):
        return g


def reduce_rows(y):
    """The output of a row-parallel product (``wo`` of an attention or an
    MLP: its contraction sharded over the model axis, so a ``DTensor``
    ``Partial`` sum) all-reduced once, here, and no later op left to place
    the sum; its backward is the identity (``_ReduceRows``). Its partner
    at the input of the column-parallel products is ``copy_to_columns``.
    A plain tensor, or one with no partial sum, is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(y, DTensor) or not any(
            pl.is_partial() for pl in y.placements):
        return y
    if not (torch.is_grad_enabled() and y.requires_grad):
        return reduce_partial(y)
    return _ReduceRows.apply(y)


def copy_to_columns(x):
    """``x``, the input of column-parallel products (the q/k/v projections,
    an MLP's gate and up products), as it is; in the backward the partial
    sums the products' input gradients leave over the model axis are
    all-reduced once, here (Megatron's conjugate ``f``: forward identity,
    backward all-reduce; ``_GatherGrad``). A plain tensor is returned as
    it is."""
    return gather_grad_dims(x, (), reduce=True)


def _global_shape(local, mesh, placements):
    shape = list(local.shape)
    for n, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            shape[pl.dim % len(shape)] *= n
    return torch.Size(shape)


def from_local(local, mesh, placements):
    """``local`` (even shards) as a ``DTensor`` with ``placements``: no
    check, no collective."""
    from torch.distributed.tensor import DTensor

    local = local.contiguous()
    shape = _global_shape(local, mesh, placements)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=shape, stride=stride)


def _head_plan(q, hq, n_kv):
    """Where ``q``'s dim ``hq`` (H query heads reading ``n_kv`` KV heads,
    query head h reading h // (H // n_kv)) is ``Shard`` over one mesh dim
    that the KV heads do not divide: (that mesh dim, its size, the first
    KV head this rank's query heads read, the number of distinct KV heads
    a rank takes, the local query heads' indices into them or None where
    they fall in equal consecutive groups). None elsewhere."""
    H = q.shape[hq]
    dims = [i for i, pl in enumerate(q.placements)
            if isinstance(pl, Shard) and type(pl) is Shard
            and pl.dim % q.ndim == hq % q.ndim]
    if len(dims) != 1:
        return None
    i = dims[0]
    n = q.device_mesh.shape[i]
    if H % n or n_kv % n == 0 or H % n_kv:
        return None
    G, H_loc = H // n_kv, H // n
    first = lambda c: (c * H_loc) // G
    n_d = max((c * H_loc + H_loc - 1) // G - first(c) + 1 for c in range(n))
    c = q.device_mesh.get_local_rank(i)
    lo = min(first(c), n_kv - n_d)
    idx = [(c * H_loc + j) // G - lo for j in range(H_loc)]
    grouped = H_loc % n_d == 0 and idx == [j // (H_loc // n_d)
                                           for j in range(H_loc)]
    return i, n, lo, n_d, (None if grouped else idx)


def kv_heads_for_queries(q, w, hq=2):
    """The KV heads' projection weight ``w`` (D, KV, Dh), KV heads
    replicated, for queries ``q`` whose H heads (dim ``hq``) are sharded
    over a mesh dim that the KV heads do not divide (2 KV heads of reduced
    llama3.2-3b on a 4-wide model axis, 8 of gemma2-9b on 16): a
    ``DTensor`` (D, n·n_d, Dh) sharded on its heads over that dim, rank c
    holding the n_d distinct KV heads its own query heads read, sliced
    from its replica of ``w`` (no data moves; the gradient is a partial
    sum over the dim, summed into the replicated weight). Project with it,
    then ``repeat_kv_heads`` repeats the projected heads to the query
    heads. Where every rank reads every KV head (the one MQA head of
    granite-20b), the ranks split each head's columns instead (``w``
    sharded on its dim 2, a local slice): gather the projection's last dim
    before its RoPE. None where it does not apply (a plain tensor, KV
    heads that divide, query heads that do not): project with ``w``
    itself."""
    from torch.distributed.tensor import DTensor, Partial

    if not (isinstance(q, DTensor) and isinstance(w, DTensor)):
        return None
    plan = _head_plan(q, hq, w.shape[1])
    if plan is None or not w.placements[plan[0]].is_replicate():
        return None
    i, n, lo, n_d, _ = plan
    if n_d == w.shape[1] and w.shape[2] % n == 0:
        pls = [Shard(2) if j == i else pl for j, pl in enumerate(w.placements)]
        return w.redistribute(w.device_mesh, pls)
    grad_pls = [Partial() if j == i else pl
                for j, pl in enumerate(w.placements)]
    local = w.to_local(grad_placements=grad_pls).narrow(1, lo, n_d)
    pls = [Shard(1) if j == i else pl for j, pl in enumerate(w.placements)]
    return from_local(local, w.device_mesh, pls)


def repeat_kv_heads(k, q, n_kv, hk=2):
    """``k`` projected with ``kv_heads_for_queries`` (its dim ``hk`` the
    n·n_d distinct heads of the ranks), each rank's heads repeated to its
    own query heads: a ``DTensor`` of ``q``'s H heads on dim ``hk``,
    sharded as ``q``'s (query head h holding KV head h // (H // n_kv)), so
    that attention runs as multi-head attention on each rank's heads. Its
    gradient sums the repeats. A ``k`` that holds every KV head on every
    rank (their columns split and gathered) is repeated the same way, its
    gradient a partial sum over the dim."""
    from torch.distributed.tensor import Partial

    i, n, lo, n_d, idx = _head_plan(q, hk, n_kv)
    H_loc = q.shape[hk] // n
    pls = list(k.placements)
    if pls[i].is_replicate():
        local = k.to_local(grad_placements=[
            Partial() if j == i else pl for j, pl in enumerate(pls)])
        pls[i] = Shard(hk % k.ndim)
    else:
        local = k.to_local()
    if idx is None:
        local = local.repeat_interleave(H_loc // n_d, dim=hk)
    else:
        local = local.index_select(hk, torch.tensor(idx, device=local.device))
    return from_local(local, k.device_mesh, pls)


def local_attention(fn, q, kvs, *, hq, hk, bq=0, bk=0, sq=None):
    """``fn(q, *kvs)``, an attention that is independent across batch rows
    (dim ``bq`` of ``q``, ``bk`` of each of ``kvs``) and query heads (dim
    ``hq`` of ``q``: H heads reading the KV heads of dim ``hk`` of
    ``kvs`` in groups), run on a mesh rank by rank on the rank's own rows
    and query heads, as the JAX package's attention runs once XLA has
    placed it: ``DTensor`` places no op of it. ``q`` keeps its shards of
    batch and heads (every other dim gathered, partial sums reduced); each
    of ``kvs`` is placed to match (a ``Replicate`` -> ``Shard`` is a local
    slice), and where its KV heads do not divide the mesh dim that shards
    the query heads each rank slices the KV heads its query heads read
    (their gradient a partial sum over that dim). The result, of ``q``'s
    leading dims, is placed as ``q``. Plain tensors: ``fn(q, *kvs)``.

    ``sq``: ``q``'s query-row dim, for an attention whose rows are also
    independent (``fn(q, *kvs, q_start=r)`` takes rows from row r on).
    Where the query heads cannot be sharded over a mesh dim that nothing
    of ``q`` uses (56 heads of arctic-480b or 24 of llama3.2-3b on a
    16-wide model axis), each rank of that dim takes its share of the
    query rows against the whole K/V (their gradient a partial sum over
    that dim) instead of repeating every row's attention, and the rows
    are gathered after."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(q, DTensor):
        return fn(q, *kvs)
    mesh = q.device_mesh
    keep = {bq % q.ndim, hq % q.ndim}
    strided = {pl.dim % q.ndim for pl in q.placements
               if _shards(pl) and type(pl) is not Shard}
    q = reduce_partial(gather_dims(q, set(range(q.ndim)) - keep | strided))
    heads = [i for i, pl in enumerate(q.placements)
             if type(pl) is Shard and pl.dim == hq % q.ndim]
    n_kv = kvs[0].shape[hk]
    plan = None
    if heads:
        n = mesh.shape[heads[0]]
        if n_kv % n:
            plan = _head_plan(q, hq, n_kv)
        if len(heads) > 1 or q.shape[hq] % n or (n_kv % n and plan is None):
            q, heads, plan = gather_dims(q, (hq,)), [], None
    rows = None
    if sq is not None and not heads:
        free = [i for i, pl in enumerate(q.placements) if pl.is_replicate()
                and q.shape[sq] % mesh.shape[i] == 0]
        if free:
            rows = free[-1]
            pls = list(q.placements)
            pls[rows] = Shard(sq % q.ndim)
            q = q.redistribute(mesh, pls)     # a local slice
    locs = []
    for kv in kvs:
        want = []
        for i, pl in enumerate(q.placements):
            if type(pl) is Shard and pl.dim == bq % q.ndim:
                want.append(Shard(bk % kv.ndim))
            elif heads and i == heads[0] and plan is None:
                want.append(Shard(hk % kv.ndim))
            else:
                want.append(Replicate())
        kv = reduce_partial(kv)
        if list(kv.placements) != want:
            kv = kv.redistribute(mesh, want)
        split = plan[0] if plan is not None else rows
        if split is None:
            locs.append(kv.to_local())
            continue
        grad_pls = [Partial() if j == split else pl
                    for j, pl in enumerate(want)]
        local = kv.to_local(grad_placements=grad_pls)
        if plan is not None:
            _, _, lo, n_d, idx = plan
            local = local.narrow(hk, lo, n_d)
            if idx is not None:
                local = local.index_select(
                    hk, torch.tensor(idx, device=local.device))
        locs.append(local)
    if rows is None:
        return from_local(fn(q.to_local(), *locs), mesh, q.placements)
    start = mesh.get_local_rank(rows) * (q.shape[sq] // mesh.shape[rows])
    out = from_local(fn(q.to_local(), *locs, q_start=start), mesh,
                      q.placements)
    return gather_dims(out, (sq,))


def rows_only(x, dim=0):
    """``x`` with no shard but its plain shards of ``dim`` and no partial
    sum left (a strided shard of ``dim`` gathered too): its local tensor
    is then a block of whole rows."""
    x = reduce_partial(x)
    d = dim % x.ndim
    other = set(range(x.ndim)) - {d}
    if any(_shards(pl) and type(pl) is not Shard and pl.dim % x.ndim == d
           for pl in x.placements):
        other.add(d)
    return gather_dims(x, other)


def _batch_mesh_dims(x, dim):
    return [i for i, pl in enumerate(x.placements)
            if type(pl) is Shard and pl.dim == dim % x.ndim]


def shard_index(mesh, placements, dim):
    """(index, count) of this rank's block of a tensor's dim ``dim`` placed
    by ``placements`` on ``mesh``: the mesh dims that split it taken in
    mesh order (the first the slowest, as ``Shard`` on several mesh dims
    splits)."""
    index, count = 0, 1
    for i, pl in enumerate(placements):
        if type(pl) is Shard and pl.dim == dim:
            n = mesh.shape[i]
            index, count = index * n + mesh.get_local_rank(i), count * n
    return index, count


class _SumInto(torch.autograd.Function):
    """``sum_into``; the backward hands each rank the gradient of its
    summand, which is the sum's (no ``Replicate`` -> ``Partial`` split of
    it)."""

    @staticmethod
    def forward(ctx, local, mesh, pls, want):
        ctx.mesh = mesh
        ctx.pls = [Replicate() if pl.is_partial() else pl for pl in pls]
        return from_local(local, mesh, pls).redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.pls).to_local(), None, None, None


def sum_into(local, mesh, pls, want):
    """Each rank's ``local`` as one ``DTensor`` placed by ``pls`` (its
    ``Partial`` mesh dims summing the ranks' tensors), redistributed to
    ``want`` (a partial sum to a shard: a reduce-scatter)."""
    return _SumInto.apply(local, mesh, list(pls), list(want))


def all_gather_rows(local, like, dim):
    """Every token shard's ``local`` (the same shape on each rank), stacked
    in the shards' order on a new leading dim: (shards, *local.shape), a
    plain tensor on every rank (an all-gather over the mesh dims that
    shard ``like``'s dim ``dim``)."""
    dims = _batch_mesh_dims(like, dim)
    pls = [Shard(0) if i in dims else Replicate()
           for i in range(like.device_mesh.ndim)]
    return from_local(local[None], like.device_mesh, pls).full_tensor()


def whole_rows(x, dim, grad_partial):
    """``x`` gathered over the mesh dims that shard its dim ``dim`` (every
    token on every rank), as a plain tensor; its gradient is a partial sum
    over the mesh dims ``grad_partial`` (each rank's use of the rows its
    own work reads)."""
    from torch.distributed.tensor import Partial

    x = gather_dims(x, (dim,))
    return x.to_local(grad_placements=[
        Partial() if i in grad_partial else pl
        for i, pl in enumerate(x.placements)])


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
