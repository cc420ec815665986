"""Per-device operation counter, the PyTorch port's counterpart of
``repro.roofline.hloparse``.

The JAX package reads a step's FLOPs and collective bytes from the
compiled per-device SPMD HLO text: it parses ``dot`` and collective
instructions and multiplies the bodies of while loops by their trip
counts. torch compiles nothing to text: an eager step is the sequence of
aten operations it dispatches, so the counterpart watches them go by.
``OpCounter`` is a ``TorchDispatchMode`` over one traced step (on the
meta device for a dry run, or on the card for a real step) that records,
for this process's device:

* **dot FLOPs**: ``mm``, ``bmm``, ``addmm`` and ``baddbmm``, 2·M·N·K (times
  the batch), the ops ``analyze_hlo`` counts as ``dot`` (``matmul``,
  ``einsum`` and ``linear`` reach the dispatcher as these). Elementwise
  ops, softmax, reductions and triangular solves are not counted, as in
  the JAX parser. The models make no fused attention call: their
  attention is einsums, counted as such.
* **collectives**, one record each (HLO kind, HLO dtype, result shape,
  group size), costed as ``analysis.collective_stats`` costs HLO
  collectives: all-reduce 2x the buffer (a ring), reduce-scatter the
  result times the group (the operand), every other kind 1x. A
  ``DTensor`` shard-to-shard redistribute is one all-to-all of the local
  shard, as the HLO has it, also on a CPU mesh, where torch runs it as
  an all-gather and a chunk.

Local work, never global. A ``DTensor`` operation is handed back
(``NotImplemented``), so ``DTensor`` runs it and desugars it into
operations on its local shards and the collectives it needs, which then
reach the counter with local shapes: what rank 0 of the mesh computes.
Counting the ``DTensor``-level operation would count the global product
(``torch.utils.flop_counter.FlopCounterMode`` does, and reads neither the
global nor the per-device figure). The shape inference ``DTensor`` runs
on fake tensors is not work and is skipped.

Trip counts only where a loop says so. The layers are a Python loop, and
``torch.utils.checkpoint`` recomputes a layer's forward inside the
backward as real operations, so the counter sees every layer's every
operation as it runs. The one exception is ``models.layers.scan`` on the
meta device, which traces one step of a sequence recurrence for all of
its steps inside ``weighted(S)``: there each FLOP and collective counts S
times over, as ``hloparse`` weighs a while body by its trip count.

A factor's update counts nothing: while a counter is active it wraps
``core.backends.dispatch`` in ``paused``. On the card the update is the repository's
own kernel, called through ``ctypes``, which no dispatch mode sees, and
on the meta device it is a shape function, so counting it nowhere keeps
the card's count and the meta device's equal. The JAX parser likewise
counts nothing inside a Mosaic custom call.

``track_memory=True`` also keeps the peak of the live bytes of every
storage an operation allocates during the step (views and in-place
results add nothing; a storage leaves when its last tensor dies): the
``temp_bytes`` of ``analysis.analyze``. It leaves out what existed before
the step (parameters, optimizer state, the batch), what allocates outside
the dispatcher (a ``ctypes`` kernel's own scratch), and the allocator's
rounding and fragmentation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The JAX parser's dtype table, by HLO name, and the torch dtypes' names.
DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}
HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}

#: This thread's depth of ``paused`` blocks.
_LOCAL = threading.local()

#: Active counters, and ``core.backends.dispatch`` as it was before the
#: first of them wrapped it.
_WRAP = {"depth": 0, "dispatch": None}


@contextlib.contextmanager
def paused():
    """Count no FLOPs and no collectives inside, on this thread (memory is
    still tracked): a factor's update (see the module docstring)."""
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


def _alltoall_modules():
    """The modules of this torch that hold ``DTensor``'s shard-to-shard
    exchange, ``shard_dim_alltoall`` (``placement_types`` calls it by the
    name it imported)."""
    from torch.distributed.tensor import _collective_utils, placement_types

    return [m for m in (_collective_utils, placement_types)
            if hasattr(m, "shard_dim_alltoall")]


def _wrap_dispatch(step: int):
    """While any counter is active (``step`` +1 on entry, -1 on exit):
    wrap ``core.backends.dispatch`` in ``paused``, and ``DTensor``'s
    ``shard_dim_alltoall`` so that a shard-to-shard redistribute on a CPU
    mesh, which torch runs as an all-gather and a chunk (no CPU group has
    an all-to-all), is recorded as the one all-to-all it stands for, of
    the local shard it returns, and its all-gather not at all. On a CUDA
    mesh it is left alone: NCCL runs the all-to-all itself."""
    from repro_torch.core import backends

    if step > 0 and _WRAP["depth"] == 0:
        orig = _WRAP["dispatch"] = backends.dispatch

        @functools.wraps(orig)
        def dispatch(*args, **kwargs):
            with paused():
                return orig(*args, **kwargs)

        backends.dispatch = dispatch
        mods = _alltoall_modules()
        _WRAP["alltoall"] = [(m, m.shard_dim_alltoall) for m in mods]
        if mods:
            a2a = mods[0].shard_dim_alltoall

            @functools.wraps(a2a)
            def shard_dim_alltoall(input, gather_dim, shard_dim, mesh,
                                   mesh_dim):
                if mesh.device_type != "cpu":
                    return a2a(input, gather_dim, shard_dim, mesh, mesh_dim)
                with paused():
                    out = a2a(input, gather_dim, shard_dim, mesh, mesh_dim)
                _record_all_to_all(out, mesh.size(mesh_dim))
                return out

            for m in mods:
                m.shard_dim_alltoall = shard_dim_alltoall
    _WRAP["depth"] += step
    if step < 0 and _WRAP["depth"] == 0:
        backends.dispatch = _WRAP["dispatch"]
        for m, fn in _WRAP.pop("alltoall", []):
            m.shard_dim_alltoall = fn


def _record_all_to_all(out, group: int) -> None:
    """One all-to-all of ``out`` (the local shard it returns) into this
    thread's innermost counter, unless paused."""
    counters = getattr(_LOCAL, "counters", ())
    if not counters or getattr(_LOCAL, "depth", 0) or _is_fake(out):
        return
    counters[-1].collectives.append(Collective(
        "all-to-all", HLO_DTYPE.get(out.dtype, str(out.dtype)),
        tuple(out.shape), group, getattr(_LOCAL, "weight", 1)))


@contextlib.contextmanager
def weighted(times: int):
    """Count each FLOP and collective inside ``times`` times over, on this
    thread (nested weights multiply): one traced step standing for a
    loop's ``times`` trips (``models.layers.scan``). Memory is tracked as
    it runs."""
    outer = getattr(_LOCAL, "weight", 1)
    _LOCAL.weight = outer * times
    try:
        yield
    finally:
        _LOCAL.weight = outer


def live_bytes() -> int:
    """The live bytes of the innermost ``OpCounter(track_memory=True)``
    active on this thread, 0 without one: what a traced region keeps is
    the difference across it (``models.layers.scan``)."""
    for c in reversed(getattr(_LOCAL, "counters", ())):
        if c.track_memory:
            return c.live_bytes
    return 0


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as the HLO names it: kind, result dtype and shape,
    and the size of the group it runs over; ``times``: how many runs of
    it the record stands for (a step traced once under ``weighted``)."""
    kind: str
    dtype: str
    shape: Tuple[int, ...]
    group: int
    times: int = 1

    @property
    def nbytes(self) -> float:
        return float(math.prod(self.shape) * DTYPE_BYTES.get(self.dtype, 0))

    def cost(self) -> float:
        """Bytes moved a device: all-reduce 2x (a ring), reduce-scatter
        the result times the group (the reduced operand), others 1x."""
        nb = self.nbytes * self.times
        if self.kind == "all-reduce":
            return 2.0 * nb
        if self.kind == "reduce-scatter" and self.group:
            return nb * self.group
        return nb


#: Dot-family op -> position of its left operand: 2 * (output elements)
#: * (the left operand's contracted last dim) FLOPs.
_DOT = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}

#: Collective op (in the c10d namespaces below) -> HLO collective kind.
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _group_size(args, kwargs) -> int:
    """The group a collective runs over: a functional collective names
    it (and gives its size where it needs it); a c10d op passes it."""
    import torch.distributed as dist

    for x in list(args) + list(kwargs.values()):
        if isinstance(x, str) and x not in ("sum", "avg", "max", "min",
                                            "product"):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group

            try:
                return _resolve_process_group(x).size()
            except (RuntimeError, ValueError, KeyError):
                continue   # a string that names no group
        if isinstance(x, dist.ProcessGroup):
            return x.size()
    return 1


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


class OpCounter(TorchDispatchMode):
    """Dot FLOPs and collectives of this device over the operations run
    inside (see the module docstring); ``analyze_ops`` sums them as
    ``hloparse.analyze_hlo`` does."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.collectives: List[Collective] = []
        self.n_ops = 0
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}

    def __enter__(self):
        _wrap_dispatch(+1)
        _LOCAL.counters = getattr(_LOCAL, "counters", []) + [self]
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _LOCAL.counters = _LOCAL.counters[:-1]
            _wrap_dispatch(-1)

    # -- memory ---------------------------------------------------------
    def _freed(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, args, out):
        seen = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._freed, key)
            seen.add(key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            return NotImplemented   # let DTensor run it on its shards
        out = func(*args, **kwargs)
        if any(_is_fake(t) for t in _tensors((args, out))):
            return out              # DTensor's shape inference
        self.n_ops += 1
        if self.track_memory:
            self._track(args, out)
        if getattr(_LOCAL, "depth", 0):
            return out
        weight = getattr(_LOCAL, "weight", 1)
        pkt = func._overloadpacket
        name = pkt.__name__
        ns = getattr(pkt, "_qualified_op_name", "").split("::")[0]
        if name in _DOT and ns == "aten":
            f = 2.0 * out.numel() * args[_DOT[name]].shape[-1] * weight
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
        elif ns in _COLL_NAMESPACES and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            g = _group_size(args, kwargs)
            res = list(_tensors(out)) or list(_tensors(args[:1]))
            for t in res:
                self.collectives.append(Collective(
                    kind, HLO_DTYPE.get(t.dtype, str(t.dtype)),
                    tuple(t.shape), g, weight))
        return out


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, type) and issubclass(t, DTensor) for t in types)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)



def coll_by_kind(records) -> Dict[str, float]:
    """Per-kind bytes a device of ``records`` (``Collective``s), with the
    sum under 'total' (only when there is one, as the JAX package's
    ``collective_stats``)."""
    out: Dict[str, float] = {}
    for r in records:
        c = r.cost()
        out[r.kind] = out.get(r.kind, 0.0) + c
        out["total"] = out.get("total", 0.0) + c
    return out


def analyze_ops(counter: OpCounter):
    """Totals of a counted step, as ``hloparse.analyze_hlo`` returns them:
    (flops, collective_bytes, coll_by_kind with 'total', info)."""
    kinds = coll_by_kind(counter.collectives)
    total = kinds.get("total", 0.0)
    kinds["total"] = total
    info = {"n_ops": counter.n_ops, "n_collectives": len(counter.collectives),
            "flops_by_op": dict(counter.flops_by_op)}
    if counter.track_memory:
        info["peak_bytes"] = counter.peak_bytes
    return counter.flops, total, kinds, info


__all__ = ["Collective", "OpCounter", "analyze_ops", "coll_by_kind",
           "paused", "weighted", "live_bytes", "DTYPE_BYTES", "HLO_DTYPE"]
