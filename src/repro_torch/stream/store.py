"""``FactorStore``: a managed fleet of per-user Cholesky factors.

Port of ``repro.stream.store``. One batched fleet of shape
``(capacity, n, n)`` — or the ``(capacity, nb, b, b)`` /
``(capacity, nb-1, b, b)`` block stacks of a block-tridiagonal fleet —
holds every admitted user's statistics. Capacity moves along a fixed
**bucket ladder**: admission assigns slots from an explicit slot map inside
the current rung, and only the rung filling up promotes the fleet to the
next rung. Because the rungs and the width buckets are enumerable ahead of
time, so is every step the serving path can run: ``warmup()``
(``repro_torch.stream.warmup``) builds the up / down / both / scale /
slot_set / promote steps for every rung x width bucket, after which
**steady-state serving builds nothing**.

**The fleet is one preallocated device tensor** (a pair for a structured
fleet); the fleet at rung ``c`` is its leading ``c`` members. Every step
writes its result back into that tensor, so each step runs at fixed
addresses. On CUDA the tensor and the static inputs hold the TOP rung's
capacity from construction (graphs bind addresses); on the CPU they hold
the current rung and are reallocated at a promotion.

* on CUDA a step is a CUDA graph, captured once per (step, rung, width[s],
  dtype) from the eager step (``CholFactor.update`` / the guarded
  downdate's calls -> ``api.chol_update_batched`` -> the ``fused_chain``
  kernel for a dense fleet, the ``btd_chain`` kernel for a structured one,
  the sharded driver's ``diag_block`` and ``panel_apply_sharded`` kernels
  for a sharded one) and replayed per call. The replays read static inputs the store owns:
  the V block(s), staged from ``pad_block``'s host array; the slot index
  and the member block (``slot_set``); alpha (``scale``). All of a store's
  graphs share one memory pool; no graph leaves a live output in it.
* on the CPU a step is the same eager code, run per call.

Either way the first use of a step's key counts one
``repro.stream.step_traces{step}`` (on CUDA that is the capture), so the
retrace guard (``warmup.assert_no_retrace``) means the same on both.

The guarded downdate (``down``, ``both``) runs as two graphs around the one
call that cannot be captured, ``solve.gram_verdict`` (``eigvalsh`` reads
its solver's status on the host): the first graph applies the update block
(``both``) and forms the Gram matrix ``G = I - PᵀP``
(``CholFactor.guard_gram``), the verdict is taken eagerly from ``G``, and
the second graph writes ``guard_select(downdate, ok)`` into the fleet. The
verdicts equal ``CholFactor.downdate_guarded``'s, which makes the same
calls.

**Memory.** On CUDA the top rung's fleet exists from construction: at
n = 1024 fp32 a member is 4 MiB, so ``DEFAULT_LADDER`` (top rung 2048)
holds 8.6 GB, a ladder of (64, 128) 0.54 GB, and a bare ``capacity=c``
derives the ladder ``(c, 2c, ..., 128c)``, so its top rung is 128 x
``capacity`` (capacity 8 at n = 1024: 4.3 GB). The static V blocks add
``top x n x w`` rows for each width bucket and sign. A CUDA store whose
fleet and static inputs exceed the card's free memory is refused at
construction (pass a shorter ``ladder=``). The shared graph pool holds the
largest step's temporaries (the kernel's output, its ``triu``, the guarded
select: about three fleets of the rung), and each call copies its result
back into the fleet (one fleet written per step, two for ``both``).

Instrumentation, two counters, as in the JAX package:

* ``mutations_issued()`` — batched rank-k mutations dispatched to the
  engine, ONE per sign block per ``apply`` call regardless of fleet size.
* ``traces_counted()`` — first uses of a step key (graph captures on
  CUDA). After ``warmup()`` a serving sequence must move
  ``mutations_issued`` but NOT ``traces_counted``.

Kernel launches are counted per real launch: a capture holds back the
capturing thread's counts (``LAUNCHES``, ``repro.kernels.launches`` and the
registry's other counters; ``obs.metrics.deferring``), since nothing ran,
and each replay of the graph applies them.

**Sharded placement** (``backend='sharded'``, ``mesh=``, ``axis=``): every
member is column-sharded over ``axis`` of the mesh, the batch replicated
(``fleet_placement``, JAX's ``P(None, None, axis)``). Each rank holds one
preallocated local tensor ``(top, n, w_loc)`` (its columns of every
member), and the fleet value is a ``DTensor`` over its leading members;
admission, eviction, promotion, compaction, decay and every step keep that
placement, and every flush dispatches through the column-sharded driver:
per sign block, n / panel ``diag_block`` launches and one
``panel_apply_sharded`` launch per 32 columns of the block on each shard,
whatever the fleet size. Every rank runs the same calls (many
controllers, one program). The guarded downdate takes its verdict from
the downdated factor's diagonal (``distributed.diag_verdict``: device ops
and a MIN all_reduce, no ``eigvalsh``), so it is one part, not two.

**Which steps are graphs** (``step_mode``, a rule, not a knob): a step is
a CUDA graph (captured per rank) only where every collective in it can be
captured: on CUDA with no mesh, or with a mesh whose axis dims each hold
one rank (those take no collective) or run over NCCL. Under ``gloo`` with
more than one rank along the axis the driver stages its blocks through
host memory (``distributed._staged``), which cannot be captured, so every
step runs eager on every call; on the CPU every step runs eager too.
Capture on an axis of several NCCL ranks (several cards) has never been
run: only the one-rank axis has been captured and replayed on a card. A
capture that fails there raises at warmup; it does not give wrong
results.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import api, backends
from repro_torch.core import distributed as _distributed
from repro_torch.core import solve as _solve
from repro_torch.core import structure as _structure
from repro_torch.core.factor import CholFactor
from repro_torch.core.precision import Precision, as_dtype
from repro_torch.kernels._launch import on_device
from repro_torch.obs import metrics as obs_metrics

def mutations_issued() -> int:
    """Cumulative batched mutations dispatched by every store."""
    return int(obs_metrics.total("repro.stream.mutations"))


def traces_counted() -> int:
    """Cumulative first uses of step keys across every store (graph
    captures on CUDA) — the counter the retrace guard asserts against."""
    return int(obs_metrics.total("repro.stream.step_traces"))


def _count_mutation(k: int = 1, *, sign: str = "both") -> None:
    obs_metrics.counter("repro.stream.mutations", sign=sign).inc(k)


def _count_trace(step: str = "unknown") -> None:
    obs_metrics.counter("repro.stream.step_traces", step=step).inc()


# -- the bucket ladder --------------------------------------------------------

#: Serving-scale default rungs. Stores built with a bare ``capacity=``
#: derive a doubling ladder from it instead.
DEFAULT_LADDER = (64, 128, 256, 512, 1024, 2048)

_DERIVED_RUNGS = 8  # capacity -> (c, 2c, 4c, ... c*2^7)

#: Storage structures the stream stack holds as fleet members.
SUPPORTED_STRUCTURES = ("dense", "blocktridiag")


class UnsupportedStorageError(TypeError):
    """A fleet/storage layout the stream stack does not support, raised at
    store construction or ``from_state``, before any step is built."""


class LadderFullError(RuntimeError):
    """Admission refused: the top ladder rung is full. Evict idle users,
    ``compact()``, or construct the store with a taller ``ladder=``."""


def ladder_from(capacity: int, *, rungs: int = _DERIVED_RUNGS
                ) -> Tuple[int, ...]:
    """The derived doubling ladder rooted at ``capacity``."""
    return tuple(capacity << i for i in range(rungs))


def _validate_ladder(ladder) -> Tuple[int, ...]:
    rungs = tuple(int(c) for c in ladder)
    if not rungs or any(c < 1 for c in rungs):
        raise ValueError(f"ladder rungs must be positive, got {rungs}")
    if any(b <= a for a, b in zip(rungs, rungs[1:])):
        raise ValueError(f"ladder must be strictly increasing, got {rungs}")
    return rungs


def _width_buckets(width: int, widths) -> Tuple[int, ...]:
    """Sorted width buckets; must be able to carry a full-width block."""
    if widths is None:
        buckets = (1, width) if width > 1 else (1,)
    else:
        buckets = tuple(sorted({int(w) for w in widths}))
    if not buckets or any(w < 1 for w in buckets):
        raise ValueError(f"width buckets must be positive, got {buckets}")
    if buckets[-1] < width:
        raise ValueError(
            f"largest width bucket {buckets[-1]} < coalesce width {width}")
    return buckets


def row_dtype_for(factor_dtype) -> np.dtype:
    """Exact host buffer dtype for rank-1 rows of a fleet of this dtype:
    float64 for an f64 fleet, float32 otherwise (bf16 storage included)."""
    if as_dtype(factor_dtype) == torch.float64:
        return np.dtype(np.float64)
    return np.dtype(np.float32)


def fleet_placement(mesh, axis):
    """The fleet placement, JAX's ``P(None, None, axis)``: ``(mesh',
    placements)`` for a ``(B, n, n)`` ``DTensor`` whose batch and rows are
    replicated and whose columns are sharded over ``axis`` (``mesh'`` is
    ``mesh``, or its dims permuted into a tuple axis's order:
    ``distributed._layout``)."""
    axes = _distributed.axis_tuple(axis)
    mesh, _ = _distributed._layout(mesh, axes)
    return mesh, _distributed._placements(mesh, axes, 3)


def _leaves(x) -> List[torch.Tensor]:
    """A fleet value's tensors: the tensor itself (a ``DTensor``'s local
    part, which aliases it), or (diag, off)."""
    if isinstance(x, _structure.BlockTriDiagStorage):
        return [x.diag, x.off]
    if _distributed.is_sharded(x):
        return [x.to_local()]
    return [x]


def _write(dst, src) -> None:
    """Copy a step's result into the fleet's own tensor(s)."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


# -- the step set --------------------------------------------------------------

_GC_LOCK = threading.Lock()
_GC_HOLD = {"depth": 0, "was": True}


@contextlib.contextmanager
def _collector_off():
    """Hold Python's cyclic collector off (across threads, nested): a
    CUDA graph freed by it inside a capture (a dropped store's: a store is
    a reference cycle through its steps' closures) resets there, which
    invalidates the capture."""
    with _GC_LOCK:
        if _GC_HOLD["depth"] == 0:
            _GC_HOLD["was"] = gc.isenabled()
            gc.disable()
        _GC_HOLD["depth"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HOLD["depth"] -= 1
            if _GC_HOLD["depth"] == 0 and _GC_HOLD["was"]:
                gc.enable()



class _Step:
    """One built step: its parts (callables over a fleet base) and, for the
    guarded downdate, the eager verdict run between the first and second
    part. On CUDA each part is a captured graph with the counts it holds."""

    def __init__(self, parts: List[Callable], verdict: Optional[Callable],
                 span: int):
        self.parts = parts
        self.verdict = verdict
        self.span = span  # leading members of the fleet the step touches
        self.graphs: list = []  # (CUDAGraph, its held counts) per part

    def run(self, base, eager: bool = False) -> None:
        """Replay the step's graphs, each adding the counts it holds; with
        ``eager``, or before a capture, call its parts on ``base`` (the
        code a capture records)."""
        replay = bool(self.graphs) and not eager
        for i, part in enumerate(self.parts):
            if replay:
                g, held = self.graphs[i]
                g.replay()
                held.apply()
            else:
                part(base)
            if i == 0 and self.verdict is not None:
                self.verdict()


class StepSet:
    """A store's steps, keyed by (step, rung, width[s], dtype).

    ``call`` runs a step, building it at the first use of its key: that
    counts one ``repro.stream.step_traces{step}`` on any device, and where
    the store's ``step_mode`` is 'graphs' captures the step's graphs (after one eager run of the step on a
    scratch copy of the fleet, on the capture stream, which builds the
    kernels and brings up the libraries the step calls). ``build`` does the
    same without running the step (warmup). ``cold_dispatches`` counts
    calls that had to build.

    Graphs are captured in thread-local mode, so a step first met in the
    background flush worker is captured there (and counted).
    """

    def __init__(self, store: "FactorStore"):
        self._store = store
        self.entries: Dict[tuple, _Step] = {}
        self.cold_dispatches = 0
        self.graphs = 0
        self._stream = None
        self._pool = None

    def key(self, name: str, cap: int, widths: Tuple[int, ...] = ()):
        dt = str(self._store._storage).replace("torch.", "")
        return (name, int(cap), tuple(int(w) for w in widths), dt)

    @property
    def executables(self) -> int:
        return len(self.entries)

    def call(self, name: str, cap: int, widths: Tuple[int, ...] = ()):
        key = self.key(name, cap, widths)
        step = self.entries.get(key)
        tier = "warm"
        if step is None:
            self.cold_dispatches += 1
            tier = "cold"
            self.build(name, cap, widths)
            step = self.entries[key]
        obs_metrics.counter("repro.stream.step_dispatch", tier=tier,
                            step=name).inc()
        store = self._store
        with on_device(store.device):  # a worker thread replays too
            step.run(store._base)

    def build(self, name: str, cap: int, widths: Tuple[int, ...] = ()
              ) -> bool:
        """Build the step for ``key``; True when it was built now, False
        when it existed. Each build's seconds land in
        ``repro.stream.compile_seconds{step=...,sharded=0}``."""
        key = self.key(name, cap, widths)
        if key in self.entries:
            return False
        t0 = time.perf_counter()
        step = self._store._make_step(name, cap, widths)
        if self._store.step_mode == "graphs":
            self._capture(step)
        self.entries[key] = step
        _count_trace(name)
        obs_metrics.histogram(
            "repro.stream.compile_seconds", step=name,
            sharded=int(self._store.sharded)).observe(
                time.perf_counter() - t0)
        return True

    def _capture(self, step: _Step) -> None:
        store = self._store
        dev = store.device
        with on_device(dev):
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=dev)
                self._pool = torch.cuda.graph_pool_handle()
            # One eager run on a scratch fleet (fresh factors, the static
            # inputs as they stand), on the capture stream: builds the
            # kernels (nvcc at first use) and brings up the libraries'
            # handles before any capture, as PyTorch's graph docs ask. The
            # store's fleet is not touched. Its launches ran, and stay
            # counted.
            scratch = [t.new_empty((step.span,) + t.shape[1:])
                       for t in store._base]
            store._fill_fresh(scratch, 0, step.span)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                step.run(scratch, eager=True)
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            self._stream.synchronize()
            del scratch
            for part in step.parts:
                g = torch.cuda.CUDAGraph()
                # Captured, not launched: this thread's counts are held.
                with _collector_off(), obs_metrics.deferring() as held, \
                        torch.cuda.graph(g, pool=self._pool,
                                         stream=self._stream,
                                         capture_error_mode="thread_local"):
                    part(store._base)
                step.graphs.append((g, held))
                self.graphs += 1


class FactorStore:
    """Fleet manager over one batched ``CholFactor`` (see module docstring).

    Args:
      n: per-user factor dimension.
      capacity: requested initial slot count — snapped UP to the smallest
        ladder rung that holds it.
      ladder: the fixed capacity ladder (strictly increasing). Default: a
        doubling ladder rooted at ``capacity`` (``ladder_from``). Admission
        past the top rung raises ``LadderFullError``. The top rung's fleet
        is allocated at construction on CUDA (see the module docstring's
        Memory: the derived ladder's top rung is 128 x ``capacity``).
      width: coalesce width k — the static max rank of a flush mutation.
      widths: the width buckets blocks are zero-padded to (default
        ``{1, width}``).
      panel / backend / interpret / precision: execution metadata threaded
        onto the fleet's ``CholFactor``.
      mesh / axis: sharded placement (with ``backend='sharded'``, and only
        with it): every member column-sharded over ``axis`` of the
        ``DeviceMesh`` (see the module docstring). The fleet lives on the
        mesh's device; every rank constructs the store alike.
      init_scale: admitted slots start as the factor of ``init_scale * I``.
      dtype: logical dtype of the fleet (storage dtype under a precision
        policy); a torch dtype or its name.
      structure: 'dense' (``(B, n, n)``) or 'blocktridiag' (``(B, nb, b,
        b)`` block stacks; requires ``block=``).
      block: block size b for 'blocktridiag' (must divide n).
      device: where the fleet lives (default CUDA; a sharded fleet lives
        on its mesh's device).
    """

    def __init__(self, n: int, *, capacity: int = 8, width: int = 16,
                 ladder: Optional[Tuple[int, ...]] = None,
                 widths: Optional[Tuple[int, ...]] = None,
                 panel: int = 64, backend: str = "auto",
                 interpret: Optional[bool] = None, precision=None,
                 mesh=None, axis="model",
                 init_scale: float = 1.0, dtype=torch.float32,
                 structure: str = "dense", block: Optional[int] = None,
                 device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if backend == "sharded" and mesh is None:
            raise ValueError("backend='sharded' requires a mesh= placement")
        if backend != "sharded" and mesh is not None:
            # Dropping the mesh silently would leave a fleet sized for
            # many ranks whole on one.
            raise ValueError(
                f"mesh= placement requires backend='sharded' "
                f"(got backend={backend!r})")
        if structure not in SUPPORTED_STRUCTURES:
            raise UnsupportedStorageError(
                f"fleet structure {structure!r} is not supported by the "
                f"stream stack; supported: {SUPPORTED_STRUCTURES}")
        if structure == "blocktridiag":
            if block is None or n % int(block):
                raise ValueError(
                    f"structure='blocktridiag' requires block= dividing "
                    f"n={n}, got block={block}")
            if mesh is not None:
                raise UnsupportedStorageError(
                    "structured fleets do not compose with mesh= placement "
                    "yet (block-chain halo sharding is the open ROADMAP "
                    "item); supported sharded structure: 'dense'")
        device = (_distributed.mesh_device(mesh) if mesh is not None
                  else api.default_device(device))
        if structure == "blocktridiag":
            # An explicit dense-only backend fails here by name, and 'auto'
            # must resolve to a structured-capable method.
            backends.resolve(backend, n=n, panel=panel, interpret=interpret,
                             device=device, structure="blocktridiag")
        self.ladder = (_validate_ladder(ladder) if ladder is not None
                       else ladder_from(capacity))
        capacity = self._rung_for(capacity)
        policy = Precision.parse(precision)
        storage = as_dtype(dtype) if policy is None else \
            policy.storage_for(dtype)
        self.n = n
        self.width = width
        self.widths = _width_buckets(width, widths)
        self.init_scale = float(init_scale)
        self._setup(device, storage, structure,
                    int(block) if structure == "blocktridiag" else None,
                    dict(panel=panel, backend=backend, interpret=interpret,
                         precision=policy, mesh=mesh, axis=axis), capacity)
        self._fill_fresh(self._base, 0, capacity)
        self._cap = capacity
        self._slot_of: Dict[object, int] = {}
        self._slot_to_user: Dict[int, object] = {}
        self._empty_slots: List[int] = list(range(capacity - 1, -1, -1))
        self._last_used: Dict[object, int] = {}
        self._observe_occupancy()

    def _setup(self, device, storage, structure, block, meta,
               capacity: int) -> None:
        """Allocate the fleet and the static inputs: at the top rung on
        CUDA, refused when they exceed the card's free memory; at
        ``capacity`` on the CPU. ``meta``: the fleet factor's execution
        metadata, ``mesh`` (None unsharded) and ``axis`` included."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._storage = storage
        self._structure = structure
        self._block = block
        self._mesh, self._axis = meta["mesh"], meta["axis"]
        if self._mesh is not None:
            axes = _distributed.axis_tuple(self._axis)
            self._placed = fleet_placement(self._mesh, axes)
            parts = _distributed.n_shards(self._mesh, axes)
            if self.n % parts:
                raise ValueError(f"n={self.n} must divide over {parts} "
                                 "column shards")
            self._w_loc = self.n // parts
            self._col0 = (_distributed.shard_index(self._mesh, axes)
                          * self._w_loc)
        else:
            self._w_loc, self._col0 = self.n, 0
        self._meta = meta
        self.step_mode = self._step_mode()
        cuda = device.type == "cuda"
        self._held = self.ladder[-1] if cuda else capacity
        if cuda:
            self._check_fits()
        self._base = self._alloc(self._held)
        kw = dict(device=self.device)
        self._vbuf: Dict[Tuple[str, int], torch.Tensor] = {}
        self._gram: Dict[int, torch.Tensor] = {}
        self._ok = torch.ones(self._held, dtype=torch.bool, **kw)
        self._slot = torch.zeros(1, dtype=torch.int64, **kw)
        self._member = self._alloc(None)
        self._alpha = torch.ones((), dtype=self._row_torch, **kw)
        self._steps = StepSet(self)

    @property
    def sharded(self) -> bool:
        """True for a fleet placed over a mesh (``backend='sharded'``)."""
        return self._mesh is not None

    @property
    def ranks(self) -> int:
        """Ranks the fleet spans: its mesh's size (1 unsharded)."""
        return self._mesh.size() if self._mesh is not None else 1

    def _step_mode(self) -> str:
        """'graphs' where every collective of a step can be captured (see
        the module docstring; several NCCL ranks along the axis are
        unverified), else 'eager'."""
        if self.device.type != "cuda":
            return "eager"
        if self._mesh is None:
            return "graphs"
        import torch.distributed as dist

        mesh, dims = _distributed._layout(
            self._mesh, _distributed.axis_tuple(self._axis))
        if all(mesh.size(d) == 1
               or dist.get_backend(mesh.get_group(d)) == "nccl"
               for d in dims):
            return "graphs"
        return "eager"

    def _check_fits(self) -> None:
        """Refuse a CUDA store whose top-rung fleet (this rank's columns
        of it) and static V / Gram blocks exceed the card's free
        memory."""
        n, top = self.n, self.ladder[-1]
        member = sum(t.numel() for t in self._alloc(None, "meta"))
        row = 8 if self._storage == torch.float64 else 4
        need = top * (member * self._storage.itemsize
                      + sum(2 * n * w + w * w for w in self.widths) * row)
        free = torch.cuda.mem_get_info(self.device)[0]
        if need > free:
            raise ValueError(
                f"the fleet at the top rung {top} of ladder={self.ladder} "
                f"and its static inputs need {need / 1e9:.2f} GB on "
                f"{self.device}, {free / 1e9:.2f} GB are free: pass a "
                f"shorter ladder= (a bare capacity= derives 128 x capacity)")

    def _grow(self, count: int) -> None:
        """CPU: hold ``count`` members in the fleet and the static inputs
        (new tensors, the leading members copied, the rest zero; the steps
        look their buffers up at each call)."""
        held = self._held

        def grown(t):
            out = t.new_zeros((count,) + t.shape[1:])
            out[:held].copy_(t)
            return out

        self._base = [grown(t) for t in self._base]
        self._vbuf = {k: grown(t) for k, t in self._vbuf.items()}
        self._gram = {k: grown(t) for k, t in self._gram.items()}
        self._ok = grown(self._ok)
        self._held = count

    @property
    def _row_torch(self) -> torch.dtype:
        return (torch.float64 if self._storage == torch.float64
                else torch.float32)

    def _alloc(self, count: Optional[int], device=None
               ) -> List[torch.Tensor]:
        """Zeroed fleet tensors for ``count`` members, or one member's."""
        lead = () if count is None else (count,)
        kw = dict(dtype=self._storage, device=device or self.device)
        if self._structure == "blocktridiag":
            b = self._block
            nb = self.n // b
            return [torch.zeros(lead + (nb, b, b), **kw),
                    torch.zeros(lead + (max(nb - 1, 0), b, b), **kw)]
        return [torch.zeros(lead + (self.n, self._w_loc), **kw)]

    def _root(self, scale: Optional[float] = None) -> float:
        """``sqrt(scale)`` in the fleet's row dtype, as the JAX package's
        host-side warm start computes it."""
        calc = self.row_dtype
        return float(np.sqrt(self.init_scale if scale is None
                             else float(scale), dtype=calc))

    def _fill_fresh(self, leaves, lo: int, hi: int,
                    scale: Optional[float] = None) -> None:
        """Members ``lo:hi`` of a fleet's tensors become the warm start
        ``sqrt(scale) * I`` (the identity's block stacks for a structured
        fleet; a shard's columns of it for a sharded one): zeros, then the
        diagonal. Capture-safe (no host input)."""
        root = self._root(scale)
        first = leaves[0][lo:hi]
        first.zero_()
        first.diagonal(offset=-self._col0, dim1=-2, dim2=-1).fill_(root)
        for t in leaves[1:]:
            t[lo:hi].zero_()

    def _view(self, leaves, cap: int):
        """The fleet value at rung ``cap`` over ``leaves``: a tensor, a
        ``BlockTriDiagStorage`` of the leading members, or a sharded
        fleet's ``DTensor`` over this rank's part of them."""
        if self._structure == "blocktridiag":
            return _structure.BlockTriDiagStorage(leaves[0][:cap],
                                                  leaves[1][:cap])
        if self._mesh is not None:
            return self._placed_value(leaves[0][:cap])
        return leaves[0][:cap]

    def _placed_value(self, loc):
        """The ``DTensor`` of the members whose local part is ``loc``
        (``(c, n, w_loc)``, or one member ``(n, w_loc)``)."""
        from torch.distributed.tensor import DTensor

        mesh, placements = self._placed
        if loc.ndim == 2:
            placements = _distributed._placements(
                mesh, _distributed.axis_tuple(self._axis), 2)
        full = torch.Size(loc.shape[:-1] + (self.n,))
        return DTensor.from_local(
            loc, mesh, placements, run_check=False, shape=full,
            stride=torch.empty(full, device="meta").stride())

    def _cf(self, data) -> CholFactor:
        return CholFactor(data, **self._meta)

    # -- observability -------------------------------------------------------
    def _observe_occupancy(self) -> None:
        """Refresh the ladder gauges after any membership/rung change."""
        cap = self.capacity
        obs_metrics.gauge("repro.stream.ladder_occupancy").set(
            self.active / cap if cap else 0.0)
        obs_metrics.gauge("repro.stream.active").set(self.active)
        obs_metrics.gauge("repro.stream.capacity").set(cap)

    # -- ladder arithmetic ---------------------------------------------------
    def _rung_for(self, capacity: int) -> int:
        """Smallest ladder rung holding ``capacity`` slots."""
        for rung in self.ladder:
            if rung >= capacity:
                return rung
        raise LadderFullError(
            f"{capacity} slots exceed the top ladder rung "
            f"{self.ladder[-1]} (ladder={self.ladder})")

    # -- reconstruction (durability) ----------------------------------------
    @classmethod
    def from_state(cls, factor: CholFactor, *, width: int,
                   slots: Dict[object, int], last_used: Dict[object, int],
                   init_scale: float,
                   ladder: Optional[Tuple[int, ...]] = None,
                   widths: Optional[Tuple[int, ...]] = None,
                   empty_slots: Optional[Tuple[int, ...]] = None
                   ) -> "FactorStore":
        """Rebuild a store around restored fleet data + slot table.

        The fleet's values are copied into a new allocation on the factor's
        device (the top rung's on CUDA, refused when it exceeds the card's
        free memory). A sharded factor (``backend='sharded'``, its
        ``mesh``/``axis``; a ``DTensor`` or the whole fleet on every rank)
        restores the sharded placement: each rank keeps its columns. The
        ladder defaults to a doubling ladder rooted at the restored
        capacity. ``empty_slots``: the live store's free-slot
        order, next-assigned first; passing it makes restored admission pop
        the same slots the pre-crash process would have.
        """
        if factor.structure not in SUPPORTED_STRUCTURES:
            raise UnsupportedStorageError(
                f"fleet factor holds {type(factor.data).__name__} "
                f"(structure {factor.structure!r}), which the stream "
                f"stack does not support; supported structures: "
                f"{SUPPORTED_STRUCTURES}")
        mesh = factor.mesh if factor.backend == "sharded" else None
        if factor.backend == "sharded" and mesh is None:
            raise ValueError("backend='sharded' requires a mesh= placement")
        if mesh is not None and factor.structure != "dense":
            raise UnsupportedStorageError(
                "structured fleets do not compose with mesh= placement; "
                "supported sharded structure: 'dense'")
        # The layout view reads shapes only: a sharded fleet is not
        # gathered here.
        storage = _structure.as_storage(factor.data)
        if not factor.batched:
            raise UnsupportedStorageError(
                f"fleet factor must be batched — (B, n, n) dense or a "
                f"batched BlockTriDiagStorage with (B, nb, b, b) block "
                f"stacks; got {storage.describe()}")
        cap = storage.batch
        self = cls.__new__(cls)
        self.n = factor.n
        self.width = width
        self.widths = _width_buckets(width, widths)
        self.ladder = (_validate_ladder(ladder) if ladder is not None
                       else ladder_from(cap))
        if cap not in self.ladder:
            raise ValueError(
                f"restored capacity {cap} is not a rung of the ladder "
                f"{self.ladder}")
        self.init_scale = float(init_scale)
        data = factor.data
        device = factor.device
        if mesh is not None:
            # Each rank keeps its own columns of the restored fleet.
            data = _distributed.shard(data, mesh, factor.axis)
            device = _distributed.mesh_device(mesh)
        self._setup(device, factor.dtype, factor.structure,
                    storage.block if factor.structure == "blocktridiag"
                    else None,
                    dict(panel=factor.panel, backend=factor.backend,
                         interpret=factor.interpret,
                         precision=factor.precision, mesh=mesh,
                         axis=factor.axis), cap)
        for dst, src in zip(self._base, _leaves(data)):
            dst[:cap].copy_(src)
        self._cap = cap
        self._slot_of = dict(slots)
        self._slot_to_user = {s: u for u, s in self._slot_of.items()}
        taken = set(self._slot_of.values())
        free = {s for s in range(cap) if s not in taken}
        if empty_slots is None:
            self._empty_slots = sorted(free, reverse=True)
        else:
            if set(empty_slots) != free or len(empty_slots) != len(free):
                raise ValueError(
                    f"restored empty_slots {tuple(empty_slots)} do not "
                    f"match the slots the slot table leaves free "
                    f"({sorted(free)})")
            # Property order is next-assigned FIRST; the stack pops the end.
            self._empty_slots = list(reversed(empty_slots))
        self._last_used = dict(last_used)
        self._observe_occupancy()
        return self

    # -- views --------------------------------------------------------------
    @property
    def factor(self) -> CholFactor:
        """The live batched fleet factor. Its data are views of the fleet's
        own tensor, which every step updates in place: clone to keep a
        snapshot."""
        return self._cf(self._view(self._base, self._cap))

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def structure(self) -> str:
        """Member storage layout: 'dense' or 'blocktridiag'."""
        return self._structure

    @property
    def block(self) -> Optional[int]:
        """Block size b of a blocktridiag fleet, None for dense (the
        coalescer's block-local contract key)."""
        return self._block

    @property
    def empty_slots(self) -> Tuple[int, ...]:
        """Free slots at the current rung, next-assigned first (LIFO)."""
        return tuple(reversed(self._empty_slots))

    @property
    def slot_to_user(self) -> Dict[int, object]:
        """Occupied slot -> user (a copy)."""
        return dict(self._slot_to_user)

    @property
    def steps(self) -> StepSet:
        """The store's step set (built steps, cold-dispatch counter)."""
        return self._steps

    @property
    def row_dtype(self) -> np.dtype:
        """Host dtype buffered rows are kept in: float64 for an f64 fleet,
        float32 otherwise (the engine casts to the storage dtype)."""
        return row_dtype_for(self._storage)

    @property
    def active(self) -> int:
        return len(self._slot_of)

    def users(self):
        return tuple(self._slot_of)

    def slot(self, user) -> int:
        return self._slot_of[user]

    def has(self, user) -> bool:
        return user in self._slot_of

    def last_used(self, user) -> int:
        return self._last_used[user]

    def factor_for(self, user) -> CholFactor:
        """A single-user factor: a copy of the user's member, with the
        fleet's execution metadata."""
        s = self.slot(user)
        fleet = self._view(self._base, self._cap)
        if self._structure == "blocktridiag":
            member = _structure.BlockTriDiagStorage(fleet.diag[s].clone(),
                                                    fleet.off[s].clone())
        elif self._mesh is not None:
            member = self._placed_value(self._base[0][s].clone())
        else:
            member = fleet[s].clone()
        return self._cf(member)

    # -- warmup --------------------------------------------------------------
    def warmup(self, **kw):
        """Build every ladder rung's steps; see
        ``repro_torch.stream.warmup.warmup_store``."""
        from repro_torch.stream.warmup import warmup_store

        return warmup_store(self, **kw)

    # -- the steps -----------------------------------------------------------
    def _vb(self, role: str, w: int) -> torch.Tensor:
        """The static V block of ``role`` ('up'/'dn') and width ``w`` over
        the members the store holds (a rung reads its leading members)."""
        buf = self._vbuf.get((role, w))
        if buf is None:
            buf = torch.zeros((self._held, self.n, w), dtype=self._row_torch,
                              device=self.device)
            self._vbuf[(role, w)] = buf
        return buf

    def _gb(self, w: int) -> torch.Tensor:
        """The static Gram block ``(held, w, w)`` of a guarded downdate."""
        buf = self._gram.get(w)
        if buf is None:
            acc = (torch.float64 if self._storage == torch.float64
                   else torch.float32)
            buf = torch.zeros((self._held, w, w), dtype=acc,
                              device=self.device)
            self._gram[w] = buf
        return buf

    def _make_step(self, name: str, cap: int, widths: Tuple[int, ...]
                   ) -> _Step:
        """The parts of step ``name`` at rung ``cap``: callables over a
        fleet base (the store's own, or a scratch copy), reading the static
        inputs. Static buffers are allocated here, before any capture, and
        sliced to the rung at each call (on the CPU a promotion
        reallocates them)."""
        view = lambda base: self._view(base, cap)  # noqa: E731
        wu, wd = widths[0] if widths else None, widths[-1] if widths else None
        vb = lambda role, w: self._vb(role, w)[:cap]  # noqa: E731
        if name == "up":
            vb("up", wu)

            def up(base):
                F = view(base)
                _write(F, self._cf(F).update(vb("up", wu)).data)

            return _Step([up], None, cap)
        if name in ("down", "both") and self._mesh is not None:
            # The sharded verdict is device ops and a MIN all_reduce: the
            # guarded downdate is one part.
            both = name == "both"
            if both:
                vb("up", wu)
            vb("dn", wd)

            def guarded(base):
                F = view(base)
                f = self._cf(F)
                if both:
                    f = f.update(vb("up", wu))
                new, ok = f.downdate_guarded(vb("dn", wd))
                _write(F, new.data)
                self._ok[:cap].copy_(ok)

            return _Step([guarded], None, cap)
        if name in ("down", "both"):
            both = name == "both"
            if both:
                vb("up", wu)
            vb("dn", wd)
            gram = lambda: self._gb(wd)[:cap]  # noqa: E731
            gram()

            def pre(base):
                F = view(base)
                if both:
                    _write(F, self._cf(F).update(vb("up", wu)).data)
                gram().copy_(self._cf(F).guard_gram(vb("dn", wd)))

            def verdict():
                self._ok[:cap].copy_(_solve.gram_verdict(gram()))

            def pick(base):
                f = self._cf(view(base))
                _write(f.data, f.guard_select(f.downdate(vb("dn", wd)),
                                              self._ok[:cap]).data)

            return _Step([pre, pick], verdict, cap)
        if name == "scale":
            alpha = self._alpha

            def scale(base):
                F = view(base)
                _write(F, self._cf(F).scale(alpha).data)

            return _Step([scale], None, cap)
        if name == "slot_set":
            slot, member = self._slot, self._member

            def slot_set(base):
                for f, m in zip(_leaves(view(base)), member):
                    f.index_copy_(0, slot, m[None])

            return _Step([slot_set], None, cap)
        if name == "promote":
            nxt = self.ladder[self.ladder.index(cap) + 1]

            def promote(base):
                self._fill_fresh(base, cap, nxt)

            return _Step([promote], None, nxt)
        raise ValueError(f"unknown step {name!r}")

    # -- fleet membership ---------------------------------------------------
    def admit(self, user, *, scale: Optional[float] = None,
              tick: int = 0) -> int:
        """Assign ``user`` a slot warm-started at ``scale * I``, promoting
        to the next ladder rung when the current one is full (raises
        ``LadderFullError`` at the top). Idempotent for admitted users."""
        if user in self._slot_of:
            self._last_used[user] = tick
            return self._slot_of[user]
        if not self._empty_slots:
            self._promote()
        s = self._empty_slots.pop()
        member = [m[None] for m in self._member]
        self._fill_fresh(member, 0, 1, scale)
        self._slot.fill_(s)
        self._steps.call("slot_set", self._cap)
        self._slot_of[user] = s
        self._slot_to_user[s] = user
        self._last_used[user] = tick
        obs_metrics.counter("repro.stream.admissions").inc()
        self._observe_occupancy()
        return s

    def evict(self, user) -> int:
        """Free a user's slot (data is reset on the next admit). A store
        managed by a ``StreamService`` is evicted through the service."""
        s = self._slot_of.pop(user)
        del self._slot_to_user[s]
        del self._last_used[user]
        self._empty_slots.append(s)
        obs_metrics.counter("repro.stream.evictions").inc()
        self._observe_occupancy()
        return s

    def _promote(self) -> None:
        """Cross the ladder boundary: the members up to the next rung
        become fresh warm starts (the ``promote`` step; the fleet's tensor
        holds them, grown first on the CPU, so nothing is copied)."""
        cap = self._cap
        idx = self.ladder.index(cap)
        if idx + 1 >= len(self.ladder):
            raise LadderFullError(
                f"fleet full at the top ladder rung ({cap} slots, "
                f"ladder={self.ladder}); evict users, compact(), or "
                "construct the store with a taller ladder=")
        nxt = self.ladder[idx + 1]
        if nxt > self._held:
            self._grow(nxt)
        self._steps.call("promote", cap)
        self._cap = nxt
        self._empty_slots.extend(range(nxt - 1, cap - 1, -1))
        obs_metrics.counter("repro.stream.promotions").inc()
        self._observe_occupancy()

    def compact(self, *, min_capacity: int = 1) -> Dict[object, int]:
        """Shrink the fleet to the smallest rung holding its active slots
        (one eager gather + remap, a maintenance event). Returns the new
        user -> slot mapping."""
        order = sorted(self._slot_of.items(), key=lambda kv: kv[1])
        keep = [s for _, s in order]
        new_cap = self._rung_for(max(len(keep), min_capacity))
        idx = keep + [0] * (new_cap - len(keep))  # pad slots: reset on admit
        gather = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        for t in self._base:
            t[:new_cap].copy_(t[gather])
        self._cap = new_cap
        self._slot_of = {u: i for i, (u, _) in enumerate(order)}
        self._slot_to_user = {i: u for u, i in self._slot_of.items()}
        self._empty_slots = list(range(new_cap - 1, len(keep) - 1, -1))
        obs_metrics.counter("repro.stream.compactions").inc()
        self._observe_occupancy()
        return dict(self._slot_of)

    # -- mutations ----------------------------------------------------------
    def _stage(self, role: str, V) -> int:
        """Copy a (capacity, n, w) block into the static V block; returns
        w."""
        V = torch.as_tensor(V)
        if V.ndim != 3 or V.shape[0] != self._cap or V.shape[1] != self.n:
            raise ValueError(
                f"block must be (capacity={self._cap}, n={self.n}, w), got "
                f"{tuple(V.shape)}")
        w = int(V.shape[-1])
        self._vb(role, w)[:self._cap].copy_(V)
        return w

    def apply(self, Vup=None, Vdn=None):
        """One sign-scheduled flush over the whole fleet.

        Args:
          Vup: (capacity, n, k) zero-padded update block (host array or
            tensor), or None.
          Vdn: (capacity, n, k) zero-padded downdate block, or None.

        Returns:
          (capacity,) bool feasibility verdicts (a tensor on the fleet's
          device) when a downdate block ran (slots with all-zero columns
          report True), else None. Exactly ONE batched mutation is counted
          per non-None block (``mutations_issued``).
        """
        if Vup is None and Vdn is None:
            return None
        cap = self._cap
        wu = self._stage("up", Vup) if Vup is not None else None
        wd = self._stage("dn", Vdn) if Vdn is not None else None
        if wu is not None and wd is not None:
            _count_mutation(2, sign="both")
            self._steps.call("both", cap, (wu, wd))
        elif wu is not None:
            _count_mutation(1, sign="up")
            self._steps.call("up", cap, (wu,))
            return None
        else:
            _count_mutation(1, sign="down")
            self._steps.call("down", cap, (wd,))
        return self._ok[:cap].clone()

    def decay(self, alpha) -> None:
        """Exponential forgetting: every slot becomes the factor of
        ``alpha^2 A`` (the engine's ``scale``); the multiplier travels in
        the fleet's row dtype."""
        self._alpha.fill_(float(self.row_dtype.type(alpha)))
        self._steps.call("scale", self._cap)

    def bucket_for(self, k: int) -> int:
        """Smallest width bucket that carries ``k`` rows."""
        for w in self.widths:
            if w >= k:
                return w
        raise ValueError(
            f"{k} rows exceed the largest width bucket {self.widths[-1]}")

    def pad_block(self, rows_by_slot: Dict[int, np.ndarray]) -> np.ndarray:
        """Stack per-slot row lists into the static zero-padded
        (capacity, n, bucket) host block ``apply`` expects, ``bucket`` the
        smallest width bucket carrying the largest per-slot row count."""
        k_max = max((rows.shape[0] for rows in rows_by_slot.values()),
                    default=1)
        if k_max > self.width:
            raise ValueError(
                f"{k_max} rows exceed coalesce width {self.width}")
        bucket = self.bucket_for(max(k_max, 1))
        out = np.zeros((self.capacity, self.n, bucket), self.row_dtype)
        for s, rows in rows_by_slot.items():
            k = rows.shape[0]
            if k:
                out[s, :, :k] = rows.T
        return out

    def __repr__(self):
        return (f"FactorStore(n={self.n}, capacity={self.capacity}, "
                f"active={self.active}, width={self.width}, "
                f"ladder={self.ladder}, factor={self.factor!r})")
