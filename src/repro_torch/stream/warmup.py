"""Warmup + retrace guard: serving without captures over the bucket ladder.

Port of ``repro.stream.warmup``. Rank-k modification is bandwidth-bound and
launch-dominated, so every microsecond of host time on the serving path is
a real fraction of the work. The JAX package compiles every serving
executable ahead of time; the port captures every serving step as CUDA
graphs ahead of time. Because the ``FactorStore``'s capacity ladder and
width buckets are FIXED and enumerable, so is every step a flush can run.

``warmup_store(store)`` walks ``store.ladder`` × ``store.widths`` and builds
the up / down / both / scale / slot_set steps of each rung (``both`` for
every pair of widths) plus ``promote`` for each rung boundary. Where the
store's ``step_mode`` is 'graphs' (CUDA, every collective capturable) a
build runs the step once eagerly on a scratch copy of the fleet, on the
capture stream (the kernels are built first, and a sharded step's mesh
layouts and process groups are made there, never inside a capture), then
captures its graphs; elsewhere (the CPU, a sharded store over gloo with
more than one rank) it records the eager step. The built steps live in the store's
``StepSet``, so after warmup admit, flush, evict, readmit, decay and rung
promotion never build.

The **retrace guard**: the first use of a step key counts one
``repro.stream.step_traces`` (``store.traces_counted()``);
``assert_no_retrace()`` brackets a serving sequence and raises
``RetraceError`` if the counter moved. A restored store is a new fleet at
new addresses: ``restore_service(..., warm=True)`` warms it (and counts
its captures) before its log replays.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional, Tuple

from repro_torch.core import backends
from repro_torch.obs import tracing as obs_tracing
from repro_torch.stream import store as store_mod
from repro_torch.stream.store import FactorStore


class RetraceError(AssertionError):
    """A step was built (captured) inside an ``assert_no_retrace`` block."""


@dataclasses.dataclass
class TraceWatch:
    """Live view of the trace counter inside a guard block."""

    start: int

    @property
    def traces(self) -> int:
        return store_mod.traces_counted() - self.start


@contextlib.contextmanager
def watch_traces():
    """Count step builds across a block (no failure — diagnostics)."""
    yield TraceWatch(start=store_mod.traces_counted())


@contextlib.contextmanager
def assert_no_retrace(what: str = "serving sequence"):
    """Hard retrace guard: raise ``RetraceError`` if any step is built
    inside the block (on CUDA: a graph capture on the serving path)."""
    watch = TraceWatch(start=store_mod.traces_counted())
    yield watch
    if watch.traces:
        raise RetraceError(
            f"{watch.traces} step trace(s) inside {what!r} — the warm "
            "serving path must replay steps built by warmup only "
            "(did warmup() cover this rung/width/dtype signature?)")


@dataclasses.dataclass
class WarmupReport:
    """What one ``warmup_store`` call built.

    Attributes:
      compiled: steps built by THIS call.
      cached: steps the store had already built.
      rungs: ladder rungs covered.
      widths: width buckets covered.
      seconds: wall-clock of the whole call.
      compile_seconds: seconds per step kind for the steps built by this
        call (the graph captures on CUDA, their eager warm-up run
        included); the same timings land in the registry histogram
        ``repro.stream.compile_seconds{step=...,sharded=0|1}``.
      graphs: CUDA graphs captured by this call (0 where the store's
        ``step_mode`` is 'eager').
      lowering: the fused-kernel lowering the steps run ('portable' or
        'mosaic', one kernel).
    """

    compiled: int = 0
    cached: int = 0
    rungs: Tuple[int, ...] = ()
    widths: Tuple[int, ...] = ()
    seconds: float = 0.0
    compile_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    graphs: int = 0
    lowering: str = "portable"


def warmup_store(store: FactorStore, *,
                 rungs: Optional[Tuple[int, ...]] = None,
                 widths: Optional[Tuple[int, ...]] = None) -> WarmupReport:
    """Build the store's steps over its ladder.

    Args:
      store: the fleet to warm.
      rungs: ladder subset to warm (default: the whole ladder — compact
        can move DOWN a rung, so lower rungs stay reachable).
      widths: width-bucket subset (default: the store's buckets).

    Returns a ``WarmupReport``. Warmup is the one phase allowed to build;
    bracket everything after it with ``assert_no_retrace``. Run it before
    ``start_background`` (captures take the device's streams).
    """
    rungs = store.ladder if rungs is None else tuple(rungs)
    widths = store.widths if widths is None else tuple(widths)
    for r in rungs:
        if r not in store.ladder:
            raise ValueError(f"rung {r} is not on the ladder {store.ladder}")
    steps = store.steps
    report = WarmupReport(rungs=tuple(rungs), widths=tuple(widths),
                          lowering=backends.resolve_lowering(
                              getattr(store.factor, "lowering", None)))
    graphs0 = steps.graphs
    t0 = time.perf_counter()

    def build(name, cap, ws=()):
        t = time.perf_counter()
        if steps.build(name, cap, ws):
            report.compiled += 1
            report.compile_seconds[name] = (
                report.compile_seconds.get(name, 0.0)
                + time.perf_counter() - t)
        else:
            report.cached += 1

    with obs_tracing.span("stream.warmup", rungs=len(rungs),
                          widths=len(widths)) as ev:
        for cap in rungs:
            for w in widths:
                build("up", cap, (w,))
                build("down", cap, (w,))
                for w2 in widths:
                    build("both", cap, (w, w2))
            build("scale", cap)
            build("slot_set", cap)
        for cap, nxt in zip(store.ladder, store.ladder[1:]):
            if cap in rungs or nxt in rungs:
                build("promote", cap)
        ev.labels.update(compiled=report.compiled, cached=report.cached)

    report.graphs = steps.graphs - graphs0
    report.seconds = time.perf_counter() - t0
    return report


def warmup_service(svc) -> WarmupReport:
    """Warm a ``StreamService``'s store (flush, tick and the background
    worker all run the store's steps)."""
    return warmup_store(svc.store)
