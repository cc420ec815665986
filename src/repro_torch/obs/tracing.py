"""Span tracing + Chrome ``trace_event`` export (DESIGN.md §13).

The port's own copy of ``repro.obs.tracing``: the same ``SpanEvent`` /
``SpanRecorder`` / ``span`` / ``instant`` / ``traced`` API and the same
exported schema (``name/ph/ts/dur/pid/tid`` on every event, labels in
``args``), with a recorder of its own, so a process that holds both
packages never mixes their spans.

``span()`` brackets a region of the serving stack (a flush, a background
drain, a checkpoint, a warmup capture) and records one structured event —
name, start, duration, labels, thread — into a bounded ring buffer.
``chrome_trace()`` renders the buffer in the Chrome ``trace_event`` JSON
format, so a ``StreamService`` run opens in a trace viewer
(chrome://tracing, ui.perfetto.dev): flush spans on the producer thread,
drain spans on the flush worker's thread, checkpoint/restore spans
wherever they ran.

Recording is always on (a deque append + two ``perf_counter`` calls per
span) and bounded (oldest events drop first), so tracing needs no enable
flag on the hot path. Export is explicit (``export_chrome_trace``) or
environment-driven through the port's OWN names:
``REPRO_TORCH_OBS_TRACE=path.json`` writes the trace at process exit and
``REPRO_TORCH_OBS_METRICS=path.json`` the port's metrics snapshot. The
exit hook is registered when ``repro_torch.obs`` is imported; it reads only
these names, never the JAX package's ``REPRO_OBS_TRACE`` /
``REPRO_OBS_METRICS``, so a test process that imports both packages has
each hook write its own file.

Timestamps and durations are microseconds from the recorder's epoch, the
unit the trace_event format specifies. Stdlib-only, like
``repro_torch.obs.metrics``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional

TRACE_ENV = "REPRO_TORCH_OBS_TRACE"
METRICS_ENV = "REPRO_TORCH_OBS_METRICS"

#: Default ring capacity: enough for ~100k spans (a long serving session)
#: while bounding memory to a few tens of MB worst-case.
DEFAULT_CAPACITY = 131072


@dataclasses.dataclass
class SpanEvent:
    """One recorded span (durations and timestamps in MICROSECONDS —
    the trace_event unit — relative to the recorder's epoch)."""

    name: str
    ts: float
    dur: float
    tid: int
    labels: Dict[str, object] = dataclasses.field(default_factory=dict)
    phase: str = "X"  # 'X' complete span | 'i' instant


class SpanRecorder:
    """Bounded thread-safe ring buffer of ``SpanEvent``s."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._ring: "collections.deque[SpanEvent]" = collections.deque(
            maxlen=capacity)
        self._epoch = time.perf_counter()

    def now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def record(self, event: SpanEvent) -> None:
        with self._lock:
            self._ring.append(event)

    def events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


#: The default recorder every instrumented layer records into.
RECORDER = SpanRecorder()


@contextlib.contextmanager
def span(name: str, *, recorder: Optional[SpanRecorder] = None, **labels):
    """Record one complete ('X') span around the block. Yields the event
    (its ``labels`` dict is live — a block can attach results, e.g. the
    flush attaches its width/mutation counts before the span closes).

    ``recorder is None`` — not truthiness — selects the default: an EMPTY
    recorder is falsy (``__len__``), and must still receive its spans."""
    rec = RECORDER if recorder is None else recorder
    ev = SpanEvent(name=name, ts=rec.now_us(), dur=0.0,
                   tid=threading.get_ident(), labels=labels)
    try:
        yield ev
    finally:
        ev.dur = rec.now_us() - ev.ts
        rec.record(ev)


def instant(name: str, *, recorder: Optional[SpanRecorder] = None,
            **labels) -> None:
    """Record a zero-duration instant event (e.g. a retrace marker)."""
    rec = RECORDER if recorder is None else recorder
    rec.record(SpanEvent(name=name, ts=rec.now_us(), dur=0.0,
                         tid=threading.get_ident(), labels=labels,
                         phase="i"))


def traced(name: Optional[str] = None, **labels):
    """Decorator form of ``span`` — the function body becomes one span
    named after the function (or ``name=``)."""

    def deco(fn):
        span_name = name or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with span(span_name, **labels):
                return fn(*args, **kw)

        return wrapper

    return deco


def chrome_trace(events: Optional[List[SpanEvent]] = None) -> Dict:
    """The Chrome ``trace_event`` JSON object for ``events`` (default: the
    default recorder's ring). Every event carries name/ph/ts/dur/pid/tid;
    labels ride in ``args``; instant events add the thread scope marker
    the viewer expects."""
    pid = os.getpid()
    out = []
    for ev in (RECORDER.events() if events is None else events):
        rec = {
            "name": ev.name,
            "ph": ev.phase,
            "ts": ev.ts,
            "dur": ev.dur,
            "pid": pid,
            "tid": ev.tid,
            "args": {k: _jsonable(v) for k, v in ev.labels.items()},
        }
        if ev.phase == "i":
            rec["s"] = "t"
        out.append(rec)
    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs"}}


def _jsonable(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


def export_chrome_trace(path, events: Optional[List[SpanEvent]] = None
                        ) -> None:
    """Write the trace to ``path`` (open it in chrome://tracing or
    ui.perfetto.dev)."""
    with open(path, "w") as fh:
        json.dump(chrome_trace(events), fh)


def _export_at_exit() -> None:
    """The ``REPRO_TORCH_OBS_TRACE``/``REPRO_TORCH_OBS_METRICS`` exit hook
    (registered by ``repro_torch.obs`` at import; env read at EXIT so a
    toggle set after import still works). Failures are swallowed —
    observability export must never turn a clean exit into a crash."""
    trace_path = os.environ.get(TRACE_ENV)
    if trace_path:
        try:
            export_chrome_trace(trace_path)
        except OSError:
            pass
    metrics_path = os.environ.get(METRICS_ENV)
    if metrics_path:
        try:
            from repro_torch.obs import metrics

            with open(metrics_path, "w") as fh:
                json.dump(metrics.snapshot(), fh)
        except OSError:
            pass
