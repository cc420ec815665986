"""Process-local metrics registry: counters, gauges, histograms (DESIGN.md §13).

The PyTorch port's own copy of ``repro.obs.metrics``: the port imports
nothing of the JAX package, and one test process that holds both packages
must not mix their counters. The API and the bucket edges are the same.

The source paper's performance story is *accounting* — launches,
bytes-per-update, dependency-chain stalls. This is the single seam those
quantities report through:

* **Counter** — monotonically increasing event count (``inc``).
* **Gauge** — last-write-wins instantaneous value (``set``).
* **Histogram** — fixed log-spaced buckets (power-of-two edges, exactly
  representable, so golden tests can pin them): ``observe`` drops a value
  into its bucket, ``percentile`` reads p50/p99 back out. The serving
  stack computes its own latency percentiles instead of every benchmark
  recomputing them.

Series are keyed by ``(name, labels)`` — labels are the
backend/lowering/structure/dtype/sign axes the conformance tables slice
by. ``snapshot()`` returns a plain-dict view (JSON-ready; the benchmark
snapshot files embed it verbatim), ``export_jsonl`` appends one record
per call, and ``total(name)`` sums a metric across every label set —
which is exactly what the legacy counter shims return, so the shims are
equivalent to the registry *by construction*.

Thread-safety: one lock per registry guards both the series table and
every mutation — the background flush worker (DESIGN.md §11) increments
from its own thread while the producer reads snapshots. Mutations are a
dict lookup + integer add; contention at serving rates is negligible
next to a device dispatch.

Stdlib-only on purpose: every layer of the port imports this module.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

#: Fixed log-spaced latency buckets, in SECONDS: power-of-two multiples of
#: 1 microsecond, 1us .. ~16.8s (25 edges + overflow). Power-of-two edges
#: are exactly representable in binary floating point, so the golden test
#: can pin them without tolerance gymnastics.
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(1e-6 * 2 ** i for i in range(25))

#: Width/occupancy buckets: powers of two 1 .. 4096 (the coalesce-width
#: and ladder-rung scales are both power-of-two ladders already).
WIDTH_BUCKETS: Tuple[float, ...] = tuple(float(2 ** i) for i in range(13))


def _label_key(labels: Dict[str, object]) -> str:
    """Canonical series key: ``name{a=1,b=x}`` with sorted label names."""
    if not labels:
        return ""
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return "{" + inner + "}"


class _Metric:
    """Shared plumbing: every metric belongs to one registry whose lock
    guards its mutations (see module docstring)."""

    def __init__(self, registry: "Registry", name: str,
                 labels: Dict[str, object]):
        self._lock = registry._lock
        self.name = name
        self.labels = dict(labels)


class Counter(_Metric):
    """Monotonic event counter."""

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._value = 0

    def inc(self, k: int = 1) -> None:
        held = getattr(_LOCAL, "deferred", None)
        if held is not None:
            held.add(("series", self.name,
                      tuple(sorted(self.labels.items()))), k)
            return
        with self._lock:
            self._value += k

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Last-write-wins instantaneous value (queue depth, occupancy)."""

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, k: float = 1.0) -> None:
        with self._lock:
            self._value += k

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram. ``counts[i]`` holds observations with
    ``edges[i-1] < v <= edges[i]`` (``counts[0]``: ``v <= edges[0]``);
    the trailing slot is the overflow bucket, so ``len(counts) ==
    len(edges) + 1`` always."""

    def __init__(self, registry, name, labels,
                 edges: Tuple[float, ...] = LATENCY_BUCKETS_S):
        super().__init__(registry, name, labels)
        self.edges = tuple(float(e) for e in edges)
        self._counts = [0] * (len(self.edges) + 1)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        idx = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Bucket-resolution percentile (upper edge of the rank's bucket)."""
        with self._lock:
            return percentile_from(
                {"edges": self.edges, "counts": list(self._counts),
                 "count": self._count}, q)


def percentile_from(hist: Dict, q: float) -> float:
    """Percentile from a histogram *snapshot entry* (also works on the
    JSON-round-tripped dicts in ``BENCH_stream.json`` — the report
    renderer reads percentiles from recorded snapshots with this).

    Returns the upper edge of the bucket the rank falls in (overflow
    observations report the last edge — the histogram cannot resolve
    beyond its range); NaN on an empty histogram.
    """
    count = hist["count"]
    if count == 0:
        return float("nan")
    rank = max(1, int(round(q / 100.0 * count)))
    seen = 0
    edges, counts = hist["edges"], hist["counts"]
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return float(edges[min(i, len(edges) - 1)])
    return float(edges[-1])


class Registry:
    """One process-local metrics registry (see module docstring)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._series: Dict[Tuple[str, str], _Metric] = {}
        #: Bumped by ``reset``: a caller that keeps a series object (to
        #: skip the lookup on a hot path) refetches it when this moves.
        self.generation = 0

    def _get(self, cls, name: str, labels: Dict[str, object], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = cls(self, name, labels, **kw)
                self._series[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{key[1]} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, buckets: Optional[Iterable[float]] =
                  None, **labels) -> Histogram:
        kw = {} if buckets is None else {"edges": tuple(buckets)}
        return self._get(Histogram, name, labels, **kw)

    def total(self, name: str) -> float:
        """Sum of a counter/gauge across every label set — the quantity the
        legacy counter shims (``mutations_issued`` et al.) return."""
        with self._lock:
            vals = [m._value for (n, _), m in self._series.items()
                    if n == name and not isinstance(m, Histogram)]
        return sum(vals)

    def value(self, name: str, **labels) -> float:
        """One series' current value (0 when the series does not exist yet
        — reading a metric must never create it)."""
        key = (name, _label_key(labels))
        with self._lock:
            m = self._series.get(key)
            return 0 if m is None else m._value

    def snapshot(self) -> Dict:
        """Plain-dict view of every series, keyed ``name{labels}``:

        ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``

        Histogram entries carry count/sum/edges/counts so percentiles are
        recomputable from the snapshot alone (``percentile_from``) — the
        benchmark trajectory files embed these verbatim.
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for (name, lk), m in sorted(self._series.items()):
                key = name + lk
                if isinstance(m, Counter):
                    out["counters"][key] = m._value
                elif isinstance(m, Gauge):
                    out["gauges"][key] = m._value
                else:
                    out["histograms"][key] = {
                        "count": m._count,
                        "sum": m._sum,
                        "edges": list(m.edges),
                        "counts": list(m._counts),
                    }
        return out

    def export_jsonl(self, path) -> None:
        """Append one timestamped snapshot record (JSONL, same append-only
        convention as the benchmark trajectory files)."""
        rec = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
               **self.snapshot()}
        with open(path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    def reset(self) -> None:
        """Drop every series (tests only — the legacy shims are cumulative
        within a process, like the module globals they replaced)."""
        with self._lock:
            self._series.clear()
            self.generation += 1


def diff_snapshots(before: Dict, after: Dict) -> Dict:
    """``after - before`` per series: counters/gauges subtract, histogram
    counts/sum subtract bucket-wise (edges must match). Series absent from
    ``before`` pass through — this is how a benchmark isolates one drive's
    metrics without resetting the process-cumulative registry."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for kind in ("counters", "gauges"):
        for key, v in after.get(kind, {}).items():
            out[kind][key] = v - before.get(kind, {}).get(key, 0)
    for key, h in after.get("histograms", {}).items():
        h0 = before.get("histograms", {}).get(key)
        if h0 is None:
            out["histograms"][key] = h
            continue
        if list(h0["edges"]) != list(h["edges"]):
            raise ValueError(f"histogram {key!r} edges changed between "
                             "snapshots — cannot diff")
        out["histograms"][key] = {
            "count": h["count"] - h0["count"],
            "sum": h["sum"] - h0["sum"],
            "edges": list(h["edges"]),
            "counts": [a - b for a, b in zip(h["counts"], h0["counts"])],
        }
    return out


#: The default registry every instrumented layer reports to. Tests build
#: private ``Registry()`` instances; production code uses these
#: module-level conveniences.
REGISTRY = Registry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


_HELD: Dict[Tuple, Tuple] = {}

_LOCAL = threading.local()


class Deferred:
    """Counts one thread held back inside ``deferring``: counter increments
    by series (applied to the default registry), and the increments of
    other counters that consult ``deferred()`` (a kernel wrapper's
    ``LaunchCounter``) by object. ``apply`` makes them count, once per
    call."""

    def __init__(self):
        self.counts: Dict[Tuple, int] = {}

    def add(self, key: Tuple, k: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + k

    def apply(self) -> None:
        for key, k in self.counts.items():
            if key[0] == "series":
                counter(key[1], **dict(key[2])).inc(k)
            else:
                key[1].add(k)


def deferred() -> Optional[Deferred]:
    """The calling thread's ``Deferred`` inside ``deferring``, else None."""
    return getattr(_LOCAL, "deferred", None)


@contextlib.contextmanager
def deferring():
    """Hold the calling thread's counter increments in a ``Deferred``
    instead of counting them; other threads count as usual. The stream
    store captures a CUDA graph inside this: the launches a capture
    records did not run, and each replay of the graph applies them."""
    prev = deferred()
    _LOCAL.deferred = held = Deferred()
    try:
        yield held
    finally:
        _LOCAL.deferred = prev


def held_counter(name: str, **labels) -> Counter:
    """``counter(name, **labels)`` for a hot path: the series object is kept
    and looked up again only when the default registry was replaced or
    reset (a kernel wrapper counts every launch)."""
    key = (name, *labels.items())
    hit = _HELD.get(key)
    if (hit is None or hit[0] is not REGISTRY
            or hit[1] != REGISTRY.generation):
        hit = (REGISTRY, REGISTRY.generation, REGISTRY.counter(name, **labels))
        _HELD[key] = hit
    return hit[2]


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, *, buckets: Optional[Iterable[float]] = None,
              **labels) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets, **labels)


def total(name: str) -> float:
    return REGISTRY.total(name)


def value(name: str, **labels) -> float:
    return REGISTRY.value(name, **labels)


def snapshot() -> Dict:
    return REGISTRY.snapshot()


def export_jsonl(path) -> None:
    REGISTRY.export_jsonl(path)
