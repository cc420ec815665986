"""``repro_torch.obs`` — the port's measurement layer (DESIGN.md §13).

The port's own metrics registry (``repro_torch.obs.metrics``) and span
tracing with a Chrome ``trace_event`` exporter (``repro_torch.obs
.tracing``), both separate from the JAX package's. Importing this package
registers the exit hook that writes the trace and the metrics snapshot
when ``REPRO_TORCH_OBS_TRACE`` / ``REPRO_TORCH_OBS_METRICS`` name files.
"""
import atexit

from repro_torch.obs.metrics import (  # noqa: F401
    LATENCY_BUCKETS_S,
    WIDTH_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    diff_snapshots,
    gauge,
    histogram,
    percentile_from,
    snapshot,
    total,
    value,
)
from repro_torch.obs.tracing import (  # noqa: F401
    METRICS_ENV,
    RECORDER,
    TRACE_ENV,
    SpanEvent,
    SpanRecorder,
    _export_at_exit,
    chrome_trace,
    export_chrome_trace,
    instant,
    span,
    traced,
)

atexit.register(_export_at_exit)


def summary_line() -> str:
    """One-line serving-metrics summary (the examples' exit line, in the
    JAX package's format), read back from the port's registry."""
    merged = None
    for key, h in snapshot()["histograms"].items():
        if key.startswith("repro.stream.flush_seconds"):
            if merged is None:
                merged = {"count": 0, "sum": 0.0, "edges": h["edges"],
                          "counts": [0] * len(h["counts"])}
            merged["count"] += h["count"]
            merged["sum"] += h["sum"]
            merged["counts"] = [a + b for a, b in
                                zip(merged["counts"], h["counts"])]
    flush = None
    if merged and merged["count"]:
        p50 = percentile_from(merged, 50) * 1e6
        p99 = percentile_from(merged, 99) * 1e6
        flush = f"flushes={merged['count']} p50<={p50:.0f}us p99<={p99:.0f}us"
    bits = [
        f"mutations={int(total('repro.stream.mutations'))}",
        flush or "flushes=0",
        f"retraces={int(total('repro.stream.retraces'))}",
        f"admissions={int(total('repro.stream.admissions'))}",
        f"evictions={int(total('repro.stream.evictions'))}",
        f"wal_bytes={int(total('repro.stream.wal_bytes'))}",
        f"occupancy={value('repro.stream.ladder_occupancy'):.2f}",
        f"spans={len(RECORDER)}",
    ]
    return "obs: " + " ".join(bits)
