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
