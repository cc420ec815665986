"""``repro_torch.obs`` — the port's own metrics registry (DESIGN.md §13).

Span tracing (``repro.obs.tracing``) is not ported yet (ROADMAP queue 1).
"""
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
    snapshot,
    total,
    value,
)
