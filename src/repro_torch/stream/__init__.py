"""``repro_torch.stream``: streaming update service over a managed fleet.

Port of ``repro.stream``: ``Coalescer`` buffers per-user rank-1 traffic in
ring buffers and drains it as sign-scheduled rank-k blocks; ``FactorStore``
manages the batched fleet those blocks mutate, one preallocated device
tensor stepped in place over a fixed capacity **bucket ladder** with an
explicit slot map; ``warmup`` builds every rung's steps (CUDA graphs on the
card) so steady-state serving never builds (``assert_no_retrace`` is the
enforcement hook); ``StreamService`` ties them together with window
forgetting, deadline flushes, decay and an optional background flush
worker; ``durability`` makes the whole thing survive a kill through a
checkpoint + replay-log restore, in the JAX package's formats.
"""
from repro_torch.stream.coalescer import Coalescer, DrainResult, RingBuffer
from repro_torch.stream.durability import (
    ReplayLog,
    checkpoint_service,
    decode_row,
    encode_row,
    restore_service,
)
from repro_torch.stream.service import FlushReport, StreamService
from repro_torch.stream.store import (
    DEFAULT_LADDER,
    FactorStore,
    LadderFullError,
    ladder_from,
    mutations_issued,
    traces_counted,
)
from repro_torch.stream.warmup import (
    RetraceError,
    WarmupReport,
    assert_no_retrace,
    warmup_service,
    warmup_store,
    watch_traces,
)

__all__ = [
    "Coalescer",
    "DrainResult",
    "RingBuffer",
    "DEFAULT_LADDER",
    "FactorStore",
    "LadderFullError",
    "ladder_from",
    "FlushReport",
    "StreamService",
    "ReplayLog",
    "checkpoint_service",
    "restore_service",
    "encode_row",
    "decode_row",
    "mutations_issued",
    "traces_counted",
    "RetraceError",
    "WarmupReport",
    "assert_no_retrace",
    "warmup_service",
    "warmup_store",
    "watch_traces",
]
