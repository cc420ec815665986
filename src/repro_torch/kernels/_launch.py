"""What every CUDA kernel wrapper of the port shares: launch counters, the
kernels' limits and the rules that keep the CUDA routes inside them.

The kernels' tile math (``csrc/chol_tile.cuh``) takes a tile of at most
``MAX_PANEL`` rows and at most ``MAX_K`` rotations a row (one warp scan).
The routes above the kernels stay within that without changing the
function they compute:

* ``rank_groups``: a rank-k modification with k > 32 runs as successive
  column groups of at most 32, ``A ± V Vᵀ = A ± V₁V₁ᵀ ± V₂V₂ᵀ ...`` (every
  partial downdate of a feasible downdate is feasible);
* ``kernel_panel``: a panel above 256 runs at its largest divisor of at
  most 256, which divides every length padded to the panel.

The cascade's transform-GEMM apply (``csrc/gemm_tile.cuh``) takes its K
split over a thread-block cluster and the slices each rank sums from here:
``gemm_split`` and ``gemm_split_bounds``, priced by the tile's layout
(``GEMM_BN``, ``GEMM_BK``, ``GEMM_WARP_BLOCKS``), which a test on the card
holds equal to the kernel's own (``repro_gemm_tile_layout``). The paper's
wavefront apply (``panel_kernels.cu`` ``panel_paper_kernel``) takes the
warps of its CTAs from ``paper_warps``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import List, Tuple

import torch

from repro_torch.obs import metrics as _obs_metrics

#: The tile math's limits (csrc/chol_tile.cuh kMaxPanel / kMaxK).
MAX_PANEL = 256
MAX_K = 32
#: (storage, accum) pairs every kernel is instantiated for -> dtype code.
KERNEL_DTYPES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.float64, torch.float64): 2,
}


class LaunchCounter:
    """Plain integer count of real kernel launches (one per launch).

    ``inc`` counts a launch, or holds it in the calling thread's
    ``obs.metrics.deferred()`` while a CUDA graph captures it."""

    _lock = threading.Lock()

    def __init__(self):
        self.count = 0

    def inc(self) -> None:
        held = _obs_metrics.deferred()
        if held is not None:
            held.add(("launches", self), 1)
        else:
            self.add(1)

    def add(self, k: int) -> None:
        with self._lock:
            self.count += k

    def reset(self) -> None:
        self.count = 0


def accum_for(storage: torch.dtype, accum_dtype=None) -> torch.dtype:
    """The accumulation dtype: the policy's, else at least fp32."""
    return accum_dtype or torch.promote_types(storage, torch.float32)


def dtype_code(storage: torch.dtype, accum: torch.dtype) -> int:
    """The kernels' code for a (storage, accum) pair; raises for others."""
    code = KERNEL_DTYPES.get((storage, accum))
    if code is None:
        raise ValueError(
            f"the CUDA kernels take storage/accum {list(KERNEL_DTYPES)}, "
            f"got {storage}/{accum}")
    return code


def kernel_panel(panel: int) -> int:
    """The panel the CUDA routes run at: the largest divisor of ``panel``
    that is at most ``MAX_PANEL`` (``panel`` itself up to 256)."""
    if panel < 1:
        raise ValueError(f"panel must be >= 1, got {panel}")
    for d in range(min(panel, MAX_PANEL), 0, -1):
        if panel % d == 0:
            return d
    return 1  # unreachable: 1 divides everything


def rank_groups(k: int) -> List[slice]:
    """Column groups of at most ``MAX_K`` a rank-k modification runs in on
    the CUDA routes: one group for k <= 32, ceil(k / 32) beyond."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return [slice(lo, min(lo + MAX_K, k)) for lo in range(0, k, MAX_K)]


def check_rc(rc: int, lib, what: str) -> None:
    """Raise with the CUDA error's text when a launch returned non-zero
    (every library of the port exports ``repro_cuda_error_string``)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.repro_cuda_error_string(rc).decode())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def on_device(device: torch.device):
    """The context that makes ``device`` current for a launch: none when it
    already is (entering ``torch.cuda.device`` costs host time per call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


# ---------------------------------------------------------------------------
# The transform-GEMM tile (csrc/gemm_tile.cuh)
# ---------------------------------------------------------------------------

#: Columns of a CTA's strip (all P + k rows); K values a slice.
GEMM_BN = 64
GEMM_BK = 16
#: CTAs of a cluster that split K (1: no cluster).
GEMM_SPLITS = (1, 2, 4)
#: The block of 32 rows each warp takes, with the vt rows (block 8) and
#: panel only: each scheduler (warp % 4) multiplies about as many slices.
GEMM_WARP_BLOCKS = {"vt": (8, 7, 6, 5, 0, 2, 3, 4, 1),
                    "panel": (7, 6, 5, 4, 0, 1, 2, 3, 8)}


def gemm_slices(P: int, k: int) -> int:
    """K slices of the product: ceil((P + k) / GEMM_BK)."""
    return -(-(P + k) // GEMM_BK)


def gemm_slice_needed(r0: int, s: int, P: int, rows: int = 16) -> bool:
    """Whether rows [r0, r0 + rows) multiply K slice ``s``: not when every
    row lies left of the slice inside ``T_rr``, whose row r is zero right
    of column r (r < q < P)."""
    q0 = s * GEMM_BK
    return not (r0 + rows <= q0 and q0 + GEMM_BK <= P)


@functools.lru_cache(maxsize=1024)
def gemm_split(batch: int, w: int, P: int, k: int, capacity) -> int:
    """CTAs of a cluster that split the K slices of one column strip of
    the cascade's apply. ``capacity[i]`` is how many clusters of
    ``GEMM_SPLITS[i]`` CTAs the card holds at once (CTAs for split 1).

    The ``batch * ceil(w / GEMM_BN)`` strips, one cluster each, run in
    ``ceil(strips / capacity)`` waves. A CTA's time has a large fixed part
    (staging the first slices, the epilogue, the reduction), so a further
    wave costs more than a larger split saves: the split takes the fewest
    waves, then the most CTAs, never more ranks than slices. A split the
    card cannot place (capacity 0: a shared or partitioned card) is not
    taken; split 1 must fit. It changes the summation order, not the
    function."""
    if capacity[0] < 1:
        raise ValueError(f"the gemm apply's CTA does not fit the device "
                         f"(capacity {capacity})")
    strips = batch * -(-w // GEMM_BN)
    best = None
    for split, cap in zip(GEMM_SPLITS, capacity):
        if cap < 1 or split > gemm_slices(P, k):
            continue
        key = (-(-strips // cap), -split)
        if best is None or key < best[0]:
            best = (key, split)
    return best[1]


def gemm_slice_cost(s: int, P: int, rows_out: int) -> int:
    """What K slice ``s`` costs a CTA: the 16-row tiles that multiply it on
    the busiest of the SM's four schedulers (warp % 4). Every slice ends at
    a barrier, so that scheduler sets the slice's time."""
    blocks = GEMM_WARP_BLOCKS["vt" if rows_out > P else "panel"]
    load = [0, 0, 0, 0]
    for warp, rb in enumerate(blocks):
        load[warp % 4] += sum(r0 < rows_out and gemm_slice_needed(r0, s, P)
                              for r0 in (32 * rb, 32 * rb + 16))
    return max(load)


@functools.lru_cache(maxsize=1024)
def gemm_split_bounds(P: int, k: int, rows_out: int,
                      split: int) -> Tuple[int, ...]:
    """The ``split - 1`` inner boundaries of the K slices that the ranks of
    a cluster sum, ascending: boundary j falls where the running cost
    (``gemm_slice_cost``) comes closest to j / split of the whole (ties to
    the earlier slice), every rank keeping at least one slice. The early
    slices of a lower-triangular T_rr cost the most, so an even count of
    slices would load rank 0 the most."""
    n = gemm_slices(P, k)
    if not 1 <= split <= n:
        raise ValueError(f"split must be in 1..{n}, got {split}")
    cum = [0]
    for s in range(n):
        cum.append(cum[-1] + gemm_slice_cost(s, P, rows_out))
    bounds: List[int] = []
    for j in range(1, split):
        lo = bounds[-1] + 1 if bounds else 1
        bounds.append(min(range(lo, n - (split - j) + 1),
                          key=lambda b: abs(split * cum[b] - j * cum[n])))
    return tuple(bounds)


def gemm_pack_bounds(bounds) -> int:
    """The boundaries as the kernel takes them: one byte each, the first
    lowest (``gemm_tile.cuh`` ``rank_slices``)."""
    return sum(b << (8 * j) for j, b in enumerate(bounds))


def upper_tiles(n_panels: int, nt: int, tile_off: int) -> List[int]:
    """Tiles right of the diagonal in each row panel of a shard of ``nt``
    tiles whose first global tile is ``tile_off``."""
    return [max(0, nt - max(0, p - tile_off + 1)) for p in range(n_panels)]


# ---------------------------------------------------------------------------
# The paper's wavefront apply (csrc/panel_kernels.cu panel_paper_kernel)
# ---------------------------------------------------------------------------

#: Warps a CTA of the paper apply may take (kPaperMinWarps..kPaperMaxWarps).
PAPER_WARPS = (16, 8, 4)
#: Rows of each of the kernel's two shared-memory rings (kPaperRing).
PAPER_RING = 96
#: Shared memory a CTA may take under the rule: two CTAs fit an SM.
PAPER_SMEM_CAP = 113 * 1024
#: The rule's model of a tick: the latency of its dependent steps (a
#: shuffle, an add, div_pre's three operations, a select) in cycles; the
#: instructions a warp issues for it; a CTA's staging of the rotations, in
#: instructions a tick and a lane of a column's segment. Estimated from
#: the code; on an H100 the rule's pick was the fastest of 4, 8 and 16
#: warps at every width of the n = 5000 cascade, k = 1, 16 and 32, and
#: within 6 % of it for the B = 64 fleet (probes/paper_tick.py, PERF.md).
PAPER_TICK_CYCLES = 48
PAPER_TICK_ISSUE = 32
PAPER_STAGE_ISSUE = 0.4


def paper_lanes(k: int) -> int:
    """Lanes of the segment that owns one column: k rounded up to 8, 16 or
    32 (the kernel's buckets), 1 at k = 1."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    return 1 if k == 1 else next(b for b in (8, 16, 32) if k <= b)


def paper_cpw(k: int) -> int:
    """Columns a warp of the paper apply holds: 32 / ``paper_lanes(k)``."""
    return 32 // paper_lanes(k)


def paper_smem(k: int, nw: int, itemsize: int) -> int:
    """Dynamic shared memory of a CTA of ``nw`` warps (kernel
    ``paper_smem_bytes``): the rotation ring, four accum values an entry,
    and the row ring of the CTA's columns, one row longer."""
    return itemsize * (PAPER_RING * 4 * paper_lanes(k)
                       + (PAPER_RING + 1) * nw * paper_cpw(k))


@functools.lru_cache(maxsize=1024)
def paper_warps(batch: int, w: int, k: int, sms: int,
                itemsize: int = 4) -> int:
    """Warps a CTA of the paper apply takes over ``w`` columns of each of
    ``batch`` members (accum values of ``itemsize`` bytes).

    A CTA of nw warps holds nw ``paper_cpw(k)`` columns. On the busiest
    of the ``sms`` multiprocessors, with ceil(CTAs / sms) CTAs, a tick
    costs the larger of its latency and what its four schedulers issue:
    each warp's tick and each CTA's staging. The rule takes the cheapest
    tick, then the most warps (fewer CTAs stage the rotations), among the
    sizes whose shared memory lets two CTAs share an SM. It changes the
    schedule, not the result."""
    if batch < 1 or w < 1 or sms < 1:
        raise ValueError(f"batch, w and sms must be >= 1, got {batch}, {w}, "
                         f"{sms}")
    kp = paper_lanes(k)
    best = None
    for nw in PAPER_WARPS:
        if paper_smem(k, nw, itemsize) > PAPER_SMEM_CAP:
            continue
        ctas = batch * -(-w // (nw * paper_cpw(k)))
        issue = -(-ctas // sms) * (nw * PAPER_TICK_ISSUE
                                   + kp * PAPER_STAGE_ISSUE) / 4
        key = (max(PAPER_TICK_CYCLES, issue), -nw)
        if best is None or key < best[0]:
            best = (key, nw)
    return best[1]


#: The largest P + k whose fp32 gemm apply takes the FFMA form (kernel
#: ``kFfmaRows``): exact fp32 products where the 3xTF32 split's error is
#: not small against the 4 P limit.
GEMM_FFMA_ROWS = 64
