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
"""
from __future__ import annotations

import math
from typing import List

import torch

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
    """Plain integer count of real kernel launches (one per launch)."""

    def __init__(self):
        self.count = 0

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


def column_tile(batch: int, w: int, block_w: int, sms: int) -> int:
    """Columns per CTA of a panel apply over ``w`` trailing columns.

    ``block_w`` (rounded down to a multiple of 32, at least 32) caps the
    tile; it halves, in multiples of 32, while the grid of
    ``batch * ceil(w / tile)`` CTAs does not yet cover ``sms``
    multiprocessors. The tile changes the schedule, not the result.
    """
    if block_w < 1:
        raise ValueError(f"block_w must be >= 1, got {block_w}")
    tile = max(32, block_w // 32 * 32)
    while tile > 32 and batch * math.ceil(w / tile) < sms:
        tile = max(32, tile // 64 * 32)
    return tile


def check_rc(rc: int, lib, what: str) -> None:
    """Raise with the CUDA error's text when a launch returned non-zero
    (every library of the port exports ``repro_cuda_error_string``)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.repro_cuda_error_string(rc).decode())
