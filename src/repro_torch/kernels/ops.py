"""The paper's multi-kernel cascade: the per-panel kernels wired into the
panelled driver. Port of ``repro.kernels.ops``.

Per panel p the cascade launches the diagonal pass on block (p, p)
(``cholupdate.diag_block``) and then one panel apply over the trailing
columns of row-panel p (``panel_apply_gemm`` or ``panel_apply_paper``):
``2 n_panels - 1`` launches per update, the paper's own accounting
(``fused.launch_count(method='pallas_2phase')``). A (B, n, n) fleet takes
the same launches. The hooks work in place on views of the padded factor,
so no panel is copied between launches.

On CUDA the kernels take a block of at most 256 rows and 32 rotations: a
panel above 256 runs at its largest divisor of at most 256, and a rank
above 32 as successive column groups of at most 32 (``_launch``). CPU
tensors run the kernels' plain versions at the given panel and rank.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import blocked
from repro_torch.core.backends import default_interpret
from repro_torch.core.precision import Precision
from repro_torch.kernels import cholupdate as _k
from repro_torch.kernels._launch import kernel_panel, rank_groups

STRATEGIES = ("paper", "gemm")


def _hooks(strategy: str, block_w: int, accum_dtype):
    """In-place diagonal and apply hooks for ``blocked.chol_update_blocked``."""

    def diag_fn(D, vtd, sig):
        c, s, T = _k.diag_block_(D, vtd, sigma=sig, accum_dtype=accum_dtype)
        return D, c, s, T

    if strategy == "paper":

        def apply_fn(R, vt, c, s, T, sig):
            _k.panel_apply_paper_(R, vt, c, s, sigma=sig, block_w=block_w,
                                  accum_dtype=accum_dtype)
            return R, vt

    else:

        def apply_fn(R, vt, c, s, T, sig):
            _k.panel_apply_gemm_(R, vt, T, block_w=block_w,
                                 accum_dtype=accum_dtype)
            return R, vt

    return diag_fn, apply_fn


def chol_update_pallas(
    L,
    V,
    *,
    sigma: int = 1,
    panel: int = 256,
    strategy: str = "paper",
    block_w: int = 512,
    interpret: Optional[bool] = None,
    precision: Optional[Precision] = None,
):
    """Panelled rank-k up/down-date with the per-panel kernels.

    ``strategy='paper'`` applies each panel with the paper's element-wise
    kernel, ``strategy='gemm'`` with the transform-GEMM kernel. ``L`` is
    (n, n) or a (B, n, n) fleet, ``V`` (n, k) / (n,) or (B, n, k) /
    (B, n). ``interpret=True`` asks for the plain versions, which run on
    CPU tensors only (on a CUDA tensor it raises). ``precision`` stores
    the factor and ``V^T`` in its storage dtype between launches while the
    kernels compute in its accum dtype.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if interpret is None:
        interpret = default_interpret(L.device)
    if L.is_cuda and interpret:
        raise ValueError(
            "interpret=True asks for the plain versions, which run only on "
            "CPU tensors; move the factor to the CPU or drop interpret")
    precision = Precision.parse(precision)
    accum_dtype = None if precision is None else precision.accum
    diag_fn, apply_fn = _hooks(strategy, block_w, accum_dtype)
    if V.ndim == L.ndim - 1:
        V = V[..., None]
    if not L.is_cuda:
        return blocked.chol_update_blocked(
            L, V, sigma=sigma, panel=panel, strategy="gemm",
            apply_fn=apply_fn, diag_fn=diag_fn, precision=precision)
    # Pad to the caller's panel, then run at the kernels' panel, which
    # divides it; each column group is a full cascade.
    n = L.shape[-1]
    L, V, _ = blocked._pad_to_panels(L, V, panel)
    for g in rank_groups(V.shape[-1]):
        L = blocked.chol_update_blocked(
            L, V[..., g], sigma=sigma, panel=kernel_panel(panel),
            strategy="gemm", apply_fn=apply_fn, diag_fn=diag_fn,
            precision=precision)
    return L[..., :n, :n]


def diag_block_pallas(D, vtd, *, sigma: int = 1,
                      interpret: Optional[bool] = None, accum_dtype=None):
    """The diagonal pass of one block on the device (paper CPU phase)."""
    if interpret is None:
        interpret = default_interpret(D.device)
    if D.is_cuda and interpret:
        raise ValueError(
            "interpret=True asks for the plain version, which runs only on "
            "CPU tensors")
    return _k.diag_block(D, vtd, sigma=sigma, accum_dtype=accum_dtype)
