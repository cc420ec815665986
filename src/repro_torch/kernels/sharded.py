"""The panel phase of the column-sharded driver: one launch per shard.

Port of ``repro.kernels.sharded``. The column-sharded rank-k up/down-date
(``repro_torch.core.distributed``, DESIGN.md §7) splits into

* a **chain phase**: per panel, the diagonal pass on the gathered block
  (``cholupdate.diag_block``), which gives the transform ``T^(p)``, the
  new diagonal block ``D^(p)`` and the running ``V^T`` entering panel p;
* a **panel phase** (this module): every tile of the shard at once,
  ``L[p, g] <- T_rr^(p) L[p, g] + T_rv^(p) vt_in^(p)[:, g]`` above the
  diagonal, ``D^(p)`` on it and zeros below. The tiles are independent,
  as each row panel of L is read in its original state.

``panel_apply_sharded`` launches the CUDA kernel (``csrc/sharded_panel.cu``,
replacing the TPU kernel ``sharded.py:118``) on CUDA tensors and runs its
plain version ``panel_apply_sharded_plain`` on CPU tensors. A ``(B, n,
w_loc)`` fleet shard takes the same one launch. One launch takes a panel
of at most 256 rows and at most 32 rotations; the driver keeps within both.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels._launch import (MAX_K, MAX_PANEL, LaunchCounter,
                                         accum_for, check_rc, dtype_code,
                                         kernel_panel, on_device,
                                         rank_groups, upper_tiles)
from repro_torch.obs import metrics as _obs_metrics

#: Launches of the CUDA panel-phase kernel made by ``panel_apply_sharded``.
LAUNCHES = LaunchCounter()

STRATEGIES = ("fused", "gemm", "paper")


def _shapes(L_loc, T_stack, D_stack, vt_stack, panel):
    """(B, n_panels, w_loc, k) of a panel phase; raises on a mismatch."""
    batched = L_loc.ndim == 3
    lead = L_loc.shape[:1] if batched else ()
    n, w = L_loc.shape[-2], L_loc.shape[-1]
    n_panels = n // panel
    k = vt_stack.shape[-2]
    want = {"T_stack": lead + (n_panels, panel + k, panel + k),
            "D_stack": lead + (n_panels, panel, panel),
            "vt_stack": lead + (n_panels, k, w)}
    got = {"T_stack": T_stack.shape, "D_stack": D_stack.shape,
           "vt_stack": vt_stack.shape}
    if (L_loc.ndim not in (2, 3) or n % panel or w % panel
            or any(tuple(got[x]) != want[x] for x in want)):
        raise ValueError(
            f"panel phase of L_loc {tuple(L_loc.shape)} at panel={panel} "
            f"takes T_stack, D_stack, vt_stack of shapes {want}, got "
            f"{ {x: tuple(s) for x, s in got.items()} }")
    return (L_loc.shape[0] if batched else 1), n_panels, w, k


def panel_apply_sharded_plain(L_loc, T_stack, D_stack, vt_stack, *,
                              tile_off: int, panel: int, accum_dtype=None):
    """Plain torch panel phase of one column shard (any device).

    Row panel p takes one product over its tiles right of the diagonal
    (global tile index ``tile_off + t > p``), accumulated in the accum dtype
    and rounded to storage once; the diagonal tile takes ``D^(p)`` and the
    tiles left of it zeros."""
    _, n_panels, w, _ = _shapes(L_loc, T_stack, D_stack, vt_stack, panel)
    acc = accum_for(L_loc.dtype, accum_dtype)
    out = torch.zeros_like(L_loc)
    for p in range(n_panels):
        rows = slice(p * panel, (p + 1) * panel)
        t_diag = p - tile_off  # local tile on the diagonal, if any
        if 0 <= t_diag < w // panel:
            cols = slice(t_diag * panel, (t_diag + 1) * panel)
            out[..., rows, cols] = D_stack[..., p, :, :].to(out.dtype)
        c0 = max(0, t_diag + 1) * panel
        if c0 >= w:
            continue
        T = T_stack[..., p, :panel, :].to(acc)
        S = torch.cat([L_loc[..., rows, c0:], vt_stack[..., p, :, c0:]],
                      dim=-2).to(acc)
        out[..., rows, c0:] = (T @ S).to(out.dtype)
    _obs_metrics.counter("repro.kernels.plain_walks",
                         module="sharded").inc()
    return out


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("sharded_panel")
    if not getattr(lib, "_repro_typed", False):
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_sharded_panel.argtypes = (
            [ptr, ptr, ptr, ll, ll, i, ptr, ptr] + [i] * 7 + [ptr])
        lib.repro_sharded_panel.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def panel_apply_sharded_cuda(L_loc, T_stack, D_stack, vt_stack, *,
                             tile_off: int, panel: int, accum_dtype=None,
                             lowering: str = "portable"):
    """Launch the CUDA panel-phase kernel: ONE launch for a shard or a
    fleet shard. Same arguments and result as the plain version (``T_rr``
    lower triangular, as ``diag_block`` emits it); ``T_stack`` may come at
    any row pitch (unit column stride). Raises on what the kernel does not
    take: non-CUDA tensors, a dtype pair other than fp32/fp32, bf16/fp32
    or f64/f64, ``panel > 256`` or ``k > 32``."""
    B, n_panels, w, k = _shapes(L_loc, T_stack, D_stack, vt_stack, panel)
    if not (1 <= panel <= MAX_PANEL and 1 <= k <= MAX_K):
        raise ValueError(
            f"one launch takes panel <= {MAX_PANEL} and 1 <= k <= {MAX_K} "
            f"(the sharded driver splits wider work), got panel={panel}, "
            f"k={k}")
    if tile_off < 0:
        raise ValueError(f"tile_off must be >= 0, got {tile_off}")
    dev = L_loc.device
    if not all(x.is_cuda and x.device == dev
               for x in (L_loc, T_stack, D_stack, vt_stack)):
        raise ValueError("panel_apply_sharded_cuda takes CUDA tensors on "
                         "one device")
    acc = accum_for(L_loc.dtype, accum_dtype)
    code = dtype_code(L_loc.dtype, acc)
    if vt_stack.dtype != L_loc.dtype:
        raise ValueError(f"vt_stack dtype {vt_stack.dtype} differs from "
                         f"L_loc's {L_loc.dtype}")
    L_loc = L_loc.contiguous()
    T = T_stack if T_stack.dtype == acc else T_stack.to(acc)
    if T.stride(-1) != 1:
        T = T.contiguous()
    D = (D_stack if D_stack.dtype == acc else D_stack.to(acc)).contiguous()
    vt = vt_stack.contiguous()
    out = torch.empty_like(L_loc)
    t_bs = T.stride(0) if T.ndim == 4 else 0
    lib = _lib()
    with on_device(dev):
        rc = lib.repro_sharded_panel(
            L_loc.data_ptr(), out.data_ptr(), T.data_ptr(), t_bs,
            T.stride(-3), T.stride(-2), D.data_ptr(), vt.data_ptr(), B,
            n_panels, w, panel, k, tile_off, code,
            torch.cuda.current_stream(dev).cuda_stream)
    check_rc(rc, lib, "panel_apply_sharded")
    LAUNCHES.inc()
    _obs_metrics.held_counter("repro.kernels.launches", module="sharded",
                              kernel="panel_apply_sharded", panel=panel,
                              lowering=lowering).inc()
    return out


def panel_apply_sharded(L_loc, T_stack, D_stack, vt_stack, *, tile_off: int,
                        panel: int, accum_dtype=None,
                        interpret: Optional[bool] = None,
                        lowering: Optional[str] = None):
    """Apply a whole update's panel phase to one column shard.

    Args:
      L_loc: (n, w_loc) the shard's columns of the ORIGINAL factor, or
        (B, n, w_loc) for a fleet shard (the same one launch).
      T_stack: (n_panels, P+k, P+k) chain-phase transforms, accum dtype
        ((B, ...) for a fleet).
      D_stack: (n_panels, P, P) new diagonal blocks, accum dtype.
      vt_stack: (n_panels, k, w_loc) running V^T entering each panel,
        storage dtype.
      tile_off: the shard's global tile offset (shard index · w_loc / P).
      panel: tile size P.
      accum_dtype: accumulation dtype (None: at least fp32).
      interpret: None picks by device; True asks for the plain version,
        which runs on CPU tensors only (on a CUDA tensor it raises).
      lowering: None/'auto'/'portable'/'mosaic': one kernel; the resolved
        name labels the launch counter.

    Returns:
      The updated shard, same shape and dtype as ``L_loc``.
    """
    from repro_torch.core.backends import default_interpret, resolve_lowering

    lowering = resolve_lowering(lowering)
    if interpret is None:
        interpret = default_interpret(L_loc.device)
    if L_loc.is_cuda:
        if interpret:
            raise ValueError(
                "interpret=True asks for the plain version, which runs only "
                "on CPU tensors; move the shard to the CPU or drop "
                "interpret")
        return panel_apply_sharded_cuda(L_loc, T_stack, D_stack, vt_stack,
                                        tile_off=tile_off, panel=panel,
                                        accum_dtype=accum_dtype,
                                        lowering=lowering)
    return panel_apply_sharded_plain(L_loc, T_stack, D_stack, vt_stack,
                                     tile_off=tile_off, panel=panel,
                                     accum_dtype=accum_dtype)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def launch_count_sharded(n: int, panel: int, *, strategy: str,
                         k: Optional[int] = None) -> int:
    """``panel_apply_sharded`` launches per shard per rank-k update, by
    strategy, independent of the fleet size (the JAX package's name):
    ``fused`` 1 (``ceil(k / 32)`` on the CUDA route with ``k`` given),
    ``gemm``/``paper`` 0 (they launch the per-panel kernels instead).
    The ``panel_apply_sharded`` entry of ``kernel_launches``."""
    return kernel_launches(n, panel, strategy=strategy, k=k or 1).get(
        "panel_apply_sharded", 0)


def kernel_launches(n: int, panel: int, *, strategy: str,
                    k: int) -> Dict[str, int]:
    """Kernel launches per shard per update on the CUDA route, by kernel:
    the chain phase's ``diag_block`` per panel of ``kernel_panel(panel)``,
    then one ``panel_apply_sharded`` (fused) or one panel apply per panel
    (gemm, paper), for each group of at most 32 columns of V."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    groups = len(rank_groups(k))
    n_panels = n // kernel_panel(panel)
    if strategy == "fused":
        return {"diag_block": groups * n_panels,
                "panel_apply_sharded": groups}
    return {"diag_block": groups * n_panels,
            f"panel_apply_{strategy}": groups * n_panels}


def panel_phase_work(n: int, w_loc: int, panel: int, k: int, *,
                     tile_off: int, batch: int = 1, storage_dtype,
                     accum_dtype=None):
    """(bytes, operations) the panel phase of one shard needs: each input
    read once and the shard written once; the lower-triangular ``T_rr``
    (row i mixes rows j <= i) and ``T_rv`` on every tile above the
    diagonal."""
    s = torch.empty((), dtype=storage_dtype).element_size()
    a = torch.empty((), dtype=accum_for(storage_dtype,
                                        accum_dtype)).element_size()
    n_panels, nt = n // panel, w_loc // panel
    per_panel = upper_tiles(n_panels, nt, tile_off)
    upper, rows_t = sum(per_panel), sum(u > 0 for u in per_panel)
    diag = sum(0 <= p - tile_off < nt for p in range(n_panels))
    nbytes = batch * (
        upper * (panel * panel + k * panel) * s   # L and vt_in tiles read
        + rows_t * panel * (panel + k) * a        # T[:P] of those panels
        + diag * panel * panel * a                # D on the diagonal
        + n * w_loc * s)                          # the shard written
    ops = batch * upper * (panel * panel * (panel + 1)
                           + 2 * panel * k * panel)
    return nbytes, ops
