"""Single-launch fused rank-k Cholesky up/down-date (DESIGN.md §5).

Port of ``repro.kernels.fused``. The paper's implementation obstacle is
that "a complex dependency pattern must be obeyed, requiring multiple
kernels to be launched": diagonal block p must finish before off-diagonal
panel p, which must finish before diagonal block p+1. This module runs the
whole cascade as ONE kernel launch:

* ``fused_chain_cuda`` launches the hand-written CUDA kernel
  (``csrc/fused_chain.cu``, tile math in ``csrc/chol_tile.cuh``) on CUDA
  tensors. It replaces the TPU kernel ``_fused_call`` of the JAX package;
  its design and bounds are described in the CUDA source.
* ``fused_chain_plain`` is the plain-torch version of the same chain walk
  (``_portable_kernel``'s math): the step table walked by a Python loop,
  the running ``V^T``, the parked ``T`` and ``(c, s)`` as loop state. The
  CPU path runs it, and the kernel is held against it on the card.

``fused_chain`` picks by the tensor's device: plain on the CPU, the kernel
on CUDA — never the plain version for a CUDA tensor. On CUDA it keeps the
kernel inside its limits without changing the function: a rank above 32
goes in successive column groups of at most 32 (one launch each), and a
panel above 256 runs at its largest divisor of at most 256
(``_launch.rank_groups``, ``_launch.kernel_panel``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.precision import Precision, as_dtype
from repro_torch.kernels._launch import (MAX_K, MAX_PANEL, LaunchCounter,
                                         accum_for, check_rc, dtype_code,
                                         kernel_panel, rank_groups)
from repro_torch.kernels.cholupdate import apply_rotations, diag_recurrence
from repro_torch.obs import metrics as _obs_metrics

GRID_MODES = ("indexed", "rect")
PANEL_APPLIES = ("gemm", "paper")


#: Launches of the CUDA fused-chain kernel made by ``fused_chain_cuda``.
LAUNCHES = LaunchCounter()


def _chain_steps(n_tiles: int):
    """(p, t) steps of the chain walk: the nP(nP+1)/2 upper tiles in
    row-major order. The 'rect' grid of the JAX kernel walks the same steps
    in the same order plus clamped no-ops, so ``grid_mode`` changes only the
    accounting (``grid_steps``), never the walk."""
    return [(p, t) for p in range(n_tiles) for t in range(p, n_tiles)]


def column_groups(batch: int, n_tiles: int, panel: int, sms: int) -> int:
    """Blocks per column tile of the CUDA kernel.

    The chain's critical step is the apply on tile (p, p+1), which one block
    per column tile runs alone; splitting each column tile into G groups of
    ``panel / G`` columns (a multiple of 32, one warp's width) splits that
    apply, and gives a short chain enough blocks to fill the card. Doubles
    G while the blocks do not yet cover ``sms`` multiprocessors.
    """
    groups = 1
    while (batch * n_tiles * groups < sms and panel % (2 * groups) == 0
           and (panel // (2 * groups)) % 32 == 0):
        groups *= 2
    return groups


def fused_chain_plain(L_pad, vt, *, sigma: int, panel: int,
                      panel_apply: str = "gemm", accum_dtype=None):
    """Plain-torch chain walk over a panel-padded fleet.

    ``L_pad``: (B, n_pad, n_pad) storage; ``vt``: (B, k, n_pad) storage.
    Returns the updated factors before ``triu`` (off-chain tiles pass
    through). Tiles and the running ``V^T`` stay in the storage dtype
    between steps; ``T``, ``(c, s)`` and all arithmetic in the accum dtype.
    """
    n_pad = L_pad.shape[-1]
    k = vt.shape[-2]
    out = L_pad.clone()
    vt = vt.clone()
    state = accum_dtype or L_pad.dtype
    acc = accum_for(L_pad.dtype, accum_dtype)
    T = c = s = None
    for p, t in _chain_steps(n_pad // panel):
        rs = slice(p * panel, (p + 1) * panel)
        cs_ = slice(t * panel, (t + 1) * panel)
        tile = L_pad[..., rs, cs_]
        slab = vt[..., cs_]
        if t == p:
            D_new, c, s, T = diag_recurrence(tile, slab, sigma=sigma,
                                             rows=panel, k=k,
                                             accum_dtype=accum_dtype)
            T, c, s = T.to(state), c.to(state), s.to(state)
            out[..., rs, cs_] = D_new.to(out.dtype)
            vt[..., cs_] = 0.0  # the recurrence annihilates this slab
            continue
        if panel_apply == "gemm":
            S = torch.cat([tile, slab], dim=-2).to(acc)
            S = T.to(acc) @ S
            R_new, vt_new = S[..., :panel, :], S[..., panel:, :]
        else:
            R_new, vt_new = apply_rotations(tile, slab, c, s, sigma=sigma,
                                            rows=panel, k=k,
                                            accum_dtype=accum_dtype)
        out[..., rs, cs_] = R_new.to(out.dtype)
        vt[..., cs_] = vt_new.to(vt.dtype)
    # A walk on the host, not a launch: its own series, so that
    # repro.kernels.launches counts kernel launches only.
    _obs_metrics.counter("repro.kernels.plain_walks", module="fused").inc()
    return out


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("fused_chain")
    if not getattr(lib, "_repro_typed", False):
        lib.repro_fused_chain.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.repro_fused_chain.restype = ctypes.c_int
        lib.repro_fused_chain_t_pitch.argtypes = [ctypes.c_int] * 2
        lib.repro_fused_chain_t_pitch.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def fused_chain_cuda(L_pad, vt, *, sigma: int, panel: int,
                     panel_apply: str = "gemm", accum_dtype=None,
                     lowering: str = "portable",
                     _groups: Optional[int] = None):
    """Launch the CUDA fused-chain kernel: ONE launch for the whole fleet.

    Same arguments and result as ``fused_chain_plain``. ``_groups`` (blocks
    per column tile, a measurement aid) overrides ``column_groups``; it
    changes the schedule, not the result. Raises on what the kernel does not take: non-CUDA or
    non-contiguous tensors, a dtype pair other than fp32/fp32, bf16/fp32 or
    f64/f64, ``panel > 256`` or ``k > 32``.
    """
    if L_pad.ndim != 3 or vt.ndim != 3:
        raise ValueError(f"L_pad must be (B, n, n) and vt (B, k, n), got "
                         f"{tuple(L_pad.shape)} and {tuple(vt.shape)}")
    B, n_pad, n2 = L_pad.shape
    k = vt.shape[1]
    if n2 != n_pad or vt.shape[0] != B or vt.shape[2] != n_pad:
        raise ValueError(f"shape mismatch: L_pad {tuple(L_pad.shape)}, "
                         f"vt {tuple(vt.shape)}")
    if not (L_pad.is_contiguous() and vt.is_contiguous()):
        raise ValueError("fused_chain_cuda takes contiguous tensors")
    if vt.dtype != L_pad.dtype:
        raise ValueError(f"vt dtype {vt.dtype} differs from L {L_pad.dtype}")
    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")
    if panel_apply not in PANEL_APPLIES:
        raise ValueError(f"panel_apply must be one of {PANEL_APPLIES}, "
                         f"got {panel_apply!r}")
    acc = accum_for(L_pad.dtype, accum_dtype)
    code = dtype_code(L_pad.dtype, acc)
    if not (1 <= panel <= MAX_PANEL and 1 <= k <= MAX_K
            and n_pad % panel == 0):
        raise ValueError(
            f"one launch takes panel <= {MAX_PANEL} dividing n_pad and "
            f"1 <= k <= {MAX_K} (fused_chain splits wider work), got "
            f"panel={panel}, k={k}, "
            f"n_pad={n_pad}")
    groups = _groups
    if groups is not None and not (
            groups == 1 or (panel % groups == 0
                            and (panel // groups) % 32 == 0)):
        raise ValueError(f"groups must be 1 or split panel={panel} into "
                         f"multiples of 32 columns, got {groups}")
    if not (L_pad.is_cuda and vt.is_cuda and L_pad.device == vt.device):
        raise ValueError("fused_chain_cuda takes CUDA tensors on one device, "
                         f"got {L_pad.device} and {vt.device}")
    n_tiles = n_pad // panel
    dev = L_pad.device
    lib = _lib()
    if groups is None:
        groups = column_groups(B, n_tiles, panel,
                               torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
    out = L_pad.clone()
    flags = torch.zeros(2 * B * n_tiles + 1, dtype=torch.int32, device=dev)
    tscr = cscr = sscr = slabscr = None
    if panel_apply == "gemm":
        pitch = lib.repro_fused_chain_t_pitch(panel, k)
        tscr = torch.empty((B * n_tiles, panel + k, pitch), dtype=acc,
                           device=dev)
    else:
        cscr = torch.empty((B * n_tiles, panel, k), dtype=acc, device=dev)
        sscr = torch.empty_like(cscr)
    if groups > 1:
        slabscr = torch.empty((B * n_tiles, k, panel), dtype=L_pad.dtype,
                              device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.repro_fused_chain(
            out.data_ptr(), vt.data_ptr(), ptr(tscr), ptr(cscr), ptr(sscr),
            ptr(slabscr), flags.data_ptr(), B, n_pad, panel, k, groups,
            sigma, int(panel_apply == "paper"), code,
            torch.cuda.current_stream(dev).cuda_stream)
    check_rc(rc, lib, "fused_chain")
    LAUNCHES.inc()
    _obs_metrics.counter("repro.kernels.launches", module="fused",
                         kernel="fused_chain", lowering=lowering,
                         panel=panel).inc()
    return out


def fused_chain(L_pad, vt, *, sigma: int, panel: int,
                panel_apply: str = "gemm", accum_dtype=None,
                interpret: bool = False, lowering: str = "portable"):
    """The chain walk on the tensors' device: plain on the CPU, the kernel
    on CUDA. ``interpret=True`` on a CUDA tensor raises instead of quietly
    running the plain version.

    On CUDA the kernel runs at ``kernel_panel(panel)`` (which divides the
    padded length) and takes V^T in ``rank_groups(k)``: ceil(k / 32)
    launches, one for k <= 32. The plain version walks the whole rank at
    ``panel`` in one pass: the same function.
    """
    if L_pad.is_cuda:
        if interpret:
            raise ValueError(
                "interpret=True asks for the plain version, which runs only "
                "on CPU tensors; move the factor to the CPU or drop "
                "interpret")
        groups = rank_groups(vt.shape[-2])
        out = L_pad
        for g in groups:
            out = fused_chain_cuda(
                out, vt if len(groups) == 1 else vt[:, g].contiguous(),
                sigma=sigma, panel=kernel_panel(panel),
                panel_apply=panel_apply, accum_dtype=accum_dtype,
                lowering=lowering)
        return out
    return fused_chain_plain(L_pad, vt, sigma=sigma, panel=panel,
                             panel_apply=panel_apply, accum_dtype=accum_dtype)


def chol_update_fused(
    L,
    V,
    *,
    sigma: int = 1,
    panel: int = 256,
    panel_apply: str = "gemm",
    grid_mode: str = "indexed",
    lowering: Optional[str] = "auto",
    interpret: Optional[bool] = None,
    precision=None,
):
    """Rank-k up/down-date of one factor or a fleet in a single launch.

    Args:
      L: (n, n) upper-triangular factor (``A = L^T L``), or a (B, n, n)
        fleet, which goes through the same single launch.
      V: (n, k) or (n,) modification; (B, n, k) or (B, n) for a fleet.
      sigma: +1 update, -1 downdate.
      panel: row-panel (= tile) size.
      panel_apply: 'gemm' (transform GEMM, default) or 'paper' (the
        paper's element-wise rotation chain).
      grid_mode: 'indexed' or 'rect'; changes only ``grid_steps``
        accounting, the result is identical.
      lowering: None/'auto'/'portable'/'mosaic': one kernel and one result;
        the resolved name labels the launch counter.
      interpret: None picks by device (plain version on the CPU, kernel on
        CUDA). True on a CUDA tensor raises.
      precision: storage/accum policy (``Precision``, 'bf16', or None).

    Returns:
      The updated upper-triangular factor(s), same shape as ``L``, in the
      policy's storage dtype (``L.dtype`` when no policy is given).
    """
    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")
    if panel_apply not in PANEL_APPLIES:
        raise ValueError(f"panel_apply must be 'gemm' or 'paper', got {panel_apply!r}")
    if grid_mode not in GRID_MODES:
        raise ValueError(f"grid_mode must be one of {GRID_MODES}, got {grid_mode!r}")
    from repro_torch.core import backends, blocked

    lowering = backends.resolve_lowering(lowering)
    if interpret is None:
        interpret = backends.default_interpret(L.device)
    precision = Precision.parse(precision)
    accum_dtype = None
    if precision is not None:
        L = precision.cast_storage(L)
        V = precision.cast_storage(V)
        accum_dtype = precision.accum
    single = L.ndim == 2
    if single:
        L, V = L[None], V[None]
    if V.ndim == 2:
        V = V[..., None]
    L_pad, V_pad, n = blocked._pad_to_panels(L, V, panel)
    out = fused_chain(L_pad.contiguous(), V_pad.mT.contiguous(), sigma=sigma,
                      panel=panel, panel_apply=panel_apply,
                      accum_dtype=accum_dtype, interpret=bool(interpret),
                      lowering=lowering)
    # Only the upper block-triangle is walked; triu drops the rest.
    out = torch.triu(out)[..., :n, :n]
    return out[0] if single else out


def launch_count(n: int, panel: int, *, method: str,
                 k: Optional[int] = None) -> int:
    """Device-kernel launches issued per up/down-date, by method.

    ``fused`` — 1, always. ``pallas``/``pallas_gemm`` — one panel-apply
    launch per panel with a trailing block (``n_panels - 1``).
    ``pallas_2phase`` — the paper's own accounting: a diagonal and a panel
    kernel per panel; the port's per-panel route on CUDA launches exactly
    this (its diagonal pass is a kernel too).

    With ``k`` given, the count of the port's CUDA routes: ceil(k / 32)
    column groups, and the panels of ``kernel_panel(panel)`` in the length
    padded to ``panel``. Without it, the JAX package's count.
    """
    n_panels = -(-n // panel)
    groups = 1
    if k is not None:
        groups = len(rank_groups(k))
        n_panels *= panel // kernel_panel(panel)
    if method == "fused":
        return groups
    if method in ("pallas", "pallas_gemm"):
        return groups * (n_panels - 1)
    if method == "pallas_2phase":
        return groups * (n_panels + (n_panels - 1))
    raise ValueError(f"unknown method {method!r}")


def bytes_per_update(n: int, panel: int, k: int, *, storage_dtype,
                     grid_mode: str = "indexed") -> int:
    """Device-memory bytes one fused rank-k update must move.

    Every upper tile of the padded factor is read and written once, and
    ``V^T`` is read once; the rotation state stays on chip (or in L2), so
    bf16 tiles halve this number while fp32 state costs no traffic.
    """
    if grid_mode not in GRID_MODES:
        raise ValueError(f"grid_mode must be one of {GRID_MODES}, got {grid_mode!r}")
    isize = as_dtype(storage_dtype).itemsize
    n_tiles = -(-n // panel)
    tiles = n_tiles * (n_tiles + 1) // 2
    return 2 * tiles * panel * panel * isize + k * (n_tiles * panel) * isize


def ops_per_update(n: int, panel: int, k: int, *,
                   panel_apply: str = "gemm") -> int:
    """Arithmetic operations one fused update does, by panel apply.

    A rotation on one element costs 6 operations (two multiply-adds, a
    multiply, a division, a multiply-subtract; a division counts as one).
    Each diagonal block sweeps ``P + 1 + k`` live columns per row (the
    recurrence and its transform); each of the nP(nP-1)/2 off-diagonal
    tiles is either the ``(P+k)^2 P`` multiply-adds of the transform GEMM
    or ``P·P·k`` rotations.
    """
    if panel_apply not in PANEL_APPLIES:
        raise ValueError(f"panel_apply must be one of {PANEL_APPLIES}, "
                         f"got {panel_apply!r}")
    n_tiles = -(-n // panel)
    diag = n_tiles * panel * (panel + 1 + k) * k * 6
    tiles = n_tiles * (n_tiles - 1) // 2
    if panel_apply == "gemm":
        return diag + tiles * 2 * (panel + k) ** 2 * panel
    return diag + tiles * panel * panel * k * 6


def grid_steps(n: int, panel: int, *, grid_mode: str = "indexed") -> int:
    """Chain steps per launch: nP(nP+1)/2 ('indexed') or nP² ('rect')."""
    n_tiles = -(-n // panel)
    if grid_mode == "indexed":
        return n_tiles * (n_tiles + 1) // 2
    if grid_mode == "rect":
        return n_tiles * n_tiles
    raise ValueError(f"grid_mode must be one of {GRID_MODES}, got {grid_mode!r}")
