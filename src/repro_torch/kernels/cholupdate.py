"""Rank-k panel kernels of the paper's multi-kernel cascade, PyTorch port.

Port of ``repro.kernels.cholupdate``. Two layers:

* the value-level kernel math in plain torch, ``diag_recurrence`` (the
  serial hyperbolic recurrence on one diagonal block, emitting the
  transform ``T``) and ``apply_rotations`` (the paper's element-wise
  rotation chain over a panel tile), which every kernel of the port is
  held against;
* the three per-panel kernels, each a wrapper that launches its CUDA
  kernel (``csrc/panel_kernels.cu``) on CUDA tensors and runs its plain
  version on CPU tensors: ``diag_block`` (replaces ``diag_block``,
  ``cholupdate.py:282``), ``panel_apply_gemm`` (``:224``) and
  ``panel_apply_paper`` (``:149``). Each takes an optional leading batch
  axis: a (B, ...) fleet is one launch. The in-place forms
  ``diag_block_`` / ``panel_apply_gemm_`` / ``panel_apply_paper_`` take
  views of a padded factor through their strides, so the cascade
  (``kernels/ops.py``) copies nothing; the functional forms sit on them.

On a CUDA tensor a wrapper launches its kernel or raises; ``LAUNCHES``
counts the launches of each kernel. The kernels take a block of at most
256 rows and at most 32 rotations a row (``_launch``); the cascade keeps
within both.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels._launch import (MAX_K, MAX_PANEL, LaunchCounter,
                                         accum_for, check_rc, dtype_code,
                                         gemm_pack_bounds, gemm_split,
                                         gemm_split_bounds, on_device,
                                         paper_warps, sm_count,
                                         GEMM_FFMA_ROWS, GEMM_SPLITS)
from repro_torch.obs import metrics as _obs_metrics

#: Launches of each per-panel CUDA kernel, by kernel name.
LAUNCHES: Dict[str, LaunchCounter] = {
    name: LaunchCounter()
    for name in ("diag_block", "panel_apply_gemm", "panel_apply_paper")}


def diag_recurrence(D, vtd, *, sigma: int, rows: int, k: int,
                    accum_dtype=None):
    """Serial diagonal-block recurrence, emitting the transform T.

    ``D``: (..., rows, rows); ``vtd``: (..., k, rows). The stacked block
    ``[D; vtd]`` is augmented with an identity so the row sweep also
    produces T with ``[R_new; vt_new] = T @ [R; vt]``.
    Returns (D_new, c, s, T); with ``accum_dtype`` the inputs are upcast
    and every output stays in that dtype.
    """
    if accum_dtype is not None:
        D = D.to(accum_dtype)
        vtd = vtd.to(accum_dtype)
    pk = rows + k
    S = torch.cat([D, vtd], dim=-2)
    eye = torch.eye(pk, dtype=S.dtype, device=S.device)
    S = torch.cat([S, eye.expand(*S.shape[:-2], pk, pk)], dim=-1)
    c_acc = S.new_zeros(S.shape[:-2] + (rows, k))
    s_acc = S.new_zeros(S.shape[:-2] + (rows, k))
    for i in range(rows):
        for m in range(k):
            row_i = S[..., i, :]
            row_v = S[..., rows + m, :]
            lii = row_i[..., i:i + 1]
            vim = row_v[..., i:i + 1]
            w = torch.sqrt(lii * lii + sigma * vim * vim)
            c = w / lii
            s = vim / lii
            row_i_new = (row_i + sigma * s * row_v) / c
            row_v_new = c * row_v - s * row_i_new
            S[..., i, :] = row_i_new
            S[..., rows + m, :] = row_v_new
            c_acc[..., i, m] = c[..., 0]
            s_acc[..., i, m] = s[..., 0]
    return (torch.triu(S[..., :rows, :rows]), c_acc, s_acc,
            S[..., :, rows:].clone())


def apply_rotations(R, vt, c, s, *, sigma: int, rows: int, k: int,
                    accum_dtype=None):
    """Element-wise rotation-chain panel apply (paper ``Apply``).

    ``R``: (..., rows, w); ``vt``: (..., k, w); ``c, s``: (..., rows, k).
    Streams the rows of R, chaining the k rotations per row. Returns
    (R_new, vt_new), in ``accum_dtype`` when one is given.
    """
    if accum_dtype is not None:
        R, vt = R.to(accum_dtype), vt.to(accum_dtype)
        c, s = c.to(accum_dtype), s.to(accum_dtype)
    R = R.clone()
    vt = vt.clone()
    for i in range(rows):
        t = R[..., i, :]
        for m in range(k):
            c_im = c[..., i, m:m + 1]
            s_im = s[..., i, m:m + 1]
            v_m = vt[..., m, :]
            t = (t + sigma * s_im * v_m) / c_im
            vt[..., m, :] = c_im * v_m - s_im * t
        R[..., i, :] = t
    return R, vt


# ---------------------------------------------------------------------------
# The per-panel kernels: CUDA on CUDA tensors, the plain version on the CPU.
# ---------------------------------------------------------------------------


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("panel_kernels")
    if not getattr(lib, "_repro_typed", False):
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_diag_block.argtypes = (
            [ptr, ll, i, ptr, ll, i, ptr, ptr, ptr] + [i] * 6 + [ptr])
        lib.repro_diag_block.restype = i
        lib.repro_panel_gemm.argtypes = (
            [ptr, ll, i, ptr, ll, i, ptr, ll] + [i] * 6
            + [ctypes.c_uint, i, ptr])
        lib.repro_panel_gemm.restype = i
        lib.repro_panel_paper.argtypes = (
            [ptr, ll, i, ptr, ll, i, ptr, ptr, ll] + [i] * 7 + [ptr])
        lib.repro_panel_paper.restype = i
        lib.repro_panel_gemm_capacity.argtypes = [i, i, i]
        lib.repro_panel_gemm_capacity.restype = i
        lib.repro_gemm_ffma_rows.argtypes = []
        lib.repro_gemm_ffma_rows.restype = i
        lib.repro_panel_t_pitch.argtypes = [i, i]
        lib.repro_panel_t_pitch.restype = i
        lib.repro_gemm_tile_layout.argtypes = [ctypes.POINTER(i)]
        lib.repro_gemm_tile_layout.restype = None
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _gemm_capacity(device: torch.device, code: int, ffma: bool = False):
    """Clusters of each split in GEMM_SPLITS (CTAs for split 1) of the gemm
    apply that the device holds at once, read once per device, dtype and
    form (``ffma``: the FFMA form of short fp32 products; the occupancy
    calculator: registers, shared memory, cluster placement)."""
    lib = _lib()
    out = []
    with on_device(device):
        for split in GEMM_SPLITS:
            n = lib.repro_panel_gemm_capacity(split, int(ffma), code)
            if n < 0:
                check_rc(-n, lib, "panel_apply_gemm occupancy")
            out.append(n)
    return tuple(out)


def _count(name: str, panel: int) -> None:
    LAUNCHES[name].inc()
    _obs_metrics.held_counter("repro.kernels.launches", module="cholupdate",
                              kernel=name, panel=panel).inc()


def _member_stride(x) -> int:
    """Elements between fleet members of a (B, r, c) or (r, c) view."""
    return x.stride(0) if x.ndim == 3 else 0


def _ld(x) -> int:
    """Elements between rows of a view (its leading dimension). The stride
    of a single row means nothing (torch may report any value for it), so
    it is the row's length."""
    return x.stride(-2) if x.shape[-2] > 1 else x.shape[-1]


def _check_views(what, views, dtype, device):
    """Each view is (r, c) or (B, r, c) with unit column stride, on one
    CUDA device and in the storage dtype."""
    for name, x in views.items():
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{what} takes CUDA tensors on one device, got "
                             f"{name} on {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{what}: {name} dtype {x.dtype} differs from "
                             f"{dtype}")
        if x.ndim not in (2, 3) or (x.shape[-1] > 1 and x.stride(-1) != 1):
            raise ValueError(f"{what} takes (r, c) or (B, r, c) views with "
                             f"unit column stride, got {name} of shape "
                             f"{tuple(x.shape)}, strides {x.stride()}")


def _limits(what, P, k):
    if not (1 <= P <= MAX_PANEL and 1 <= k <= MAX_K):
        raise ValueError(
            f"{what} takes a block of P <= {MAX_PANEL} rows and 1 <= k <= "
            f"{MAX_K} rotations (the cascade splits wider work), got P={P}, "
            f"k={k}")


def _diag_block_cuda(D, vtd, sigma, accum_dtype, zero_slab):
    """Launch the diagonal kernel on views D (..., P, P), vtd (..., k, P):
    D in place (and vtd zeroed with ``zero_slab``); returns (c, s, T)."""
    P, k = D.shape[-1], vtd.shape[-2]
    _limits("diag_block", P, k)
    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")
    _check_views("diag_block", {"D": D, "vtd": vtd}, D.dtype, D.device)
    lead = D.shape[:-2]
    if D.shape[-2] != P or vtd.shape[-1] != P or vtd.shape[:-2] != lead:
        raise ValueError(f"shape mismatch: D {tuple(D.shape)}, vtd "
                         f"{tuple(vtd.shape)}")
    acc = accum_for(D.dtype, accum_dtype)
    code = dtype_code(D.dtype, acc)
    lib = _lib()
    tp = lib.repro_panel_t_pitch(P, k)
    c = torch.empty(lead + (P, k), dtype=acc, device=D.device)
    s = torch.empty_like(c)
    T = torch.empty(lead + (P + k, tp), dtype=acc, device=D.device)
    B = D.shape[0] if D.ndim == 3 else 1
    with on_device(D.device):
        rc = lib.repro_diag_block(
            D.data_ptr(), _member_stride(D), _ld(D), vtd.data_ptr(),
            _member_stride(vtd), _ld(vtd), T.data_ptr(), c.data_ptr(),
            s.data_ptr(), B, P, k, sigma, int(zero_slab), code,
            torch.cuda.current_stream(D.device).cuda_stream)
    check_rc(rc, lib, "diag_block")
    _count("diag_block", P)
    return c, s, T[..., :P + k]


def _diag_block_plain(D, vtd, sigma, accum_dtype):
    P, k = D.shape[-1], vtd.shape[-2]
    D_new, c, s, T = diag_recurrence(D, vtd, sigma=sigma, rows=P, k=k,
                                     accum_dtype=accum_dtype)
    state = accum_dtype or D.dtype
    return D_new.to(D.dtype), c.to(state), s.to(state), T.to(state)


def diag_block(D, vtd, *, sigma: int, accum_dtype=None):
    """The diagonal pass of one block (or a fleet of blocks).

    ``D``: (..., P, P) upper triangular; ``vtd``: (..., k, P), its V^T
    slab. Returns ``(D_new, c, s, T)`` as the JAX kernel does: ``D_new`` in
    ``D``'s dtype, ``c``, ``s`` (..., P, k) and ``T`` (..., P+k, P+k) in
    the accum dtype (``accum_dtype``, else ``D``'s), with
    ``[R_new; vt_new] = T @ [R; vt]``. One launch on CUDA.
    """
    if D.is_cuda:
        D_new = D.clone(memory_format=torch.contiguous_format)
        c, s, T = _diag_block_cuda(D_new, vtd.to(D.dtype).contiguous(),
                                   sigma, accum_dtype, False)
        return D_new.triu_(), c, s, T
    return _diag_block_plain(D, vtd, sigma, accum_dtype)


def diag_block_(D, vtd, *, sigma: int, accum_dtype=None):
    """``diag_block`` in place on views of a padded factor: ``D`` takes
    ``D_new`` and ``vtd`` is annihilated (zero), as the recurrence leaves
    it. Returns ``(c, s, T)``."""
    if D.is_cuda:
        return _diag_block_cuda(D, vtd, sigma, accum_dtype, True)
    D_new, c, s, T = _diag_block_plain(D, vtd, sigma, accum_dtype)
    D.copy_(D_new)
    vtd.zero_()
    return c, s, T


def _apply_cuda(R, vt, T, c, s, sigma, accum_dtype, paper):
    """Launch a panel apply on views R (..., P, w), vt (..., k, w), in
    place: the paper's (c, s) or the transform GEMM (T, any row pitch)."""
    P, w, k = R.shape[-2], R.shape[-1], vt.shape[-2]
    what = "panel_apply_paper" if paper else "panel_apply_gemm"
    _limits(what, P, k)
    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")
    dev = R.device
    _check_views(what, {"R": R, "vt": vt}, R.dtype, dev)
    lead = R.shape[:-2]
    if vt.shape[-1] != w or vt.shape[:-2] != lead:
        raise ValueError(f"shape mismatch: R {tuple(R.shape)}, vt "
                         f"{tuple(vt.shape)}")
    acc = accum_for(R.dtype, accum_dtype)
    code = dtype_code(R.dtype, acc)
    lib = _lib()
    B = R.shape[0] if R.ndim == 3 else 1
    if paper:
        if c.shape != lead + (P, k) or s.shape != c.shape:
            raise ValueError(f"c, s must be {lead + (P, k)}, got "
                             f"{tuple(c.shape)}, {tuple(s.shape)}")
        c = c.to(device=dev, dtype=acc).contiguous()
        s = s.to(device=dev, dtype=acc).contiguous()
        nw = paper_warps(B, w, k, sm_count(dev), c.element_size())
        with on_device(dev):
            rc = lib.repro_panel_paper(
                R.data_ptr(), _member_stride(R), _ld(R), vt.data_ptr(),
                _member_stride(vt), _ld(vt), c.data_ptr(), s.data_ptr(),
                P * k if R.ndim == 3 else 0, B, w, nw, P, k, sigma, code,
                torch.cuda.current_stream(dev).cuda_stream)
    else:
        if T.shape != lead + (P + k, P + k):
            raise ValueError(f"T must be {lead + (P + k, P + k)}, got "
                             f"{tuple(T.shape)}")
        # The kernel reads T through its row pitch: diag_block's padded T
        # passes as it is.
        if T.dtype != acc or T.device != dev:
            T = T.to(device=dev, dtype=acc)
        if T.stride(-1) != 1:
            T = T.contiguous()
        ffma = acc == torch.float32 and P + k <= GEMM_FFMA_ROWS
        split = gemm_split(B, w, P, k, _gemm_capacity(dev, code, ffma))
        bounds = gemm_pack_bounds(gemm_split_bounds(P, k, P + k, split))
        with on_device(dev):
            rc = lib.repro_panel_gemm(
                R.data_ptr(), _member_stride(R), _ld(R), vt.data_ptr(),
                _member_stride(vt), _ld(vt), T.data_ptr(), _member_stride(T),
                _ld(T), B, w, P, k, split, bounds, code,
                torch.cuda.current_stream(dev).cuda_stream)
    check_rc(rc, lib, what)
    _count(what, P)


def _gemm_plain(R, vt, T, accum_dtype):
    acc = accum_dtype or torch.promote_types(
        torch.promote_types(R.dtype, T.dtype), torch.float32)
    S = T.to(acc) @ torch.cat([R, vt], dim=-2).to(acc)
    P = R.shape[-2]
    return S[..., :P, :].to(R.dtype), S[..., P:, :].to(vt.dtype)


def _paper_plain(R, vt, c, s, sigma, accum_dtype):
    acc = accum_dtype or torch.promote_types(R.dtype, c.dtype)
    R_new, vt_new = apply_rotations(R, vt, c, s, sigma=sigma,
                                    rows=R.shape[-2], k=vt.shape[-2],
                                    accum_dtype=acc)
    return R_new.to(R.dtype), vt_new.to(vt.dtype)


def _check_block_w(block_w):
    if block_w < 1:
        raise ValueError(f"block_w must be >= 1, got {block_w}")


def panel_apply_gemm(R, vt, T, *, block_w: int = 512, accum_dtype=None):
    """``[R; vt] <- T @ [R; vt]``: the off-diagonal panel apply as one
    transform GEMM, accumulated in ``accum_dtype`` (else at least fp32).

    ``R``: (..., P, w); ``vt``: (..., k, w); ``T``: (..., P+k, P+k) as
    ``diag_block`` emits it (its top-left P x P block lower triangular).
    Returns ``(R_new, vt_new)`` in the inputs' dtypes. ``block_w`` is the
    JAX kernel's grid block; the CUDA kernel's strips are its own
    (``_launch.gemm_split``), and the result does not depend on either.
    One launch on CUDA.
    """
    _check_block_w(block_w)
    if R.is_cuda:
        R_new = R.clone(memory_format=torch.contiguous_format)
        vt_new = vt.clone(memory_format=torch.contiguous_format)
        _apply_cuda(R_new, vt_new, T, None, None, 1, accum_dtype, False)
        return R_new, vt_new
    return _gemm_plain(R, vt, T, accum_dtype)


def panel_apply_paper(R, vt, c, s, *, sigma: int, block_w: int = 512,
                      accum_dtype=None):
    """The paper's element-wise panel apply: per row the k rotations
    ``(c, s)`` chain over the columns of ``R`` (..., P, w) and ``vt``
    (..., k, w). Zero columns are fixed points. Returns ``(R_new,
    vt_new)`` in the inputs' dtypes; the chain runs in ``accum_dtype``
    (else the wider of ``R``'s and ``c``'s). One launch on CUDA, a
    (row, rotation) wavefront in ``apply_rotations``' own operations: its
    result is the plain version's bit for bit. ``block_w`` is the JAX
    kernel's grid block; the CUDA kernel's CTAs are its own
    (``_launch.paper_warps``), and the result depends on neither."""
    _check_block_w(block_w)
    if R.is_cuda:
        R_new = R.clone(memory_format=torch.contiguous_format)
        vt_new = vt.clone(memory_format=torch.contiguous_format)
        _apply_cuda(R_new, vt_new, None, c, s, sigma, accum_dtype, True)
        return R_new, vt_new
    return _paper_plain(R, vt, c, s, sigma, accum_dtype)


def panel_apply_gemm_(R, vt, T, *, block_w: int = 512, accum_dtype=None):
    """``panel_apply_gemm`` in place on views of a padded factor."""
    _check_block_w(block_w)
    if R.is_cuda:
        _apply_cuda(R, vt, T, None, None, 1, accum_dtype, False)
        return
    R_new, vt_new = _gemm_plain(R, vt, T, accum_dtype)
    R.copy_(R_new)
    vt.copy_(vt_new)


def panel_apply_paper_(R, vt, c, s, *, sigma: int, block_w: int = 512,
                       accum_dtype=None):
    """``panel_apply_paper`` in place on views of a padded factor."""
    _check_block_w(block_w)
    if R.is_cuda:
        _apply_cuda(R, vt, None, c, s, sigma, accum_dtype, True)
        return
    R_new, vt_new = _paper_plain(R, vt, c, s, sigma, accum_dtype)
    R.copy_(R_new)
    vt.copy_(vt_new)


def panel_apply_gemm_work(P: int, k: int, widths, storage_dtype,
                          accum_dtype=None):
    """(bytes, operations) the gemm applies over trailing ``widths`` need:
    each apply reads ``[R; vt]`` and T once and writes ``[R; vt]`` once;
    its operations are two per nonzero of T a column: the lower-triangular
    ``T_rr`` (row i mixes rows j <= i), the dense ``T_rv`` and ``T_vr``,
    and the lower-triangular ``T_vv`` (V row m meets V rows m' < m only
    through the pivot rows), 2 (P (P+1) / 2 + 2 P k + k (k+1) / 2)."""
    s = torch.empty((), dtype=storage_dtype).element_size()
    a = torch.empty((), dtype=accum_for(storage_dtype,
                                        accum_dtype)).element_size()
    widths = list(widths)
    nbytes = sum(2 * (P + k) * w * s + (P + k) ** 2 * a for w in widths)
    ops = sum(2 * (P * (P + 1) // 2 + 2 * P * k + k * (k + 1) // 2) * w
              for w in widths)
    return nbytes, ops
