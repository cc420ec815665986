"""Block-tridiagonal rank-k up/down-date in one launch (DESIGN.md §12).

Port of ``repro.kernels.blocktridiag``. For an upper block-bidiagonal
factor, block row j has one trailing tile, the coupling block ``off[j]``,
so the dense panel chain collapses to::

    for j = 0 .. nb-1:
        diag[j], T_j        <- diagonal sweep of (diag[j], V^T slab j)
        [off[j]; slab j+1]  <- T_j [off[j]; slab j+1]

Skipping every other trailing tile is exact when each column of V is
supported inside one adjacent block-row pair (``structure
.assert_blocklocal``): those tiles are zero by structure, and the slabs
beyond j+1 belong to columns whose rotations at block j are identities.
Work is O(k·b²·nb), bytes O(n·b).

* ``btd_chain_cuda`` launches the CUDA kernel (``csrc/btd_chain.cu``) on
  CUDA tensors: one launch for one factor or a fleet, any block size b
  (a block wider than 256 rows is swept as row sub-tiles of at most 256
  inside the launch). It replaces the TPU kernel ``_btd_call``
  (``blocktridiag.py:117``).
* ``btd_chain_plain`` is its plain version, the same chain as a Python
  loop over blocks (any leading fleet axis), which CPU tensors run.

On CUDA a rank above 32 goes in successive column groups of at most 32, one
launch each (``_launch.rank_groups``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import Precision, as_dtype
from repro_torch.core.structure import BlockTriDiagStorage
from repro_torch.kernels._launch import (MAX_K, LaunchCounter, accum_for,
                                         check_rc, dtype_code, rank_groups)
from repro_torch.kernels.cholupdate import diag_recurrence
from repro_torch.obs import metrics as _obs_metrics

#: Launches of the CUDA block-chain kernel made by ``btd_chain_cuda``.
LAUNCHES = LaunchCounter()


def btd_chain_plain(diag, off, vt, *, sigma: int, accum_dtype=None):
    """Plain-torch block chain. ``diag``: (..., nb, b, b), ``off``:
    (..., nb-1, b, b), ``vt``: (..., k, nb·b), all storage. Returns the new
    ``(diag, off)``; blocks and the running slab are stored in the storage
    dtype between steps, ``T`` and the arithmetic in the accum dtype."""
    nb, b = diag.shape[-3], diag.shape[-1]
    k = vt.shape[-2]
    acc = accum_for(diag.dtype, accum_dtype)
    store = diag.dtype
    diag_new, off_new = diag.clone(), off.clone()
    slab = vt[..., 0:b]
    for j in range(nb):
        D_new, _c, _s, T = diag_recurrence(diag[..., j, :, :], slab,
                                           sigma=sigma, rows=b, k=k,
                                           accum_dtype=acc)
        diag_new[..., j, :, :] = D_new.to(store)
        if j + 1 == nb:
            break
        S = torch.cat([off[..., j, :, :], vt[..., (j + 1) * b:(j + 2) * b]],
                      dim=-2).to(acc)
        S = T @ S
        off_new[..., j, :, :] = S[..., :b, :].to(store)
        slab = S[..., b:, :].to(store)
    _obs_metrics.counter("repro.kernels.plain_walks",
                         module="blocktridiag").inc()
    return diag_new, off_new


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("btd_chain")
    if not getattr(lib, "_repro_typed", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_btd_chain.argtypes = [ptr] * 4 + [i] * 6 + [ptr]
        lib.repro_btd_chain.restype = i
        lib.repro_btd_scratch_elems.argtypes = [i, i, i]
        lib.repro_btd_scratch_elems.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def btd_chain_cuda(diag, off, vt, *, sigma: int, accum_dtype=None):
    """Launch the CUDA block-chain kernel: ONE launch for a factor or a
    fleet. Same arguments and result as ``btd_chain_plain``; ``diag``,
    ``off``, ``vt`` are (B, nb, b, b), (B, nb-1, b, b), (B, k, nb·b).
    Raises on what the kernel does not take: non-CUDA tensors, a dtype pair
    other than fp32/fp32, bf16/fp32 or f64/f64, or ``k > 32``.
    """
    if diag.ndim != 4 or off.ndim != 4 or vt.ndim != 3:
        raise ValueError(f"diag, off must be (B, nb, b, b) and vt "
                         f"(B, k, n), got {tuple(diag.shape)}, "
                         f"{tuple(off.shape)}, {tuple(vt.shape)}")
    B, nb, b, _ = diag.shape
    k = vt.shape[1]
    if (off.shape != (B, nb - 1, b, b) or vt.shape != (B, k, nb * b)):
        raise ValueError(f"shape mismatch: diag {tuple(diag.shape)}, off "
                         f"{tuple(off.shape)}, vt {tuple(vt.shape)}")
    if not (diag.dtype == off.dtype == vt.dtype):
        raise ValueError(f"dtypes differ: {diag.dtype}, {off.dtype}, "
                         f"{vt.dtype}")
    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")
    acc = accum_for(diag.dtype, accum_dtype)
    code = dtype_code(diag.dtype, acc)
    if not (b >= 1 and 1 <= k <= MAX_K):
        raise ValueError(
            f"one launch takes 1 <= k <= {MAX_K} (chol_update_blocktridiag "
            f"splits a wider rank), got b={b}, k={k}")
    if not all(x.is_cuda and x.device == diag.device
               for x in (diag, off, vt)):
        raise ValueError("btd_chain_cuda takes CUDA tensors on one device")
    lib = _lib()
    dev = diag.device
    d_out = diag.contiguous().clone()
    o_out = off.contiguous().clone()
    vt = vt.contiguous()
    elems = lib.repro_btd_scratch_elems(b, k, code)
    scr = torch.empty((B, elems), dtype=acc, device=dev) if elems else None
    with torch.cuda.device(dev):
        rc = lib.repro_btd_chain(
            d_out.data_ptr(), o_out.data_ptr() if nb > 1 else None,
            vt.data_ptr(), None if scr is None else scr.data_ptr(), B, nb, b,
            k, sigma, code,
            torch.cuda.current_stream(dev).cuda_stream)
    check_rc(rc, lib, "btd_chain")
    LAUNCHES.inc()
    _obs_metrics.counter("repro.kernels.launches", module="blocktridiag",
                         kernel="btd_chain", panel=b).inc()
    return d_out, o_out


def btd_chain(diag, off, vt, *, sigma: int, accum_dtype=None,
              interpret: bool = False):
    """The block chain on the tensors' device: plain on the CPU, the kernel
    on CUDA (``rank_groups(k)`` launches). ``interpret=True`` on a CUDA
    tensor raises instead of quietly running the plain version."""
    if diag.is_cuda:
        if interpret:
            raise ValueError(
                "interpret=True asks for the plain version, which runs only "
                "on CPU tensors; move the factor to the CPU or drop "
                "interpret")
        groups = rank_groups(vt.shape[-2])
        for g in groups:
            diag, off = btd_chain_cuda(
                diag, off, vt if len(groups) == 1 else vt[:, g],
                sigma=sigma, accum_dtype=accum_dtype)
        return diag, off
    return btd_chain_plain(diag, off, vt, sigma=sigma,
                           accum_dtype=accum_dtype)


def chol_update_blocktridiag(S, V, *, sigma: int = 1, interpret=None,
                             precision=None, **_ignored):
    """Rank-k up/down-date of a block-bidiagonal factor, one launch per
    sign block (per 32 columns of V) for a factor or a fleet.

    Args:
      S: ``BlockTriDiagStorage``, one factor or a fleet (4-D leaves).
      V: (n, k) or (n,); (B, n, k) or (B, n) for a fleet. Every column must
        be supported inside one adjacent block-row pair
        (``structure.assert_blocklocal``; not checked here).
      sigma: +1 update, -1 downdate.
      interpret: None picks by device; True asks for the plain version
        (CPU tensors only).
      precision: storage/accum policy ('bf16', a ``Precision``, or None).

    Returns:
      The modified ``BlockTriDiagStorage`` in the policy's storage dtype.
    """
    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")
    from repro_torch.core.backends import default_interpret

    if interpret is None:
        interpret = default_interpret(S.device)
    precision = Precision.parse(precision)
    accum_dtype = None
    if precision is not None:
        S = precision.cast_storage(S)
        V = precision.cast_storage(V)
        accum_dtype = precision.accum
    single = not S.batched
    diag, off = S.diag, S.off
    if single:
        diag, off, V = diag[None], off[None], V[None]
    if V.ndim == 2:
        V = V[..., None]
    d_new, o_new = btd_chain(diag, off, V.mT.contiguous(), sigma=sigma,
                             accum_dtype=accum_dtype,
                             interpret=bool(interpret))
    if single:
        d_new, o_new = d_new[0], o_new[0]
    return BlockTriDiagStorage(d_new, o_new)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def launch_count(k: int = 1) -> int:
    """Device launches per rank-k modification: 1 per sign block (one
    factor or a fleet), ``ceil(k / 32)`` on the CUDA route for k > 32."""
    return len(rank_groups(k))


def bytes_per_update(nb: int, b: int, k: int, *, storage_dtype) -> int:
    """Device-memory bytes one structured rank-k update moves, O(n·b).

    The JAX package's model: every diag and (padded) off block read and
    written once, plus the ``(k, (nb+1)·b)`` V^T load.
    """
    isize = as_dtype(storage_dtype).itemsize
    tile_traffic = 2 * (nb + nb) * b * b * isize
    vt_traffic = k * (nb + 1) * b * isize
    return tile_traffic + vt_traffic


def factor_bytes(nb: int, b: int, *, storage_dtype) -> int:
    """Resident factor bytes: (2·nb - 1) b² elements, O(n·b)."""
    return (2 * nb - 1) * b * b * as_dtype(storage_dtype).itemsize
