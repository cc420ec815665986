"""Value-level kernel math of the rank-k panel update, in plain torch.

Port of the value-level half of ``repro.kernels.cholupdate``:
``diag_recurrence`` (the serial hyperbolic recurrence on one diagonal
block, emitting the transform ``T``) and ``apply_rotations`` (the paper's
element-wise rotation chain over a panel tile). They are the plain versions
the CUDA fused-chain kernel (``csrc/chol_tile.cuh``) is held against. Both
take any leading batch axes, which is how a ``(B, n, n)`` fleet runs.

The three per-panel ``pallas_call`` wrappers of that module (``diag_block``,
``panel_apply_gemm``, ``panel_apply_paper``) are not on the port's path yet
(ROADMAP queue 2).
"""
from __future__ import annotations

import torch


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
