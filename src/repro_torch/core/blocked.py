"""Panelled rank-k Cholesky modification (paper §4), plain torch.

Port of ``repro.core.blocked``. ``L`` is split into row-panels: each square
diagonal block is processed serially, then the off-diagonal panel to its
right is updated with the rotations the diagonal pass produced. Two
panel-apply strategies:

* ``paper`` — the paper's element-wise rotation chain per row.
* ``gemm``  — the ``P·k`` rotations of a panel form one linear map
  ``T ∈ R^{(P+k)x(P+k)}`` acting on the stacked rows ``[R; V^T]``, so the
  panel update is one matmul. ``T`` comes from the diagonal pass run on the
  block augmented with an identity.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.core import ref as _ref
from repro_torch.core.precision import Precision

Strategy = Literal["paper", "gemm"]


def _pad_to_panels(L, V, panel):
    """Pad ``(..., n, n)`` L to a panel multiple with an identity block.

    V (``(..., n, k)``) is padded with zeros. Padded rows then produce
    identity rotations (v_i = 0 -> c = 1, s = 0), so the result on the
    original block is unchanged; a zero pad would divide by zero in
    ``c = w / l_ii``.
    """
    n = L.shape[-1]
    n_pad = (-n) % panel
    if n_pad == 0:
        return L, V, n
    L = torch.nn.functional.pad(L, (0, n_pad, 0, n_pad))
    idx = torch.arange(n, n + n_pad, device=L.device)
    L[..., idx, idx] = 1.0
    V = torch.nn.functional.pad(V, (0, 0, 0, n_pad))
    return L, V, n


def panel_diag(D, vtd, sigma, *, with_transform: bool):
    """Serial pass over one diagonal block (the paper's CPU phase).

    Args:
      D:   (P, P) upper-triangular diagonal block of L.
      vtd: (k, P) the rows of V^T belonging to this panel.
      sigma: +1 / -1.
      with_transform: also accumulate the (P+k, P+k) transform ``T`` by
        augmenting the block: ``[D | I | 0]`` over ``[vt | 0 | I]``.

    Returns:
      (D_new, c, s, T) — ``c, s`` are (P, k); ``T`` is None unless
      requested, and satisfies ``[R_new; vt_new] = T @ [R; vt]``.
    """
    P = D.shape[0]
    k = vtd.shape[0]
    dt, dev = D.dtype, D.device
    W = D.clone()
    vt = vtd.to(dt).clone()
    if with_transform:
        W = torch.cat([W, torch.eye(P, dtype=dt, device=dev),
                       torch.zeros((P, k), dtype=dt, device=dev)], dim=1)
        vt = torch.cat([vt, torch.zeros((k, P), dtype=dt, device=dev),
                        torch.eye(k, dtype=dt, device=dev)], dim=1)
    cs, ss = [], []
    for i in range(P):
        c_i, s_i, lii = _ref._row_rotations(W[i, i], vt[:, i], sigma)
        # Columns right of i (and every augmented column) update; v[:, i]
        # is annihilated.
        t_new, vt_new = _ref._apply_rotations_to_row(
            W[i, i + 1:], vt[:, i + 1:], c_i, s_i, sigma)
        W[i, i + 1:] = t_new
        W[i, i] = lii
        vt[:, i + 1:] = vt_new
        vt[:, i] = 0.0
        cs.append(c_i)
        ss.append(s_i)
    D_new = torch.triu(W[:, :P])
    T = torch.cat([W[:, P:], vt[:, P:]], dim=0) if with_transform else None
    return D_new, torch.stack(cs), torch.stack(ss), T


def panel_apply_paper(R, vt, c, s, sigma):
    """Element-wise off-diagonal panel apply (the paper's GPU kernel).

    Streams the P rows in order; per row the k rotations chain over the
    panel columns. ``R``: (P, w); ``vt``: (k, w); ``c, s``: (P, k).
    """
    R = R.clone()
    vt = vt.clone()
    for i in range(R.shape[0]):
        t, vt = _ref._apply_rotations_to_row(R[i], vt, c[i], s[i], sigma)
        R[i] = t
    return R, vt


def panel_apply_gemm(R, vt, T):
    """GEMM panel apply: one (P+k, P+k) @ (P+k, w) matmul.

    Accumulates in at least fp32; wider operands keep their own width.
    """
    acc = torch.promote_types(torch.promote_types(R.dtype, T.dtype),
                              torch.float32)
    S = torch.cat([R, vt], dim=0).to(acc)
    S = (T.to(acc) @ S).to(R.dtype)
    P = R.shape[0]
    return S[:P], S[P:]


def chol_update_blocked(
    L,
    V,
    *,
    sigma: int = 1,
    panel: int = 256,
    strategy: Strategy = "gemm",
    precision: Optional[Precision] = None,
):
    """Panelled rank-k up/down-date of one ``(n, n)`` factor.

    ``precision`` mirrors the fused kernel's storage/accum split: ``L`` and
    the running ``V^T`` are stored in the storage dtype between panel
    steps, while the diagonal recurrence and the panel applies compute in
    the accumulation dtype.
    """
    _ref._check_sigma(sigma)
    if strategy not in ("paper", "gemm"):
        raise ValueError(f"strategy must be 'paper' or 'gemm', got {strategy!r}")
    if V.ndim == 1:
        V = V[:, None]
    if precision is not None:
        L = precision.cast_storage(L)
        V = precision.cast_storage(V)
    up = (lambda x: x) if precision is None else precision.up
    store = L.dtype
    L, V, n = _pad_to_panels(L.clone(), V, panel)
    vt = V.T.clone()
    n_pad = L.shape[0]
    for r0 in range(0, n_pad, panel):
        r1 = r0 + panel
        D_new, c, s, T = panel_diag(up(L[r0:r1, r0:r1]), up(vt[:, r0:r1]),
                                    sigma, with_transform=strategy == "gemm")
        L[r0:r1, r0:r1] = D_new.to(store)
        vt[:, r0:r1] = 0.0
        if r1 == n_pad:
            continue
        R, vtr = up(L[r0:r1, r1:]), up(vt[:, r1:])
        if strategy == "gemm":
            R_new, vtr_new = panel_apply_gemm(R, vtr, T)
        else:
            R_new, vtr_new = panel_apply_paper(R, vtr, c, s, sigma)
        L[r0:r1, r1:] = R_new.to(store)
        vt[:, r1:] = vtr_new.to(store)
    return L[:n, :n]
