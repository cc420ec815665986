"""Plain-torch oracle for rank-k Cholesky up/down-dating (paper Algorithm 1).

Port of ``repro.core.ref``. ``L`` is the *upper* factor with
``A = L.T @ L``; ``V`` is ``(n, k)``; ``sigma = +1`` updates
(``A + V V^T``), ``sigma = -1`` downdates (``A - V V^T``). The row sweep is
a Python loop (``lax.scan`` in the JAX package); O(k n^2) work.
"""
from __future__ import annotations

import torch


def _row_rotations(l_ii, v_i, sigma):
    """Paper ``Compute`` applied k times at one row (sequential in m).

    Returns the coefficient vectors ``c, s`` of shape ``(k,)`` and the final
    diagonal element; ``c**2 = 1 + sigma * s**2`` per rotation.
    """
    cs, ss = [], []
    for m in range(v_i.shape[0]):
        vim = v_i[m]
        w = torch.sqrt(l_ii * l_ii + sigma * vim * vim)
        cs.append(w / l_ii)
        ss.append(vim / l_ii)
        l_ii = w
    return torch.stack(cs), torch.stack(ss), l_ii


def _apply_rotations_to_row(t, vt, c, s, sigma):
    """Paper ``Apply`` for all k rotations of one row, vector over columns."""
    rows = []
    for m in range(vt.shape[0]):
        t = (t + sigma * s[m] * vt[m]) / c[m]
        rows.append(c[m] * vt[m] - s[m] * t)
    return t, torch.stack(rows)


def _check_sigma(sigma):
    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")


def chol_update_ref(L, V, *, sigma: int = 1):
    """Rank-k up/down-date of the upper Cholesky factor, O(k n^2).

    Args:
      L: (n, n) upper-triangular with positive diagonal, ``A = L.T @ L``.
      V: (n, k) update matrix (or (n,) for rank 1).
      sigma: +1 update, -1 downdate.

    Returns:
      (n, n) upper-triangular factor of ``A + sigma * V @ V.T``.
    """
    _check_sigma(sigma)
    if V.ndim == 1:
        V = V[:, None]
    L = L.clone()
    vt = V.T.clone()
    n = L.shape[0]
    for i in range(n):
        c, s, l_ii = _row_rotations(L[i, i], vt[:, i], sigma)
        # Only trailing columns (j > i) are updated; v[:, i] is annihilated.
        t_new, vt_new = _apply_rotations_to_row(L[i, i + 1:], vt[:, i + 1:],
                                                c, s, sigma)
        L[i, i + 1:] = t_new
        L[i, i] = l_ii
        vt[:, i + 1:] = vt_new
        vt[:, i] = 0.0
    return L


def chol_update_dense(L, V, *, sigma: int = 1):
    """Ground truth by full re-factorization: chol(L^T L + sigma V V^T).

    O(n^3); the independent oracle the paper measures its errors against.
    """
    if V.ndim == L.ndim - 1:
        V = V[..., None]
    A = L.mT @ L + sigma * (V @ V.mT)
    return torch.linalg.cholesky(A).mT


def modify_error(L_new, L_old, V, *, sigma: int = 1):
    """The paper's error metric: ``max_ij |Atilde_ij - (Ltilde^T Ltilde)_ij|``."""
    if V.ndim == L_old.ndim - 1:
        V = V[..., None]
    A_tilde = L_old.mT @ L_old + sigma * (V @ V.mT)
    return torch.amax(torch.abs(A_tilde - L_new.mT @ L_new), dim=(-2, -1))
