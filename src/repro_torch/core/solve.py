"""Cholesky-factor utilities: solves, logdet, feasibility (upper convention).

Port of ``repro.core.solve``. Every function takes one ``(n, n)`` factor or
a ``(B, n, n)`` fleet: torch's linear algebra batches over leading axes,
which is what ``vmap`` did in the JAX package.
"""
from __future__ import annotations

import torch


def solve_triangular(L, b, *, trans: bool):
    """Solve ``L^T x = b`` (trans=True) or ``L x = b`` (trans=False).

    ``b`` is a vector ``(..., n)`` or a matrix ``(..., n, m)``.
    """
    vec = b.ndim == L.ndim - 1
    out_dtype = L.dtype
    if L.dtype.itemsize < 4:
        # torch has no 16-bit triangular solve: solve in fp32, store back.
        L = L.float()
    rhs = (b[..., None] if vec else b).to(L.dtype)
    if trans:
        x = torch.linalg.solve_triangular(L.mT, rhs, upper=False)
    else:
        x = torch.linalg.solve_triangular(L, rhs, upper=True)
    return (x[..., 0] if vec else x).to(out_dtype)


def chol_solve(L, b):
    """Solve ``A x = b`` given the upper factor (two triangular solves)."""
    y = solve_triangular(L, b, trans=True)
    return solve_triangular(L, y, trans=False)


def chol_logdet(L):
    """log det A = 2 * sum(log diag L)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)


def is_positive_factor(L, *, tol: float = 0.0):
    """True iff the factor has a strictly positive diagonal (valid factor)."""
    return torch.all(torch.diagonal(L, dim1=-2, dim2=-1) > tol, dim=-1)


def downdate_feasible(L, V):
    """Check that ``A - V V^T`` stays PD: ``I - P^T P`` PD with ``L^T P = V``.

    Exact for rank 1, the standard sufficiency check for rank k (k
    triangular solves plus a k x k eigenvalue problem).
    """
    if V.ndim == L.ndim - 1:
        V = V[..., None]
    if L.dtype.itemsize < 4:
        L = L.float()
    Pm = solve_triangular(L, V, trans=True)
    k = V.shape[-1]
    G = torch.eye(k, dtype=L.dtype, device=L.device) - Pm.mT @ Pm
    return torch.all(torch.linalg.eigvalsh(G) > 0, dim=-1)
