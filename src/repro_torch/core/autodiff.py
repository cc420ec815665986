"""Differentiation rules for the rank-k Cholesky modification, PyTorch port.

Port of ``repro.core.autodiff``. ``chol_update`` computes
``L~ = chol(L^T L + sigma V V^T)`` by a chain of hyperbolic rotations or a
CUDA kernel, neither of which autograd should trace. Murray (2016,
"Differentiation of the Cholesky decomposition") gives rules for the
FUNCTION instead, which these ``torch.autograd.Function`` classes apply.

Forward (``jvp``; ``torch.func.jvp``, ``torch.autograd.forward_ad``). With
``A~ = L~^T L~``::

    dA~ = dL^T L + L^T dL + sigma (dV V^T + V dV^T)
    dL~ = Psi(L~^{-T} dA~ L~^{-1}) L~,   Psi(M) = triu(M) - diag(M) / 2

Reverse (``backward``). The JAX package transposes the tangent map; torch
cannot, so the transpose is written out. With ``G`` the cotangent of
``L~`` (``Psi`` is its own adjoint)::

    Abar = L~^{-1} Psi(G L~^T) L~^{-T}
    Lbar = L (Abar + Abar^T)
    Vbar = sigma (Abar + Abar^T) V

Precision: every solve and product runs in at least fp32 (f64 stays f64);
only the returned tangent or cotangent is cast, to its output's or input's
dtype, so a bf16-stored factor gives an fp32 gradient for an fp32 ``V``.
Every step acts on the trailing two axes (``.mT`` is torch's batched
transpose, the JAX package's ``_mT``): a ``(B, n, n)`` fleet goes through
the same rule. The forward runs the backend with no tape.

The structured rule (``diffable_update_structured``) is the same rule
applied block by block along the block-tridiagonal chain: O(nb·b³) work,
nothing ``(n, n)`` built in the forward or the backward.

The sharded rule (``diffable_update_sharded``) is the dense rule around
the column-sharded driver (``method='sharded'``), whose result is a
``DTensor``. Its backward makes ``L~`` and the cotangent whole on every
rank (``distributed.gather``, the same collectives on every rank), runs
the dense rule's solves and products there, and hands each input its
gradient in the input's own layout: ``Lbar`` sharded like ``L`` (each rank
keeps its own columns, no communication), ``Vbar`` whole like ``V``. A
replicated gradient is never reduced again (that would multiply it by the
number of ranks). ``jvp`` does the same for forward mode, where the result
is gathered whole on every rank: torch's forward-mode AD cannot attach a
tangent to a ``DTensor``.
"""
from __future__ import annotations

import torch

from repro_torch.core import distributed as _distributed
from repro_torch.core.structure import BlockTriDiagStorage


def _psi(M):
    """Upper-triangular half-diagonal projector: triu(M) - diag(M)/2, on
    the trailing two axes."""
    return torch.triu(M) - 0.5 * torch.diag_embed(
        torch.diagonal(M, dim1=-2, dim2=-1))


def _acc(dtype):
    """The rule's arithmetic dtype: at least fp32, f64 kept."""
    return torch.promote_types(dtype, torch.float32)


def _or_zeros(t, like):
    return torch.zeros_like(like) if t is None else t


def _own(x):
    """``x``, copied if it is a view: a Function's output must own its
    memory for forward-mode AD to give it a tangent of its layout."""
    return x if x._base is None else x.clone()


def _solve_upper(U, B, *, trans: bool, left: bool = True):
    """``U^{-T} B`` / ``U^{-1} B`` (``left``) or ``B U^{-T}`` / ``B U^{-1}``."""
    if trans:
        return torch.linalg.solve_triangular(U.mT, B, upper=False, left=left)
    return torch.linalg.solve_triangular(U, B, upper=True, left=left)


def _murray_tangent(U, dA):
    """``Psi(U^{-T} dA U^{-1}) U``: the Cholesky differential of
    ``A = U^T U`` in direction ``dA`` (upper convention)."""
    M = _solve_upper(U, _solve_upper(U, dA, trans=True), trans=False,
                     left=False)
    return _psi(M) @ U


def _murray_adjoint(U, G):
    """``U^{-1} Psi(G U^T) U^{-T}``: the adjoint of ``_murray_tangent``."""
    X = _solve_upper(U, _psi(G @ U.mT), trans=False)
    return _solve_upper(U, X, trans=True, left=False)


def _whole(x):
    """``x`` whole on every rank (a ``DTensor`` is gathered, a collective
    every rank makes; a ``Partial`` one is reduced first); anything else
    as it is."""
    if not _distributed.is_sharded(x):
        return x
    if any(p.is_partial() for p in x.placements):
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh,
                           [Replicate() if p.is_partial() else p
                            for p in x.placements])
    return _distributed.gather(x)


class _DenseRule(torch.autograd.Function):
    """``impl(L, V, sigma)`` under the Murray rule (dense, any fleet, or
    sharded over a mesh: then on the whole factor on every rank). With
    ``whole`` the result is gathered whole (forward mode through the
    sharded driver: a ``DTensor`` cannot carry a forward-mode tangent)."""

    @staticmethod
    def forward(impl, sigma, whole, L, V):
        out = impl(L, V, sigma)
        return _own(_whole(out) if whole else out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, sigma, _, L, V = inputs
        ctx.sigma = sigma
        ctx.save_for_backward(L, V, output)
        ctx.save_for_forward(L, V, output)

    @staticmethod
    def backward(ctx, G):
        L, V, Ln = ctx.saved_tensors
        acc = _acc(Ln.dtype)
        Abar = _murray_adjoint(_whole(Ln).to(acc), _whole(G).to(acc))
        S = Abar + Abar.mT
        gL = gV = None
        if ctx.needs_input_grad[3]:
            gL = _distributed.place_like(
                (_whole(L).to(acc) @ S).to(L.dtype), L)
        if ctx.needs_input_grad[4]:
            gV = _distributed.place_like(
                (ctx.sigma * (S @ _whole(V).to(acc))).to(V.dtype), V)
        return None, None, None, gL, gV

    @staticmethod
    def jvp(ctx, _impl_t, _sigma_t, _whole_t, dL, dV):
        L, V, Ln = ctx.saved_tensors
        acc = _acc(Ln.dtype)
        Lh, Vh = _whole(L).to(acc), _whole(V).to(acc)
        dLh = _whole(_or_zeros(dL, L)).to(acc)
        dVh = _whole(_or_zeros(dV, V)).to(acc)
        dA = (dLh.mT @ Lh + Lh.mT @ dLh
              + ctx.sigma * (dVh @ Vh.mT + Vh @ dVh.mT))
        return _distributed.place_like(
            _murray_tangent(_whole(Ln).to(acc), dA).to(Ln.dtype), Ln)


def diffable_update_sharded(impl, sigma, L, V, *, forward_mode=False):
    """``impl(L, V, sigma) -> L_new`` (a ``DTensor``) under the dense
    Murray rule, for a factor or a ``(B, n, n)`` fleet sharded over a mesh
    (``L`` a ``DTensor`` or the whole tensor on every rank). Every rank of
    the mesh calls it, and its backward, with the same arguments. With
    ``forward_mode`` (a forward-AD level is active) the inputs must be
    whole tensors and the result comes back whole on every rank, carrying
    its tangent."""
    return _DenseRule.apply(impl, sigma, forward_mode, L, V)


def diffable_update(impl, sigma, L, V):
    """``impl(L, V, sigma) -> L_new`` under Murray's derivative rules.

    ``impl`` is the dispatched backend (the CUDA kernel on the card), run
    with no tape; ``V`` must already be ``(..., n, k)``. Stacked
    ``(B, n, n)`` / ``(B, n, k)`` operands go through the same rule.
    """
    return _DenseRule.apply(impl, sigma, False, L, V)


# ---------------------------------------------------------------------------
# Block-tridiagonal storage.
# ---------------------------------------------------------------------------


def _chain_factor(Ad, Ao):
    """Block-chain Cholesky: ``(Ad, Ao)`` blocks of a block-tridiagonal SPD
    matrix -> ``(diag, off)`` blocks of its upper block-bidiagonal factor
    (``BlockTriDiagStorage``'s chain), batched over leading axes; O(nb·b³),
    never ``(n, n)``. The backward re-enters it under autograd."""
    nb = Ad.shape[-3]
    diag, off = [], []
    S = Ad[..., 0, :, :]
    for j in range(nb):
        U = torch.linalg.cholesky(S).mT
        diag.append(U)
        if j + 1 == nb:
            break
        o = _solve_upper(U, Ao[..., j, :, :], trans=True)
        off.append(o)
        S = Ad[..., j + 1, :, :] - o.mT @ o
    return torch.stack(diag, dim=-3), _stack_off(off, Ad)


def _stack_off(off, like):
    if off:
        return torch.stack(off, dim=-3)
    return like.new_zeros(like.shape[:-3] + (0,) + like.shape[-2:])


def _chain_factor_jvp(U, O, dAd, dAo):
    """Tangents ``(dU, dO)`` of the chain factor ``(U, O)`` in direction
    ``(dAd, dAo)``, the chain's own recurrence differentiated::

        dS_j  = dAd_j - dO_{j-1}^T O_{j-1} - O_{j-1}^T dO_{j-1}
        dU_j  = Psi(U_j^{-T} dS_j U_j^{-1}) U_j
        dO_j  = U_j^{-T} (dAo_j - dU_j^T O_j)
    """
    nb = U.shape[-3]
    dU, dO = [], []
    dS = dAd[..., 0, :, :]
    for j in range(nb):
        Uj = U[..., j, :, :]
        dUj = _murray_tangent(Uj, dS)
        dU.append(dUj)
        if j + 1 == nb:
            break
        Oj = O[..., j, :, :]
        dOj = _solve_upper(Uj, dAo[..., j, :, :] - dUj.mT @ Oj, trans=True)
        dO.append(dOj)
        dS = dAd[..., j + 1, :, :] - dOj.mT @ Oj - Oj.mT @ dOj
    return torch.stack(dU, dim=-3), _stack_off(dO, dAd)


def _bilinear(x, y, sigma):
    """``(Ad, Ao)`` of ``D2^T D + O2^T O`` (shifted a block) ``+ sigma V2
    V^T`` in block form, for ``x = (D, O, V)`` and ``y = (D2, O2, V2)``
    (``V`` may be None): ``_bilinear(x, x)`` are the blocks of ``U^T U +
    sigma V V^T``, ``_bilinear(dx, x) + _bilinear(x, dx)`` their tangent.
    O(n·b·k); ``V`` is ``(..., n, k)``."""
    (D, O, V), (D2, O2, V2) = x, y
    nb, b = D.shape[-3], D.shape[-1]
    Ad = D2.mT @ D
    Ao = D2[..., :-1, :, :].mT @ O
    if V is not None:
        shape = V.shape[:-2] + (nb, b, V.shape[-1])
        Vb, V2b = V.reshape(shape), V2.reshape(shape)
        Ad = Ad + sigma * (V2b @ Vb.mT)
        Ao = Ao + sigma * (V2b[..., :-1, :, :] @ Vb[..., 1:, :, :].mT)
    if nb > 1:
        Ad = torch.cat([Ad[..., :1, :, :],
                        Ad[..., 1:, :, :] + O2.mT @ O], dim=-3)
    return Ad, Ao


class _StructuredRule(torch.autograd.Function):
    """``impl(S, V, sigma)`` for ``BlockTriDiagStorage`` under the
    blockwise Murray rule; tensors in and out are the block stacks."""

    @staticmethod
    def forward(impl, sigma, diag, off, V):
        S_new = impl(BlockTriDiagStorage(diag, off), V, sigma)
        return _own(S_new.diag), _own(S_new.off)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, sigma, diag, off, V = inputs
        ctx.sigma = sigma
        ctx.save_for_backward(diag, off, V, *output)
        ctx.save_for_forward(diag, off, V, *output)

    @staticmethod
    def backward(ctx, gDn, gOn):
        diag, off, V, Dn, On = ctx.saved_tensors
        acc = _acc(Dn.dtype)
        with torch.enable_grad():
            ins = tuple(x.detach().to(acc).requires_grad_(True)
                        for x in (diag, off, V))
            Ad, Ao = _bilinear(ins, ins, ctx.sigma)
            # The chain is differentiated at the modified matrix recovered
            # from the primal output, as the JAX rule does; the direction
            # comes from the inputs (value of Adn, gradient of Ad).
            out = (Dn.detach().to(acc), On.detach().to(acc), None)
            Adn, Aon = _bilinear(out, out, ctx.sigma)
            U, O = _chain_factor(Adn + (Ad - Ad.detach()),
                                 Aon + (Ao - Ao.detach()))
            outs, cots = [U], [gDn.to(acc)]
            if O.shape[-3]:
                outs.append(O)
                cots.append(gOn.to(acc))
            grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
        return (None, None) + tuple(
            None if g is None or not need else g.to(x.dtype)
            for g, x, need in zip(grads, (diag, off, V),
                                  ctx.needs_input_grad[2:]))

    @staticmethod
    def jvp(ctx, _impl_t, _sigma_t, dD, dO, dV):
        diag, off, V, Dn, On = ctx.saved_tensors
        acc = _acc(Dn.dtype)
        x = tuple(t.to(acc) for t in (diag, off, V))
        dx = tuple(_or_zeros(d, t).to(acc)
                   for d, t in zip((dD, dO, dV), (diag, off, V)))
        (a, b), (c, d) = (_bilinear(dx, x, ctx.sigma),
                          _bilinear(x, dx, ctx.sigma))
        dU, dOn = _chain_factor_jvp(Dn.to(acc), On.to(acc), a + c, b + d)
        return dU.to(Dn.dtype), dOn.to(On.dtype)


def diffable_update_structured(impl, sigma, S, V):
    """The structured twin of ``diffable_update``: ``S`` is a
    ``BlockTriDiagStorage`` (one factor or a fleet), ``impl(S, V, sigma)``
    its backend. Exact for the block-local directions the storage's
    contract allows (``assert_blocklocal``); returns a storage."""
    diag, off = _StructuredRule.apply(impl, sigma, S.diag, S.off, V)
    return BlockTriDiagStorage(diag, off)
