"""CholeskyPrecond: the paper's rank-k up/down-date as a training-time
feature, PyTorch port of ``repro.optim.cholesky_precond``.

A sketched Online-Newton-Step optimizer in the Shampoo/Sketchy family.
For every 2-D parameter ``W (m, n)`` it preconditions the gradient over the
*smaller* side with the maintained statistics

    A = eps*I + sum_s beta^(t-s) V_s V_s^T,     V_s = G_s Omega / sqrt(k)

where ``V_s`` is a rank-k sketch of step s's gradient. ``A``'s upper
Cholesky factor is never refactorized:

* per step the factor absorbs the new sketch by a rank-k **update**;
* exponential decay ``beta`` is exact factor scaling (``C <- sqrt(beta) C``);
* with ``window > 0`` the factor is **downdated** by the expiring
  (decay-scaled) sketch, kept in a ring: the paper's downdate every step.

The preconditioned direction ``A^{-1} G`` (or ``G A^{-1}``) comes from two
triangular solves against the factor and is grafted onto Adam's step norm.
Sides larger than ``block_size`` are split into independent diagonal
blocks, one batched ``CholFactor`` of ``(n_blocks, b, b)`` a parameter, so
each mutation is one launch of the fused kernel on CUDA (``update_method=
'auto'``). Non-2-D and ineligible parameters take the Adam path.

The sketch ``Omega`` is drawn by ``sketch`` from a ``torch.Generator`` on
the parameter's device, seeded from ``(seed, step, parameter index)``; the
port does not reproduce ``jax.random``'s draws (tests put JAX's draws in
``sketch``'s place). The step count is a host int, so the ring's slot and
whether a downdate is due are decided on the host: while the expiring slot
still holds no sketch (the first ``window`` steps) the downdate, by exact
zeros and so the identity, is not launched.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

from repro_torch.core.factor import CholFactor
from repro_torch.optim.adamw import (_adam_direction, _adam_moments,
                                     _bias_corrections, _decayed_step, _lr_at)
from repro_torch.optim.base import (Optimizer, donated, flatten_up_to,
                                    tree_leaves, tree_map, unflatten)


def _precond_side(p_shape, max_precond_dim, rank, block_size):
    """Which side to precondition: the smaller one; None if ineligible."""
    if len(p_shape) != 2:
        return None
    m, n = p_shape
    d = min(m, n)
    if d < 2 * rank or d > max_precond_dim:
        return None
    b = min(block_size, d)
    if d % b:
        return None
    return "left" if m <= n else "right"


def _whole(x):
    """A ``DTensor`` gathered whole on every rank (the factors are
    replicated, as the JAX package's ``opt_state_specs`` places them); a
    tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _seed(seed: int, step: int, index: int) -> int:
    return ((seed * 1_000_003 + step) * 1_000_003 + index) % (2 ** 63)


def sketch(other: int, rank: int, *, seed: int, step: int, index: int,
           device) -> torch.Tensor:
    """``Omega / sqrt(rank)``: an ``(other, rank)`` fp32 Gaussian sketch for
    parameter ``index`` at ``step``, from a generator on ``device``. On
    the meta device (a dry run's trace) there is nothing to draw: a meta
    tensor of the sketch's shape."""
    if torch.device(device).type == "meta":
        return torch.empty((other, rank), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, step, index))
    om = torch.randn((other, rank), generator=gen, dtype=torch.float32,
                     device=device)
    return om / math.sqrt(rank)


def cholesky_precond(
    lr: Union[float, Callable] = 1e-3,
    *,
    rank: int = 16,
    block_size: int = 1024,
    beta: float = 0.999,
    window: int = 0,
    eps: float = 1e-2,
    b1: float = 0.9,
    b2: float = 0.95,
    adam_eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_precond_dim: int = 16384,
    update_method: str = "auto",
    seed: int = 0,
) -> Optimizer:
    """See module docstring. ``window > 0`` enables exact sliding-window
    statistics; it composes with ``beta`` by downdating the expiring sketch
    scaled by ``beta**(window/2)``. ``update(..., donate=True)`` writes
    the new moments into the state's tensors (``base.donated``)."""

    def init(params):
        def per_param(p):
            side = _precond_side(p.shape, max_precond_dim, rank, block_size)
            if side is None:
                return None
            d = min(p.shape)
            b = min(block_size, d)
            c0 = CholFactor.identity(b, scale=eps, batch=d // b,
                                     backend=update_method,
                                     panel=min(256, b), device=p.device)
            state = {"c": c0}
            if window > 0:
                state["ring"] = torch.zeros((window, d, rank),
                                            dtype=torch.float32,
                                            device=p.device)
            return state

        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params),
                "factors": tree_map(per_param, params)}

    def update(grads, state, params, *, donate=False):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        bc1, bc2 = _bias_corrections(b1, b2, step)

        def upd(index, g, m, v, p, fac):
            g32 = g.float()
            m_new, v_new = _adam_moments(g32, m, v, b1, b2)
            side = _precond_side(g32.shape, max_precond_dim, rank,
                                 block_size)
            if fac is None or side is None:
                del g32  # the Adam path needs no more of it
            adam_dir = _adam_direction(m_new, v_new, bc1, bc2, adam_eps)
            m_new, v_new = donated(donate, (m, v), (m_new, v_new))
            if fac is None or side is None:
                return (_decayed_step(adam_dir, p, lr_t, weight_decay), m_new,
                        v_new, fac)

            gmat = _whole(g32 if side == "left" else g32.T)  # (d, other)
            d, other = gmat.shape
            b = min(block_size, d)
            v_sk = gmat @ sketch(other, rank, seed=seed, step=step,
                                 index=index, device=g32.device)  # (d, k)

            # Decay is exact factor scaling, the new sketch a rank-k update,
            # the expiring sketch a rank-k downdate: one maintained factor.
            c = fac["c"].scale(math.sqrt(beta))
            c = c.update(v_sk.reshape(d // b, b, rank))
            fac_new = dict(fac)
            if window > 0:
                slot = (step - 1) % window
                if step > window:
                    old = fac["ring"][slot] * beta ** (window / 2.0)
                    c = c.downdate(old.reshape(d // b, b, rank))
                ring = fac["ring"].clone()
                ring[slot] = v_sk
                fac_new["ring"] = ring
            fac_new["c"] = c

            # direction = A^{-1} gmat: two triangular solves per block.
            pdir = c.solve(gmat.reshape(d // b, b, other)).reshape(d, other)
            if side == "right":
                pdir = pdir.T
            # Grafting: second-order direction, Adam step norm.
            direction = pdir * (torch.linalg.norm(adam_dir)
                                / (torch.linalg.norm(pdir) + 1e-16))
            return (_decayed_step(direction, p, lr_t, weight_decay), m_new,
                    v_new, fac_new)

        leaves = zip(tree_leaves(grads),
                     *(flatten_up_to(grads, t) for t in
                       (state["m"], state["v"], params, state["factors"])))
        out = [upd(i, *a) for i, a in enumerate(leaves)]
        pick = lambda i: unflatten(grads, [o[i] for o in out])
        return pick(0), {"step": step, "m": pick(1), "v": pick(2),
                         "factors": pick(3)}

    return Optimizer(init=init, update=update)
