"""SGD with momentum (baseline optimizer), PyTorch port of
``repro.optim.sgd``."""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import _lr_at
from repro_torch.optim.base import (Optimizer, donated, flatten_up_to,
                                    tree_leaves, tree_map, unflatten)


def sgd(lr=1e-2, *, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    """SGD with momentum; ``update(..., donate=True)`` writes the new
    momentum into the state's tensors (``base.donated``)."""

    def init(params):
        return {"step": 0,
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)}

    def update(grads, state, params, *, donate=False):
        del params
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)

        def upd(g, mu):
            g32 = g.float()
            mu_new = momentum * mu + g32
            d = g32 + momentum * mu_new if nesterov else mu_new
            return -lr_t * d, donated(donate, (mu,), (mu_new,))[0]

        out = [upd(g, mu) for g, mu in zip(
            tree_leaves(grads), flatten_up_to(grads, state["mu"]))]
        return (unflatten(grads, [o[0] for o in out]),
                {"step": step, "mu": unflatten(grads, [o[1] for o in out])})

    return Optimizer(init=init, update=update)
