"""AdamW with fp32 state over possibly lower-precision params, PyTorch port
of ``repro.optim.adamw``."""
from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.optim.base import (Optimizer, flatten_up_to, tree_leaves,
                                    tree_map, unflatten)

ScheduleOrFloat = Union[float, Callable[[int], float]]


def _lr_at(lr: ScheduleOrFloat, step: int) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _bias_corrections(b1: float, b2: float, step: int):
    return 1.0 - b1 ** step, 1.0 - b2 ** step


def _adam_moments(g32, m, v, b1, b2):
    """The new first and second moments, in fp32."""
    return (b1 * m.float() + (1 - b1) * g32,
            b2 * v.float() + (1 - b2) * torch.square(g32))


def adamw(
    lr: ScheduleOrFloat = 1e-3,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    state_dtype=torch.float32,
) -> Optimizer:
    """AdamW. ``state_dtype`` may be bf16 for memory-squeezed mega models.
    The state's ``step`` is a host int."""

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        bc1, bc2 = _bias_corrections(b1, b2, step)

        def upd(g, m, v, p):
            m_new, v_new = _adam_moments(g.float(), m, v, b1, b2)
            delta = -lr_t * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                             + weight_decay * p.float())
            return delta, m_new.to(state_dtype), v_new.to(state_dtype)

        out = [upd(*a) for a in zip(
            tree_leaves(grads), *(flatten_up_to(grads, t)
                                  for t in (state["m"], state["v"], params)))]
        pick = lambda i: unflatten(grads, [o[i] for o in out])
        return pick(0), {"step": step, "m": pick(1), "v": pick(2)}

    return Optimizer(init=init, update=update)
