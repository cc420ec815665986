"""AdamW with fp32 state over possibly lower-precision params, PyTorch port
of ``repro.optim.adamw``."""
from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.optim.base import (Optimizer, donated, flatten_up_to,
                                    tree_leaves, tree_map, unflatten)

ScheduleOrFloat = Union[float, Callable[[int], float]]


def _lr_at(lr: ScheduleOrFloat, step: int) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _bias_corrections(b1: float, b2: float, step: int):
    return 1.0 - b1 ** step, 1.0 - b2 ** step


def _adam_moments(g32, m, v, b1, b2):
    """The new first and second moments, in fp32: ``b1 m + (1 - b1) g`` and
    ``b2 v + (1 - b2) g²``, each sum and product formed in place (the same
    roundings, fewer leaf-sized temporaries)."""
    m_new = b1 * m.float()
    m_new += (1 - b1) * g32
    sq = torch.square(g32)
    sq *= 1 - b2
    v_new = b2 * v.float()
    v_new += sq
    return m_new, v_new


def _adam_direction(m_new, v_new, bc1, bc2, eps):
    """``(m_new / bc1) / (sqrt(v_new / bc2) + eps)``, formed in place."""
    den = v_new / bc2
    den.sqrt_()
    den += eps
    out = m_new / bc1
    out /= den
    return out


def _decayed_step(direction, p, lr_t, weight_decay):
    """``-lr_t * (direction + weight_decay * p)``, in place on
    ``direction``."""
    direction += weight_decay * p.float()
    direction *= -lr_t
    return direction


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
    The state's ``step`` is a host int. ``update(..., donate=True)`` writes
    the new moments into the state's tensors (``base.donated``)."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=state_dtype)
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params, *, donate=False):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        bc1, bc2 = _bias_corrections(b1, b2, step)

        def upd(g, m, v, p):
            m_new, v_new = _adam_moments(g.float(), m, v, b1, b2)
            delta = _decayed_step(_adam_direction(m_new, v_new, bc1, bc2, eps),
                                  p, lr_t, weight_decay)
            news = (m_new.to(state_dtype), v_new.to(state_dtype))
            return (delta,) + donated(donate, (m, v), news)

        out = [upd(*a) for a in zip(
            tree_leaves(grads), *(flatten_up_to(grads, t)
                                  for t in (state["m"], state["v"], params)))]
        pick = lambda i: unflatten(grads, [o[i] for o in out])
        return pick(0), {"step": step, "m": pick(1), "v": pick(2)}

    return Optimizer(init=init, update=update)
