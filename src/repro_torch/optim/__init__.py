"""Optimizers, PyTorch port of ``repro.optim``: functional (init, update)
pairs over trees of tensors, and ``cholesky_precond``, which keeps its
statistics in batched ``CholFactor``s (scale, update, downdate, solve)."""
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import (Optimizer, apply_updates, cast_tree,
                                    global_norm)
from repro_torch.optim.cholesky_precond import cholesky_precond
from repro_torch.optim.clip import all_finite, clip_by_global_norm
from repro_torch.optim.schedule import constant, inverse_sqrt, warmup_cosine
from repro_torch.optim.sgd import sgd

__all__ = [
    "Optimizer",
    "apply_updates",
    "global_norm",
    "cast_tree",
    "adamw",
    "sgd",
    "cholesky_precond",
    "clip_by_global_norm",
    "all_finite",
    "constant",
    "inverse_sqrt",
    "warmup_cosine",
    "get_optimizer",
]


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    """Config-driven optimizer factory."""
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "cholesky_precond":
        return cholesky_precond(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
