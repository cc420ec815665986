"""Gradient clipping and finiteness guards, PyTorch port of
``repro.optim.clip``."""
from __future__ import annotations

import torch

from repro_torch.optim.base import global_norm, tree_leaves, tree_map


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped_grads, pre_clip_norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def all_finite(tree):
    return torch.stack([torch.all(torch.isfinite(x))
                        for x in tree_leaves(tree)]).all()
