"""Family dispatch facade, PyTorch port: one API over the decoder-only
families.

The port's model is an ``nn.Module`` (``transformer.LM``) whose parameters
are the values the JAX package's functions take as a tree: ``init_model``
returns it, ``split_params`` gives it back beside the logical-axes tree,
and ``forward`` / ``decode_step`` take it where the JAX package takes the
values. The encoder-decoder family (``models/encdec.py`` there) and the
losses (``loss_fn``) are not ported yet (ROADMAP item 11b): each entry point
refuses ``family == 'encdec'``.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def _no_encdec(cfg, what):
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{what}: the encoder-decoder family is not ported yet "
            "(ROADMAP item 11b)")


def init_model(cfg, *, device=None, seed: int = 0):
    """The model with its parameters drawn by the JAX package's init rules
    from ``seed`` (``transformer.init_lm``); on CUDA unless ``device`` says
    otherwise."""
    _no_encdec(cfg, "init_model")
    return T.init_lm(cfg, device=device, seed=seed)


def split_params(model):
    """-> (values, logical-axes tree): the module itself holds the values;
    the axes tree is the JAX package's (``'layers'`` in front of each
    layer leaf's axes)."""
    _no_encdec(model.cfg, "split_params")
    return model, T.lm_axes(model)


def forward(model, cfg, batch):
    """batch: dict with 'tokens' (+ 'embeds' for the vlm stub)."""
    _no_encdec(cfg, "forward")
    logits, _ = T.forward_lm(model, cfg, batch["tokens"],
                             embeds=batch.get("embeds"))
    return logits


def init_cache(cfg, batch_size, seq_len, dtype=torch.bfloat16, *,
               device=None):
    _no_encdec(cfg, "init_cache")
    spec = T.cache_spec(cfg, batch_size, seq_len)
    return T.init_cache(cfg, spec, dtype, device=device)


def decode_step(model, cfg, cache, tokens):
    _no_encdec(cfg, "decode_step")
    return T.decode_step(model, cfg, cache, tokens)


def param_count(model) -> int:
    return sum(int(p.numel()) for p in model.parameters())
