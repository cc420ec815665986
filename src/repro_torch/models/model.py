"""Family dispatch facade, PyTorch port: one API over the decoder-only and
encoder-decoder families.

The port's model is an ``nn.Module`` (``transformer.LM`` or
``encdec.EncDec``) whose parameters are the values the JAX package's
functions take as a tree: ``init_model`` returns it, ``split_params`` gives
it back beside the logical-axes tree, ``values_tree`` reads it as the JAX
values tree (stacked layer leaves, no copy), and ``forward`` /
``loss_fn`` / ``decode_step`` take it where the JAX package takes the
values.
"""
from __future__ import annotations

import torch

from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T


def init_model(cfg, *, device=None, seed: int = 0):
    """The model with its parameters drawn by the JAX package's init rules
    from ``seed``; on CUDA unless ``device`` says otherwise."""
    if cfg.family == "encdec":
        return ED.init_encdec(cfg, device=device, seed=seed)
    return T.init_lm(cfg, device=device, seed=seed)


def split_params(model):
    """-> (values, logical-axes tree): the module itself holds the values;
    the axes tree is the JAX package's (``'layers'`` in front of each
    stacked leaf's axes)."""
    if model.cfg.family == "encdec":
        return model, ED.encdec_axes(model)
    return model, T.lm_axes(model)


def values_tree(model) -> dict:
    """The JAX package's values tree (``split_params(...)[0]`` there) over
    the model's own storage: ``transformer.values``."""
    return T.values(model)


def loss_fn(model, cfg, batch):
    """batch: dict with 'tokens'/'labels' (+ 'embeds' or 'src_embeds').
    Returns (total, metrics)."""
    if cfg.family == "encdec":
        return ED.encdec_loss(model, cfg, batch["src_embeds"],
                              batch["tokens"], batch["labels"])
    return T.lm_loss(model, cfg, batch["tokens"], batch["labels"],
                     embeds=batch.get("embeds"))


def forward(model, cfg, batch):
    """batch: dict with 'tokens' (+ 'embeds' for the vlm stub,
    'src_embeds' for encdec)."""
    if cfg.family == "encdec":
        enc = ED.encode(model, cfg, batch["src_embeds"])
        return ED.decode_train(model, cfg, enc, batch["tokens"])
    logits, _ = T.forward_lm(model, cfg, batch["tokens"],
                             embeds=batch.get("embeds"))
    return logits


def init_cache(cfg, batch_size, seq_len, dtype=torch.bfloat16, *,
               device=None):
    if cfg.family == "encdec":
        return ED.init_encdec_cache(cfg, batch_size, seq_len, seq_len, dtype,
                                    device=device)
    spec = T.cache_spec(cfg, batch_size, seq_len)
    return T.init_cache(cfg, spec, dtype, device=device)


def decode_step(model, cfg, cache, tokens):
    if cfg.family == "encdec":
        return ED.encdec_decode_step(model, cfg, cache, tokens)
    return T.decode_step(model, cfg, cache, tokens)


def param_count(model) -> int:
    return sum(int(p.numel()) for p in model.parameters())
