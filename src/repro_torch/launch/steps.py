"""Train / prefill / serve steps + per-cell input specs, PyTorch port.

The train step takes the model (its parameters are the values), the
optimizer state and a batch, and hands the optimizer the JAX package's
values tree (``models.values_tree``): the same leaves, in the same order
(keys sorted), with the same shapes, each stack of layers one leaf a
parameter. So ``cholesky_precond`` preconditions exactly the leaves the
JAX package's step preconditions (for llama3.2-3b: ``embed.tokens`` and
the stacked ``layers.ln1.scale`` / ``layers.ln2.scale``; every 3-D and
4-D stacked weight takes the Adam path), grafts each onto its own Adam
norm, and seeds each sketch from the JAX package's leaf index. The
stacked leaves are the layers' own storage, so the updates land in the
model in place.
"""
from __future__ import annotations

import torch

import repro_torch.optim as optim
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import (decode_step, init_cache, loss_fn,
                                split_params)
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.optim.base import tree_map


# ---------------------------------------------------------------------------
# Step bodies.
# ---------------------------------------------------------------------------


def _set(tree: dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _grads(cfg, model, batch):
    """(total, metrics, grads): the loss, its metrics (detached) and the
    gradient of ``total`` as the JAX package's values tree (each stacked
    leaf the layers' gradients stacked, in the parameters' dtype)."""
    leaves = T.stacked_leaves(model)
    sources = [p for _, _, srcs in leaves for p in srcs]
    total, metrics = loss_fn(model, cfg, batch)
    gs = list(torch.autograd.grad(total, sources, allow_unused=True))
    grads, at = {}, 0
    for path, leaf, srcs in leaves:
        part = [torch.zeros_like(p) if g is None else g
                for g, p in zip(gs[at:at + len(srcs)], srcs)]
        gs[at:at + len(srcs)] = [None] * len(srcs)   # free as we stack
        _set(grads, path, part[0] if len(srcs) == 1 and leaf is srcs[0]
             else torch.stack(part))
        at += len(srcs)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, opt: optim.Optimizer, *, clip_norm=1.0,
                    grad_accum: int = 1, mesh=None, policy: str = "tp"):
    """One optimizer step, ``step(model, opt_state, batch) -> (model,
    opt_state, metrics)``: the model is updated in place, and the optimizer
    writes its new moments into the state it is given (``donate=True``,
    the JAX driver's ``donate_argnums``), so the caller gives that state
    up. ``grad_accum`` microbatches the global batch, accumulating the
    microbatches' gradients in fp32 (the JAX package's accumulator) and
    averaging their metrics.

    ``mesh``: the mesh of several ranks the model's parameters are placed
    on (``launch.train.build``); each batch is then placed by
    ``batch_specs`` (under ``policy``), and the step runs under
    ``implicit_replication`` (the plain tensors the model code makes, such
    as positions, count as replicated). A batch on the meta device (the
    dry run's stand-ins) is placed where it is: it has nothing to copy."""
    if mesh is None:
        return _train_step(cfg, opt, clip_norm, grad_accum, lambda b: b)
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    def place(batch):
        specs = batch_specs(batch, mesh, policy=policy)
        return {k: distribute_tensor(
                    x if x.is_meta else x.to(mesh.device_type), mesh,
                    list(specs[k]))
                for k, x in batch.items()}

    inner = _train_step(cfg, opt, clip_norm, grad_accum, place)

    def sharded_step(model, opt_state, batch):
        with implicit_replication():
            model, opt_state, metrics = inner(model, opt_state, batch)
        return model, opt_state, {
            k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in metrics.items()}

    return sharded_step


def _train_step(cfg, opt, clip_norm, grad_accum, place):
    """The step of ``make_train_step``; ``place`` puts a (micro)batch
    where the model's parameters are."""

    def train_step(model, opt_state, batch):
        if grad_accum == 1:
            total, metrics, grads = _grads(cfg, model, place(batch))
        else:
            mb = {k: x.reshape(grad_accum, x.shape[0] // grad_accum,
                               *x.shape[1:]) for k, x in batch.items()}
            gsum, tsum, mets = None, None, []
            for i in range(grad_accum):
                t, met, g = _grads(cfg, model,
                                   place({k: x[i] for k, x in mb.items()}))
                if gsum is None:  # fp32 accumulators from zero
                    gsum = tree_map(lambda a: torch.zeros_like(
                        a, dtype=torch.float32), g)
                    tsum = torch.zeros_like(t, dtype=torch.float32)
                gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
                tsum = tsum + t
                mets.append(met)
                del g
            grads = tree_map(lambda g: g / grad_accum, gsum)
            del gsum
            total = tsum / grad_accum
            metrics = {k: torch.mean(torch.stack([m[k] for m in mets]),
                                     dim=0) for k in mets[0]}
        grads, gnorm = optim.clip_by_global_norm(grads, clip_norm)
        values = T.values(model)
        updates, opt_state = opt.update(grads, opt_state, values,
                                        donate=True)
        del grads
        with torch.no_grad():
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), values, updates)
        metrics = dict(metrics, grad_norm=gnorm, loss_total=total)
        return model, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(model, cache, tokens):
        # A serve step takes no gradient (the JAX one is a jit of the
        # forward): no autograd graph holds its activations.
        with torch.no_grad():
            return decode_step(model, cfg, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Forward over the full prompt emitting the last token's logits."""

    def prefill_step(model, batch):
        from repro_torch.models.model import forward

        with torch.no_grad():   # a forward only, as the JAX jit of it
            return forward(model, cfg, batch)[:, -1]

    return prefill_step


# ---------------------------------------------------------------------------
# Shape specs per cell (meta-device stand-ins; no allocation, no draw).
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell, *,
                cache_dtype=torch.bfloat16):
    """Meta-device stand-ins for every model input of the cell (shapes and
    dtypes, no memory)."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        specs = {"tokens": _meta((B, S), torch.int32)}
        if cell.kind == "train":
            specs["labels"] = _meta((B, S), torch.int32)
        if cfg.family == "vlm":
            P = int(S * cfg.frontend_frac)
            specs["embeds"] = _meta((B, P, cfg.d_model), torch.bfloat16)
        if cfg.family == "encdec":
            specs["src_embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        return specs
    if cell.kind == "decode":
        cache = init_cache(cfg, B, S, cache_dtype, device="meta")
        return {"tokens": _meta((B,), torch.int32), "cache": cache}
    raise ValueError(cell.kind)


def _meta_model(cfg):
    """The model's parameters on the meta device: built, never drawn (a
    meta tensor takes no generator)."""
    return (ED.EncDec if cfg.family == "encdec" else T.LM)(cfg,
                                                           device="meta")


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def param_shapes_and_axes(cfg: ModelConfig, model=None):
    """(values tree of meta tensors, logical axes tree) without allocation.

    Shapes come from the full config built on the meta device (or from
    ``model``, such a model already built); axes from the reduced config's
    model (identical tree structure, checked), as the JAX package takes
    them."""
    values = T.values(_meta_model(cfg) if model is None else model)
    _, axes = split_params(_meta_model(cfg.reduced()))
    s1, s2 = _structure(values), _structure(axes)
    assert s1 == s2, f"axes tree mismatch: {s1} vs {s2}"
    return values, axes


def opt_state_specs(opt_state_shapes, param_specs_tree, mesh):
    """Placements for the optimizer state: m/v mirror the params when the
    subtree's structure matches; the step, the factors and everything
    else replicate."""
    from torch.distributed.tensor import Replicate

    from repro_torch.sharding.rules import axis_sizes

    rep = tuple(Replicate() for _ in axis_sizes(mesh))

    def replicate(sub):
        if isinstance(sub, dict):
            return {k: replicate(v) for k, v in sub.items()}
        return rep

    want = _structure(param_specs_tree)
    out = {}
    for k, sub in opt_state_shapes.items():
        if k in ("m", "v") and isinstance(sub, dict) and \
                _structure(sub) == want:
            out[k] = param_specs_tree
        else:
            out[k] = replicate(sub)
    return out


def batch_specs(specs_tree, mesh, *, policy: str = "tp"):
    """Batch-dim placements over the data axes (replicate when
    indivisible). Under policy='dp' the model axis joins the data axes; if
    the batch does not divide the combined size, the largest divisible
    prefix is used."""
    from repro_torch.sharding import rules

    sizes = rules.axis_sizes(mesh)
    dp = rules.data_axes(mesh)
    if policy == "dp":
        dp = dp + rules.model_axes(mesh)

    def spec(x):
        dims = [()] * x.ndim
        if x.ndim:
            axes = list(dp)
            size = 1
            for a in axes:
                size *= sizes[a]
            while axes and x.shape[0] % size:
                size //= sizes[axes.pop()]  # drop the innermost axis
            dims[0] = tuple(axes)
        return rules._placements(dims, mesh)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return spec(t)

    return walk(specs_tree)
