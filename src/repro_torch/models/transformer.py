"""Decoder-only LM assembly, PyTorch port: the dense / moe / rwkv /
mamba-hybrid / vlm families.

The JAX package stacks the layers' parameters on a leading ``layers`` axis
and scans them; here the layers are an ``nn.ModuleList`` and the list index
is that axis. Their parameters live in one stacked tensor per leaf
(``layers.alias_stacked``), so ``values`` reads the JAX package's values
tree with no copy and an optimizer's in-place update of a stacked leaf
updates every layer (``lm_axes`` puts ``'layers'`` back in front of each
leaf's logical axes). With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), and
the loss (``chunked_xent``) projects the vocabulary a chunk of tokens at a
time, each chunk checkpointed too. Per-layer heterogeneity stays data, not
structure:

* gemma2's local/global alternation reads a per-layer ``window`` value
  (``layer_windows``; 0 disables it);
* zamba2's shared attention block (one parameter set) runs before each
  group of ``shared_attn_every`` mamba layers and before the tail.

``decode_step`` walks the same layers with per-layer cache slices; SWA
caches are ring buffers (O(window) memory for long streams). A decode
step takes its cache donated, as the JAX dry run's step does: it writes
every leaf in place and returns the same tensors.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.sharding import rules


# ---------------------------------------------------------------------------
# Per-layer init by family.
# ---------------------------------------------------------------------------


def _layer_init(cfg, dtype, device):
    fam = cfg.family
    d = cfg.d_model
    p = L.Params()
    if fam in ("dense", "vlm"):
        p.child("ln1", L.norm_init(cfg.norm, d, dtype, device))
        p.child("attn", A.attention_init(cfg.attn, d, dtype, device))
        p.child("ln2", L.norm_init(cfg.norm, d, dtype, device))
        p.child("mlp", L.mlp_init(d, cfg.d_ff, dtype,
                                  activation=cfg.activation, device=device))
        if cfg.post_norm:
            p.child("ln1_post", L.norm_init(cfg.norm, d, dtype, device))
            p.child("ln2_post", L.norm_init(cfg.norm, d, dtype, device))
        return p
    if fam == "moe":
        p.child("ln1", L.norm_init(cfg.norm, d, dtype, device))
        p.child("attn", A.attention_init(cfg.attn, d, dtype, device))
        p.child("ln2", L.norm_init(cfg.norm, d, dtype, device))
        p.child("moe", M.moe_init(d, cfg.moe, cfg.d_ff, dtype, device))
        return p
    if fam == "rwkv":
        p.child("ln1", L.norm_init(cfg.norm, d, dtype, device))
        p.child("tmix", S.rwkv_init(d, cfg.rwkv, cfg.d_ff, dtype, device))
        p.child("ln2", L.norm_init(cfg.norm, d, dtype, device))
        p.child("cmix", S.rwkv_channel_mix_init(d, cfg.d_ff, dtype, device))
        return p
    if fam == "mamba_hybrid":
        p.child("ln1", L.norm_init(cfg.norm, d, dtype, device))
        p.child("mamba", S.mamba_init(d, cfg.ssm, dtype, device))
        return p
    raise ValueError(fam)


def _shared_block_init(cfg, dtype, device):
    """zamba2's shared attention+MLP block (single parameter set)."""
    d = cfg.d_model
    p = L.Params()
    p.child("ln1", L.norm_init(cfg.norm, d, dtype, device))
    p.child("attn", A.attention_init(cfg.attn, d, dtype, device))
    p.child("ln2", L.norm_init(cfg.norm, d, dtype, device))
    p.child("mlp", L.mlp_init(d, cfg.d_ff, dtype, activation=cfg.activation,
                              device=device))
    return p


class LM(L.Params):
    """The decoder-only LM's parameters: ``embed``, ``layers`` (a
    ``ModuleList``, one ``Params`` a layer), ``final_norm``, and
    ``lm_head`` (untied) / ``shared`` (zamba2) where the config has them.
    The layers' parameters view rows of ``stacked['layers']``, one tensor
    a leaf (``layers.alias_stacked``). Built uninitialised
    (``torch.empty``); ``init_lm`` draws the values."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dtype = L.as_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.child("embed", L.embed_init(cfg.vocab_padded, cfg.d_model,
                                         dtype, device))
        self.layers = nn.ModuleList(
            [_layer_init(cfg, dtype, device) for _ in range(cfg.num_layers)])
        self.child("final_norm", L.norm_init(cfg.norm, cfg.d_model, dtype,
                                             device))
        if not cfg.tie_embeddings:
            self.child("lm_head", L.linear_init(
                cfg.d_model, cfg.vocab_padded, ("embed", "vocab"), dtype,
                device=device))
        if cfg.shared_attn_every:
            self.child("shared", _shared_block_init(cfg, dtype, device))
        self.stacked = {"layers": L.alias_stacked(list(self.layers))}


def init_lm(cfg, *, device=None, seed: int = 0) -> LM:
    """The LM with every parameter drawn by the JAX package's rules (its
    init scales, zeros and ones) from a generator on ``device`` (default
    CUDA) seeded with ``seed``. The draw cannot equal ``jax.random``'s:
    carry the JAX package's values across with
    ``interop.params_from_numpy``."""
    from repro_torch.core.api import default_device

    dev = default_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    model = LM(cfg, device=dev)
    L.init_tree(model, generator)
    return model


def values(model) -> dict:
    """The JAX package's values tree of ``model`` (an ``LM`` or an
    ``encdec.EncDec``): the same keys and leaf shapes, each stack of layers
    a subtree of stacked tensors, every leaf the model's own storage (no
    copy; the stacked leaves need no grad, the rest are the module's
    parameters)."""
    out = {}
    for name, m in model._modules.items():
        if name in model.stacked:
            if not L.stacked_rows(list(m), model.stacked[name]):
                raise RuntimeError(
                    f"{name}: the layers' parameters no longer view their "
                    "stacked storage (re-homed by Module.to or the like)")
            out[name] = model.stacked[name]
        else:
            out[name] = L.values_tree(m)
    return out


def stacked_leaves(model) -> list:
    """``(path, leaf, sources)`` for every leaf of ``values(model)`` in the
    JAX package's leaf order (keys sorted): ``sources`` is the list of the
    module's parameters the leaf holds, one per layer for a stacked leaf,
    else the leaf itself."""
    tree = values(model)
    out = []

    def walk(t, path, nodes):
        for key in sorted(t):
            sub = t[key]
            if isinstance(sub, dict):
                walk(sub, path + (key,),
                     None if nodes is None else [n[key] for n in nodes])
            else:
                out.append((path + (key,), sub,
                            [sub] if nodes is None
                            else [n[key] for n in nodes]))

    for name in sorted(tree):
        if name in model.stacked:
            walk(tree[name], (name,), list(model._modules[name]))
        else:
            walk({name: tree[name]}, (), None)
    return out


def lm_axes(model: LM) -> dict:
    """Every leaf's logical axes, the JAX package's tree: the layers' axes
    with ``'layers'`` in front."""
    def stack(t):
        return ({k: stack(v) for k, v in t.items()} if isinstance(t, dict)
                else ("layers",) + t)

    out = {}
    for name, m in model._modules.items():
        out[name] = (stack(L.axes_tree(m[0])) if name == "layers"
                     else L.axes_tree(m))
    return out


# ---------------------------------------------------------------------------
# Per-layer static schedules (data, not structure).
# ---------------------------------------------------------------------------


def layer_windows(cfg) -> torch.Tensor:
    """(L,) int32 per-layer SWA window on the host; 0 disables."""
    w = torch.zeros((cfg.num_layers,), dtype=torch.int32)
    if cfg.attn and cfg.attn.window:
        if cfg.attn.local_global_period:
            pat = torch.arange(cfg.num_layers) % cfg.attn.local_global_period == 0
            w = torch.where(pat, cfg.attn.window, 0).to(torch.int32)
        else:
            w = torch.full((cfg.num_layers,), cfg.attn.window,
                           dtype=torch.int32)
    return w


def shared_flags(cfg) -> torch.Tensor:
    if not cfg.shared_attn_every:
        return torch.zeros((cfg.num_layers,), dtype=torch.bool)
    return torch.arange(cfg.num_layers) % cfg.shared_attn_every == 0


def hybrid_groups(cfg):
    """(n_groups, group_size, tail): the zamba2 pattern — shared attention
    before layers 0, every, 2*every, … — as groups of ``every`` mamba
    layers, each preceded by the shared block, plus a tail."""
    every = cfg.shared_attn_every
    n_groups = cfg.num_layers // every
    tail = cfg.num_layers - n_groups * every
    return n_groups, every, tail


# ---------------------------------------------------------------------------
# Forward (train / prefill).
# ---------------------------------------------------------------------------


def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance": z, "router_z": z}


def _apply_shared_block(shared, x, positions, cfg):
    y = A.attn_block(
        shared["attn"], L.apply_norm(cfg.norm, shared["ln1"], x), positions,
        cfg.attn, causal=True, window=cfg.attn.window,
    )
    x = x + y
    x = x + L.mlp(shared["mlp"], L.apply_norm(cfg.norm, shared["ln2"], x),
                  activation=cfg.activation)
    return x


def remat(cfg, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    when ``cfg.remat`` and autograd records: the backward recomputes the
    call's activations instead of keeping them (``jax.checkpoint``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _layer_fwd(lp, x, positions, cfg, window, collect_cache: bool):
    """One layer. Returns (x, (aux, cache))."""
    fam = cfg.family
    # Pin the residual stream to the batch axes at every layer boundary,
    # as the JAX package does (a no-op on a plain tensor).
    if cfg.pin_batch:
        x = rules.constrain_batch_dim(x, 0)
    aux = _zero_aux(x.device)
    cache = None
    if fam in ("dense", "vlm", "moe"):
        h = L.apply_norm(cfg.norm, lp["ln1"], x)
        q, k, v = A.qkv(lp["attn"], h, positions, cfg.attn,
                        repeat_kv=not collect_cache)
        o = A.flash_attention(q, k, v, causal=True, window=window,
                              cap=cfg.attn.softcap)
        y = rules.reduce_rows(L.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"]))
        if cfg.post_norm:
            y = L.apply_norm(cfg.norm, lp["ln1_post"], y)
        x = x + y
        h = L.apply_norm(cfg.norm, lp["ln2"], x)
        if fam == "moe":
            y, aux = M.moe_block(lp["moe"], h, cfg.moe,
                                 activation=cfg.activation)
        else:
            y = L.mlp(lp["mlp"], h, activation=cfg.activation)
        if cfg.post_norm:
            y = L.apply_norm(cfg.norm, lp["ln2_post"], y)
        x = x + y
        if collect_cache:
            cache = (k, v)
    elif fam == "rwkv":
        h = L.apply_norm(cfg.norm, lp["ln1"], x)
        y, tstate = S.rwkv_time_mix(lp["tmix"], h, cfg.rwkv,
                                    return_state=True)
        x = x + y
        h = L.apply_norm(cfg.norm, lp["ln2"], x)
        y, cstate = S.rwkv_channel_mix(lp["cmix"], h, return_state=True)
        x = x + y
        if collect_cache:
            cache = (tstate, cstate)
    elif fam == "mamba_hybrid":
        h = L.apply_norm(cfg.norm, lp["ln1"], x)
        y, mstate = S.mamba_block(lp["mamba"], h, cfg.ssm, return_state=True)
        x = x + y
        if collect_cache:
            cache = mstate
    else:
        raise ValueError(fam)
    return x, (aux, cache)


def _stack(items):
    """Stack a list of equal-structured tuples of tensors leaf by leaf (the
    layout ``lax.scan`` gives its per-layer outputs)."""
    if isinstance(items[0], tuple):
        return tuple(_stack([it[i] for it in items])
                     for i in range(len(items[0])))
    return torch.stack(items)


def _add_aux(total, aux):
    return {k: total[k] + aux[k] for k in total}


def _forward_hybrid(model, cfg, x, positions, collect_cache):
    """zamba2: (shared block + ``every`` mamba layers) x n_groups + tail.
    Caches as the JAX package's group scan gives them: the groups'
    ``(n_groups, every, ...)``, the tail's ``(tail, ...)`` or None."""
    n_groups, every, tail = hybrid_groups(cfg)
    aux = _zero_aux(x.device)
    groups, tail_caches = [], []
    for g in range(n_groups + (1 if tail else 0)):
        x = _apply_shared_block(model["shared"], x, positions, cfg)
        size = every if g < n_groups else tail
        caches = []
        for j in range(size):
            x, (a, c) = remat(cfg, _layer_fwd, model.layers[g * every + j],
                              x, positions, cfg, None, collect_cache)
            aux = _add_aux(aux, a)
            caches.append(c)
        (groups if g < n_groups else tail_caches).append(caches)
    if not collect_cache:
        return x, aux, None
    main = _stack([_stack(c) for c in groups])
    return x, aux, (main, _stack(tail_caches[0]) if tail else None)


def forward_lm(model, cfg, tokens, *, embeds=None, collect_cache=False,
               return_hidden=False):
    """tokens: (B, S) int. ``embeds``: optional (B, P, D) precomputed
    frontend embeddings (vision / audio stub) that replace the first P
    token positions. Returns (logits fp32 (B, S, vocab_padded), aux
    dict[, cache]); with ``return_hidden`` the first element is the final
    hidden state instead."""
    B, S_ = tokens.shape
    x = L.embed_lookup(model["embed"], tokens)
    if cfg.family == "vlm" and embeds is not None:
        P = embeds.shape[1]
        x = torch.cat([embeds.to(x.dtype), x[:, P:]], dim=1)
    if cfg.embed_scale:
        x = x * L.sqrt_scale(cfg.d_model, x.dtype)
    positions = torch.arange(S_, device=x.device)[None].expand(B, S_)

    if cfg.family == "mamba_hybrid" and cfg.shared_attn_every:
        x, aux, caches = _forward_hybrid(model, cfg, x, positions,
                                         collect_cache)
    else:
        aux = _zero_aux(x.device)
        caches = []
        for lp, window in zip(model.layers, layer_windows(cfg).tolist()):
            x, (a, c) = remat(cfg, _layer_fwd, lp, x, positions, cfg,
                              window, collect_cache)
            aux = _add_aux(aux, a)
            caches.append(c)
        caches = _stack(caches) if collect_cache else None
    x = L.apply_norm(cfg.norm, model["final_norm"], x)
    if return_hidden:
        return x, aux
    logits = project_logits(model, cfg, x)
    if collect_cache:
        return logits, aux, caches
    return logits, aux


def project_logits(model, cfg, x):
    # The vocabulary's shards make the gradient of x a partial sum over
    # them: reduce it here, once (plain tensors untouched).
    x = rules.copy_to_columns(x)
    if cfg.tie_embeddings:
        w = model["embed"]["tokens"]
        if 1 in rules.sharded_dims(w):
            # A table sharded on its embedding dim (fsdp) gets its gradient
            # from here sharded there with a partial sum over the
            # vocabulary's axis, which torch 2.11 cannot add to the
            # lookup's (a partial sum over the batch's axes): place it as
            # the table.
            w = rules.place_grad_like(w)
        logits = L.einsum("...d,vd->...v", x, w)
    else:
        logits = L.mm(x, model["lm_head"]["w"])
    return L.softcap(logits.float(), cfg.logit_softcap)


def _chunk_xent(model, cfg, xi, li):
    """(sum of the chunk's log-likelihoods at its unmasked labels, count
    of those labels): fp32, and int32 as ``jnp.sum`` of a mask gives."""
    if cfg.pin_batch:  # batch-sharded logits, as the JAX package pins them
        xi = rules.constrain_batch_dim(xi, 0)
    logits = project_logits(model, cfg, xi)
    if cfg.pin_batch:   # the vocabulary's shard stays (``_label_loglik``)
        logits = rules.constrain_batch_dim(logits, 0, keep=(-1,))
    ll = _label_loglik(logits, li.clamp(min=0).long())
    mask = li >= 0
    return (torch.where(mask, ll, torch.zeros((), dtype=ll.dtype,
                                              device=ll.device)).sum(),
            mask.sum(dtype=torch.int32))


def _label_loglik(logits, labels):
    """``log_softmax(logits)`` at ``labels`` over the last dim. Logits that
    are a ``DTensor`` sharded on the vocabulary take it shard by shard, as
    XLA reduces the JAX loss: ``picked - (m + log sum exp(logits - m))``,
    ``m`` the detached max, the max and the sums reduced across the shards
    (all-reduces of the labels' shape) and the label's logit picked where
    the shard's vocabulary indices equal it; nothing gathers the
    vocabulary. Other tensors take ``log_softmax`` and ``gather``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    last = logits.ndim - 1
    if last not in rules.sharded_dims(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, labels[..., None])[..., 0]
    # The vocabulary's indices, sharded as the logits' last dim.
    vocab = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.device),
        logits.device_mesh,
        [Shard(0) if rules._shards(pl) and pl.dim % logits.ndim == last
         else Replicate() for pl in logits.placements])
    # The reductions over the vocabulary each all-reduced to a replica (no
    # shard of the batch over the vocabulary's axis), and the gradients
    # their backward hands back sliced to the vocabulary's shards: else
    # DTensor moves the logits to meet them.
    m = rules.reduce_partial(logits.detach().amax(-1, keepdim=True))
    e = rules.place_grad_like(torch.exp(logits - m))
    lse = m + torch.log(rules.reduce_partial(e.sum(-1, keepdim=True)))
    picked = rules.place_grad_like(
        torch.where(vocab == labels[..., None], logits, 0.0))
    return rules.reduce_partial(picked.sum(-1)) - lse[..., 0]


def chunked_xent(model, cfg, x, labels):
    """Next-token cross-entropy over sequence chunks of ``cfg.loss_chunk``
    tokens (one chunk when it does not divide the sequence), so the
    (tokens, vocab) logits never exist beyond one chunk: each chunk runs
    under ``torch.utils.checkpoint``, which keeps its inputs and recomputes
    its logits in the backward. Labels below 0 are masked; the sums are
    fp32."""
    B, S_, D = x.shape
    c = min(cfg.loss_chunk, S_)
    n_chunks = S_ // c if S_ % c == 0 else 1
    if S_ % c != 0:
        c = S_
    xc = rules.reshape(x, (B, n_chunks, c, D)).transpose(0, 1)  # (n, B, c, D)
    lc = labels.reshape(B, n_chunks, c).transpose(0, 1)
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(n_chunks):
        # On a mesh the chunk's gradient may come back sharded on its
        # tokens, which the backward of the split above cannot merge back
        # into the sequence: gather them (plain tensors untouched).
        xi = rules.gather_grad_dims(xc[i], (1,))
        if torch.is_grad_enabled():
            si, ni = checkpoint(_chunk_xent, model, cfg, xi, lc[i],
                                use_reentrant=False)
        else:
            si, ni = _chunk_xent(model, cfg, xi, lc[i])
        s = s - si
        n = n + ni
    return s / torch.clamp(n, min=1)


def lm_loss(model, cfg, tokens, labels, *, embeds=None):
    """Mean next-token cross-entropy (fp32, vocab-chunked) + aux losses.
    Returns (total, metrics): metrics hold ``loss`` and the moe aux terms
    (``load_balance``, ``router_z``; zeros for the other families)."""
    x, aux = forward_lm(model, cfg, tokens, embeds=embeds,
                        return_hidden=True)
    loss = chunked_xent(model, cfg, x, labels)
    total = loss + aux["load_balance"] + aux["router_z"]
    return total, {"loss": loss, **aux}


# ---------------------------------------------------------------------------
# Decode (single token against per-layer caches).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static description of the decode cache for (cfg, batch, slots)."""
    batch: int
    slots: int          # KV slots: window size for ring caches
    ring: bool


def cache_spec(cfg, batch: int, seq_len: int) -> CacheSpec:
    ring = bool(
        cfg.attn and cfg.attn.window and not cfg.attn.local_global_period
    )
    slots = min(cfg.attn.window, seq_len) if ring else seq_len
    if cfg.family in ("rwkv",):
        slots = 0
    return CacheSpec(batch=batch, slots=slots, ring=ring)


def init_cache(cfg, spec: CacheSpec, dtype=torch.bfloat16, *, device=None):
    """The zeroed decode cache (``pos`` a 0-d int32 tensor). ``device``
    defaults to CUDA."""
    from repro_torch.core.api import default_device

    dev = default_device(device)
    dtype = L.as_dtype(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    B = spec.batch
    Lc = cfg.num_layers
    fam = cfg.family
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if fam in ("dense", "vlm", "moe"):
        kvs = (Lc, B, spec.slots, cfg.attn.num_kv_heads, cfg.attn.head_dim)
        cache["k"] = zeros(kvs)
        cache["v"] = zeros(kvs)
    elif fam == "rwkv":
        hd = cfg.rwkv.head_dim
        nh = cfg.d_model // hd
        cache["shift_t"] = zeros((Lc, B, cfg.d_model))
        cache["shift_c"] = zeros((Lc, B, cfg.d_model))
        cache["S"] = zeros((Lc, B, nh, hd, hd))
    elif fam == "mamba_hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        nh = d_inner // cfg.ssm.head_dim
        conv_c = d_inner + 2 * cfg.ssm.state_dim
        cache["conv"] = zeros((Lc, B, cfg.ssm.conv_width - 1, conv_c))
        cache["h"] = zeros((Lc, B, nh, cfg.ssm.head_dim, cfg.ssm.state_dim))
        n_groups, _, tail = hybrid_groups(cfg)
        n_occ = n_groups + (1 if tail else 0)
        w = (min(cfg.attn.window or spec.slots, spec.slots) if cfg.attn
             else spec.slots)
        kvs = (n_occ, B, w, cfg.attn.num_kv_heads, cfg.attn.head_dim)
        cache["sk"] = zeros(kvs)
        cache["sv"] = zeros(kvs)
    return cache


def _write_slot(dst, val, at):
    """``dst[:, at] = val`` (``dynamic_update_index_in_dim`` on axis 1), in
    place on ``dst``, ``at`` a 0-d tensor. A ``DTensor`` cache (a dry run
    on a mesh) takes it as a select over the slots, which ``DTensor`` can
    place (``index_copy_`` has no sharding rule in every torch)."""
    if type(dst).__name__ == "DTensor":
        S = dst.shape[1]
        hit = (torch.arange(S, device=dst.device) == at).reshape(
            (1, S) + (1,) * (dst.ndim - 2))
        dst.copy_(torch.where(hit, val[:, None].to(dst.dtype), dst))
        return
    dst.index_copy_(1, at.reshape(1).long(), val[:, None].to(dst.dtype))


def decode_step(model, cfg, cache, tokens):
    """One decode step. tokens: (B,) int. Returns (logits (B, V), cache).

    The cache is donated (the JAX dry run's ``donate_argnums``): every leaf
    is written in place, ``pos`` included, and the returned dict holds the
    same tensors. Clone a cache to keep it as it was."""
    pos = cache["pos"]
    x = L.embed_lookup(model["embed"], tokens)  # (B, D)
    if cfg.embed_scale:
        x = x * L.sqrt_scale(cfg.d_model, x.dtype)
    fam = cfg.family

    if fam in ("dense", "vlm", "moe"):
        slots = cache["k"].shape[2]
        ring = bool(cfg.attn.window and not cfg.attn.local_global_period
                    and slots <= cfg.attn.window)
        write_at = (torch.remainder(pos, slots) if ring
                    else torch.clamp(pos, max=slots - 1))
        windows = layer_windows(cfg).tolist()
        for i, lp in enumerate(model.layers):
            h = L.apply_norm(cfg.norm, lp["ln1"], x)
            o, k1, v1 = A.decode_attn(
                lp["attn"], h, cache["k"][i], cache["v"][i], pos, cfg.attn,
                window=windows[i], ring=ring,
            )
            if cfg.post_norm:
                o = L.apply_norm(cfg.norm, lp["ln1_post"], o)
            x = x + o
            h = L.apply_norm(cfg.norm, lp["ln2"], x)
            if fam == "moe":
                y, _ = M.moe_block(lp["moe"], h[:, None], cfg.moe,
                                   activation=cfg.activation)
                y = y[:, 0]
            else:
                y = L.mlp(lp["mlp"], h, activation=cfg.activation)
            if cfg.post_norm:
                y = L.apply_norm(cfg.norm, lp["ln2_post"], y)
            x = x + y
            _write_slot(cache["k"][i], k1, write_at)
            _write_slot(cache["v"][i], v1, write_at)

    elif fam == "rwkv":
        for i, lp in enumerate(model.layers):
            sh_t, Sst = cache["shift_t"][i], cache["S"][i]
            sh_c = cache["shift_c"][i]
            h = L.apply_norm(cfg.norm, lp["ln1"], x)[:, None]
            y, (sh_t2, S2) = S.rwkv_time_mix(
                lp["tmix"], h, cfg.rwkv, state=(sh_t, Sst), return_state=True
            )
            x = x + y[:, 0]
            h = L.apply_norm(cfg.norm, lp["ln2"], x)[:, None]
            y, sh_c2 = S.rwkv_channel_mix(lp["cmix"], h, state=sh_c,
                                          return_state=True)
            x = x + y[:, 0]
            sh_t.copy_(sh_t2)
            Sst.copy_(S2)
            sh_c.copy_(sh_c2)

    elif fam == "mamba_hybrid":
        shared = model["shared"]
        w_slots = cache["sk"].shape[2]
        write_at = torch.remainder(pos, w_slots)
        n_groups, every, tail = hybrid_groups(cfg)
        for g in range(n_groups + (1 if tail else 0)):
            # The shared block's occurrence g, against its own K/V cache.
            h = L.apply_norm(cfg.norm, shared["ln1"], x)
            o, k1, v1 = A.decode_attn(shared["attn"], h, cache["sk"][g],
                                      cache["sv"][g], pos, cfg.attn,
                                      ring=True)
            x = x + o
            x = x + L.mlp(shared["mlp"],
                          L.apply_norm(cfg.norm, shared["ln2"], x),
                          activation=cfg.activation)
            _write_slot(cache["sk"][g], k1, write_at)
            _write_slot(cache["sv"][g], v1, write_at)
            size = every if g < n_groups else tail
            for i in range(g * every, g * every + size):
                conv_st, h_st = cache["conv"][i], cache["h"][i]
                hn = L.apply_norm(cfg.norm, model.layers[i]["ln1"], x)[:, None]
                y, (conv2, h2) = S.mamba_block(
                    model.layers[i]["mamba"], hn, cfg.ssm,
                    state=(conv_st, h_st), return_state=True)
                x = x + y[:, 0]
                conv_st.copy_(conv2)
                h_st.copy_(h2)

    else:
        raise ValueError(fam)

    x = L.apply_norm(cfg.norm, model["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.einsum("bd,vd->bv", x, model["embed"]["tokens"])
    else:
        logits = L.mm(x, model["lm_head"]["w"])
    logits = L.softcap(logits.float(), cfg.logit_softcap)
    pos.add_(1)
    return logits, dict(cache)
