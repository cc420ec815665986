"""Encoder-decoder transformer (seamless-m4t backbone), PyTorch port.

The multimodal frontend is a stub: ``input_specs()`` supplies pre-computed
(B, S_src, D) frame embeddings to the encoder. The decoder is a causal
stack with cross-attention into the encoder output; decode caches both the
decoder's self-attention K/V and the (static) cross-attention K/V computed
once at prefill (``decode_train(collect_cache=True)``).

As in ``transformer.py`` the two stacks are ``nn.ModuleList``s whose
parameters view one stacked tensor per leaf (``stacked['enc_layers']``,
``stacked['dec_layers']``), and ``cfg.remat`` runs each layer under
``torch.utils.checkpoint``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import _stack, chunked_xent, remat
from repro_torch.sharding import rules


def _gated(cfg):
    return cfg.activation in ("swiglu", "geglu")


def _enc_layer_init(cfg, dtype, device):
    d = cfg.d_model
    p = L.Params()
    p.child("ln1", L.norm_init(cfg.norm, d, dtype, device))
    p.child("attn", A.attention_init(cfg.attn, d, dtype, device))
    p.child("ln2", L.norm_init(cfg.norm, d, dtype, device))
    p.child("mlp", L.mlp_init(d, cfg.d_ff, dtype, activation=cfg.activation,
                              gated=_gated(cfg), device=device))
    return p


def _dec_layer_init(cfg, dtype, device):
    d = cfg.d_model
    p = L.Params()
    p.child("ln1", L.norm_init(cfg.norm, d, dtype, device))
    p.child("self_attn", A.attention_init(cfg.attn, d, dtype, device))
    p.child("ln_x", L.norm_init(cfg.norm, d, dtype, device))
    p.child("cross_attn", A.attention_init(cfg.attn, d, dtype, device))
    p.child("ln2", L.norm_init(cfg.norm, d, dtype, device))
    p.child("mlp", L.mlp_init(d, cfg.d_ff, dtype, activation=cfg.activation,
                              gated=_gated(cfg), device=device))
    return p


class EncDec(L.Params):
    """The encoder-decoder's parameters: ``embed``, ``enc_layers``,
    ``enc_norm``, ``dec_layers``, ``final_norm`` and, untied, ``lm_head``.
    Built uninitialised; ``init_encdec`` draws the values."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dtype = L.as_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.child("embed", L.embed_init(cfg.vocab_padded, cfg.d_model,
                                         dtype, device))
        self.enc_layers = nn.ModuleList(
            [_enc_layer_init(cfg, dtype, device)
             for _ in range(cfg.enc_layers)])
        self.child("enc_norm", L.norm_init(cfg.norm, cfg.d_model, dtype,
                                           device))
        self.dec_layers = nn.ModuleList(
            [_dec_layer_init(cfg, dtype, device)
             for _ in range(cfg.num_layers)])
        self.child("final_norm", L.norm_init(cfg.norm, cfg.d_model, dtype,
                                             device))
        if not cfg.tie_embeddings:
            self.child("lm_head", L.linear_init(
                cfg.d_model, cfg.vocab_padded, ("embed", "vocab"), dtype,
                device=device))
        self.stacked = {"enc_layers": L.alias_stacked(list(self.enc_layers)),
                        "dec_layers": L.alias_stacked(list(self.dec_layers))}


def init_encdec(cfg, *, device=None, seed: int = 0) -> EncDec:
    """The model with every parameter drawn by the JAX package's rules from
    a generator on ``device`` (default CUDA) seeded with ``seed``; the
    draw cannot equal ``jax.random``'s (``interop.params_from_numpy``
    carries the JAX package's values across)."""
    from repro_torch.core.api import default_device

    dev = default_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    model = EncDec(cfg, device=dev)
    L.init_tree(model, generator)
    return model


def encdec_axes(model: EncDec) -> dict:
    """Every leaf's logical axes, the JAX package's tree (``'layers'`` in
    front of each stacked leaf's axes)."""
    def stack(t):
        return ({k: stack(v) for k, v in t.items()} if isinstance(t, dict)
                else ("layers",) + t)

    return {name: (stack(L.axes_tree(m[0])) if name in model.stacked
                   else L.axes_tree(m))
            for name, m in model._modules.items()}


def _positions(B, S, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def _enc_layer(lp, x, positions, cfg):
    h = L.apply_norm(cfg.norm, lp["ln1"], x)
    x = x + A.attn_block(lp["attn"], h, positions, cfg.attn, causal=False)
    h = L.apply_norm(cfg.norm, lp["ln2"], x)
    return x + L.mlp(lp["mlp"], h, activation=cfg.activation)


def encode(model, cfg, src_embeds):
    """src_embeds: (B, Ss, D) frontend-stub frame embeddings."""
    B, Ss, _ = src_embeds.shape
    x = src_embeds.to(L.as_dtype(cfg.param_dtype))
    positions = _positions(B, Ss, x.device)
    for lp in model.enc_layers:
        x = remat(cfg, _enc_layer, lp, x, positions, cfg)
    return L.apply_norm(cfg.norm, model["enc_norm"], x)


def _dec_layer(lp, x, positions, enc_out, kv_positions, cfg, collect_cache):
    h = L.apply_norm(cfg.norm, lp["ln1"], x)
    q, k, v = A.qkv(lp["self_attn"], h, positions, cfg.attn,
                    repeat_kv=not collect_cache)
    o = A.flash_attention(q, k, v, causal=True)
    x = x + rules.reduce_rows(L.einsum("bshk,hkd->bsd", o,
                                       lp["self_attn"]["wo"]))
    h = L.apply_norm(cfg.norm, lp["ln_x"], x)
    x = x + A.cross_attn_block(lp["cross_attn"], h, positions, enc_out,
                               kv_positions, cfg.attn)
    h = L.apply_norm(cfg.norm, lp["ln2"], x)
    x = x + L.mlp(lp["mlp"], h, activation=cfg.activation)
    if not collect_cache:
        return x, None
    ck = L.einsum("bsd,dhk->bshk", enc_out, lp["cross_attn"]["wk"])
    ck = L.rope(ck, kv_positions, theta=cfg.attn.rope_theta)
    cv = L.einsum("bsd,dhk->bshk", enc_out, lp["cross_attn"]["wv"])
    return x, (k, v, ck, cv)


def _vocab(model, cfg, x):
    x = rules.copy_to_columns(x)
    if cfg.tie_embeddings:
        logits = L.einsum("...d,vd->...v", x, model["embed"]["tokens"])
    else:
        logits = L.mm(x, model["lm_head"]["w"])
    return logits.float()


def decode_hidden(model, cfg, enc_out, tgt_tokens):
    """Decoder stack up to (but not including) the vocab projection."""
    return decode_train(model, cfg, enc_out, tgt_tokens, return_hidden=True)


def decode_train(model, cfg, enc_out, tgt_tokens, *, collect_cache=False,
                 return_hidden=False):
    """Teacher-forced decoder over ``tgt_tokens`` (B, St) against
    ``enc_out``: fp32 logits (B, St, vocab_padded), with
    ``collect_cache`` also the per-layer caches ``(k, v, xk, xv)``
    stacked on a leading layer axis; with ``return_hidden`` the final
    hidden state."""
    B, St = tgt_tokens.shape
    Ss = enc_out.shape[1]
    x = L.embed_lookup(model["embed"], tgt_tokens)
    if cfg.embed_scale:
        x = x * L.sqrt_scale(cfg.d_model, x.dtype)
    positions = _positions(B, St, x.device)
    kv_positions = _positions(B, Ss, x.device)
    caches = []
    for lp in model.dec_layers:
        x, c = remat(cfg, _dec_layer, lp, x, positions, enc_out,
                     kv_positions, cfg, collect_cache)
        caches.append(c)
    x = L.apply_norm(cfg.norm, model["final_norm"], x)
    if return_hidden:
        return x
    logits = _vocab(model, cfg, x)
    if collect_cache:
        return logits, _stack(caches)
    return logits


def encdec_loss(model, cfg, src_embeds, tgt_tokens, labels):
    enc_out = encode(model, cfg, src_embeds)
    x = decode_hidden(model, cfg, enc_out, tgt_tokens)
    loss = chunked_xent(model, cfg, x, labels)
    return loss, {"loss": loss}


def init_encdec_cache(cfg, batch, slots, src_len, dtype=torch.bfloat16, *,
                      device=None):
    """The zeroed decode cache: self-attention ``k``/``v`` of ``slots``,
    cross-attention ``xk``/``xv`` of ``src_len``, ``pos`` a 0-d int32
    tensor; on CUDA unless ``device`` says otherwise."""
    from repro_torch.core.api import default_device

    dev = default_device(device)
    dtype = L.as_dtype(dtype)
    Lc, KV, Dh = cfg.num_layers, cfg.attn.num_kv_heads, cfg.attn.head_dim
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "k": torch.zeros((Lc, batch, slots, KV, Dh), dtype=dtype, device=dev),
        "v": torch.zeros((Lc, batch, slots, KV, Dh), dtype=dtype, device=dev),
        "xk": torch.zeros((Lc, batch, src_len, KV, Dh), dtype=dtype,
                          device=dev),
        "xv": torch.zeros((Lc, batch, src_len, KV, Dh), dtype=dtype,
                          device=dev),
    }


def _cross_core(q, xk, xv, scale):
    """One query (B, H, Dh) against the encoder's K/V (B, Ss, KV, Dh), on
    plain tensors."""
    B, H, Dh = q.shape
    KV = xk.shape[2]
    qg = q.reshape(B, KV, H // KV, Dh)
    s = L.einsum("bkgd,bskd->bkgs", qg, xk, out_dtype=torch.float32) * scale
    w = torch.softmax(s, dim=-1)
    o = L.einsum("bkgs,bskd->bkgd", w.to(xv.dtype), xv)
    return o.reshape(B, H, Dh)


def encdec_decode_step(model, cfg, cache, tokens):
    """One decoder step against the self-K/V cache and the precomputed
    cross-K/V. tokens: (B,) int. Returns (logits fp32 (B, V), the cache):
    the cache is donated, its ``k``/``v`` slot and ``pos`` written in
    place (``transformer.decode_step``)."""
    from repro_torch.models.transformer import _write_slot

    B = tokens.shape[0]
    pos = cache["pos"]
    x = L.embed_lookup(model["embed"], tokens)
    if cfg.embed_scale:
        x = x * L.sqrt_scale(cfg.d_model, x.dtype)
    slots = cache["k"].shape[2]
    write_at = torch.clamp(pos, max=slots - 1)
    a = cfg.attn
    scale = L.inv_sqrt(a.head_dim)
    pos_arr = torch.full((B, 1), 0, dtype=torch.int32, device=x.device) + pos
    for i, lp in enumerate(model.dec_layers):
        xk, xv = cache["xk"][i], cache["xv"][i]
        h = L.apply_norm(cfg.norm, lp["ln1"], x)
        o, k1, v1 = A.decode_attn(lp["self_attn"], h, cache["k"][i],
                                  cache["v"][i], pos, a)
        x = x + o
        # Cross-attention against the full precomputed encoder K/V.
        h = L.apply_norm(cfg.norm, lp["ln_x"], x)
        q = L.einsum("bd,dhk->bhk", h, lp["cross_attn"]["wq"])
        q = L.rope(q[:, None], pos_arr, theta=a.rope_theta)[:, 0]
        # On a mesh each rank attends with its own query heads
        # (``rules.local_attention``).
        o = rules.local_attention(
            lambda q, xk, xv: _cross_core(q, xk, xv, scale), q, (xk, xv),
            hq=1, hk=2)
        x = x + rules.reduce_rows(L.einsum("bhk,hkd->bd", o,
                                           lp["cross_attn"]["wo"]))
        h = L.apply_norm(cfg.norm, lp["ln2"], x)
        x = x + L.mlp(lp["mlp"], h, activation=cfg.activation)
        _write_slot(cache["k"][i], k1, write_at)
        _write_slot(cache["v"][i], v1, write_at)
    pos.add_(1)
    x = L.apply_norm(cfg.norm, model["final_norm"], x)
    return _vocab(model, cfg, x), dict(cache)
