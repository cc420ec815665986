"""Attention, PyTorch port: chunked online-softmax attention + decode cache
paths, in plain torch operations as the JAX package writes them.

Covers every assigned variant: MHA/GQA/MQA (grouped KV), sliding-window
(SWA), logit soft-capping (gemma2), local/global alternation (the window
is per-layer data, 0 or negative disabling it), causal and bidirectional
modes. Training/prefill attention streams KV chunks with an online softmax
(running max / normaliser in fp32, a finite ``NEG_INF`` sentinel and the
probabilities masked explicitly), so the (S x S) score matrix never
materialises beyond one chunk pair. Decode attends one query against a
cache; SWA uses a ring buffer of ``window`` slots (O(window) memory).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.sharding import rules

NEG_INF = -1e30


def attention_init(attn_cfg, d_model, dtype, device=None):
    H, KV, Dh = attn_cfg.num_heads, attn_cfg.num_kv_heads, attn_cfg.head_dim
    p = L.Params()
    p.param("wq", (d_model, H, Dh), ("embed", "heads", "head_dim"),
            dtype=dtype, device=device)
    p.param("wk", (d_model, KV, Dh), ("embed", "kv_heads", "head_dim"),
            dtype=dtype, device=device)
    p.param("wv", (d_model, KV, Dh), ("embed", "kv_heads", "head_dim"),
            dtype=dtype, device=device)
    p.param("wo", (H, Dh, d_model), ("heads", "head_dim", "embed"),
            dtype=dtype, device=device)
    return p


def qkv(p, x, positions, attn_cfg, *, repeat_kv=True):
    """Project + RoPE. x: (B, S, D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh).

    On a mesh whose model axis shards the query heads but not the KV heads
    (``repeat_kv``, the default), each rank projects only the distinct KV
    heads its query heads read and repeats them to those heads: k/v are
    then (B, S, H, Dh), placed as q (``rules.kv_heads_for_queries``).
    Plain tensors: the projections as they are."""
    x = rules.copy_to_columns(x)
    q = L.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = _kv(p, x, positions, q, attn_cfg, repeat_kv)
    return L.rope(q, positions, theta=attn_cfg.rope_theta), k, v


def _kv(p, src, positions, q, attn_cfg, repeat_kv=True):
    """K (rotated at ``positions``) and V projected from ``src`` (B, S, D)
    for the queries ``q``, their KV heads repeated to ``q``'s on a mesh
    (``qkv``)."""
    wk = wv = None
    if repeat_kv:
        wk = rules.kv_heads_for_queries(q, p["wk"])
        wv = rules.kv_heads_for_queries(q, p["wv"])
    k = L.einsum("bsd,dhk->bshk", src, p["wk"] if wk is None else wk)
    v = L.einsum("bsd,dhk->bshk", src, p["wv"] if wv is None else wv)
    # Columns split over the ranks (an MQA head): whole heads first.
    k, v = rules.gather_dims(k, (3,)), rules.gather_dims(v, (3,))
    k = L.rope(k, positions, theta=attn_cfg.rope_theta)
    if wk is not None:
        n_kv = attn_cfg.num_kv_heads
        k, v = (rules.repeat_kv_heads(t, q, n_kv) for t in (k, v))
    return k, v


def _window_value(window) -> int:
    return 0 if window is None else int(window)


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool,
    window=None,
    cap: Optional[float] = None,
    q_offset=0,
    kv_offset=0,
    q_chunk: int = 2048,
    kv_chunk: int = 1024,
):
    """Chunked online-softmax attention.

    q: (B, Sq, H, Dh); k, v: (B, Skv, KV, Dh) with H % KV == 0.
    ``window``: None, an int or a scalar tensor (0/negative disables it).
    Offsets give global positions (cross-chunk prefill, right-aligned
    decode). On a mesh it runs rank by rank on each rank's batch rows and
    query heads, or its query rows where the heads cannot be sharded
    (``rules.local_attention``).
    """
    return rules.local_attention(
        lambda q, k, v, q_start=0: _flash(
            q, k, v, causal, window, cap, q_offset + q_start, kv_offset,
            q_chunk, kv_chunk),
        q, (k, v), hq=2, hk=2, sq=1)


def _flash(q, k, v, causal, window, cap, q_offset, kv_offset, q_chunk,
           kv_chunk):
    """``flash_attention`` on plain tensors."""
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"chunk sizes must divide: {Sq}%{q_chunk}, "
                         f"{Skv}%{kv_chunk}")
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    dev, f32 = q.device, torch.float32
    scale = L.inv_sqrt(Dh)
    window_val = _window_value(window)

    qg = q.reshape(B, nq, q_chunk, KV, G, Dh).permute(1, 0, 3, 4, 2, 5)
    # qg: (nq, B, KV, G, Cq, Dh)
    kc = k.reshape(B, nk, kv_chunk, KV, Dh).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, kv_chunk, KV, Dh).permute(1, 0, 3, 2, 4)
    # kc, vc: (nk, B, KV, Ckv, Dh)

    outs = []
    for qi in range(nq):
        q_blk = qg[qi]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=f32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, Dh), dtype=f32, device=dev)
        for ki in range(nk):
            k_blk, v_blk = kc[ki], vc[ki]
            kv_pos = (kv_offset + ki * kv_chunk
                      + torch.arange(kv_chunk, device=dev))
            s = L.einsum("bkgqd,bksd->bkgqs", q_blk, k_blk,
                         out_dtype=f32) * scale
            s = L.softcap(s, cap)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kv_pos[None, :] <= q_pos[:, None]
            if window_val > 0:
                mask &= kv_pos[None, :] > (q_pos[:, None] - window_val)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            # Mask p explicitly: with a finite NEG_INF sentinel, a fully
            # masked block would otherwise produce exp(0) = 1 everywhere.
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = L.einsum("bkgqs,bksd->bkgqd", p.to(v_blk.dtype), v_blk,
                          out_dtype=f32)
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs)  # (nq, B, KV, G, Cq, Dh) -> (B, Sq, H, Dh)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, KV * G, Dh)
    return out.to(q.dtype)


def attn_block(p, x, positions, attn_cfg, *, causal=True, window=None):
    """Full attention sub-layer (projections + flash + output)."""
    q, k, v = qkv(p, x, positions, attn_cfg)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        cap=attn_cfg.softcap)
    return rules.reduce_rows(L.einsum("bshk,hkd->bsd", o, p["wo"]))


def cross_attn_block(p, x, positions, kv_src, kv_positions, attn_cfg):
    """Cross-attention: queries from x, keys/values from kv_src (encoder)."""
    x, kv_src = rules.copy_to_columns(x), rules.copy_to_columns(kv_src)
    q = L.einsum("bsd,dhk->bshk", x, p["wq"])
    q = L.rope(q, positions, theta=attn_cfg.rope_theta)
    k, v = _kv(p, kv_src, kv_positions, q, attn_cfg)
    o = flash_attention(q, k, v, causal=False, cap=attn_cfg.softcap)
    return rules.reduce_rows(L.einsum("bshk,hkd->bsd", o, p["wo"]))


# ---------------------------------------------------------------------------
# Decode (single new token against a cache).
# ---------------------------------------------------------------------------


def decode_attn(p, x1, cache_k, cache_v, pos, attn_cfg, *, window=None,
                ring=False):
    """One-token attention against a (ring or linear) cache.

    x1: (B, D) current token activations; cache_k/v: (B, S_slots, KV, Dh)
    (already rotated); pos: the current position, a 0-d integer tensor.
    ``ring=True`` treats the cache as a ring buffer of S_slots recent
    positions; ``window`` (0/negative disables) masks a sliding window
    inside a *linear* cache (gemma2's alternating layers). Returns (out,
    k_new, v_new) with this step's rotated K/V (B, KV, Dh) for the caller
    to insert (at slot ``pos % S_slots`` when ring, else ``pos``).
    Scores and the weighted sum accumulate in fp32 whatever the cache's
    dtype.
    """
    B, S_slots = cache_k.shape[:2]
    dev = x1.device
    pos_arr = torch.full((B, 1), 0, dtype=torch.int32, device=dev) + pos
    q = _project_heads(x1, p["wq"])[:, None]  # (B, 1, H, Dh)
    q = L.rope(q, pos_arr, theta=attn_cfg.rope_theta)[:, 0]
    k1 = L.einsum("bd,dhk->bhk", x1, p["wk"])[:, None]
    k1 = L.rope(k1, pos_arr, theta=attn_cfg.rope_theta)[:, 0]
    v1 = L.einsum("bd,dhk->bhk", x1, p["wv"])

    slot = torch.arange(S_slots, device=dev)
    if ring:
        # Slot s holds absolute position pos - ((pos - s) % W) (a floor
        # modulo, as jnp.mod); the caller writes this step's K/V at slot
        # pos % W after the call.
        slot_pos = pos - torch.remainder(pos - slot, S_slots)
        valid = (slot_pos >= 0) & ~(slot_pos == pos)  # 2.11: no DTensor ne
    else:
        valid = slot < pos
        window_val = _window_value(window)
        if window_val > 0:
            valid &= slot > (pos - window_val)

    if type(valid).__name__ == "DTensor":
        valid = valid.full_tensor()   # replicated: no data moves
    # On a mesh each rank attends with its own query heads, against the
    # cache's KV heads they read (``rules.local_attention``).
    o = rules.local_attention(
        lambda q, ck, cv, k1, v1: _decode_core(q, ck, cv, k1[:, 0],
                                               v1[:, 0], valid, attn_cfg),
        q, (cache_k, cache_v, k1[:, None], v1[:, None]), hq=1, hk=2)
    out = rules.reduce_rows(_heads_out(o.to(x1.dtype), p["wo"]))
    return out, k1, v1


def _spare_dim(x, w, hw):
    """The mesh dim, if any, over which both ``x`` and the weight ``w``
    replicate while ``w``'s heads (dim ``hw``) could not be sharded over
    it (56 heads of arctic-480b on a 16-wide model axis), and which
    divides the merged (H, Dh) columns; None elsewhere (plain tensors)."""
    if type(w).__name__ != "DTensor" or type(x).__name__ != "DTensor":
        return None
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        n = w.device_mesh.shape[i]
        if (px.is_replicate() and pw.is_replicate() and w.shape[hw] % n
                and (w.shape[hw] * w.shape[hw + 1]) % n == 0):
            return i
    return None


def _split_dim(t, i, dim):
    """``t`` sharded on ``dim`` over mesh dim ``i`` (it replicates there:
    a local slice)."""
    pls = list(t.placements)
    pls[i] = rules.Shard(dim)
    return t.redistribute(t.device_mesh, pls)


def _project_heads(x, w):
    """``x`` (B, D) @ ``w`` (D, H, Dh) -> (B, H, Dh). Where the heads
    replicate over a mesh dim that nothing else uses (``_spare_dim``), its
    ranks split the merged H·Dh columns and gather the product
    (Megatron's column-parallel product over heads the mesh cannot
    split), instead of each projecting every head."""
    i = _spare_dim(x, w, 1)
    if i is None:
        return L.einsum("bd,dhk->bhk", x, w)
    D, H, Dh = w.shape
    y = L.mm(x, _split_dim(w.reshape(D, H * Dh), i, 1))
    return rules.gather_dims(y, (1,)).reshape(x.shape[0], H, Dh)


def _heads_out(o, w):
    """``o`` (B, H, Dh) @ ``w`` (H, Dh, D) -> (B, D); over a spare mesh
    dim (``_spare_dim``) its ranks split the merged H·Dh contraction
    (row-parallel: a partial sum for ``rules.reduce_rows``)."""
    i = _spare_dim(o, w, 0)
    if i is None:
        return L.einsum("bhk,hkd->bd", o, w)
    H, Dh, D = w.shape
    return L.mm(_split_dim(o.reshape(o.shape[0], H * Dh), i, 1),
                _split_dim(w.reshape(H * Dh, D), i, 0))


def _decode_core(q, cache_k, cache_v, k1, v1, valid, attn_cfg):
    """``decode_attn``'s attention on plain tensors: q (B, H, Dh) against
    the cache's slots ``valid`` and this step's k1/v1 (B, KV, Dh); fp32
    (B, H, Dh)."""
    B, H, Dh = q.shape
    KV = cache_k.shape[2]
    G = H // KV
    f32 = torch.float32
    qg = q.reshape(B, KV, G, Dh)
    scale = L.inv_sqrt(Dh)
    s = L.einsum("bkgd,bskd->bkgs", qg, cache_k, out_dtype=f32) * scale
    s_self = L.einsum("bkgd,bkd->bkg", qg, k1,
                      out_dtype=f32)[..., None] * scale
    s = L.softcap(s, attn_cfg.softcap)
    s_self = L.softcap(s_self, attn_cfg.softcap)
    s = torch.where(valid, s, NEG_INF)
    s_all = torch.cat([s, s_self], dim=-1)
    w = torch.softmax(s_all.to(f32), dim=-1)
    o = L.einsum("bkgs,bskd->bkgd", w[..., :-1].to(cache_v.dtype), cache_v,
                 out_dtype=f32)
    o = o + w[..., -1:].to(f32) * v1.reshape(B, KV, 1, Dh).to(f32)
    return o.reshape(B, H, Dh)
