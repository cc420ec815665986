"""Attention-free sequence mixers, PyTorch port: RWKV6 (Finch) and Mamba2
(SSD).

Both are exact linear recurrences in fp32, run over time by
``layers.scan`` as the JAX package runs them by ``jax.lax.scan``. Decode
is a single recurrence step against an O(1) state.

RWKV6 per-head state: S in R^{hd x hd} with data-dependent per-channel decay
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)           (Finch, arXiv:2404.05892)

Mamba2 per-head state: h in R^{hd x N} with scalar-per-head decay
    h_t = a_t h_{t-1} + dt_t * x_t B_t^T,   a_t = exp(-exp(A_log) dt_t)
    y_t = h_t C_t + D x_t                              (SSD, arXiv:2405.21060)

The JAX package pins the recurrences' carries to the batch axes of a mesh
(XLA propagation hints, no-ops without one); the port has no such hint.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import rules


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def rwkv_init(d_model, rwkv_cfg, d_ff, dtype, device=None):
    hd = rwkv_cfg.head_dim
    nh = d_model // hd
    lora = rwkv_cfg.mix_lora
    dl = rwkv_cfg.decay_lora
    kw = dict(dtype=dtype, device=device)
    p = L.Params()
    # data-dependent token-shift mixing (ddlerp)
    p.param("mu_base", (5, d_model), (None, "embed"), init="zeros", **kw)
    p.param("mix_a", (d_model, 5 * lora), ("embed", "mlp"), scale=0.01, **kw)
    p.param("mix_b", (5, lora, d_model), (None, "mlp", "embed"), scale=0.01,
            **kw)
    # projections
    for name in ("wr", "wk", "wv", "wg"):
        p.param(name, (d_model, d_model), ("embed", "heads_mlp"), **kw)
    p.param("wo", (d_model, d_model), ("heads_mlp", "embed"), **kw)
    # data-dependent decay (the Finch contribution)
    p.param("w0", (d_model,), ("embed",), init="zeros", **kw)
    p.param("decay_a", (d_model, dl), ("embed", "mlp"), scale=0.01, **kw)
    p.param("decay_b", (dl, d_model), ("mlp", "embed"), scale=0.01, **kw)
    p.param("u", (nh, hd), ("heads", "head_dim"), init="zeros", **kw)
    p.param("ln_x", (d_model,), ("embed",), init="ones", **kw)
    return p


def rwkv_time_mix(p, x, rwkv_cfg, *, state=None, return_state=False):
    """x: (B, S, D). state: optional (shift (B, D), S (B, nh, hd, hd))."""
    B, S, D = x.shape
    hd = rwkv_cfg.head_dim
    nh = D // hd
    lora = p["mix_a"].shape[1] // 5
    f32 = torch.float32

    if state is None:
        shift_in = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    else:
        shift_in = state[0]
    xprev = L.cat([shift_in[:, None], x[:, :-1]], dim=1)
    xx = xprev - x

    l = rules.reshape(torch.tanh(L.mm(x, p["mix_a"])), (B, S, 5, lora))
    mixed = []
    for i in range(5):
        mix = p["mu_base"][i].to(f32) + L.einsum(
            "bsl,ld->bsd", l[:, :, i], p["mix_b"][i].to(f32))
        mixed.append(x + xx * mix.to(x.dtype))
    x_r, x_k, x_v, x_w, x_g = mixed

    r = rules.reshape(L.mm(x_r, p["wr"]), (B, S, nh, hd))
    k = rules.reshape(L.mm(x_k, p["wk"]), (B, S, nh, hd))
    v = rules.reshape(L.mm(x_v, p["wv"]), (B, S, nh, hd))
    g = L.mm(x_g, p["wg"])
    # Data-dependent decay in fp32: w in (0, 1).
    dec = p["w0"].to(f32) + L.mm(
        torch.tanh(L.mm(x_w.to(f32), p["decay_a"].to(f32))),
        p["decay_b"].to(f32))
    w = rules.reshape(torch.exp(-torch.exp(dec.clip(-8.0, 8.0))),
                  (B, S, nh, hd))

    u = p["u"].to(f32)
    Sst = (torch.zeros((B, nh, hd, hd), dtype=f32, device=x.device)
           if state is None else state[1].to(f32))
    rs, ks, vs = r.to(f32), k.to(f32), v.to(f32)
    # Pin the recurrence to the batch axes, as the JAX package does (a
    # no-op on plain tensors).
    Sst, rs, ks, vs, w = (rules.constrain_batch_dim(t, 0)
                          for t in (Sst, rs, ks, vs, w))
    Sst, y = L.scan(_rwkv_step, Sst, (rs, ks, vs, w), (u,))  # (B, S, nh, hd)
    # Per-head group norm, then gate.
    y = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
        y.var(-1, keepdim=True, unbiased=False) + 1e-5)
    # On a mesh the merged heads' gradient may come back sharded, which
    # the merge's backward cannot split: gather it (plain: untouched).
    y = rules.gather_grad_dims(y.reshape(B, S, D), (2,)) * p["ln_x"].to(f32)
    y = L.mm(y.to(x.dtype) * F.silu(g), p["wo"])
    if return_state:
        return y, (x[:, -1], Sst.to(x.dtype))
    return y


def _rwkv_step(Sst, x_t, u):
    r_t, k_t, v_t, w_t = x_t
    kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
    y_t = torch.einsum("bhk,bhkv->bhv", r_t, Sst + u[None, :, :, None] * kv)
    return w_t[..., None] * Sst + kv, y_t


def rwkv_channel_mix_init(d_model, d_ff, dtype, device=None):
    kw = dict(dtype=dtype, device=device)
    p = L.Params()
    p.param("mu_k", (d_model,), ("embed",), init="zeros", **kw)
    p.param("wk", (d_model, d_ff), ("embed", "mlp"), **kw)
    p.param("wv", (d_ff, d_model), ("mlp", "embed"), **kw)
    p.param("wr", (d_model, d_model), ("embed", "heads_mlp"), **kw)
    return p


def rwkv_channel_mix(p, x, *, state=None, return_state=False):
    B, S, D = x.shape
    shift_in = (torch.zeros((B, D), dtype=x.dtype, device=x.device)
                if state is None else state)
    xprev = L.cat([shift_in[:, None], x[:, :-1]], dim=1)
    xk = x + (xprev - x) * p["mu_k"].to(x.dtype)
    h = torch.square(F.relu(L.mm(xk, p["wk"])))
    out = torch.sigmoid(L.mm(x, p["wr"])) * L.mm(h, p["wv"])
    if return_state:
        return out, x[:, -1]
    return out


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba_init(d_model, ssm_cfg, dtype, device=None):
    hd = ssm_cfg.head_dim
    n = ssm_cfg.state_dim
    d_inner = ssm_cfg.expand * d_model
    nh = d_inner // hd
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    p = L.Params()
    # in_proj emits [z, x, B, C, dt]
    p.param("w_in", (d_model, 2 * d_inner + 2 * n + nh), ("embed", "mlp"),
            **kw)
    p.param("conv", (ssm_cfg.conv_width, d_inner + 2 * n), (None, "mlp"),
            scale=0.5, **kw)
    p.param("a_log", (nh,), ("heads",), init="zeros", **f32)
    p.param("dt_bias", (nh,), ("heads",), init="zeros", **f32)
    p.param("d_skip", (nh,), ("heads",), init="ones", **f32)
    p.param("norm", (d_inner,), ("mlp",), init="ones", **kw)
    p.param("w_out", (d_inner, d_model), ("mlp", "embed"), **kw)
    return p


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); state: (B, K-1, C).
    A state of a wider dtype than ``x`` widens the result, as
    ``jnp.concatenate`` promotes."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state
    xp = L.cat([pad, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i][None, None, :]
              for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out, new_state


def _mamba_step(h, x_t):
    a_t, dtx_t, b_t, c_t = x_t
    h = a_t[:, :, None, None] * h + torch.einsum("bhd,bn->bhdn", dtx_t, b_t)
    return h, torch.einsum("bhdn,bn->bhd", h, c_t)


def mamba_block(p, x, ssm_cfg, *, state=None, return_state=False):
    """x: (B, S, D). state: (conv_state (B, K-1, C), h (B, nh, hd, N))."""
    B, S, D = x.shape
    hd = ssm_cfg.head_dim
    n = ssm_cfg.state_dim
    d_inner = ssm_cfg.expand * D
    nh = d_inner // hd
    f32 = torch.float32

    zxbcdt = L.mm(x, p["w_in"])
    z, xc, b, c, dt = torch.split(
        zxbcdt, [d_inner, d_inner, n, n, zxbcdt.shape[-1] - 2 * d_inner
                 - 2 * n], dim=-1)
    conv_in = torch.cat([xc, b, c], dim=-1)
    conv_state = None if state is None else state[0]
    conv_out, conv_state_new = _causal_conv(conv_in, p["conv"], conv_state)
    conv_out = F.silu(conv_out)
    xc, b, c = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt = torch.logaddexp(dt.to(f32) + p["dt_bias"],
                         torch.zeros((), dtype=f32, device=x.device))
    a = torch.exp(-torch.exp(p["a_log"].clip(-8.0, 8.0)) * dt)  # (B, S, nh)
    xh = rules.reshape(xc, (B, S, nh, hd)).to(f32)
    b32, c32 = b.to(f32), c.to(f32)
    dtx = dt[..., None] * xh

    h = (torch.zeros((B, nh, hd, n), dtype=f32, device=x.device)
         if state is None else state[1].to(f32))
    h, a, dtx, b32, c32 = (rules.constrain_batch_dim(t, 0)
                           for t in (h, a, dtx, b32, c32))
    h, y = L.scan(_mamba_step, h, (a, dtx, b32, c32))  # (B, S, nh, hd)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = rules.gather_grad_dims(y.reshape(B, S, d_inner), (2,)).to(x.dtype)
    # Gated RMS norm (mamba2's norm-before-out).
    y = y * F.silu(z)
    y32 = y.to(f32)
    y = y32 * torch.rsqrt(torch.mean(torch.square(y32), -1, keepdim=True)
                          + 1e-6)
    y = (y * p["norm"].to(f32)).to(x.dtype)
    out = L.mm(y, p["w_out"])
    if return_state:
        return out, (conv_state_new, h.to(x.dtype))
    return out
