"""Mixture-of-Experts FFN, PyTorch port: top-k routing, scatter/gather
dispatch.

Dispatch layout: every (token, choice) is assigned a slot in a capacity-
padded expert-input buffer of shape (E*C + 1, D) (the extra row absorbs
dropped tokens). Dispatch is a scatter-add (``index_add_``), combine a
gather. Routing runs in fp32; top-k breaks ties by the lower expert index,
as ``lax.top_k`` does (a stable descending sort). Supports the arctic-480b
wrinkle: a *dense residual* FFN in parallel with the routed experts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import rules


def moe_init(d_model, moe_cfg, d_ff_default, dtype, device=None):
    e = moe_cfg.num_experts
    d_ff = moe_cfg.expert_d_ff or d_ff_default
    p = L.Params()
    p.param("router", (d_model, e), ("embed", "experts"),
            dtype=torch.float32, device=device)
    p.param("wi", (e, d_model, d_ff), ("experts", "embed", "expert_mlp"),
            dtype=dtype, device=device)
    p.param("wg", (e, d_model, d_ff), ("experts", "embed", "expert_mlp"),
            dtype=dtype, device=device)
    p.param("wo", (e, d_ff, d_model), ("experts", "expert_mlp", "embed"),
            dtype=dtype, device=device)
    if moe_cfg.dense_residual:
        p.child("dense", L.mlp_init(d_model, d_ff_default, dtype,
                                    device=device))
    return p


def top_k(x, k):
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(p, x, moe_cfg, *, activation="swiglu"):
    """x: (B, S, D) -> (out (B, S, D), aux_losses dict)."""
    B, S, D = x.shape
    T = B * S
    e = moe_cfg.num_experts
    k = moe_cfg.top_k
    cap = max(int(moe_cfg.capacity_factor * T * k / e), 1)

    # On a mesh the tokens' gradient comes back summed over two uses and
    # scattered over every mesh axis, which the reshape's backward
    # mis-sizes: gather and reduce it first (plain tensors: untouched).
    xt = rules.gather_grad_dims(x.reshape(T, D), (0,), reduce=True)
    logits = L.mm(xt.float(), p["router"])  # (T, E) fp32 routing
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)  # (T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # Slot assignment: position within the chosen expert via masked cumsum.
    flat_e = expert_idx.reshape(T * k)
    onehot = F.one_hot(flat_e, e).to(torch.int32)  # (T*k, E)
    pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, e * cap))  # drop row at e*cap

    # Dispatch: scatter token copies into the expert-input buffer.
    tok = torch.arange(T * k, device=x.device) // k
    xs = xt[tok]  # (T*k, D)
    buf = torch.zeros((e * cap + 1, D), dtype=x.dtype, device=x.device)
    if type(xs).__name__ == "DTensor":
        # On a mesh: the token copies and their slots whole on every rank,
        # the scatter on those local tensors (a scatter of global slot
        # indices from token shards has no DTensor placement in every
        # torch), the buffer replicated.
        buf = rules.add_rows_replicated(buf, slot, xs)
    else:
        buf.index_add_(0, slot, xs)
    xe = buf[: e * cap].reshape(e, cap, D)

    # Expert FFNs.
    act = F.silu if activation in ("swiglu", "silu") else (
        lambda t: F.gelu(t, approximate="tanh"))
    h = act(L.einsum("ecd,edf->ecf", xe, p["wg"])) * L.einsum(
        "ecd,edf->ecf", xe, p["wi"])
    ye = L.einsum("ecf,efd->ecd", h, p["wo"])  # (E, C, D)

    # Combine: gather back, weight by gates, sum the k choices.
    ye_flat = torch.cat([ye.reshape(e * cap, D),
                         torch.zeros((1, D), dtype=ye.dtype,
                                     device=ye.device)], dim=0)
    # On a mesh the slots whole: no torch places an index by a tensor
    # sharded over two mesh axes (pod and data) on one dim.
    y = ye_flat[rules.gather_dims(slot, (0,))].float()
    y = y * gate_vals.reshape(T * k, 1)
    out = torch.sum(y.reshape(T, k, D), dim=1).to(x.dtype).reshape(B, S, D)

    if "dense" in p:
        out = out + L.mlp(p["dense"], x, activation=activation)

    # Aux losses: load-balance (Switch-style) + router z-loss.
    density = torch.mean(F.one_hot(expert_idx[:, 0], e).float(), dim=0)
    router_prob = torch.mean(probs, dim=0)
    aux = {
        "load_balance": moe_cfg.aux_loss_coef * e * torch.sum(
            density * router_prob),
        "router_z": moe_cfg.router_z_coef * torch.mean(
            torch.square(torch.logsumexp(logits, dim=-1))),
    }
    return out, aux
