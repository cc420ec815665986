"""Mixture-of-Experts FFN, PyTorch port: top-k routing, scatter/gather
dispatch, expert-parallel on a mesh.

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
from torch.distributed.tensor import Partial, Replicate, Shard

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
    mesh = type(x).__name__ == "DTensor"

    xt = x.reshape(T, D)
    router = p["router"]
    if mesh:
        # The tokens sharded on their batch rows only (partial sums
        # reduced, any other shard gathered), the router whole: routing is
        # then each rank's own rows.
        xt = rules.rows_only(xt)
        router = rules.gather_dims(router, (0, 1))
    logits = L.mm(xt.float(), router)  # (T, E) fp32 routing
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)  # (T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    act = F.silu if activation in ("swiglu", "silu") else (
        lambda t: F.gelu(t, approximate="tanh"))

    if mesh:
        out = _dispatch_on_mesh(p, xt, expert_idx, gate_vals, e, k, cap,
                                act).reshape(B, S, D)
    else:
        flat_e = expert_idx.reshape(T * k)
        slot, _ = _slots(flat_e, e, cap)

        # Dispatch: scatter token copies into the expert-input buffer.
        tok = torch.arange(T * k, device=x.device) // k
        xs = xt[tok]  # (T*k, D)
        buf = torch.zeros((e * cap + 1, D), dtype=x.dtype, device=x.device)
        buf.index_add_(0, slot, xs)
        xe = buf[: e * cap].reshape(e, cap, D)
        ye = _experts(p, xe, act)  # (E, C, D)

        # Combine: gather back, weight by gates, sum the k choices.
        ye_flat = torch.cat([ye.reshape(e * cap, D),
                             torch.zeros((1, D), dtype=ye.dtype,
                                         device=ye.device)], dim=0)
        y = ye_flat[slot].float()
        y = y * gate_vals.reshape(T * k, 1)
        out = torch.sum(y.reshape(T, k, D), dim=1).to(x.dtype).reshape(
            B, S, D)

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


def _slots(flat_e, e, cap, lower=None):
    """(slot, keep) of each token copy (expert ``flat_e``): its position
    within its expert by a masked cumsum over the copies in order, kept
    below ``cap``; a dropped copy's slot is the drop row ``e * cap``.
    ``lower(counts)``: the copies each expert took in the token shards
    before this one, given this shard's counts (E,) (a mesh)."""
    onehot = F.one_hot(flat_e, e).to(torch.int32)  # (n, E)
    pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
    if lower is not None:
        pos = pos + lower(torch.sum(onehot, dim=0))[flat_e]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, e * cap))
    return slot, keep


def _experts(p, xe, act, weights=None):
    """The expert FFNs on the expert-input buffer (E, C, D). On a mesh the
    gate and up products' partial sums (an ``embed`` dim sharded against
    replicated rows) are reduced before the activation."""
    wg, wi, wo = weights or (p["wg"], p["wi"], p["wo"])
    h = act(rules.reduce_partial(L.einsum("ecd,edf->ecf", xe, wg))) * \
        rules.reduce_partial(L.einsum("ecd,edf->ecf", xe, wi))
    return L.einsum("ecf,efd->ecd", h, wo)


def _dispatch_on_mesh(p, xt, expert_idx, gate_vals, e, k, cap, act):
    """The routed experts of ``moe_block`` on a mesh, expert-parallel.

    Each rank routes its own token rows (``xt``, (T, D) sharded on its rows
    over the batch's mesh dims): a copy's slot is the reference's, its
    position within its expert counted over the whole batch, the copies of
    the lower token shards first (an all-gather of each shard's E counts),
    so the same routing drops the same copies. The (E, C, D) expert-input
    buffer is laid out over the mesh (``_expert_layout``): the experts
    where their weights shard them (EP over the model axis), the capacity
    rows over the token shards' mesh dims where they divide C. The tokens
    and the copies' slots and gates are gathered whole (an all-gather of
    T rows, as Megatron's all-gather token dispatcher does); each rank
    reads the tokens of its own block of slots and runs the expert GEMMs
    on them, the weights' ``embed`` dim gathered (fsdp) over the mesh dims
    that shard the rows; over a token mesh dim that does not divide C (a
    decode step's few rows) the rows are replicated and the ``embed`` dim
    stays sharded, each rank contracting its share of it. Each rank then
    adds its rows' outputs, weighted by their gates, into the rows of
    their tokens (fp32, as the reference sums the k choices), and the sum
    over the ranks is reduce-scattered back to the token shards."""
    mesh = xt.device_mesh
    T, D = xt.shape
    T_loc = xt.to_local().shape[0]
    flat_e = expert_idx.to_local().reshape(T_loc * k)
    shard, _ = rules.shard_index(mesh, xt.placements, 0)
    slot, _ = _slots(flat_e, e, cap, lambda counts: torch.sum(
        rules.all_gather_rows(counts, xt, 0)[:shard], dim=0))

    want = _expert_layout(p["wi"], xt, cap)
    split = {i for i, pl in enumerate(want) if type(pl) is Shard}
    e0, ne = rules.shard_index(mesh, want, 0)
    c0, nc = rules.shard_index(mesh, want, 1)
    E_loc, C_loc = e // ne, cap // nc
    dev = slot.device
    # The copy that fills each slot of this rank's block (T * k: none).
    slots_all = rules.all_gather_rows(slot, xt, 0).reshape(T * k)
    filled = torch.full((e * cap + 1,), T * k, dtype=slots_all.dtype,
                        device=dev).scatter(0, slots_all, torch.arange(
                            T * k, dtype=slots_all.dtype, device=dev))
    mine = ((e0 * E_loc + torch.arange(E_loc, device=dev))[:, None] * cap
            + c0 * C_loc + torch.arange(C_loc, device=dev)[None, :])
    copy = filled[mine.reshape(-1)]                     # (E_loc * C_loc,)

    x_all = rules.whole_rows(xt, 0, split)              # (T, D)
    x_pad = torch.cat([x_all, x_all.new_zeros((1, D))])
    xe = rules.from_local(
        x_pad[copy // k].reshape(E_loc, C_loc, D), mesh, want)
    rows = {i for i, pl in enumerate(want) if pl == Shard(1)}
    weights = (rules.gather_dims(p["wg"], (1,), rows),
               rules.gather_dims(p["wi"], (1,), rows),
               rules.gather_dims(p["wo"], (2,), rows))
    ye = _experts(p, xe, act, weights)                  # (E, C, D)
    block = [want[i] if i in split else pl
             for i, pl in enumerate(ye.placements)]
    if block != list(ye.placements):
        ye = ye.redistribute(mesh, block)

    # Each rank's sum: partial over the mesh dims that split the rows or
    # the experts' contraction, its D sharded where ye's is.
    pls = [Partial() if i in split or pl.is_partial()
           else Shard(1) if type(pl) is Shard and pl.dim == 2
           else Replicate() for i, pl in enumerate(ye.placements)]
    g_all = rules.whole_rows(gate_vals, 0, {
        i for i, pl in enumerate(pls) if not pl.is_replicate()})
    g_pad = torch.cat([g_all.reshape(T * k), g_all.new_zeros((1,))])
    ye_loc = ye.to_local()
    y = ye_loc.reshape(E_loc * C_loc, -1).float() * g_pad[copy][:, None]
    y = torch.zeros((T + 1, y.shape[1]), dtype=y.dtype,
                    device=dev).index_add(0, copy // k, y)[:T]
    out = rules.sum_into(y, mesh, pls, xt.placements)
    return out.to(xt.dtype)


def _expert_layout(w, xt, cap):
    """Placements of the expert-input buffer (E, C, D): the experts
    sharded where the expert weights ``w`` (E, D, F) shard them, the
    capacity rows over every mesh dim that shards the tokens where their
    product divides C (else over none: a weight's ``embed`` dim split over
    the pod and the data dims is gathered over both or neither), every
    other mesh dim replicated."""
    mesh = xt.device_mesh
    tokens = [i for i, pl in enumerate(xt.placements)
              if type(pl) is Shard and pl.dim == 0]
    split = 1
    for i in tokens:
        split *= mesh.shape[i]
    want = []
    for i, pw in enumerate(w.placements):
        if type(pw) is Shard and pw.dim == 0:
            want.append(Shard(0))
        elif i in tokens and cap % split == 0:
            want.append(Shard(1))
        else:
            want.append(Replicate())
    return want
