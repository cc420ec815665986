"""Parameter substrate + elementary layers, PyTorch port.

Parameters live in ``Params`` modules (``nn.Module``s) that mirror the JAX
package's parameter tree: a ``Params`` holds its leaves and child
``Params`` under the JAX tree's keys, and ``p["wq"]`` reads a leaf or a
child as ``p["wq"]`` reads the JAX dict. Every leaf is created through
``Params.param(...)``, which records its *logical axis names* and its init
rule beside it; ``axes_tree`` gives the axes as the JAX package's
``split`` does. The weight layout is the JAX package's: ``linear`` is
``x @ w`` with ``w`` of shape ``(d_in, d_out)``.

The math follows the JAX package op for op: norms in fp32 internals cast
back to the input's dtype, half-split rotary embeddings, tanh soft-capping,
tanh-approximate GELU. JAX promotes mixed dtypes in a matmul silently and
torch refuses them: ``mm`` writes the promotion out.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.core.precision import as_dtype


def default_scale(shape) -> float:
    """The JAX package's default init scale: 1/sqrt(shape[0]) for a matrix
    or a stack (so 1/sqrt(H) for an ``(H, Dh, D)`` output projection),
    1/sqrt(shape[-1]) for a vector; computed in fp32 as there."""
    fan = shape[0] if len(shape) > 1 else shape[-1]
    return float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(fan))))


class Params(nn.Module):
    """A node of the parameter tree: leaves with logical axes, and
    children. ``p[name]`` is the leaf or the child of that name."""

    def __init__(self):
        super().__init__()
        self.axes: Dict[str, Tuple[Optional[str], ...]] = {}
        self._inits: Dict[str, Tuple[str, Optional[float]]] = {}

    def param(self, name, shape, axes, *, dtype, device=None,
              scale: Optional[float] = None, init: str = "normal"):
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} vs shape {shape}")
        t = torch.empty(tuple(shape), dtype=as_dtype(dtype), device=device)
        self.register_parameter(name, nn.Parameter(t))
        self.axes[name] = tuple(axes)
        self._inits[name] = (init, scale)
        return self

    def child(self, name, node: "Params") -> "Params":
        self.add_module(name, node)
        return node

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self.axes or name in self._modules

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        """Draw every leaf of this node (not its children) by its rule:
        zeros, ones, or fp32 normals times its scale, cast to its dtype."""
        for name, (init, scale) in self._inits.items():
            p = getattr(self, name)
            if init == "zeros":
                p.zero_()
            elif init == "ones":
                p.fill_(1)
            else:
                s = default_scale(p.shape) if scale is None else scale
                x = torch.randn(p.shape, generator=generator,
                                dtype=torch.float32, device=p.device)
                p.copy_(x * s)


def init_tree(module: nn.Module, generator: torch.Generator) -> None:
    """``reset`` every ``Params`` node below ``module``, in module order."""
    for m in module.modules():
        if isinstance(m, Params):
            m.reset(generator)


def values_tree(node: Params) -> dict:
    """The node's leaves and children as a nested dict of tensors."""
    out = {name: getattr(node, name) for name in node.axes}
    for name, m in node._modules.items():
        out[name] = values_tree(m)
    return out


def axes_tree(node: Params) -> dict:
    """The node's logical axes as a nested dict of tuples."""
    out = dict(node.axes)
    for name, m in node._modules.items():
        out[name] = axes_tree(m)
    return out


def alias_stacked(nodes) -> dict:
    """Re-home the leaves of equal-structured nodes (the layers of a
    stack) in one tensor per leaf, stacked on a leading axis: node i's
    leaf becomes a ``Parameter`` over row i of it (the same storage, each
    row still its own autograd leaf). Returns the nested dict of the
    stacked tensors, the layout of the JAX package's ``layers`` subtree:
    an in-place change to a stacked tensor is a change to every layer's
    parameter, and the layers' values read as that subtree with no copy."""
    first = nodes[0]
    out = {}
    for name in first.axes:
        rows = [getattr(n, name) for n in nodes]
        stacked = torch.empty((len(rows),) + tuple(rows[0].shape),
                              dtype=rows[0].dtype, device=rows[0].device)
        for i, (n, row) in enumerate(zip(nodes, rows)):
            with torch.no_grad():
                stacked[i].copy_(row)
            n._parameters[name] = nn.Parameter(stacked[i])
        out[name] = stacked
    for name in first._modules:
        out[name] = alias_stacked([n._modules[name] for n in nodes])
    return out


def _ptr(t: torch.Tensor) -> int:
    """The address of ``t``'s data (of its local shard for a DTensor)."""
    return (t.to_local() if hasattr(t, "to_local") else t).data_ptr()


def stacked_rows(nodes, stacked: dict) -> bool:
    """True iff every leaf of every node still views its row of
    ``stacked`` (``alias_stacked``'s layout; ``Module.to`` and the like
    re-home parameters and break it)."""
    first = nodes[0]
    for name in first.axes:
        st = stacked[name]
        for i, n in enumerate(nodes):
            p = getattr(n, name)
            if (_ptr(p) != _ptr(st[i]) or p.shape != st[i].shape
                    or p.dtype != st.dtype):
                return False
    return all(stacked_rows([n._modules[name] for n in nodes], stacked[name])
               for name in first._modules)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul``; a
    ``DTensor`` weight ``b`` (2-D) first gathers ``weight_gathers``'
    dims."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if type(b).__name__ == "DTensor" and b.ndim == 2 and a.ndim >= 1:
        from repro_torch.sharding import rules

        lead = "".join(chr(ord("A") + i) for i in range(a.ndim - 1))
        b = rules.gather_dims(b, weight_gathers(lead + "k", "kn", a, b))
    return torch.matmul(a.to(dt), b.to(dt))


def weight_gathers(ta, tw, a, w) -> set:
    """The dims of the weight ``w`` (einsum letters ``tw``) that a product
    with the activation ``a`` (letters ``ta``) gathers first: each that
    a mesh dim shards while that mesh dim shards a dim of ``a`` of another
    letter (an fsdp-sharded ``embed`` against batch-sharded rows), as XLA
    gathers an fsdp weight. ``DTensor`` would otherwise move the
    activation to meet the weight, leaving a partial sum of the whole
    batch. A shard on a letter both share (experts against experts) stays."""
    from repro_torch.sharding import rules

    if type(w).__name__ != "DTensor" or type(a).__name__ != "DTensor":
        return set()
    out = set()
    for pa, pw in zip(a.placements, w.placements):
        if rules._shards(pa) and rules._shards(pw):
            dw = pw.dim % w.ndim
            if tw[dw] != ta[pa.dim % a.ndim]:
                out.add(dw)
    return out


def cat(xs, dim: int) -> torch.Tensor:
    """``jnp.concatenate``: the pieces in their promoted dtype."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.cat([x.to(dt) for x in xs], dim=dim)


def einsum(eq: str, *xs: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``jnp.einsum`` of the operands in their promoted dtype;
    ``out_dtype=torch.float32`` stands for ``preferred_element_type=f32``
    (operands widened to fp32: a product of bf16 values is exact there)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    if out_dtype is not None:
        dt = torch.promote_types(dt, out_dtype)
    xs = tuple(x.to(dt) for x in xs)
    if any(type(x).__name__ == "DTensor" for x in xs):
        return _dtensor_einsum(eq, *xs)
    return torch.einsum(eq, *xs)


def _expand_ellipsis(eq, xs):
    """``eq`` with each ``...`` spelled out in capital letters, one a dim,
    aligned to the right as torch broadcasts them."""
    ins, out = eq.replace(" ", "").split("->")
    terms = ins.split(",")
    n = max((x.ndim - len(t) + 3 for t, x in zip(terms, xs) if "..." in t),
            default=0)
    caps = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"[:n]
    terms = [t.replace("...", caps[n - (x.ndim - len(t) + 3):])
             for t, x in zip(terms, xs)]
    return terms, out.replace("...", caps)


def einsum_gathers(eq, *xs):
    """Per operand of a two-operand ``einsum(eq, *xs)``, the dims a
    ``DTensor`` operand gathers first. torch runs it as one batched matmul,
    each operand permuted and reshaped into (batch, free, contracted)
    groups of dims; a shard on a dim that this merges behind another of its
    group, or a strided shard, cannot be viewed in place. A group's letters
    run in the output's order, the contracted ones in label order (capitals
    first), as torch permutes them, letters of size 1 left out; a plain
    shard on a group's first letter stays (``rules.reshape_gathers`` is the
    same rule for a plain reshape)."""
    from repro_torch.sharding import rules

    terms, out = _expand_ellipsis(eq, xs)
    if len(terms) != 2:
        return [set() for _ in xs]
    size = {}
    for t, x in zip(terms, xs):
        for c, n in zip(t, x.shape):
            size[c] = max(size.get(c, 1), n)
    order = out + "".join(sorted({c for t in terms for c in t} - set(out)))
    order = "".join(c for c in order if size.get(c, 1) > 1)
    common = set(terms[0]) & set(terms[1])
    gathers = []
    for term, other, x in ((terms[0], terms[1], xs[0]),
                           (terms[1], terms[0], xs[1])):
        g = set()
        if type(x).__name__ == "DTensor":
            groups = ([c for c in order if c in common and c in out],
                      [c for c in order if c in term and c not in other
                       and c in out],
                      [c for c in order if c in common and c not in out])
            first = {grp[0] for grp in groups if grp}
            for pl in x.placements:
                if rules._shards(pl):
                    d = pl.dim % x.ndim
                    if term[d] not in first or type(pl).__name__ != "Shard":
                        g.add(d)
        gathers.append(g)
    return gathers


def _dtensor_einsum(eq, *xs):
    """``torch.einsum`` of ``DTensor``s with explicit placements. A
    projection ``...d,dhk->...hk`` (its product's merged (h, k) columns
    sharded across a head: 8 KV heads of 128 over a 16-wide axis) runs as a
    matmul and a placed reshape; any other equation first gathers each
    operand's ``einsum_gathers`` dims, and its gradient the same dims on
    the way back. What ``DTensor`` then cannot place raises."""
    from repro_torch.sharding import rules

    ins, out = eq.split("->")
    terms = ins.split(",")
    if len(terms) == 2:
        # The second operand is the weight: it gathers the dims that would
        # meet the activation's shards of other dims (fsdp).
        full, _ = _expand_ellipsis(eq, xs)
        xs = (xs[0], rules.gather_dims(xs[1], weight_gathers(*full, *xs)))
        a, b = terms
        if len(b) == 3 and b[0] == a[-1] and out == a[:-1] + b[1:]:
            x, w = xs
            # The weight's gradient comes back with the same columns
            # sharded, which the reshape's backward cannot split: gather.
            y = torch.matmul(x, rules.gather_grad_dims(
                w.reshape(w.shape[0], -1), (1,)))
            return rules.reshape(y, tuple(x.shape[:-1]) + tuple(w.shape[1:]))
    return torch.einsum(eq, *(
        rules.gather_grad_dims(rules.gather_dims(x, g), g)
        for x, g in zip(xs, einsum_gathers(eq, *xs))))


# ---------------------------------------------------------------------------
# Sequence recurrences (``jax.lax.scan``).
# ---------------------------------------------------------------------------


def scan(step, carry, xs, consts=()):
    """``jax.lax.scan`` over axis 1: ``step(carry, x_t, *consts) -> (carry,
    y_t)`` for t in range(S), ``x_t`` the tuple of ``x[:, t]`` for x in
    ``xs`` (each (B, S, ...)); returns (the last carry, the y_t stacked
    on axis 1). ``consts`` are tensors every step reads (passed, not
    closed over, so that a gradient reaches them on the meta device).

    On tensors that hold values it is the Python loop over t. On the meta
    device (a dry run) no values flow, so one step stands for all S: it is
    traced once under ``opcount.weighted(S)``, which counts its FLOPs and
    collectives S times over as ``hloparse`` weighs a while body, and what
    the loop would keep (its outputs, its saved per-step residuals) is
    made at its full S length, so that a tracked peak holds what the
    loop's holds (``_ScanOnce`` under autograd).
    """
    if carry.device.type != "meta":
        return _scan_loop(step, carry, xs, consts)
    parts = (carry, *xs, *consts)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in parts)):
        c1, ys, _ = _scan_once(step, carry, xs, consts)
        return c1, ys
    c1, ys = _ScanOnce.apply(step, len(xs), *parts)
    node = ys.grad_fn
    anchor = node.anchor()
    if anchor is not None:
        # The graph keeps what the step saved, as it would keep the loop's
        # residuals (no ``checkpoint`` dropped them): hold their bytes for
        # as long as it does (a finalizer holds its arguments until then).
        weakref.finalize(anchor, lambda held: None,
                         _meta_bytes(node.residual_bytes))
    return c1, ys


def _scan_loop(step, carry, xs, consts):
    ys = []
    for t in range(xs[0].shape[1]):
        carry, y = step(carry, tuple(x[:, t] for x in xs), *consts)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _nbytes(t) -> int:
    """Bytes of the storage rank 0 holds of ``t`` (a ``DTensor``'s local
    shard)."""
    return getattr(t, "_local_tensor", t).untyped_storage().nbytes()


def _storage_key(t) -> int:
    return getattr(t, "_local_tensor", t).untyped_storage()._cdata


def _meta_bytes(nbytes):
    """A meta tensor of ``nbytes`` bytes standing for storages the loop
    would hold (a dispatched allocation: a tracking ``OpCounter`` sees
    it)."""
    return torch.empty((max(int(nbytes), 0),), dtype=torch.uint8,
                       device="meta")


def _full_length(y, S):
    """``y`` (one step's output, or a gradient of one step's input) as the
    loop's stack of S of them on axis 1: a new storage, placed as ``y``."""
    return y.unsqueeze(1).expand(
        (y.shape[0], S) + tuple(y.shape[1:])).contiguous()


def _leaves(parts):
    """Fresh leaves of ``parts`` (each requiring grad as its source does),
    for tracing one step on a graph of its own."""
    return [t.detach().requires_grad_(t.requires_grad) for t in parts]


def _scan_once(step, carry, xs, consts):
    """One step traced at weight S (on a graph of its own where grad is
    enabled). Returns (carry out, the outputs at full length, the bytes
    of the residuals the loop's graph would keep)."""
    from repro_torch.roofline import opcount

    S = xs[0].shape[1]
    before = opcount.live_bytes()
    c_in, *k_in = _leaves((carry, *consts))
    x_in = _leaves([x[:, 0] for x in xs])
    saved = set()

    def pack(t):
        saved.add(_storage_key(t))
        return t

    # The step's own graph keeps its residuals, under remat too (an outer
    # ``checkpoint`` would drop them in its first forward only).
    with opcount.weighted(S), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        c1, y1 = step(c_in, tuple(x_in), *k_in)
    kept = opcount.live_bytes() - before - _nbytes(c1) - _nbytes(y1)
    # The loop keeps each step's residuals and, where a step saves its
    # carry, every carry but the last (returned).
    residual_bytes = S * kept
    if saved & {_storage_key(c_in), _storage_key(c1)}:
        residual_bytes += (S - 1) * _nbytes(c1)
    c1, y1 = c1.detach(), y1.detach()   # the step's graph goes
    held = _meta_bytes(S * _nbytes(y1))  # the loop's list, until its stack
    ys = _full_length(y1, S)
    del held
    return c1, ys, residual_bytes


class _ScanOnce(torch.autograd.Function):
    """``scan`` on the meta device under autograd. The forward traces one
    step at weight S and saves an empty anchor tensor beside its inputs;
    ``scan`` holds a meta tensor of the loop's residual bytes for as long
    as the graph holds the anchor, so they come and go as the loop's do: a
    ``torch.utils.checkpoint`` drops both in its first forward, and its
    recompute runs this forward again, keeping them until the backward.
    The backward retraces the step uncounted and counts its VJP at weight
    S."""

    @staticmethod
    def forward(ctx, step, n_xs, carry, *rest):
        xs, consts = rest[:n_xs], rest[n_xs:]
        with torch.enable_grad():
            c1, ys, ctx.residual_bytes = _scan_once(step, carry, xs,
                                                    consts)
        ctx.step, ctx.n_xs = step, n_xs
        ctx.set_materialize_grads(False)   # an unused carry: no gradient
        anchor = _meta_bytes(0)
        ctx.anchor = weakref.ref(anchor.untyped_storage())
        ctx.save_for_backward(carry, *xs, *consts, anchor)
        return c1, ys

    @staticmethod
    def backward(ctx, g_carry, g_ys):
        from repro_torch.roofline import opcount

        carry, *rest, _ = ctx.saved_tensors
        xs, consts = rest[:ctx.n_xs], rest[ctx.n_xs:]
        S = xs[0].shape[1]
        with torch.enable_grad():
            c_in, *k_in = _leaves((carry, *consts))
            x_in = _leaves([x[:, 0] for x in xs])
            with opcount.paused():
                c1, y1 = ctx.step(c_in, tuple(x_in), *k_in)
            # The carry's gradient is a step's own input in all but the
            # last trip: trace the step with one (zeros where the last
            # carry is unused).
            if g_carry is None:
                g_carry = torch.zeros_like(c1)
            ins = [t for t in (c_in, *x_in, *k_in) if t.requires_grad]
            with opcount.weighted(S):
                # Where a step's slice of the output's gradient is a new
                # storage (a DTensor gathers a sequence shard for it), the
                # loop's stack backward holds all S of them at once.
                before = opcount.live_bytes()
                g_y = g_ys[:, 0]
                held = _meta_bytes((S - 1)
                                   * (opcount.live_bytes() - before))
                got = iter(torch.autograd.grad(
                    (c1, y1), ins, (g_carry, g_y), allow_unused=True))
                del held
        g_c, *g_rest = [next(got) if t.requires_grad else None
                        for t in (c_in, *x_in, *k_in)]
        g_xs = [None if g is None else _full_length(g, S)
                for g in g_rest[:ctx.n_xs]]
        return (None, None, g_c, *g_xs, *g_rest[ctx.n_xs:])


# ---------------------------------------------------------------------------
# Norms (fp32 internals regardless of activation dtype).
# ---------------------------------------------------------------------------


def rmsnorm_init(d, dtype, device=None):
    return Params().param("scale", (d,), ("embed",), dtype=dtype,
                          device=device, init="ones")


def rmsnorm(p, x, *, eps=1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def layernorm_init(d, dtype, device=None):
    p = Params().param("scale", (d,), ("embed",), dtype=dtype, device=device,
                       init="ones")
    return p.param("bias", (d,), ("embed",), dtype=dtype, device=device,
                   init="zeros")


def layernorm(p, x, *, eps=1e-6):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def norm_init(kind, d, dtype, device=None):
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def apply_norm(kind, p, x):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# Linear / embedding.
# ---------------------------------------------------------------------------


def linear_init(d_in, d_out, axes, dtype, *, scale=None, device=None):
    return Params().param("w", (d_in, d_out), axes, dtype=dtype,
                          device=device, scale=scale)


def linear(p, x):
    return mm(x, p["w"])


def embed_init(vocab, d, dtype, device=None):
    return Params().param("tokens", (vocab, d), ("vocab", "embed"),
                          dtype=dtype, device=device, scale=1.0)


def embed_lookup(p, tokens):
    """Rows ``tokens`` of the table. A ``DTensor`` table (on a mesh) takes
    ``F.embedding``, which ``DTensor`` places over a sharded vocabulary and
    whose backward it can place (the indexing's backward, ``index_put``,
    has a broken rule in some torch versions); a plain table keeps the
    indexing."""
    if type(p["tokens"]).__name__ == "DTensor":
        from repro_torch.sharding import rules

        # The rows of a sharded vocabulary come back as a masked partial
        # sum, which later adds cannot take: reduce it here; and reduce the
        # gradient's partial sums before it reaches that reduction's
        # backward (no torch redistributes a sum into a masked sum). A
        # table sharded on its embedding dim where the tokens shard their
        # rows gathers that dim first (fsdp), so the rows stay sharded.
        table = p["tokens"]
        table = rules.gather_dims(table, weight_gathers("bs"[-tokens.ndim:],
                                                        "vd", tokens, table))
        y = rules.reduce_partial(F.embedding(tokens.long(), table))
        return rules.gather_grad_dims(y, (), reduce=True)
    return p["tokens"][tokens.long()]


# ---------------------------------------------------------------------------
# Activations / gated MLP.
# ---------------------------------------------------------------------------


def _act(name, x):
    if name in ("swiglu", "silu"):
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(name)


def mlp_init(d, d_ff, dtype, *, activation="swiglu", gated=True,
             device=None):
    p = Params()
    p.param("wi", (d, d_ff), ("embed", "mlp"), dtype=dtype, device=device)
    p.param("wo", (d_ff, d), ("mlp", "embed"), dtype=dtype, device=device)
    if gated:
        p.param("wg", (d, d_ff), ("embed", "mlp"), dtype=dtype,
                device=device)
    return p


def mlp(p, x, *, activation="swiglu"):
    """The gated (or plain) MLP. On a mesh its input's gradient is reduced
    once (``rules.copy_to_columns``) and the down projection's partial sum
    once (``rules.reduce_rows``): Megatron's pair around the column- and
    the row-parallel products."""
    from repro_torch.sharding import rules

    x = rules.copy_to_columns(x)
    if "wg" in p:
        h = _act(activation, mm(x, p["wg"])) * mm(x, p["wi"])
    else:
        h = _act(activation, mm(x, p["wi"]))
    return rules.reduce_rows(mm(h, p["wo"]))


# ---------------------------------------------------------------------------
# Rotary position embedding.
# ---------------------------------------------------------------------------


def rope(x, positions, *, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq). The
    frequencies are fp32, as the JAX package's; nothing crosses from the
    host to the device."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    f32 = torch.float32
    log_theta = float(torch.log(torch.tensor(theta, dtype=f32)))
    freqs = torch.exp(
        -log_theta * torch.arange(0, half, dtype=f32, device=x.device) / half
    )
    angles = positions[..., None].to(f32) * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def sqrt_scale(d: int, dtype) -> float:
    """``jnp.asarray(jnp.sqrt(d), dtype)`` as a Python float: sqrt in fp32,
    rounded to ``dtype`` (a Python scalar multiplies on the device with no
    copy from the host)."""
    return float(torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
                 .to(dtype))


def inv_sqrt(d: int) -> float:
    """``1 / jnp.sqrt(jnp.asarray(d, f32))``, computed in fp32, as a Python
    float (exact)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))
