"""Public API for rank-k Cholesky up/down-dating, PyTorch port.

Port of ``repro.core.api``. ``chol_update`` is the single entry point;
``method`` names a backend from the registry (``repro_torch.core.backends``):
``reference``, ``paper``, ``gemm``, ``pallas``, ``pallas_gemm``, ``fused``,
``sharded`` (with ``mesh=``, ``axis=``: the column-sharded driver of
``repro_torch.core.distributed``, which takes a fleet whole), or ``auto``,
which picks ``fused`` for CUDA tensors (and under explicit interpret mode)
and ``reference``/``gemm`` by size on the CPU.

Device: a tensor argument keeps its device; anything else (numpy arrays,
lists) goes to ``device``, which defaults to CUDA. With no CUDA device and
no tensor to follow, the entry points raise instead of carrying on on the
CPU. Tests ask for the CPU by passing CPU tensors.

``precision`` is the storage/accum policy (DESIGN.md §8). ``V`` is always
cast to ``L``'s dtype before dispatch (the factor is never promoted).

``L`` may also be a structured storage (``repro_torch.core.structure``,
e.g. ``BlockTriDiagStorage``): ``method`` then resolves against its
structure ('auto' -> ``blocktridiag`` on CUDA, ``blocktridiag_ref`` on
the CPU), and a structured fleet goes through ``chol_update_batched``.

Gradients: when an input requires a gradient (or carries a forward-AD
tangent), the call goes through the Murray rules of
``repro_torch.core.autodiff`` (a ``torch.autograd.Function`` around the
dispatched backend, which runs with no tape); otherwise it dispatches
directly, with no ``Function`` in the way. ``method='sharded'`` takes the
dense rule on the whole factor on every rank (``diffable_update_sharded``:
its result is a ``DTensor``, the gradient of ``L`` comes back in ``L``'s
layout; under forward mode the result is gathered whole on every rank).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.autograd.forward_ad as _fwad

from repro_torch.core import autodiff, backends
from repro_torch.core import structure as _structure
from repro_torch.core.precision import Precision


def default_device(device=None):
    """``device`` if given, else CUDA, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card unless the caller "
            "passes CPU tensors or device='cpu'")
    return torch.device("cuda")


def as_tensor(x, device=None):
    """``x`` as a tensor: a tensor keeps its device unless ``device`` is
    given; anything else goes to ``device``, default CUDA. A structured
    storage keeps its blocks' device, or moves to ``device``."""
    if _structure.is_factor_storage(x):
        return x if device is None else x.to(device)
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=default_device(device))


def _forward_mode() -> bool:
    """True when a forward-AD level (``torch.autograd.forward_ad``,
    ``torch.func.jvp``) is active."""
    return (getattr(_fwad, "_current_level", -1) >= 0
            or torch._C._functorch.maybe_current_level() is not None)


def _needs_rule(L, V) -> bool:
    """True when ``L`` or ``V`` requires a gradient, or a forward-AD level
    is active: the call then goes through the Murray rule. Attribute reads
    only, so a call with no gradient dispatches as it always did."""
    if torch.is_grad_enabled() and (L.requires_grad or V.requires_grad):
        return True
    return _forward_mode()


def _run(L, V, *, sigma, method, **kw):
    """Dispatch, through the Murray rule when ``_needs_rule``."""
    if not _needs_rule(L, V):
        return backends.dispatch(L, V, sigma=sigma, method=method, **kw)

    def impl(L, V, sigma):
        return backends.dispatch(L, V, sigma=sigma, method=method, **kw)

    if method == "sharded":
        return autodiff.diffable_update_sharded(
            impl, sigma, L, V, forward_mode=_forward_mode())
    if _structure.is_factor_storage(L):
        return autodiff.diffable_update_structured(impl, sigma, L, V)
    return autodiff.diffable_update(impl, sigma, L, V)


def _check_method_sigma(method, sigma):
    if method not in backends.methods():
        raise ValueError(
            f"method must be one of {backends.methods()}, got {method!r}")
    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")


def chol_update(
    L,
    V,
    *,
    sigma: int = 1,
    method: str = "auto",
    panel: int = 256,
    interpret: Optional[bool] = None,
    precision=None,
    device=None,
    **opts,
):
    """Rank-k up/down-date of the upper Cholesky factor L (A = L^T L).

    Args:
      L: (n, n) upper-triangular factor with positive diagonal, or a
        structured storage of one factor.
      V: (n, k) or (n,) modification matrix; cast to ``L.dtype``.
      sigma: +1 for update (A + V V^T), -1 for downdate (A - V V^T).
      method: backend name or 'auto'.
      panel: row-panel size for the blocked and fused paths.
      interpret: None picks by device; True asks for the plain version of
        the fused kernel (CPU tensors only).
      precision: storage/accum dtype policy ('bf16', a ``Precision``, or
        None). The result carries the storage dtype.
      device: where non-tensor inputs go (default CUDA).
      **opts: backend options (``panel_apply=``, ``grid_mode=``,
        ``lowering=`` for 'fused'; ``mesh=``, ``axis=``, ``strategy=``,
        ``lowering=`` for 'sharded').

    Returns:
      The modified upper-triangular factor.
    """
    _check_method_sigma(method, sigma)
    L = as_tensor(L, device)
    V = as_tensor(V, L.device)
    if _structure.is_factor_storage(L):
        if L.batched:
            raise ValueError(
                "batched structured storage goes through "
                f"chol_update_batched (got {L.describe()})")
    elif L.ndim == 3 and method != "sharded":
        # The sharded driver takes a fleet whole, as in the JAX package.
        raise ValueError(
            f"stacked (B, n, n) factors go through chol_update_batched "
            f"(method={method!r})")
    if V.ndim == 1:
        V = V[:, None]
    if V.dtype != L.dtype:
        V = V.to(L.dtype)  # the factor's dtype wins on every backend
    return _run(L, V, sigma=sigma, method=method, panel=panel,
                interpret=interpret, precision=Precision.parse(precision),
                **opts)


def chol_update_batched(
    L,
    V,
    *,
    sigma: int = 1,
    method: str = "auto",
    panel: int = 256,
    interpret: Optional[bool] = None,
    precision=None,
    device=None,
    **opts,
):
    """Batched rank-k up/down-date over stacked factors.

    The serving workload: many per-user factors each receive their own
    modification in one call. ``method`` resolves once for the batch; on
    ``fused`` and ``blocktridiag`` the whole fleet goes through ONE kernel
    launch per sign block, on ``pallas``/``pallas_gemm`` through the
    launches of one factor; ``sharded`` takes the fleet whole (one
    collective per panel and one panel-phase launch per shard for all B).

    Args:
      L: (B, n, n) stacked upper-triangular factors, or batched structured
        storage.
      V: (B, n, k) — or (B, n), rank 1 — stacked modifications.
      sigma, method, panel, interpret, precision, device, **opts: as in
        ``chol_update`` (shared across the batch).

    Returns:
      (B, n, n) stacked updated factors.
    """
    _check_method_sigma(method, sigma)
    L = as_tensor(L, device)
    V = as_tensor(V, L.device)
    structure = getattr(L, "structure", "dense")
    if structure != "dense":
        # A structured fleet: batched storage and (B, n, k) rows; the
        # method resolves once against the storage's structure.
        if not L.batched:
            raise ValueError(f"structured fleet must be batched storage, "
                             f"got {L.describe()}")
        batch, n = L.batch, L.n
    else:
        if L.ndim != 3:
            raise ValueError(
                f"L must be (B, n, n), got shape {tuple(L.shape)}")
        batch, n = L.shape[0], L.shape[-1]
    if V.ndim == 2:
        V = V[:, :, None]
    if V.ndim != 3 or V.shape[0] != batch or V.shape[1] != n:
        raise ValueError(f"V must be (B, n, k) matching a fleet of {batch} "
                         f"factors of order {n}, got {tuple(V.shape)}")
    if V.dtype != L.dtype:
        V = V.to(L.dtype)
    method = backends.resolve(method, n=n, panel=panel,
                              interpret=interpret, device=L.device,
                              structure=structure)
    return _run(L, V, sigma=sigma, method=method, panel=panel,
                interpret=interpret, precision=Precision.parse(precision),
                **opts)


def chol_downdate(L, V, **kw):
    """Convenience wrapper for ``chol_update(..., sigma=-1)``."""
    return chol_update(L, V, sigma=-1, **kw)


def chol_downdate_batched(L, V, **kw):
    """Convenience wrapper for ``chol_update_batched(..., sigma=-1)``."""
    return chol_update_batched(L, V, sigma=-1, **kw)
