"""Backend registry for rank-k Cholesky up/down-dating (DESIGN.md §7).

Port of ``repro.core.backends``. Every execution path of the modification
is a registered implementation of ONE protocol::

    update(L, V, *, sigma, panel, interpret, precision, **opts) -> L_new

``L`` is ``(n, n)`` or a ``(B, n, n)`` fleet. The registered paths are the
serial oracle ``reference``, the panelled drivers ``paper`` and ``gemm``,
and the single-launch ``fused`` kernel (the CUDA kernel on CUDA tensors,
its plain version on CPU tensors). The per-panel kernels, the sharded
driver and the structured backends are not ported yet (ROADMAP queues 1
and 2); asking for them raises like an unknown name.

``resolve('auto')`` keys on the device kind of the factor's tensor: CUDA
(or any Pallas-capable kind the JAX package knows, or explicit interpret
mode) -> ``fused``; otherwise ``reference`` under two panels and ``gemm``
beyond.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.precision import Precision
from repro_torch.obs import metrics as obs_metrics

# Device kinds with a kernel for the fused chain: the JAX package's
# Pallas-capable kinds, so routing under a faked kind matches it.
PALLAS_DEVICE_KINDS = ("tpu", "gpu", "cuda", "rocm")

#: Valid ``lowering=`` values. The port has one lowering of the fused chain
#: (the CUDA kernel with its plain version); 'mosaic' is the TPU spec.
LOWERINGS = ("auto", "portable")

# Environment overrides, as in the JAX package: REPRO_FAKE_DEVICE_KIND
# makes routing see a chosen device kind; REPRO_FORCE_INTERPRET=1 pins the
# interpret auto-detect to True (on a CUDA tensor the fused path then
# raises rather than silently running the plain version).
FAKE_DEVICE_KIND_ENV = "REPRO_FAKE_DEVICE_KIND"
FORCE_INTERPRET_ENV = "REPRO_FORCE_INTERPRET"


def device_kind(device=None) -> str:
    """The device kind routing keys on: the fake override, else 'cuda' for
    a CUDA device and 'cpu' for anything else."""
    fake = os.environ.get(FAKE_DEVICE_KIND_ENV)
    if fake:
        return fake.lower()
    if device is None:
        return "cpu"
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def resolve_lowering(lowering: Optional[str] = None) -> str:
    """Map a ``lowering`` request to the port's one lowering, 'portable'."""
    if lowering in (None, "auto", "portable"):
        return "portable"
    raise ValueError(
        f"lowering must be one of {LOWERINGS} (or None), got {lowering!r}; "
        "'mosaic' is the TPU-only spec of the JAX package")


def default_interpret(device=None) -> bool:
    """Interpret-mode auto-detect: True where no kernel runs (CPU tensors)
    or under ``REPRO_FORCE_INTERPRET=1``. An explicit ``interpret=``
    argument always wins over this."""
    if os.environ.get(FORCE_INTERPRET_ENV, "") not in ("", "0"):
        return True
    return device is None or torch.device(device).type != "cuda"


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered implementation of the rank-k modification protocol."""

    name: str
    fn: Callable
    kind: str  # 'serial' | 'blocked' | 'kernel'
    description: str
    # Whether ``fn`` takes a (B, n, n) fleet itself (one launch); the others
    # run member by member.
    batched: bool = False

    def __call__(self, L, V, *, sigma, panel, interpret, precision=None,
                 **opts):
        precision = Precision.parse(precision)
        if precision is not None:
            # Storage casts happen at the funnel: every backend sees inputs
            # already in the policy's storage dtype, and returns it.
            L = precision.cast_storage(L)
            V = precision.cast_storage(V)
        kw = dict(sigma=sigma, panel=panel, interpret=interpret,
                  precision=precision, **opts)
        if L.ndim == 3 and not self.batched:
            return torch.stack([self.fn(l, v, **kw) for l, v in zip(L, V)])
        return self.fn(L, V, **kw)


_REGISTRY: Dict[str, Backend] = {}


def register(name: str, *, kind: str, description: str,
             batched: bool = False):
    """Decorator registering ``fn`` as backend ``name``."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = Backend(name, fn, kind, description, batched)
        return fn

    return deco


def get(name: str) -> Backend:
    """Look up a backend; raises ValueError naming the valid set."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"method must be one of {methods()}, got {name!r}") from None


def names() -> Tuple[str, ...]:
    """Registered backend names, registration order."""
    return tuple(_REGISTRY)


def methods() -> Tuple[str, ...]:
    """Valid ``method=`` strings: every backend plus the 'auto' heuristic."""
    return names() + ("auto",)


def resolve(method: str, *, n: int, panel: int = 256,
            interpret: Optional[bool] = None, device=None) -> str:
    """Map ``method`` (possibly 'auto') to a concrete backend name.

    'auto' picks the single-launch ``fused`` chain on every kernel-capable
    device kind (CUDA tensors) or under explicit interpret mode; otherwise
    the serial oracle for problems under two panels and the transform-GEMM
    driver beyond.
    """
    if method != "auto":
        get(method)  # validate the name
        return method
    if device_kind(device) in PALLAS_DEVICE_KINDS or interpret:
        return "fused"
    if n < 2 * panel:
        return "reference"
    return "gemm"


def dispatch(L, V, *, sigma, method, panel, interpret, precision=None,
             **opts):
    """Resolve + run: the single funnel every update flows through.

    Records the resolve decision and the bandwidth model's bytes (times
    the fleet size) in the port's registry, labeled by backend, lowering,
    dtype and sign. Counts are per eager call.
    """
    n = L.shape[-1]
    name = resolve(method, n=n, panel=panel, interpret=interpret,
                   device=L.device)
    policy = Precision.parse(precision)
    storage_dt = L.dtype if policy is None else policy.storage_for(L.dtype)
    lowering = (resolve_lowering(opts.get("lowering")) if name == "fused"
                else "none")
    labels = dict(backend=name, structure="dense", lowering=lowering,
                  dtype=str(storage_dt).replace("torch.", ""),
                  sign="up" if sigma > 0 else "down")
    obs_metrics.counter("repro.backends.resolve", method=method,
                        **labels).inc()
    batch = L.shape[0] if L.ndim == 3 else 1
    # The kernel module imports this one: a module-level import would cycle.
    from repro_torch.kernels.fused import bytes_per_update

    obs_metrics.counter("repro.backends.bytes", **labels).inc(
        batch * bytes_per_update(n, panel, V.shape[-1],
                                 storage_dtype=storage_dt))
    return get(name)(L, V, sigma=sigma, panel=panel, interpret=interpret,
                     precision=precision, **opts)


# ---------------------------------------------------------------------------
# Registered implementations.
# ---------------------------------------------------------------------------


@register("reference", kind="serial",
          description="serial hyperbolic sweeps, O(k n^2) (paper Alg. 1)")
def _reference(L, V, *, sigma, panel, interpret, precision=None, **opts):
    del panel, interpret, opts
    from repro_torch.core import ref

    if precision is None:
        return ref.chol_update_ref(L, V, sigma=sigma)
    # No tile structure: the whole sweep runs in the accumulation dtype.
    out = ref.chol_update_ref(precision.up(L), precision.up(V), sigma=sigma)
    return precision.down(out, like=L)


@register("paper", kind="blocked",
          description="panelled, element-wise panel apply (paper §4)")
def _paper(L, V, *, sigma, panel, interpret, precision=None, **opts):
    del interpret, opts
    from repro_torch.core import blocked

    return blocked.chol_update_blocked(L, V, sigma=sigma, panel=panel,
                                       strategy="paper", precision=precision)


@register("gemm", kind="blocked",
          description="panelled, transform-GEMM panel apply")
def _gemm(L, V, *, sigma, panel, interpret, precision=None, **opts):
    del interpret, opts
    from repro_torch.core import blocked

    return blocked.chol_update_blocked(L, V, sigma=sigma, panel=panel,
                                       strategy="gemm", precision=precision)


@register("fused", kind="kernel", batched=True,
          description="single-launch fused chain: hand-written CUDA kernel "
                      "on CUDA tensors, its plain version on the CPU "
                      "(DESIGN.md §5)")
def _fused(L, V, *, sigma, panel, interpret, precision=None, **opts):
    from repro_torch.kernels import fused as kernel_fused

    return kernel_fused.chol_update_fused(L, V, sigma=sigma, panel=panel,
                                          interpret=interpret,
                                          precision=precision, **opts)
