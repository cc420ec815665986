"""Backend registry for rank-k Cholesky up/down-dating (DESIGN.md §7).

Port of ``repro.core.backends``. Every execution path of the modification
is a registered implementation of ONE protocol::

    update(L, V, *, sigma, panel, interpret, precision, **opts) -> L_new

``L`` is ``(n, n)``, a ``(B, n, n)`` fleet, or a structured storage
(``repro_torch.core.structure``); each backend declares the structures it
takes. Dense: the serial oracle ``reference``, the panelled drivers
``paper`` and ``gemm``, the per-panel kernel cascade ``pallas`` /
``pallas_gemm`` (2 n_panels - 1 launches) and the single-launch ``fused``
chain. Block-tridiagonal: the block-chain kernel ``blocktridiag`` and its
plain twin ``blocktridiag_ref``. Across ranks: the column-sharded driver
``sharded`` (``mesh=`` required; ``resolve('auto')`` never picks it). The
kernel backends launch their CUDA kernels on CUDA tensors and run their
plain versions on CPU tensors.

``resolve('auto')`` keys on the device kind of the factor's tensor: CUDA
(or any Pallas-capable kind the JAX package knows, or explicit interpret
mode) -> ``fused`` (dense) / ``blocktridiag`` (structured); otherwise
``reference`` under two panels and ``gemm`` beyond (dense) /
``blocktridiag_ref`` (structured).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import structure as _structure
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
    kind: str  # 'serial' | 'blocked' | 'kernel' | 'collective'
    description: str
    # Whether ``fn`` takes a fleet itself (one launch per sign block); the
    # others run member by member.
    batched: bool = False
    # Storage structures the backend takes (``repro_torch.core.structure``).
    structures: Tuple[str, ...] = ("dense",)

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
        structured = _structure.is_factor_storage(L)
        fleet = L.batched if structured else L.ndim == 3
        if fleet and not self.batched:
            if structured:
                return type(L).stack([self.fn(m, v, **kw)
                                      for m, v in zip(L.members(), V)])
            return torch.stack([self.fn(l, v, **kw) for l, v in zip(L, V)])
        return self.fn(L, V, **kw)


_REGISTRY: Dict[str, Backend] = {}


def register(name: str, *, kind: str, description: str,
             batched: bool = False, structures: Tuple[str, ...] = ("dense",)):
    """Decorator registering ``fn`` as backend ``name``."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = Backend(name, fn, kind, description, batched,
                                  tuple(structures))
        return fn

    return deco


def get(name: str) -> Backend:
    """Look up a backend; raises ValueError naming the valid set."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"method must be one of {methods()}, got {name!r}") from None


def names(structure: Optional[str] = None) -> Tuple[str, ...]:
    """Registered backend names, registration order; ``structure=`` keeps
    those that take that storage structure."""
    return tuple(name for name, b in _REGISTRY.items()
                 if structure is None or structure in b.structures)


def methods(structure: Optional[str] = None) -> Tuple[str, ...]:
    """Valid ``method=`` strings: every backend (for ``structure``, when
    given) plus the 'auto' heuristic, which resolves per structure."""
    return names(structure) + ("auto",)


def resolve(method: str, *, n: int, panel: int = 256,
            interpret: Optional[bool] = None, device=None,
            structure: str = "dense") -> str:
    """Map ``method`` (possibly 'auto') to a concrete backend name.

    An explicit ``method`` must take ``structure``: a dense-only backend
    asked to modify structured storage raises here, naming the valid set.

    Dense 'auto' picks the single-launch ``fused`` chain on every
    kernel-capable device kind (CUDA tensors) or under explicit interpret
    mode; otherwise the serial oracle for problems under two panels and the
    transform-GEMM driver beyond. Block-tridiagonal 'auto' picks the
    block-chain kernel ``blocktridiag`` in the same cases and its plain
    twin ``blocktridiag_ref`` otherwise.
    """
    if method != "auto":
        backend = get(method)  # validate the name first
        if structure not in backend.structures:
            raise ValueError(
                f"method {method!r} supports structures "
                f"{backend.structures}, not {structure!r}; valid methods "
                f"for {structure!r}: {methods(structure)}")
        return method
    kernel = device_kind(device) in PALLAS_DEVICE_KINDS or interpret
    if structure == "blocktridiag":
        return "blocktridiag" if kernel else "blocktridiag_ref"
    if kernel:
        return "fused"
    if n < 2 * panel:
        return "reference"
    return "gemm"


def modeled_bytes_per_update(*, structure: str, n: int, panel: int, k: int,
                             storage_dtype, nblocks: int = 0,
                             block: int = 0) -> int:
    """The bandwidth model for ONE rank-k modification, by layout: dense,
    every upper tile of the padded factor read and written once and V^T
    read once (``fused.bytes_per_update``); block-tridiagonal, the diag and
    padded off block stacks read and written and V^T read once
    (``blocktridiag.bytes_per_update``)."""
    # The kernel modules import this one: module-level imports would cycle.
    if structure == "blocktridiag":
        from repro_torch.kernels import blocktridiag

        return blocktridiag.bytes_per_update(nblocks, block, k,
                                             storage_dtype=storage_dtype)
    from repro_torch.kernels import fused

    return fused.bytes_per_update(n, panel, k, storage_dtype=storage_dtype)


def dispatch(L, V, *, sigma, method, panel, interpret, precision=None,
             **opts):
    """Resolve + run: the single funnel every update flows through.

    Records the resolve decision and the bandwidth model's bytes (times
    the fleet size) in the port's registry, labeled by backend, lowering,
    dtype and sign. Counts are per eager call.
    """
    structure = getattr(L, "structure", "dense")
    n = L.shape[-1] if structure == "dense" else L.n
    name = resolve(method, n=n, panel=panel, interpret=interpret,
                   device=L.device, structure=structure)
    policy = Precision.parse(precision)
    storage_dt = L.dtype if policy is None else policy.storage_for(L.dtype)
    lowering = (resolve_lowering(opts.get("lowering"))
                if name in ("fused", "sharded") else "none")
    labels = dict(backend=name, structure=structure, lowering=lowering,
                  dtype=str(storage_dt).replace("torch.", ""),
                  sign="up" if sigma > 0 else "down")
    obs_metrics.counter("repro.backends.resolve", method=method,
                        **labels).inc()
    if structure == "dense":
        batch = L.shape[0] if L.ndim == 3 else 1
    else:
        batch = L.batch or 1
    obs_metrics.counter("repro.backends.bytes", **labels).inc(
        batch * modeled_bytes_per_update(
            structure=structure, n=n, panel=panel, k=V.shape[-1],
            storage_dtype=storage_dt, nblocks=getattr(L, "nblocks", 0),
            block=getattr(L, "block", 0)))
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


@register("pallas", kind="kernel", batched=True,
          description="per-panel kernels (diagonal pass + element-wise "
                      "panel apply per panel): CUDA on CUDA tensors, their "
                      "plain versions on the CPU")
def _pallas(L, V, *, sigma, panel, interpret, precision=None, **opts):
    from repro_torch.kernels import ops as kernel_ops

    return kernel_ops.chol_update_pallas(L, V, sigma=sigma, panel=panel,
                                         strategy="paper",
                                         interpret=interpret,
                                         precision=precision, **opts)


@register("pallas_gemm", kind="kernel", batched=True,
          description="per-panel kernels (diagonal pass + transform-GEMM "
                      "panel apply per panel): CUDA on CUDA tensors, their "
                      "plain versions on the CPU")
def _pallas_gemm(L, V, *, sigma, panel, interpret, precision=None, **opts):
    from repro_torch.kernels import ops as kernel_ops

    return kernel_ops.chol_update_pallas(L, V, sigma=sigma, panel=panel,
                                         strategy="gemm",
                                         interpret=interpret,
                                         precision=precision, **opts)


@register("fused", kind="kernel", batched=True,
          description="single-launch fused chain: hand-written CUDA kernel "
                      "on CUDA tensors, its plain version on the CPU "
                      "(DESIGN.md §5)")
def _fused(L, V, *, sigma, panel, interpret, precision=None, **opts):
    from repro_torch.kernels import fused as kernel_fused

    return kernel_fused.chol_update_fused(L, V, sigma=sigma, panel=panel,
                                          interpret=interpret,
                                          precision=precision, **opts)


@register("blocktridiag", kind="kernel", batched=True,
          structures=("blocktridiag",),
          description="block-chain kernel for block-bidiagonal factors: one "
                      "launch per sign block for a factor or a fleet, "
                      "O(n*b) bytes (DESIGN.md §12)")
def _blocktridiag(L, V, *, sigma, panel, interpret, precision=None, **opts):
    del panel  # the chain's tile is the storage's block size
    opts.pop("lowering", None)  # one lowering; accepted and ignored
    from repro_torch.kernels import blocktridiag as kernel_btd

    return kernel_btd.chol_update_blocktridiag(L, V, sigma=sigma,
                                               interpret=interpret,
                                               precision=precision, **opts)


@register("blocktridiag_ref", kind="blocked", structures=("blocktridiag",),
          description="plain block chain (diagonal pass + transform-GEMM "
                      "apply per block), the twin of the block-chain kernel")
def _blocktridiag_ref(L, V, *, sigma, panel, interpret, precision=None,
                      **opts):
    del panel, interpret
    opts.pop("lowering", None)
    from repro_torch.core import structure

    return structure.chol_update_blocktridiag_ref(L, V, sigma=sigma,
                                                  precision=precision,
                                                  **opts)


@register("sharded", kind="collective", batched=True,
          description="column-sharded multi-rank driver: a chain phase of "
                      "diagonal passes, then one panel-phase kernel launch "
                      "per shard (DESIGN.md §4+§7); requires mesh=")
def _sharded(L, V, *, sigma, panel, interpret, precision=None, mesh=None,
             axis="model", **opts):
    if mesh is None:
        raise ValueError("method='sharded' requires a mesh= argument")
    opts.pop("lowering", None)  # one lowering, validated by dispatch
    from repro_torch.core import distributed

    return distributed.chol_update_sharded(L, V, sigma=sigma, mesh=mesh,
                                           axis=axis, panel=panel,
                                           interpret=interpret,
                                           precision=precision, **opts)
