"""``CholFactor``: the maintained Cholesky factor, PyTorch port.

Port of ``repro.core.factor`` for dense data. The factor absorbs rank-k
modifications without refactorization; this type holds the upper factor
plus its execution metadata (panel size, backend name, dtype policy,
interpret flag, lowering)::

    f = CholFactor.from_matrix(A)    # on CUDA unless A is a CPU tensor
    f = f.update(V)                  # A + V V^T, no refactorization
    f = f.downdate(V)                # A - V V^T
    x = f.solve(b)
    ld = f.logdet()

The JAX pytree becomes a frozen dataclass holding one tensor. ``data`` may
be ``(B, n, n)`` — a fleet of per-user factors; every method batches over
the leading axis, and an update of the fleet is one kernel launch on the
``fused`` backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import api, backends
from repro_torch.core import solve as _solve
from repro_torch.core.precision import Precision
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass(frozen=True)
class CholFactor:
    """Upper Cholesky factor (``A = L^T L``) + execution metadata.

    Attributes:
      data: (n, n) — or (B, n, n) batched — upper-triangular factor(s).
      panel: row-panel size for the blocked/kernel backends.
      backend: registry name or 'auto' (resolved per call).
      interpret: None picks by device; True asks for the fused kernel's
        plain version (CPU tensors only).
      precision: storage/accum dtype policy (``Precision``, a preset string
        like 'bf16', or None = the factor's own dtype).
      lowering: fused lowering, None/'auto'/'portable'.
    """

    data: torch.Tensor
    panel: int = 256
    backend: str = "auto"
    interpret: Optional[bool] = None
    precision: Optional[Precision] = None
    lowering: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "precision", Precision.parse(self.precision))

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_matrix(cls, A, *, device=None, **meta) -> "CholFactor":
        """Factor an SPD matrix (O(n^3), once) into a maintained factor."""
        A = api.as_tensor(A, device)
        return cls(torch.linalg.cholesky(A).mT.contiguous(), **meta)

    @classmethod
    def from_factor(cls, L, *, device=None, **meta) -> "CholFactor":
        """Wrap an existing upper factor (no validation)."""
        return cls(api.as_tensor(L, device), **meta)

    @classmethod
    def identity(cls, n: int, *, scale: float = 1.0,
                 batch: Optional[int] = None, dtype=torch.float32,
                 device=None, **meta) -> "CholFactor":
        """Factor of ``scale * I`` — the canonical warm-start."""
        eye = math.sqrt(scale) * torch.eye(
            n, dtype=dtype, device=api.default_device(device))
        if batch is not None:
            eye = eye.expand(batch, n, n).contiguous()
        return cls(eye, **meta)

    # -- metadata views -----------------------------------------------------
    @property
    def structure(self) -> str:
        return "dense"

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def batched(self) -> bool:
        return self.data.ndim == 3

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def replace(self, **changes) -> "CholFactor":
        return dataclasses.replace(self, **changes)

    # -- the paper's operations --------------------------------------------
    def _mutate(self, V, sigma: int) -> "CholFactor":
        obs_metrics.counter(
            "repro.core.mutations",
            op="update" if sigma > 0 else "downdate",
            structure="dense", backend=self.backend).inc()
        opts = {}
        if self.lowering is not None and self.backend in ("auto", "fused"):
            opts["lowering"] = self.lowering
        V = api.as_tensor(V, self.device)
        fn = api.chol_update_batched if self.batched else api.chol_update
        new = fn(self.data, V, sigma=sigma, method=self.backend,
                 panel=self.panel, interpret=self.interpret,
                 precision=self.precision, **opts)
        return dataclasses.replace(self, data=new)

    def update(self, V) -> "CholFactor":
        """Absorb ``+ V V^T`` (rank k) without refactorization."""
        return self._mutate(V, 1)

    def downdate(self, V) -> "CholFactor":
        """Remove ``- V V^T`` (rank k) without refactorization."""
        return self._mutate(V, -1)

    def downdate_guarded(self, V):
        """Feasibility-guarded downdate: ``(factor', ok)``.

        ``factor'`` is the downdated factor where ``A - V V^T`` stays PD and
        the unchanged factor where it does not (``ok`` says which, per
        fleet member). Both branches are computed.
        """
        obs_metrics.counter("repro.core.guard_calls", structure="dense",
                            backend=self.backend).inc()
        V = api.as_tensor(V, self.device)
        down = self.downdate(V)
        ok = self.downdate_feasible(V)
        mask = ok[..., None, None] if self.batched else ok
        new = torch.where(mask, down.data, self.data)
        return dataclasses.replace(self, data=new), ok

    def scale(self, alpha) -> "CholFactor":
        """Factor of ``alpha^2 * A``; only ``|alpha|`` matters, so a negative
        multiplier cannot flip the positive diagonal."""
        return dataclasses.replace(self, data=self.data * abs(alpha))

    # -- consumer operations ------------------------------------------------
    def solve(self, b):
        """Solve ``A x = b`` against the maintained factor."""
        return _solve.chol_solve(self.data, api.as_tensor(b, self.device))

    def solve_triangular(self, b, *, trans: bool):
        """One triangular solve: ``L^T x = b`` (trans) or ``L x = b``."""
        return _solve.solve_triangular(self.data,
                                       api.as_tensor(b, self.device),
                                       trans=trans)

    def logdet(self):
        """``log det A`` from the maintained diagonal."""
        return _solve.chol_logdet(self.data)

    def downdate_feasible(self, V):
        """True where ``A - V V^T`` stays PD (per batch element)."""
        V = api.as_tensor(V, self.device)
        if V.dtype != self.dtype:
            V = V.to(self.dtype)
        return _solve.downdate_feasible(self.data, V)

    def is_valid(self, *, tol: float = 0.0):
        """Strictly positive diagonal — the factor invariant."""
        return _solve.is_positive_factor(self.data, tol=tol)

    def diagonal(self):
        """The factor's diagonal (sqrt of A's pivots)."""
        return torch.diagonal(self.data, dim1=-2, dim2=-1)

    def matrix(self):
        """Materialise ``A = L^T L`` (O(n^3) — diagnostics only)."""
        return self.data.mT @ self.data

    def __repr__(self):
        shape = "x".join(str(s) for s in self.data.shape)
        return (f"CholFactor({shape} {self.dtype} on {self.device}, "
                f"panel={self.panel}, backend={self.backend!r})")


def resolve_backend_for(factor: CholFactor) -> str:
    """The concrete backend a factor's next mutation will run on."""
    return backends.resolve(factor.backend, n=factor.n, panel=factor.panel,
                            interpret=factor.interpret, device=factor.device)
