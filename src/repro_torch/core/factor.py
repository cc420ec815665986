"""``CholFactor``: the maintained Cholesky factor, PyTorch port.

Port of ``repro.core.factor``. The factor absorbs rank-k modifications
without refactorization; this type holds the upper factor plus its
execution metadata (panel size, backend name, dtype policy, interpret
flag, lowering)::

    f = CholFactor.from_matrix(A)    # on CUDA unless A is a CPU tensor
    f = f.update(V)                  # A + V V^T, no refactorization
    f = f.downdate(V)                # A - V V^T
    x = f.solve(b)
    ld = f.logdet()

The JAX pytree becomes a frozen dataclass. ``data`` is a tensor, ``(n, n)``
or ``(B, n, n)`` (a fleet of per-user factors, one kernel launch per
update on the ``fused`` backend), or a structured storage
(``repro_torch.core.structure``): ``CholFactor.from_blocktridiag`` keeps
the O(n·b) factor of a block-tridiagonal matrix. The layout-specific
operations delegate to the storage.

With ``backend='sharded'`` and a ``mesh`` (a ``DeviceMesh``), the factor's
columns are sharded over ``axis`` of the mesh (``repro_torch.core
.distributed``): after the first update ``data`` is a ``DTensor``, and
every rank of the mesh calls each operation with the same arguments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import api, backends
from repro_torch.core import distributed as _distributed
from repro_torch.core import structure as _structure
from repro_torch.core.precision import Precision
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass(frozen=True)
class CholFactor:
    """Upper Cholesky factor (``A = L^T L``) + execution metadata.

    Attributes:
      data: (n, n) — or (B, n, n) batched — upper-triangular factor(s), or
        a structured storage such as ``BlockTriDiagStorage``.
      panel: row-panel size for the blocked/kernel backends.
      backend: registry name or 'auto' (resolved per call).
      interpret: None picks by device; True asks for the fused kernel's
        plain version (CPU tensors only).
      precision: storage/accum dtype policy (``Precision``, a preset string
        like 'bf16', or None = the factor's own dtype).
      lowering: fused lowering, None/'auto'/'portable'.
      mesh, axis: the ``DeviceMesh`` and the dim name (or tuple of names)
        the 'sharded' backend shards the columns over (None otherwise),
        for a factor or a fleet.
    """

    data: torch.Tensor
    panel: int = 256
    backend: str = "auto"
    interpret: Optional[bool] = None
    precision: Optional[Precision] = None
    lowering: Optional[str] = None
    mesh: Optional[object] = None
    axis: Union[str, Tuple[str, ...]] = "model"

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
        """Wrap an existing upper factor or storage (no validation)."""
        return cls(api.as_tensor(L, device), **meta)

    @classmethod
    def from_storage(cls, storage, **meta) -> "CholFactor":
        """Wrap a ``FactorStorage`` (dense storage unwraps to the tensor)."""
        return cls(storage.raw, **meta)

    @classmethod
    def from_blocktridiag(cls, Ad, Ao, *, device=None,
                          **meta) -> "CholFactor":
        """Factor a block-tridiagonal SPD matrix given as blocks.

        ``Ad``: (nb, b, b) diagonal blocks; ``Ao``: (nb-1, b, b)
        super-diagonal blocks ``A[j, j+1]`` (a leading fleet axis on both
        makes a fleet). O(nb·b³) work, O(n·b) memory: the (n, n) matrix is
        never formed. Tensors keep their device; anything else goes to
        ``device``, default CUDA.
        """
        Ad = api.as_tensor(Ad, device)
        Ao = api.as_tensor(Ao, Ad.device)
        return cls(_structure.BlockTriDiagStorage.from_matrix_blocks(Ad, Ao),
                   **meta)

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
    def storage(self) -> "_structure.FactorStorage":
        """The layout delegate (dense data gets wrapped, no copy; the
        columns of a sharded factor are gathered whole first, a
        collective)."""
        return _structure.as_storage(_distributed.gather(self.data))

    @property
    def structure(self) -> str:
        """'dense' or a structured layout name ('blocktridiag')."""
        return getattr(self.data, "structure", "dense")

    @property
    def n(self) -> int:
        return _structure.as_storage(self.data).n

    @property
    def batched(self) -> bool:
        return _structure.as_storage(self.data).batched

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
            structure=self.structure, backend=self.backend).inc()
        opts = {}
        if self.backend == "sharded":
            if self.mesh is None:
                raise ValueError("sharded backend requires a mesh binding "
                                 "(CholFactor(..., mesh=, axis=))")
            opts = {"mesh": self.mesh, "axis": self.axis}
        if self.lowering is not None and self.backend in ("auto", "fused",
                                                          "sharded"):
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

        On the sharded backend the verdict comes from the downdated
        factor's diagonal, which leaves the PD cone exactly when ``A - V
        V^T`` does: each rank checks the diagonal entries of the columns
        it owns and a MIN all_reduce over the axis makes one verdict, with
        no gather of the factor.
        """
        obs_metrics.counter("repro.core.guard_calls",
                            structure=self.structure,
                            backend=self.backend).inc()
        V = api.as_tensor(V, self.device)
        down = self.downdate(V)
        if self.backend == "sharded":
            ok = _distributed.diag_verdict(down.data, mesh=self.mesh,
                                           axis=self.axis)
            new = _distributed.where_sharded(ok, down.data, self.data,
                                             mesh=self.mesh, axis=self.axis)
            return dataclasses.replace(self, data=new), ok
        ok = self.downdate_feasible(V)
        if self.structure != "dense":
            # The verdict gates every block: scalar for one factor, (B,)
            # broadcast over each stack's block axes for a fleet.
            def pick(d, o):
                return torch.where(
                    ok.reshape(ok.shape + (1,) * (d.ndim - ok.ndim)), d, o)

            new = type(self.data)(pick(down.data.diag, self.data.diag),
                                  pick(down.data.off, self.data.off))
            return dataclasses.replace(self, data=new), ok
        mask = ok[..., None, None] if self.batched else ok
        new = torch.where(mask, down.data, self.data)
        return dataclasses.replace(self, data=new), ok

    def scale(self, alpha) -> "CholFactor":
        """Factor of ``alpha^2 * A``; only ``|alpha|`` matters, so a negative
        multiplier cannot flip the positive diagonal. Every block of a
        structured factor scales alike."""
        if self.structure != "dense":
            return dataclasses.replace(self, data=self.data.scale(alpha))
        return dataclasses.replace(self, data=self.data * abs(alpha))

    # -- consumer operations ------------------------------------------------
    # Layout-specific: delegated to the storage (repro_torch.core.structure).
    # A sharded factor is gathered whole first (``storage``), on every rank,
    # except for its diagonal (``diagonal``, ``is_valid``, ``logdet``).
    def solve(self, b):
        """Solve ``A x = b`` against the maintained factor (a sharded
        factor is gathered whole first)."""
        return self.storage.solve(api.as_tensor(b, self.device))

    def solve_triangular(self, b, *, trans: bool):
        """One triangular solve: ``L^T x = b`` (trans) or ``L x = b``."""
        return self.storage.solve_triangular(api.as_tensor(b, self.device),
                                             trans=trans)

    def logdet(self):
        """``log det A`` from the maintained diagonal (of a sharded factor,
        its diagonal alone is gathered)."""
        if _distributed.is_sharded(self.data):
            return 2.0 * torch.sum(torch.log(self.diagonal()), dim=-1)
        return self.storage.logdet()

    def downdate_feasible(self, V):
        """True where ``A - V V^T`` stays PD (per batch element)."""
        V = api.as_tensor(V, self.device)
        if V.dtype != self.dtype:
            V = V.to(self.dtype)
        return self.storage.downdate_feasible(V)

    def is_valid(self, *, tol: float = 0.0):
        """Strictly positive diagonal — the factor invariant."""
        if _distributed.is_sharded(self.data):
            return torch.all(self.diagonal() > tol, dim=-1)
        return self.storage.is_valid(tol=tol)

    def diagonal(self):
        """The factor's diagonal (sqrt of A's pivots), any layout; of a
        sharded factor each rank reads its own columns' entries and only
        the diagonal is gathered, O(n)."""
        if _distributed.is_sharded(self.data):
            return _distributed.diagonal(self.data,
                                         mesh=self.data.device_mesh,
                                         axis=self.axis)
        return self.storage.diagonal()

    def matrix(self):
        """Materialise ``A = L^T L`` (O(n^3) — diagnostics only; a sharded
        factor is gathered whole first)."""
        return self.storage.matrix()

    def __repr__(self):
        return (f"CholFactor({_structure.as_storage(self.data).describe()} "
                f"{self.dtype} on {self.device}, panel={self.panel}, "
                f"backend={self.backend!r})")


def resolve_backend_for(factor: CholFactor) -> str:
    """The concrete backend a factor's next mutation will run on."""
    return backends.resolve(factor.backend, n=factor.n, panel=factor.panel,
                            interpret=factor.interpret, device=factor.device,
                            structure=factor.structure)
