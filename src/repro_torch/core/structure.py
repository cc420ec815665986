"""Storage-structure layer: the factor's layout as an object (DESIGN.md §12).

Port of ``repro.core.structure``. ``CholFactor`` delegates every
layout-specific operation to a storage:

* ``DenseStorage`` — the ``(n, n)`` / ``(B, n, n)`` tensor layout;
* ``BlockTriDiagStorage`` — the upper block-BIdiagonal factor of a
  block-tridiagonal SPD matrix (Kalman smoothing, banded normal
  equations): ``(nb, b, b)`` diagonal blocks plus ``(nb-1, b, b)`` coupling
  blocks, O(n·b) memory for ``n = nb·b``. A leading axis makes a fleet.

Upper convention, ``A = Uᵀ U``. For block-tridiagonal ``A`` with diagonal
blocks ``Ad[j]`` and super-diagonal blocks ``Ao[j] = A[j, j+1]`` the factor
follows the chain (Schwan et al., transposed to the upper convention)::

    S_0     = Ad[0]
    diag[j] = chol_upper(S_j)
    off[j]  = diag[j]^{-T} Ao[j]
    S_{j+1} = Ad[j+1] - off[j]^T off[j]

A modification ``A ± V Vᵀ`` keeps the factor block-bidiagonal iff every
column of ``V`` is supported inside one adjacent block-row pair
(``assert_blocklocal``); ``repro_torch.kernels.blocktridiag`` has the
dependency argument. Nothing here forms an ``(n, n)`` matrix except
``to_dense`` and ``matrix`` (diagnostics).
"""
from __future__ import annotations

import dataclasses
from typing import List, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import solve as _solve
from repro_torch.core.precision import Precision


@runtime_checkable
class FactorStorage(Protocol):
    """What ``CholFactor`` requires of a storage layout: ``structure``
    (the key backends declare support for), the metadata views ``n``,
    ``batched``, ``dtype``, ``device`` and ``raw`` (what ``CholFactor.data``
    holds: the bare tensor for dense, the storage itself otherwise), and the
    layout-specific operations."""

    structure: str

    @property
    def n(self) -> int: ...

    @property
    def batched(self) -> bool: ...

    @property
    def dtype(self): ...

    @property
    def raw(self): ...

    def diagonal(self): ...

    def solve(self, b): ...

    def solve_triangular(self, b, *, trans: bool): ...

    def logdet(self): ...

    def is_valid(self, *, tol: float = 0.0): ...

    def downdate_gram(self, V): ...

    def downdate_feasible(self, V): ...

    def matrix(self): ...

    def to_dense(self): ...

    def astype(self, dtype): ...


@dataclasses.dataclass(frozen=True)
class DenseStorage:
    """The ``(n, n)`` / ``(B, n, n)`` tensor layout; torch's solves batch
    over the leading axis."""

    data: torch.Tensor

    structure = "dense"

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def batched(self) -> bool:
        return self.data.ndim == 3

    @property
    def batch(self):
        """Fleet size when batched, else None."""
        return self.data.shape[0] if self.data.ndim == 3 else None

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def raw(self):
        return self.data

    def diagonal(self):
        return torch.diagonal(self.data, dim1=-2, dim2=-1)

    def solve(self, b):
        return _solve.chol_solve(self.data, b)

    def solve_triangular(self, b, *, trans: bool):
        return _solve.solve_triangular(self.data, b, trans=trans)

    def logdet(self):
        return _solve.chol_logdet(self.data)

    def is_valid(self, *, tol: float = 0.0):
        return _solve.is_positive_factor(self.data, tol=tol)

    def downdate_gram(self, V):
        return _solve.downdate_gram(self.data, V)

    def downdate_feasible(self, V):
        return _solve.gram_verdict(self.downdate_gram(V))

    def matrix(self):
        return self.data.mT @ self.data

    def to_dense(self):
        return self.data

    def astype(self, dtype):
        return DenseStorage(self.data.to(dtype))

    def describe(self) -> str:
        return "x".join(str(s) for s in self.data.shape)


@dataclasses.dataclass(frozen=True)
class BlockTriDiagStorage:
    """Upper block-bidiagonal factor of a block-tridiagonal SPD matrix.

    Attributes:
      diag: ``(nb, b, b)`` upper-triangular diagonal blocks ``U[j, j]``, or
        ``(B, nb, b, b)`` for a fleet of B factors.
      off: ``(nb-1, b, b)`` coupling blocks ``U[j, j+1]``, or
        ``(B, nb-1, b, b)``.
    """

    diag: torch.Tensor
    off: torch.Tensor

    structure = "blocktridiag"

    def __post_init__(self):
        d, o = tuple(self.diag.shape), tuple(self.off.shape)
        if len(d) not in (3, 4) or d[-1] != d[-2]:
            raise ValueError(f"diag must be (nb, b, b) or (B, nb, b, b), "
                             f"got {d}")
        if (len(o) != len(d) or o[-2:] != d[-2:] or o[-3] != d[-3] - 1
                or o[:-3] != d[:-3]):
            raise ValueError(
                f"off must be (..., nb-1, b, b) matching diag {d}, got {o}")
        if self.off.dtype != self.diag.dtype or (
                self.off.device != self.diag.device):
            raise ValueError("diag and off must share dtype and device, got "
                             f"{self.diag.dtype}/{self.diag.device} and "
                             f"{self.off.dtype}/{self.off.device}")

    # -- metadata views -----------------------------------------------------
    @property
    def nblocks(self) -> int:
        return self.diag.shape[-3]

    @property
    def block(self) -> int:
        return self.diag.shape[-1]

    @property
    def n(self) -> int:
        return self.nblocks * self.block

    @property
    def batched(self) -> bool:
        return self.diag.ndim == 4

    @property
    def batch(self):
        """Fleet size when batched, else None."""
        return self.diag.shape[0] if self.batched else None

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    @property
    def requires_grad(self) -> bool:
        return self.diag.requires_grad or self.off.requires_grad

    @property
    def raw(self):
        return self

    def members(self) -> List["BlockTriDiagStorage"]:
        """The fleet's members as single storages (views)."""
        if not self.batched:
            raise ValueError(f"not a fleet: {self.describe()}")
        return [BlockTriDiagStorage(d, o) for d, o in zip(self.diag,
                                                          self.off)]

    @classmethod
    def stack(cls, members) -> "BlockTriDiagStorage":
        """A fleet from single storages of one layout."""
        return cls(torch.stack([m.diag for m in members]),
                   torch.stack([m.off for m in members]))

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_matrix_blocks(cls, Ad, Ao) -> "BlockTriDiagStorage":
        """Factor block-tridiagonal SPD blocks by the chain above.

        ``Ad``: (..., nb, b, b) diagonal blocks; ``Ao``: (..., nb-1, b, b)
        super-diagonal blocks ``A[j, j+1]``. O(nb·b³) work, O(n·b) memory.
        """
        Ad = torch.as_tensor(Ad)
        Ao = torch.as_tensor(Ao, device=Ad.device)
        nb = Ad.shape[-3]
        diag, off = [], []
        S = Ad[..., 0, :, :]
        infos = []
        for j in range(nb):
            C, info = torch.linalg.cholesky_ex(S)
            infos.append(info)
            U = C.mT
            diag.append(U)
            if j + 1 == nb:
                break
            o = torch.linalg.solve_triangular(C, Ao[..., j, :, :],
                                              upper=False)
            off.append(o)
            S = Ad[..., j + 1, :, :] - o.mT @ o
        if bool(torch.stack(infos).any()):
            raise ValueError("the block-tridiagonal matrix is not positive "
                             "definite (a chain pivot block failed)")
        off_t = (torch.stack(off, dim=-3) if off else
                 Ad.new_zeros(Ad.shape[:-3] + (0,) + Ad.shape[-2:]))
        return cls(torch.stack(diag, dim=-3), off_t)

    @classmethod
    def from_dense(cls, L, block: int) -> "BlockTriDiagStorage":
        """Slice an (..., n, n) upper block-bidiagonal factor into blocks;
        entries outside the two block diagonals are dropped."""
        n = L.shape[-1]
        if n % block:
            raise ValueError(f"block {block} does not divide n={n}")
        nb = n // block
        blk = lambda r, c: L[..., r * block:(r + 1) * block,
                             c * block:(c + 1) * block]
        diag = torch.stack([blk(j, j) for j in range(nb)], dim=-3)
        if nb > 1:
            off = torch.stack([blk(j, j + 1) for j in range(nb - 1)],
                              dim=-3)
        else:
            off = L.new_zeros(L.shape[:-2] + (0, block, block))
        return cls(diag.contiguous(), off.contiguous())

    @classmethod
    def identity(cls, nb: int, block: int, *, scale: float = 1.0,
                 dtype=torch.float32, batch=None,
                 device=None) -> "BlockTriDiagStorage":
        """Factor of ``scale * I`` in block form; ``batch=B`` makes a
        fleet of B identical members."""
        eye = float(np.sqrt(scale)) * torch.eye(block, dtype=dtype,
                                                device=device)
        lead = () if batch is None else (batch,)
        diag = eye.expand(lead + (nb, block, block)).contiguous()
        off = torch.zeros(lead + (max(nb - 1, 0), block, block), dtype=dtype,
                          device=device)
        return cls(diag, off)

    # -- densification (diagnostics only) -----------------------------------
    def to_dense(self):
        """The (..., n, n) upper factor: O(n²) memory, diagnostics only; the
        modification path never calls this."""
        b, nb = self.block, self.nblocks
        out = self.diag.new_zeros(self.diag.shape[:-3] + (self.n, self.n))
        for j in range(nb):
            out[..., j * b:(j + 1) * b, j * b:(j + 1) * b] = \
                self.diag[..., j, :, :]
        for j in range(nb - 1):
            out[..., j * b:(j + 1) * b, (j + 1) * b:(j + 2) * b] = \
                self.off[..., j, :, :]
        return out

    def matrix(self):
        """Materialise ``A = Uᵀ U`` (O(n²), diagnostics only)."""
        U = self.to_dense()
        return U.mT @ U

    def matrix_blocks(self):
        """``(Ad, Ao)`` of ``A = Uᵀ U`` in block form, O(n·b)."""
        ad = self.diag.mT @ self.diag
        if self.nblocks > 1:
            ad[..., 1:, :, :] += self.off.mT @ self.off
        ao = self.diag[..., :-1, :, :].mT @ self.off
        return ad, ao

    # -- layout-specific operations -----------------------------------------
    def diagonal(self):
        d = torch.diagonal(self.diag, dim1=-2, dim2=-1)
        return d.reshape(d.shape[:-2] + (-1,))

    def solve_triangular(self, b, *, trans: bool):
        """``Uᵀ x = b`` (trans) or ``U x = b`` by block substitution.

        Forward (trans): ``y_j = U_jj^{-T} (b_j - off_{j-1}ᵀ y_{j-1})``.
        Backward:        ``x_j = U_jj^{-1} (y_j - off_j x_{j+1})``.
        ``b`` is (..., n) or (..., n, m) with the storage's batch axis in
        front; O(nb·b²·m) work, never an (n, n) operand.
        """
        lead = self.diag.shape[:-3]
        vec = b.ndim == len(lead) + 1
        if b.shape[len(lead)] != self.n:
            raise ValueError(f"rhs length {b.shape[len(lead)]} != "
                             f"n={self.n}")
        out_dtype = self.dtype
        diag, off = self.diag, self.off
        if diag.dtype.itemsize < 4:
            # torch has no 16-bit triangular solve: solve in fp32.
            diag, off = diag.float(), off.float()
        rhs = (b[..., None] if vec else b).to(diag.dtype)
        nb, bs = self.nblocks, self.block
        rhs = rhs.reshape(lead + (nb, bs, rhs.shape[-1]))
        st = torch.linalg.solve_triangular
        out = [None] * nb
        if trans:
            for j in range(nb):
                r = rhs[..., j, :, :]
                if j:
                    r = r - off[..., j - 1, :, :].mT @ out[j - 1]
                out[j] = st(diag[..., j, :, :].mT, r, upper=False)
        else:
            for j in reversed(range(nb)):
                r = rhs[..., j, :, :]
                if j + 1 < nb:
                    r = r - off[..., j, :, :] @ out[j + 1]
                out[j] = st(diag[..., j, :, :], r, upper=True)
        x = torch.stack(out, dim=-3).reshape(lead + (self.n, -1))
        return (x[..., 0] if vec else x).to(out_dtype)

    def solve(self, b):
        y = self.solve_triangular(b, trans=True)
        return self.solve_triangular(y, trans=False)

    def logdet(self):
        return 2.0 * torch.sum(torch.log(self.diagonal()), dim=-1)

    def is_valid(self, *, tol: float = 0.0):
        return torch.all(self.diagonal() > tol, dim=-1)

    def downdate_gram(self, V):
        """``I - PᵀP`` for ``Uᵀ P = V`` (``downdate_feasible``'s matrix); the
        forward substitution keeps it O(n·b·k), with no host
        synchronisation. A fleet takes (B, n, k) and gives (B, k, k)."""
        if V.ndim == len(self.diag.shape[:-3]) + 1:
            V = V[..., None]
        P = self.solve_triangular(V, trans=True)
        if P.dtype.itemsize < 4:
            P = P.float()
        return torch.eye(V.shape[-1], dtype=P.dtype, device=P.device) - \
            P.mT @ P

    def downdate_feasible(self, V):
        """``I - PᵀP`` PD for ``Uᵀ P = V``, as the dense path decides it. A
        fleet takes (B, n, k) and returns (B,) verdicts."""
        return _solve.gram_verdict(self.downdate_gram(V))

    def astype(self, dtype):
        return BlockTriDiagStorage(self.diag.to(dtype), self.off.to(dtype))

    def to(self, *args, **kwargs):
        """``Tensor.to`` on both block stacks (dtype and/or device)."""
        return BlockTriDiagStorage(self.diag.to(*args, **kwargs),
                                   self.off.to(*args, **kwargs))

    def scale(self, alpha) -> "BlockTriDiagStorage":
        """Factor of ``alpha² A``: every block scales by ``|alpha|``
        (``scaled``)."""
        return BlockTriDiagStorage(scaled(self.diag, alpha),
                                   scaled(self.off, alpha))

    def describe(self) -> str:
        if self.batched:
            return f"blocktridiag[{self.batch}x{self.nblocks}x{self.block}]"
        return f"blocktridiag[{self.nblocks}x{self.block}]"


def scaled(x, alpha):
    """``x * |alpha|``. A 16-bit ``x`` is multiplied in fp32 and rounded once,
    whether ``alpha`` is a Python number or a tensor (a 0-d fp32 tensor
    would otherwise be rounded to ``x``'s dtype first)."""
    a = abs(alpha)
    if x.dtype.itemsize < 4:
        return (x.float() * a).to(x.dtype)
    return x * a


#: Storage classes the layer knows about.
STORAGE_CLASSES = (DenseStorage, BlockTriDiagStorage)


def is_factor_storage(x) -> bool:
    """True for storage objects (raw tensors are dense data)."""
    return isinstance(x, STORAGE_CLASSES)


def as_storage(data) -> FactorStorage:
    """The delegation view of a ``CholFactor.data`` value."""
    if is_factor_storage(data):
        return data
    return DenseStorage(data)


def _blocklocal_error(m, first, last):
    return ValueError(
        f"column {m} of V spans block rows {first}..{last}; the "
        "block-tridiagonal modification contract allows one adjacent pair "
        "(A ± v v^T would leave the storage class)")


def _host(V):
    if isinstance(V, torch.Tensor):
        V = V.detach().cpu()
        if V.dtype == torch.bfloat16:
            V = V.float()
        return V.numpy()
    return np.asarray(V)


def assert_blocklocal(V, block: int):
    """Host-side check of the structured modification contract: each
    column of ``V`` must be supported inside one adjacent block-row pair
    ``{j, j+1}`` for ``A ± V Vᵀ`` to stay block-tridiagonal."""
    V = _host(V)
    if V.ndim == 1:
        V = V[:, None]
    for m in range(V.shape[1]):
        nz = np.nonzero(V[:, m])[0]
        if nz.size == 0:
            continue
        first, last = int(nz[0]) // block, int(nz[-1]) // block
        if last - first > 1:
            raise _blocklocal_error(m, first, last)


def anchor_block(v, block: int):
    """The first block row a block-local rank-1 row touches (a row on pair
    {j, j+1} anchors at j), or None for an all-zero row. Raises like
    ``assert_blocklocal``."""
    v = _host(v).reshape(-1)
    nz = np.nonzero(v)[0]
    if nz.size == 0:
        return None
    first, last = int(nz[0]) // block, int(nz[-1]) // block
    if last - first > 1:
        raise _blocklocal_error(0, first, last)
    return first


def chol_update_blocktridiag_ref(S, V, *, sigma: int = 1, precision=None,
                                 **_ignored):
    """Plain block-chain rank-k up/down-date of one structured factor, the
    twin of the JAX package's ``lax.scan`` reference.

    Walks the block chain as the dense blocked driver walks panels: the
    diagonal pass on block j annihilates ``V^T`` slab j and emits the
    transform ``T``; the GEMM apply transforms the one trailing tile the
    structure has, ``off[j]``, together with slab j+1, which carries the
    cascade to block j+1. O(k·b²·nb) work; never forms an (n, n) matrix.
    """
    from repro_torch.core import blocked

    if sigma not in (1, -1):
        raise ValueError(f"sigma must be +1 or -1, got {sigma}")
    precision = Precision.parse(precision)
    if precision is not None:
        S = precision.cast_storage(S)
        V = precision.cast_storage(V)
    up = (lambda x: x) if precision is None else precision.up
    if V.ndim == 1:
        V = V[:, None]
    nb, b = S.nblocks, S.block
    k = V.shape[1]
    store = S.dtype
    slabs = V.mT.reshape(k, nb, b).transpose(0, 1)  # (nb, k, b)
    diag_new, off_new = [], []
    slab = slabs[0]
    for j in range(nb):
        D_new, _c, _s, T = blocked.panel_diag(up(S.diag[j]), up(slab), sigma,
                                              with_transform=True)
        diag_new.append(D_new.to(store))
        if j + 1 == nb:
            break
        R_new, nxt = blocked.panel_apply_gemm(up(S.off[j]), up(slabs[j + 1]),
                                              T)
        off_new.append(R_new.to(store))
        slab = nxt.to(store)
    off_t = (torch.stack(off_new) if off_new else S.off.clone())
    return BlockTriDiagStorage(torch.stack(diag_new), off_t)
