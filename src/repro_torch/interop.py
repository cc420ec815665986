"""Carry factor state across from the JAX package and back.

The JAX package's ``CholFactor`` state is its ``data`` array plus its
metadata (panel, backend, precision preset, lowering). ``factor_from_numpy``
builds the port's ``CholFactor`` from that state as numpy values, and
``factor_to_numpy`` gives it back, so both packages can be driven from the
same state. A block-tridiagonal factor's state is its ``(diag, off)`` block
stacks (``BlockTriDiagStorage``), one factor or a fleet: pass the pair as
``data``, or use ``storage_from_numpy`` / ``storage_to_numpy``. A factor
of the ``sharded`` backend takes a ``DeviceMesh`` whose dim names are the
JAX mesh's axis names: its columns are sharded over ``axis`` on the way in
and gathered whole on the way out (on every rank). Nothing of the JAX
package is imported: numpy arrays and plain values cross the boundary.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import backends
from repro_torch.core import distributed
from repro_torch.core.factor import CholFactor
from repro_torch.core.precision import Precision
from repro_torch.core.structure import BlockTriDiagStorage

# The JAX package's lowerings: 'mosaic' is its TPU-only spec; the port's
# one lowering computes the same chain.
_JAX_LOWERINGS = (None, "auto", "mosaic", "portable")


def _precision_from(spec) -> Optional[Precision]:
    """A port policy from a preset/dtype spec, a ``(storage, accum)`` pair
    of dtype names, or any object with ``storage``/``accum`` attributes."""
    if spec is None or isinstance(spec, (str, Precision)):
        return Precision.parse(spec)
    if isinstance(spec, tuple):
        storage, accum = spec
    else:
        storage, accum = spec.storage, spec.accum
    return Precision(storage=None if storage is None else str(storage),
                     accum=str(accum))


def _to_tensor(data, device) -> torch.Tensor:
    arr = np.asarray(data)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16; the widening to fp32 is exact.
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # A copy: arrays exported by JAX are read-only views of its buffers.
    return torch.from_numpy(np.array(arr)).to(device)


def storage_from_numpy(diag, off, *, device=None) -> BlockTriDiagStorage:
    """The port's ``BlockTriDiagStorage`` from the JAX package's ``diag``
    and ``off`` block stacks as numpy arrays (4-D for a fleet). ``device``
    defaults to CUDA."""
    from repro_torch.core.api import default_device

    dev = default_device(device)
    return BlockTriDiagStorage(_to_tensor(diag, dev), _to_tensor(off, dev))


def storage_to_numpy(storage: BlockTriDiagStorage):
    """``(diag, off)`` as numpy arrays (bf16 widened to fp32, exactly)."""
    out = []
    for x in (storage.diag, storage.off):
        x = x.detach()
        out.append((x.float() if x.dtype == torch.bfloat16 else x)
                   .cpu().numpy())
    return tuple(out)


def factor_from_numpy(data, *, panel: int = 256, backend: str = "auto",
                      precision=None, lowering: Optional[str] = None,
                      interpret: Optional[bool] = None, device=None,
                      mesh=None, axis="model") -> CholFactor:
    """A port ``CholFactor`` from the JAX package's factor state.

    ``data`` is the dense array, or a ``(diag, off)`` pair for a
    block-tridiagonal factor. ``device`` defaults to CUDA (the port's
    rule); pass ``'cpu'`` to keep the state on the host. With ``mesh`` (a
    ``DeviceMesh``, whose device it is) the dense factor's columns are
    sharded over ``axis``, the JAX factor's axis metadata, for the
    ``sharded`` backend.
    """
    if backend not in backends.methods():
        raise ValueError(f"backend {backend!r} is not ported; the port's "
                         f"methods are {backends.methods()}")
    if lowering not in _JAX_LOWERINGS:
        raise ValueError(f"unknown lowering {lowering!r}")
    from repro_torch.core.api import default_device

    if mesh is not None:
        if isinstance(data, tuple):
            raise ValueError("a sharded factor is dense; got (diag, off)")
        state = distributed.shard(_to_tensor(data, distributed.mesh_device(
            mesh)), mesh, axis)
    elif isinstance(data, tuple):
        state = storage_from_numpy(*data, device=device)
    else:
        state = _to_tensor(data, default_device(device))
    return CholFactor(state, panel=panel,
                      backend=backend, interpret=interpret,
                      precision=_precision_from(precision),
                      lowering=None if lowering == "mosaic" else lowering,
                      mesh=mesh, axis=axis)


def factor_to_numpy(factor: CholFactor):
    """``(data, meta)``: the factor's array as numpy plus its metadata.

    ``data`` is the dense array (a sharded factor gathered whole), or the
    ``(diag, off)`` pair of a block-tridiagonal factor. bf16 data comes
    back widened to fp32 (exact); the precision entry is a ``(storage,
    accum)`` pair of dtype names, which ``factor_from_numpy`` and the JAX
    package's ``Precision(storage=, accum=)`` both take; ``axis`` is the
    sharded backend's axis binding.
    """
    if isinstance(factor.data, BlockTriDiagStorage):
        data = storage_to_numpy(factor.data)
    else:
        data = distributed.gather(factor.data).detach()
        data = (data.float() if data.dtype == torch.bfloat16
                else data).cpu().numpy()
    p = factor.precision
    prec = None if p is None else (
        None if p.storage is None else str(p.storage).replace("torch.", ""),
        str(p.accum).replace("torch.", ""))
    meta = dict(panel=factor.panel, backend=factor.backend, precision=prec,
                lowering=factor.lowering, axis=factor.axis)
    return data, meta
