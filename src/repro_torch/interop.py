"""Carry factor state across from the JAX package and back.

The JAX package's ``CholFactor`` state is its ``data`` array plus its
metadata (panel, backend, precision preset, lowering). ``factor_from_numpy``
builds the port's ``CholFactor`` from that state as numpy values, and
``factor_to_numpy`` gives it back, so both packages can be driven from the
same state. Nothing of the JAX package is imported: numpy arrays and plain
values cross the boundary.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import backends
from repro_torch.core.factor import CholFactor
from repro_torch.core.precision import Precision

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


def factor_from_numpy(data, *, panel: int = 256, backend: str = "auto",
                      precision=None, lowering: Optional[str] = None,
                      interpret: Optional[bool] = None,
                      device=None) -> CholFactor:
    """A port ``CholFactor`` from the JAX package's factor state.

    ``device`` defaults to CUDA (the port's rule); pass ``'cpu'`` to keep
    the state on the host.
    """
    if backend not in backends.methods():
        raise ValueError(f"backend {backend!r} is not ported; the port's "
                         f"methods are {backends.methods()}")
    if lowering not in _JAX_LOWERINGS:
        raise ValueError(f"unknown lowering {lowering!r}")
    from repro_torch.core.api import default_device

    return CholFactor(_to_tensor(data, default_device(device)), panel=panel,
                      backend=backend, interpret=interpret,
                      precision=_precision_from(precision),
                      lowering=None if lowering == "mosaic" else lowering)


def factor_to_numpy(factor: CholFactor):
    """``(data, meta)``: the factor's array as numpy plus its metadata.

    bf16 data comes back widened to fp32 (exact); the precision entry is a
    ``(storage, accum)`` pair of dtype names, which ``factor_from_numpy``
    and the JAX package's ``Precision(storage=, accum=)`` both take.
    """
    data = factor.data.detach()
    if data.dtype == torch.bfloat16:
        data = data.float()
    p = factor.precision
    prec = None if p is None else (
        None if p.storage is None else str(p.storage).replace("torch.", ""),
        str(p.accum).replace("torch.", ""))
    meta = dict(panel=factor.panel, backend=factor.backend, precision=prec,
                lowering=factor.lowering)
    return data.cpu().numpy(), meta
