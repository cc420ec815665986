"""Carry factor state across from the JAX package and back.

The JAX package's ``CholFactor`` state is its ``data`` array plus its
metadata (panel, backend, precision preset, lowering). ``factor_from_numpy``
builds the port's ``CholFactor`` from that state as numpy values, and
``factor_to_numpy`` gives it back, so both packages can be driven from the
same state. A block-tridiagonal factor's state is its ``(diag, off)`` block
stacks (``BlockTriDiagStorage``), one factor or a fleet: pass the pair as
``data``, or use ``storage_from_numpy`` / ``storage_to_numpy``. An optimizer's state
(``cholesky_precond``, ``adamw``, ``sgd``) crosses with
``optimizer_state_from_numpy`` / ``optimizer_state_to_numpy``. A model's
parameters, decoder-only or encoder-decoder, cross with
``params_from_numpy`` / ``params_to_numpy`` (the JAX package's
``split_params(init_model(...))[0]`` tree, each stack of layers on a
leading axis), its decode cache with ``cache_from_numpy`` /
``cache_to_numpy``, and a training state ``{"values", "opt"}`` with
``train_state_from_numpy`` / ``train_state_to_numpy``. A factor
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

# The JAX package's lowerings, which the port takes as they are.
_JAX_LOWERINGS = (None,) + backends.LOWERINGS


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
                      lowering=lowering,
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


# ---------------------------------------------------------------------------
# Optimizer state.
# ---------------------------------------------------------------------------


def _array_to_numpy(x):
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def optimizer_state_from_numpy(state, *, device=None):
    """The port's optimizer state from the JAX package's, as numpy.

    ``state`` is the JAX state dict with every array as numpy: ``step``,
    the moment trees (``m``, ``v``; ``mu`` for sgd) and, for
    ``cholesky_precond``, ``factors``: a tree holding, at each parameter,
    None or ``{"c": (data, meta), "ring": array}`` (``ring`` with a window
    only), ``(data, meta)`` as ``factor_to_numpy`` gives them. Trees are
    nested dicts and lists. ``device`` defaults to CUDA.
    """
    from repro_torch.core.api import default_device
    from repro_torch.optim.base import flatten_up_to, tree_map, unflatten

    dev = default_device(device)
    out = {"step": int(np.asarray(state["step"]))}
    moments = [k for k in ("m", "v", "mu") if k in state]
    for key in moments:
        out[key] = tree_map(lambda a: _to_tensor(a, dev), state[key])
    if "factors" in state:
        def fac(sub):
            if sub is None:
                return None
            data, meta = sub["c"]
            new = {"c": factor_from_numpy(data, device=dev, **meta)}
            if "ring" in sub:
                new["ring"] = _to_tensor(sub["ring"], dev)
            return new

        shape = state[moments[0]]
        out["factors"] = unflatten(shape, [
            fac(sub) for sub in flatten_up_to(shape, state["factors"])])
    return out


def optimizer_state_to_numpy(state):
    """The inverse of ``optimizer_state_from_numpy``: the port's state as
    numpy arrays (bf16 widened to fp32, exactly), each factor as
    ``factor_to_numpy``'s ``(data, meta)``."""
    from repro_torch.optim.base import flatten_up_to, tree_map, unflatten

    out = {"step": np.asarray(state["step"], np.int32)}
    moments = [k for k in ("m", "v", "mu") if k in state]
    for key in moments:
        out[key] = tree_map(_array_to_numpy, state[key])
    if "factors" in state:
        def fac(sub):
            if sub is None:
                return None
            new = {"c": factor_to_numpy(sub["c"])}
            if "ring" in sub:
                new["ring"] = _array_to_numpy(sub["ring"])
            return new

        shape = state[moments[0]]
        out["factors"] = unflatten(shape, [
            fac(sub) for sub in flatten_up_to(shape, state["factors"])])
    return out


# ---------------------------------------------------------------------------
# LM parameters and decode caches.
# ---------------------------------------------------------------------------


def params_from_numpy(values, cfg, *, device=None):
    """The port's model (``models.transformer.LM``, or
    ``models.encdec.EncDec`` for ``family == 'encdec'``) holding the JAX
    package's parameter values: ``values`` is its ``split_params(...)[0]``
    tree with every leaf as a numpy array, each stack of layers on a
    leading axis. The tree's keys and every leaf's shape must be the
    model's; a leaf's dtype becomes the parameter's (fp32 values widened
    from bf16 come back exact). ``device`` defaults to CUDA."""
    from repro_torch.core.api import default_device
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import LM

    dev = default_device(device)
    model = (EncDec if cfg.family == "encdec" else LM)(cfg, device=dev)

    def load(node, tree, index, path):
        names = set(node.axes) | set(node._modules)
        if set(tree) != names:
            raise ValueError(f"{path or 'params'}: keys {sorted(tree)} are "
                             f"not the model's {sorted(names)}")
        for name in node.axes:
            arr = np.asarray(tree[name])
            if index is not None:
                arr = arr[index]
            dst = getattr(node, name)
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{path}/{name}: shape {arr.shape}, the "
                                 f"model's {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(_to_tensor(arr, dev))
        for name, m in node._modules.items():
            load(m, tree[name], index, f"{path}/{name}")

    names = set(model._modules)
    if set(values) != names:
        raise ValueError(f"params: keys {sorted(values)} are not the "
                         f"model's {sorted(names)}")
    for name, m in model._modules.items():
        if name in model.stacked:
            for i, lp in enumerate(m):
                load(lp, values[name], i, f"{name}[{i}]")
        else:
            load(m, values[name], None, name)
    return model


def params_to_numpy(model) -> dict:
    """The model's parameters as the JAX package's values tree of numpy
    arrays: each stack of layers on a leading axis, bf16 widened to fp32
    (exactly)."""
    from repro_torch.models.transformer import values

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _array_to_numpy(t)

    return conv(values(model))


def train_state_from_numpy(state, cfg, *, device=None) -> dict:
    """A training state ``{"values": model, "opt": optimizer state}`` from
    the JAX package's ``{"values", "opt"}`` as numpy (``values`` as
    ``params_from_numpy`` takes it, ``opt`` as
    ``optimizer_state_from_numpy`` does)."""
    return {"values": params_from_numpy(state["values"], cfg, device=device),
            "opt": optimizer_state_from_numpy(state["opt"], device=device)}


def train_state_to_numpy(state) -> dict:
    """The inverse of ``train_state_from_numpy``."""
    return {"values": params_to_numpy(state["values"]),
            "opt": optimizer_state_to_numpy(state["opt"])}


def cache_from_numpy(cache, *, device=None) -> dict:
    """A decode cache from the JAX package's (a dict of numpy arrays,
    ``pos`` a scalar): tensors on ``device`` (default CUDA), ``pos`` a 0-d
    int32 tensor."""
    from repro_torch.core.api import default_device

    dev = default_device(device)
    out = {}
    for name, arr in cache.items():
        if name == "pos":
            out[name] = torch.tensor(int(np.asarray(arr)), dtype=torch.int32,
                                     device=dev)
        else:
            out[name] = _to_tensor(arr, dev)
    return out


def cache_to_numpy(cache) -> dict:
    """The inverse of ``cache_from_numpy`` (bf16 widened to fp32): a copy,
    since a decode step writes its cache in place."""
    return {name: (np.asarray(int(t), np.int32) if name == "pos"
                   else np.array(_array_to_numpy(t)))
            for name, t in cache.items()}
