"""Checkpointing of named tensors: atomic on-disk saves, resume.

Port of ``repro.checkpoint.checkpoint`` with the same on-disk format, so
each package reads the other's checkpoints. One directory per step
(``step_00000123/``) holding

* ``tree.json``  — per-leaf metadata (name, key, shape, dtype name) and the
  caller's ``extra`` dict,
* ``arrays.npz`` — every leaf as raw bytes (a flat uint8 array),
* ``DONE``       — commit marker written last (readers ignore directories
  without it; a crash mid-write leaves no valid-looking junk).

A tree of dicts (and lists) takes the pytree's place, under the leaf
names the JAX package's pytree paths give:

* torch tensors (any device; gathered to the host, a ``DTensor`` gathered
  whole on every rank and written by rank 0) and numpy arrays;
* a ``BlockTriDiagStorage``: its two block stacks, ``<name>/0`` (diag) and
  ``<name>/1`` (off);
* a ``CholFactor``: its ``data`` as its one child, ``<name>/0`` (the JAX
  package's pytree flattening of the class);
* a Python int (an optimizer's host step): a 0-d int32 array, as the JAX
  package stores its step;
* None: no leaf, as in JAX (an optimizer state's leaves that hold no
  factor).

So a training state ``{"values": models.values_tree(model), "opt":
optimizer state}`` is written under the names the JAX package writes for
its own (``values/layers/attn/wq``, ``opt/m/...``,
``opt/factors/.../c/0``, ``opt/step``), and each package restores the
other's. ``restore`` copies each leaf into the tensor its template holds
there, so restoring into a model's values tree loads the model. Dtype
names are numpy's (``float32``, ``float64``, ``bfloat16``): bfloat16
leaves are written and read by viewing their bytes as a torch tensor, so
neither side needs ``ml_dtypes`` here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.structure import BlockTriDiagStorage

_STEP_RE = re.compile(r"^step_(\d+)$")

#: Dtype names numpy cannot parse without ml_dtypes, read through torch.
_TORCH_ONLY = {"bfloat16": torch.bfloat16}


def np_dtype_for(name: str) -> np.dtype:
    """Resolve a stored dtype name to a numpy dtype. ``bfloat16`` has no
    numpy dtype without ``ml_dtypes``, which the port does not use: it
    raises here, and ``torch_dtype_for`` resolves it."""
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(
            f"dtype {name!r} has no numpy dtype without ml_dtypes; use "
            "torch_dtype_for") from None


def torch_dtype_for(name: str) -> torch.dtype:
    """Resolve a stored dtype name (numpy's spelling) to a torch dtype."""
    if name in _TORCH_ONLY:
        return _TORCH_ONLY[name]
    return torch.from_numpy(np.zeros(0, np_dtype_for(name))).dtype


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``torch.float32`` ->
    ``float32``), as the JAX package writes it."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _is_storage(x) -> bool:
    """A ``BlockTriDiagStorage``, or the class itself (a template leaf)."""
    return isinstance(x, BlockTriDiagStorage) or x is BlockTriDiagStorage


def _children(tree):
    """The (key, child) pairs of an inner node in the JAX package's order,
    or None for a leaf."""
    from repro_torch.core.factor import CholFactor

    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), t) for i, t in enumerate(tree)]
    if _is_storage(tree):
        return [("0", getattr(tree, "diag", None)),
                ("1", getattr(tree, "off", None))]
    if isinstance(tree, CholFactor):
        return [("0", tree.data)]
    return None


def _flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the JAX package's order and spelling: dict
    keys sorted, ``a/b`` paths, the nodes of the module docstring; None
    has no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    out = []
    for key, sub in kids:
        for name, leaf in _flatten_with_names(sub):
            out.append((f"{key}/{name}" if name else key, leaf))
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _leaf_bytes(leaf) -> Tuple[np.ndarray, List[int], str]:
    """A leaf as (flat uint8 bytes, shape, dtype name)."""
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        leaf = np.asarray(leaf, np.int32)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return raw, list(t.shape), dtype_name(t.dtype)
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.view(np.uint8).reshape(-1), list(arr.shape), arr.dtype.name


def save(ckpt_dir, step: int, tree: Dict[str, Any], *, keep: int = 3,
         extra: Optional[dict] = None) -> Path:
    """Atomic save of a dict of named tensors at ``step``; prunes to the
    newest ``keep``.

    ``extra`` is a JSON-able dict persisted beside the leaf metadata and
    returned by ``read_meta``: the home for what the raw leaves lose (a
    fleet's backend, panel, precision, slot table).
    """
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    leaves = _flatten_with_names(tree)
    sharded = any(_is_dtensor(leaf) for _, leaf in leaves)
    if sharded:
        # Every rank takes part in the gathers; rank 0 writes.
        import torch.distributed as dist

        leaves = [(n, x.full_tensor() if _is_dtensor(x) else x)
                  for n, x in leaves]
        if dist.get_rank() != 0:
            dist.barrier()
            return final
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {}
    meta = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(leaves):
        key = f"a{i}"
        arrays[key], shape, dt = _leaf_bytes(leaf)
        meta["leaves"].append(
            {"name": name, "key": key, "shape": shape, "dtype": dt})
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "tree.json").write_text(json.dumps(meta))
    (tmp / "DONE").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _prune(ckpt_dir, keep)
    if sharded:
        import torch.distributed as dist

        dist.barrier()
    return final


def _prune(ckpt_dir: Path, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(Path(ckpt_dir) / f"step_{s:08d}", ignore_errors=True)


def all_steps(ckpt_dir) -> list:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        m = _STEP_RE.match(p.name)
        if m and (p / "DONE").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_meta(ckpt_dir, step: int) -> dict:
    """The committed checkpoint's metadata dict (leaf specs + ``extra``).
    Raises ``FileNotFoundError`` on an uncommitted or missing step."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    if not (path / "DONE").exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    return json.loads((path / "tree.json").read_text())


def _leaf_tensor(raw: np.ndarray, shape, name: str, device) -> torch.Tensor:
    """A stored leaf's bytes as a tensor of its dtype and shape."""
    t = torch.from_numpy(np.array(raw, dtype=np.uint8))
    return t.view(torch_dtype_for(name)).reshape(shape).to(device)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _copy_into(like: torch.Tensor, t: torch.Tensor, name: str):
    """The stored leaf ``t`` copied into the template's tensor ``like``
    (a ``DTensor`` keeps its mesh and placements)."""
    if tuple(like.shape) != tuple(t.shape) or like.dtype != t.dtype:
        raise ValueError(
            f"checkpoint leaf {name!r} is {t.dtype} {tuple(t.shape)}, the "
            f"template's tensor {like.dtype} {tuple(like.shape)}")
    if _is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        t = distribute_tensor(t.to(like.device_mesh.device_type),
                              like.device_mesh, list(like.placements))
    with torch.no_grad():
        like.copy_(t)
    return like


def _unflatten(like, by_name: Dict[str, torch.Tensor], device,
               prefix: str = ""):
    from repro_torch.core.factor import CholFactor

    if like is None:
        return None
    if isinstance(like, dict):
        return {key: _unflatten(like[key], by_name, device,
                                _join(prefix, key)) for key in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, by_name, device, _join(prefix, i))
                          for i, t in enumerate(like))
    if _is_storage(like):
        return BlockTriDiagStorage(
            _unflatten(getattr(like, "diag", torch.Tensor), by_name, device,
                       f"{prefix}/0"),
            _unflatten(getattr(like, "off", torch.Tensor), by_name, device,
                       f"{prefix}/1"))
    if isinstance(like, CholFactor):
        return dataclasses.replace(
            like, data=_unflatten(like.data, by_name, device,
                                  _join(prefix, 0)))
    if isinstance(like, int) and not isinstance(like, bool):
        return int(by_name[prefix])
    if isinstance(like, torch.Tensor):
        return _copy_into(like, by_name[prefix], prefix)
    return by_name[prefix].to(device)


def restore(ckpt_dir, step: int, like: Any, *, device=None,
            shardings=None) -> Any:
    """Restore into the structure of ``like``.

    Where ``like`` holds a tensor (a ``DTensor`` too), the stored leaf is
    copied into it, which must have the leaf's shape and dtype, and that
    tensor is returned: restoring into ``models.values_tree(model)`` loads
    the model in place. Any other leaf of ``like`` (a numpy array, the
    class ``torch.Tensor``) stands for a new tensor on ``device`` (default
    the CPU). A ``BlockTriDiagStorage`` (or the class itself) and a
    ``CholFactor`` (with ``like``'s metadata) come back where ``like``
    holds one, a Python int where ``like`` holds an int. With
    ``shardings`` (a tree of ``sharding.rules.NamedSharding`` over
    ``like``'s dicts) each leaf is then placed on its sharding's mesh: the
    elastic re-mesh happens here.
    """
    meta = read_meta(ckpt_dir, step)
    path = Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(path / "arrays.npz") as npz:
        by_name = {leaf["name"]: _leaf_tensor(npz[leaf["key"]],
                                              leaf["shape"], leaf["dtype"],
                                              "cpu")
                   for leaf in meta["leaves"]}
    names = [name for name, _ in _flatten_with_names(like)]
    missing = [n for n in names if n not in by_name]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
    out = _unflatten(like, by_name,
                     torch.device("cpu") if device is None else device)
    if shardings is not None:
        from repro_torch.runtime.fault_tolerance import elastic_reshard

        out = elastic_reshard(out, shardings)
    return out
