"""Checkpointing of named tensors: atomic on-disk saves, resume.

Port of ``repro.checkpoint.checkpoint`` with the same on-disk format, so
each package reads the other's checkpoints. One directory per step
(``step_00000123/``) holding

* ``tree.json``  — per-leaf metadata (name, key, shape, dtype name) and the
  caller's ``extra`` dict,
* ``arrays.npz`` — every leaf as raw bytes (a flat uint8 array),
* ``DONE``       — commit marker written last (readers ignore directories
  without it; a crash mid-write leaves no valid-looking junk).

A dict of named tensors takes the pytree's place. Leaves are torch tensors
(any device; gathered to the host), numpy arrays, or a
``BlockTriDiagStorage``, whose two block stacks are stored under the leaf
names the JAX package gives them (``<name>/0`` for ``diag``, ``<name>/1``
for ``off``). Dtype names are numpy's (``float32``, ``float64``,
``bfloat16``): bfloat16 leaves are written and read by viewing their bytes
as a torch tensor, so neither side needs ``ml_dtypes`` here.
"""
from __future__ import annotations

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


def _flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the JAX package's order and spelling: dict
    keys sorted, ``a/b`` paths, a ``BlockTriDiagStorage`` as its two
    children ``0`` (diag) and ``1`` (off)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            for name, leaf in _flatten_with_names(tree[key]):
                out.append((f"{key}/{name}" if name else str(key), leaf))
        return out
    if _is_storage(tree):
        return [("0", getattr(tree, "diag", None)),
                ("1", getattr(tree, "off", None))]
    return [("", tree)]


def _leaf_bytes(leaf) -> Tuple[np.ndarray, List[int], str]:
    """A leaf as (flat uint8 bytes, shape, dtype name)."""
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
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {}
    meta = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
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
    t = torch.from_numpy(np.array(raw, dtype=np.uint8))
    return t.view(torch_dtype_for(name)).reshape(shape).to(device)


def _unflatten(like, by_name: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(like, dict):
        return {key: _unflatten(
            like[key], by_name, f"{prefix}/{key}" if prefix else str(key))
            for key in like}
    if _is_storage(like):
        return BlockTriDiagStorage(by_name[f"{prefix}/0"],
                                   by_name[f"{prefix}/1"])
    return by_name[prefix]


def restore(ckpt_dir, step: int, like: Dict[str, Any], *,
            device=None) -> Dict[str, Any]:
    """Restore into the structure of ``like`` (values ignored): tensors on
    ``device`` (default the CPU), a ``BlockTriDiagStorage`` where ``like``
    holds one (or the class itself)."""
    meta = read_meta(ckpt_dir, step)
    path = Path(ckpt_dir) / f"step_{step:08d}"
    dev = torch.device("cpu") if device is None else torch.device(device)
    with np.load(path / "arrays.npz") as npz:
        by_name = {leaf["name"]: _leaf_tensor(npz[leaf["key"]],
                                              leaf["shape"], leaf["dtype"],
                                              dev)
                   for leaf in meta["leaves"]}
    names = [name for name, _ in _flatten_with_names(like)]
    missing = [n for n in names if n not in by_name]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
    return _unflatten(like, by_name)
