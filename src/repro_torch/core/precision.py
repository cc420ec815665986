"""Precision policy: storage dtype vs accumulation dtype (DESIGN.md §8).

Port of ``repro.core.precision`` with torch dtypes. The modification is
bandwidth-bound, so the bytes each stored L-tile occupies dominate the cost
of an update; the numerically sensitive part (the diagonal recurrence
divides by the running diagonal every row) stays in the accumulation dtype.

* ``storage`` — the dtype L-tiles and the running ``V^T`` are stored in
  between chain steps. ``None`` keeps whatever dtype the inputs have.
* ``accum``   — the dtype every computation runs in: the recurrence, the
  rotations ``(c, s)``, the transform ``T`` and GEMM accumulation. Always
  at least fp32 and at least as wide as ``storage``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

PrecisionLike = Union[None, str, "Precision", Any]

# Named presets: the same spellings as the JAX package.
_PRESETS = {
    "float32": ("float32", "float32"),
    "f32": ("float32", "float32"),
    "fp32": ("float32", "float32"),
    "bfloat16": ("bfloat16", "float32"),
    "bf16": ("bfloat16", "float32"),
    "float64": ("float64", "float64"),
    "f64": ("float64", "float64"),
    "highest": (None, "float64"),
}


def as_dtype(spec) -> torch.dtype:
    """A torch floating dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(spec, torch.dtype):
        dt = spec
    else:
        name = getattr(spec, "name", None) or str(spec)
        name = name.replace("torch.", "")
        dt = getattr(torch, name, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"not a dtype: {spec!r}")
    if not dt.is_floating_point:
        raise ValueError(f"precision dtypes must be floating, got {dt}")
    return dt


@dataclasses.dataclass(frozen=True)
class Precision:
    """Storage/accumulation dtype split for the rank-k modification.

    Attributes:
      storage: dtype the factor tiles and ``V^T`` are stored in between
        chain steps (None = keep the input dtype untouched).
      accum: dtype the recurrence/rotations/GEMMs compute in; at least as
        wide as ``storage`` and at least fp32.
    """

    storage: Optional[torch.dtype] = None
    accum: torch.dtype = torch.float32

    def __post_init__(self):
        storage = None if self.storage is None else as_dtype(self.storage)
        accum = as_dtype(self.accum)
        if accum.itemsize < torch.float32.itemsize:
            raise ValueError(
                f"accum dtype must be at least float32, got {accum} — the "
                "diagonal recurrence divides by the running diagonal and is "
                "not stable in 16-bit arithmetic")
        if storage is not None and storage.itemsize > accum.itemsize:
            raise ValueError(
                f"storage dtype {storage} is wider than accum dtype {accum}; "
                "the policy is storage <= accum")
        object.__setattr__(self, "storage", storage)
        object.__setattr__(self, "accum", accum)

    @classmethod
    def parse(cls, spec: PrecisionLike) -> Optional["Precision"]:
        """Canonicalise a user spec: None | preset str | dtype | Precision.

        A bare dtype means "store in this dtype, accumulate in fp32 or
        wider".
        """
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, str) and spec.lower() in _PRESETS:
            storage, accum = _PRESETS[spec.lower()]
            return cls(storage=storage, accum=accum)
        storage = as_dtype(spec)
        return cls(storage=storage,
                   accum=torch.promote_types(storage, torch.float32))

    def storage_for(self, dtype) -> torch.dtype:
        """The dtype an input of ``dtype`` is stored as under this policy."""
        return as_dtype(dtype) if self.storage is None else self.storage

    def cast_storage(self, x):
        """Cast a tensor to the policy's storage dtype (no-op if None)."""
        return x if self.storage is None else x.to(self.storage)

    def up(self, x):
        """Upcast into the accumulation dtype (compute happens here)."""
        return x.to(self.accum)

    def down(self, x, like=None):
        """Downcast a computed value back to storage (or ``like``'s dtype)."""
        target = like.dtype if like is not None else self.storage
        return x if target is None else x.to(target)

    def bytes_per_element(self, input_dtype) -> int:
        """Stored bytes per L element — the bandwidth-bound quantity."""
        return int(self.storage_for(input_dtype).itemsize)

    def __repr__(self):
        st = "input" if self.storage is None else str(self.storage)
        return f"Precision(storage={st}, accum={self.accum})"
