"""Checkpoints of named tensors in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpoint import (
    all_steps,
    dtype_name,
    latest_step,
    np_dtype_for,
    read_meta,
    restore,
    save,
    torch_dtype_for,
)

__all__ = ["save", "restore", "latest_step", "all_steps", "read_meta",
           "np_dtype_for", "torch_dtype_for", "dtype_name"]
