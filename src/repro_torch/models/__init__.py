"""The LM zoo, PyTorch port: the decoder-only families of the JAX
package's ``models`` (dense, vlm, moe, rwkv, mamba_hybrid) in plain torch
operations, with no hand-written kernel of their own."""
from repro_torch.models.model import (
    decode_step,
    forward,
    init_cache,
    init_model,
    param_count,
    split_params,
)

__all__ = [
    "init_model",
    "split_params",
    "forward",
    "init_cache",
    "decode_step",
    "param_count",
]
