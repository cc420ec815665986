"""The LM zoo, PyTorch port: the families of the JAX package's ``models``
(dense, vlm, moe, rwkv, mamba_hybrid, encdec) and their losses in plain
torch operations, with no hand-written kernel of their own."""
from repro_torch.models.model import (
    decode_step,
    forward,
    init_cache,
    init_model,
    loss_fn,
    param_count,
    split_params,
    values_tree,
)

__all__ = [
    "init_model",
    "split_params",
    "forward",
    "loss_fn",
    "values_tree",
    "init_cache",
    "decode_step",
    "param_count",
]
