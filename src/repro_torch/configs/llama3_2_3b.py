"""llama3.2-3b [dense]: small llama3.

28L d_model=3072 24H (GQA kv=8, head_dim=128) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]
Note: 24 q-heads do not divide the 16-way TP axis; the sharding rules
auto-replicate the head axes (DESIGN.md §7) — a recorded hillclimb target.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    d_ff=8192,
    vocab_size=128256,
    attn=AttnConfig(num_heads=24, num_kv_heads=8, head_dim=128,
                    rope_theta=500_000.0),
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
