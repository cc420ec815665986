"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block.

81L d_model=3584 (Mamba2, ssm_state=64) with one *shared* attention+MLP
block (32H MHA kv=32, head_dim=112, d_ff=14336) applied every 6 layers.
[arXiv:2411.15242; unverified]
Deviation noted (DESIGN.md): the shared attention carries a 4096 SWA window
so the 500k-token decode state stays O(window) — serving-oriented choice.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="mamba_hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=112, window=4096),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    shared_attn_every=6,
    activation="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
