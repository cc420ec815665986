"""mixtral-8x22b [moe]: 8 experts top-2, SWA.

56L d_model=6144 48H (GQA kv=8, head_dim=128) expert d_ff=16384 vocab=32768.
[arXiv:2401.04088; hf]
8 experts do not divide the 16-way TP axis -> the rules shard expert_mlp
(TP-within-expert) instead of the expert axis.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    d_ff=16384,
    vocab_size=32768,
    attn=AttnConfig(num_heads=48, num_kv_heads=8, head_dim=128, window=4096),
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=16384),
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    fsdp=True,
    pin_batch=False,  # §Perf cell D: scatter dispatch prefers XLA's layout
)
