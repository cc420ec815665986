"""arctic-480b [moe]: 128 experts top-2 + dense residual.

35L d_model=7168 56H (GQA kv=8, head_dim=128) expert d_ff=4864 vocab=32000.
[hf:Snowflake/snowflake-arctic-base; hf]
56 q-heads do not divide the 16-way TP axis -> head axes auto-replicate
(DESIGN.md §7); experts shard 128/16 = 8 per device (EP). FSDP + bf16
optimizer state keep the 480B configuration within per-device HBM.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    d_ff=4864,
    vocab_size=32000,
    attn=AttnConfig(num_heads=56, num_kv_heads=8, head_dim=128),
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                  dense_residual=True),
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    fsdp=True,
    opt_state_dtype="bfloat16",
)
