"""pixtral-12b [vlm]: Pixtral-ViT frontend (STUB) + mistral-nemo backbone.

40L d_model=5120 32H (GQA kv=8, head_dim=128 per hf config) d_ff=14336
vocab=131072. [hf:mistralai/Pixtral-12B-2409; unverified]
The vision tower is a stub: input_specs() supplies pre-computed patch
embeddings for the leading ``frontend_frac`` of the sequence.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131072,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0),
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    frontend="vision",
    frontend_frac=0.125,
    fsdp=True,
)
