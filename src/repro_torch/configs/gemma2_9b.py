"""gemma2-9b [dense]: local/global alternating attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8, head_dim=256) d_ff=14336 vocab=256000.
Local window 4096 on every other layer, attn softcap 50, final softcap 30,
GeGLU, sandwich (pre+post) norms. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    attn=AttnConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                    window=4096, softcap=50.0, local_global_period=2),
    activation="geglu",
    norm="rmsnorm",
    post_norm=True,
    logit_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
)
