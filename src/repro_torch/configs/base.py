"""Model / run configuration dataclasses, PyTorch port.

A copy of the JAX package's ``configs/base.py``, field for field, so that
a config object of either package describes the same model. The XLA-only
knobs (``scan_layers``, ``pin_batch``, ``fsdp``, ``remat``, ``loss_chunk``)
stay as data: the port's serving path reads none of them.

One ``ModelConfig`` describes any of the ten assigned architectures; family-
specific knobs live in optional sub-configs. ``reduced()`` returns the scaled-
down smoke variant each architecture's CPU test instantiates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    window: Optional[int] = None          # sliding-window attention (SWA)
    softcap: Optional[float] = None       # attention logit soft-capping
    local_global_period: int = 0          # >0: alternate local/global layers
    rope_theta: float = 10_000.0
    qk_norm: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    expert_d_ff: int = 0                  # 0 -> use model d_ff
    dense_residual: bool = False          # arctic: parallel dense FFN
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time-mix parameters."""
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                           # dense | moe | rwkv | mamba_hybrid | encdec | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    enc_layers: int = 0                   # encoder-decoder only
    shared_attn_every: int = 0            # zamba2: shared attn block period
    activation: str = "swiglu"            # swiglu | geglu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    post_norm: bool = False               # gemma2 sandwich norms
    logit_softcap: Optional[float] = None
    embed_scale: bool = False             # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    max_seq_len: int = 8192
    # Modality frontend stubs (DESIGN.md §6): fraction of the sequence whose
    # embeddings are supplied pre-computed by input_specs().
    frontend: Optional[str] = None        # None | 'vision' | 'audio'
    frontend_frac: float = 0.125
    # Numerics / distribution knobs.
    loss_chunk: int = 1024                # tokens per vocab-projection chunk
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    # scan_layers=False fully unrolls the layer loop: bigger HLO, but XLA's
    # cost_analysis does not multiply while-loop bodies by trip count, so
    # the roofline extraction lowers an unrolled variant.
    scan_layers: bool = True
    # Pin the residual stream to the batch axes at layer boundaries
    # (EXPERIMENTS.md §Perf A3). Off for mixtral: its 8-expert scatter
    # dispatch prefers XLA's own layout (cell D iterations).
    pin_batch: bool = True
    fsdp: bool = False                    # shard params over the data axes too
    remat: bool = True

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE

    @property
    def sub_quadratic(self) -> bool:
        """True iff a 500k-token decode state is bounded (SSM or windowed)."""
        if self.family in ("rwkv", "mamba_hybrid"):
            return True
        return bool(self.attn and self.attn.window and self.attn.local_global_period == 0)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        attn = self.attn
        if attn is not None:
            attn = dataclasses.replace(
                attn,
                num_heads=max(2, min(4, attn.num_heads)),
                num_kv_heads=max(1, min(2, attn.num_kv_heads)),
                head_dim=16,
                window=64 if attn.window else None,
                local_global_period=attn.local_global_period and 2,
            )
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(moe, num_experts=4, expert_d_ff=64)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, state_dim=8, head_dim=8)
        rwkv = self.rwkv
        if rwkv is not None:
            rwkv = dataclasses.replace(rwkv, head_dim=8, decay_lora=8, mix_lora=8)
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 4),
            enc_layers=min(self.enc_layers, 2),
            d_model=64,
            d_ff=128,
            vocab_size=512,
            attn=attn,
            moe=moe,
            ssm=ssm,
            rwkv=rwkv,
            shared_attn_every=2 if self.shared_attn_every else 0,
            max_seq_len=128,
            param_dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch x input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
