"""Architecture registry, PyTorch port: the ten assigned configs + shape
cells, copies of the JAX package's."""
from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    AttnConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeCell,
    SSMConfig,
)

from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.granite_20b import CONFIG as _granite
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _h2o
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.llama3_2_3b import CONFIG as _llama32
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

ARCHS = {
    c.name: c
    for c in [
        _pixtral,
        _seamless,
        _rwkv6,
        _granite,
        _h2o,
        _gemma2,
        _llama32,
        _mixtral,
        _arctic,
        _zamba2,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cells():
    """All runnable (arch, shape) cells; long_500k only for sub-quadratic."""
    out = []
    for name, cfg in ARCHS.items():
        for shape in SHAPES:
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                continue
            out.append((name, shape.name))
    return out


__all__ = [
    "ARCHS",
    "get_config",
    "cells",
    "SHAPES",
    "SHAPES_BY_NAME",
    "ModelConfig",
    "AttnConfig",
    "MoEConfig",
    "SSMConfig",
    "RWKVConfig",
    "ShapeCell",
]
