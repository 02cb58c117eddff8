"""Config registry of the PyTorch port: the architectures the port
serves — MoE decoders, the dense GQA decoders, MiniCPM3-4B (MLA), the
Qwen2-VL decoder with its vision stub, DeepSeek-V2-Lite (MLA, a
leading dense layer, shared experts, YaRN), Mamba2, the Zamba2 hybrid and the
Whisper-large-v3 encoder-decoder with its audio stub (its
own copy of the JAX package's dataclasses, so the port never imports that
package)."""
from __future__ import annotations

from .base import ModelConfig, DualSparseConfig, InputShape, INPUT_SHAPES

from . import qwen3_moe_30b_a3b
from . import paper_models
from . import mamba2_370m
from . import zamba2_7b
from . import dbrx_132b
from . import qwen2_7b
from . import granite_20b
from . import starcoder2_3b
from . import qwen2_vl_7b
from . import minicpm3_4b
from . import whisper_large_v3
from . import deepseek_v2_lite

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.arch_id}")
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


for _mod in (qwen3_moe_30b_a3b, paper_models, mamba2_370m, zamba2_7b,
             dbrx_132b, qwen2_7b, granite_20b, starcoder2_3b, qwen2_vl_7b,
             minicpm3_4b, whisper_large_v3, deepseek_v2_lite):
    for _cfg in _mod.CONFIGS:
        register(_cfg)


# the ten architectures the system was assigned (the JAX package's list)
ASSIGNED_ARCHS = [
    "zamba2-7b", "granite-20b", "starcoder2-3b", "qwen3-moe-30b-a3b",
    "qwen2-vl-7b", "mamba2-370m", "dbrx-132b", "whisper-large-v3",
    "qwen2-7b", "minicpm3-4b",
]


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["ModelConfig", "DualSparseConfig", "InputShape", "INPUT_SHAPES",
           "ASSIGNED_ARCHS", "get_config", "list_archs", "register"]
