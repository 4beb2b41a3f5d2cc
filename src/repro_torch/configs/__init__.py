"""Config registry of the port: ``get_config(arch_id[, reduced])`` for every
architecture of the reference (``repro.configs._ARCH_MODULES``)."""
import importlib
from typing import Dict

from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPE_CELLS, MLAConfig,
                                      MoEConfig, ModelConfig, RankConfig, RWKVConfig,
                                      ShapeCell, SSMConfig, TrainConfig)

# arch id -> the port's config module
_ARCH_MODULES: Dict[str, str] = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "drrl-paper": "repro_torch.configs.drrl_paper",
}

ARCH_IDS = tuple(k for k in _ARCH_MODULES if k != "drrl-paper")


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.reduced_config() if reduced else mod.full_config()


def cells_for(arch: str):
    """The assigned shape cells this arch runs: ``long_500k`` only for the
    sub-quadratic mixers (``LONG_CONTEXT_ARCHS``)."""
    return [cell for cell in SHAPE_CELLS
            if cell.name != "long_500k" or arch in LONG_CONTEXT_ARCHS]


__all__ = ["ARCH_IDS", "LONG_CONTEXT_ARCHS", "MLAConfig", "MoEConfig", "ModelConfig",
           "RankConfig", "RWKVConfig", "SHAPE_CELLS", "SSMConfig", "ShapeCell",
           "TrainConfig", "cells_for", "get_config"]
