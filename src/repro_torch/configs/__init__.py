"""Config registry of the port: ``get_config(arch_id[, reduced])`` for the
reference's architectures (``repro.configs._ARCH_MODULES``). An arch id
whose family the port does not run yet raises ``not_ported``."""
import importlib
from typing import Dict, Optional

from repro_torch import not_ported
from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig, RankConfig,
                                      TrainConfig)

# arch id -> the port's config module (None: its family is not ported yet)
_ARCH_MODULES: Dict[str, Optional[str]] = {
    "zamba2-7b": None,
    "seamless-m4t-medium": None,
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "rwkv6-1.6b": None,
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2-vl-7b": None,
    "drrl-paper": "repro_torch.configs.drrl_paper",
}

ARCH_IDS = tuple(k for k in _ARCH_MODULES if k != "drrl-paper")


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    module = _ARCH_MODULES[name]
    if module is None:
        raise not_ported(f"arch {name!r}", "item 18")
    mod = importlib.import_module(module)
    return mod.reduced_config() if reduced else mod.full_config()


__all__ = ["ARCH_IDS", "MLAConfig", "MoEConfig", "ModelConfig", "RankConfig",
           "TrainConfig", "get_config"]
