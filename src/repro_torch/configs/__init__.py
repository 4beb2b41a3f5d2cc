"""Model configurations of the port."""
from repro_torch.configs import drrl_paper
from repro_torch.configs.base import ModelConfig, RankConfig, TrainConfig

_ARCHS = {"drrl-paper": drrl_paper}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod = _ARCHS[name]
    return mod.reduced_config() if reduced else mod.full_config()


__all__ = ["ModelConfig", "RankConfig", "TrainConfig", "get_config"]
