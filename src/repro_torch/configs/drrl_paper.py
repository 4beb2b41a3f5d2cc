"""The paper's own experimental config: a GPT-small-scale decoder
(r_min=16, r_max=64). Same values as ``repro/configs/drrl_paper.py``."""
from repro_torch.configs.base import ModelConfig, RankConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="drrl-paper", family="dense",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=50257, head_dim=64,
        rope_theta=1e4, dtype="float32", param_dtype="float32",
        sharding="dp",
        rank=RankConfig(mode="drrl", rank_grid=(16, 24, 32, 40, 48, 56, 64),
                        fixed_rank=32, segment_len=512),
    )


def reduced_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=128,
        rank=RankConfig(mode="drrl", rank_grid=(4, 8, 12, 16), fixed_rank=8,
                        segment_len=32),
    )
