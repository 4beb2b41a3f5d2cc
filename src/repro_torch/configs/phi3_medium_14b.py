"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE SwiGLU GQA. Same values as
``repro/configs/phi3_medium_14b.py`` (``remat="dots"`` included, applied by
``models.common.remat_layer``)."""
from repro_torch.configs.base import ModelConfig, RankConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
        d_ff=17920, vocab_size=100352, head_dim=128,
        rope_theta=1e4, dtype="bfloat16", param_dtype="bfloat16",
        remat="dots",
        rank=RankConfig(mode="off"),
    )


def reduced_config() -> ModelConfig:
    return full_config().with_(
        remat="none",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
        max_seq_len=128,
        rank=RankConfig(mode="off", rank_grid=(4, 8, 12, 16)),
    )
