"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544, GQA. Same values as ``repro/configs/internlm2_20b.py``
(``remat="dots"`` included, applied by ``models.common.remat_layer``)."""
from repro_torch.configs.base import ModelConfig, RankConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=92544, head_dim=128,
        rope_theta=1e6, dtype="bfloat16", param_dtype="bfloat16",
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
