"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8: dense attention and the MoE FFN. Same
values as ``repro/configs/granite_moe_3b_a800m.py`` (``remat="dots"``
included, applied by ``models.common.remat_layer``)."""
from repro_torch.configs.base import MoEConfig, ModelConfig, RankConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        d_ff=512, vocab_size=49155, head_dim=64,
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
        rope_theta=1e4, dtype="bfloat16", param_dtype="bfloat16",
        remat="dots",
        rank=RankConfig(mode="off", rank_grid=(8, 16, 24, 32, 40, 48, 56, 64)),
    )


def reduced_config() -> ModelConfig:
    return full_config().with_(
        remat="none",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32,
                      capacity_factor=2.0),
        dtype="float32", param_dtype="float32", max_seq_len=128,
        rank=RankConfig(mode="off", rank_grid=(4, 8, 12, 16)),
    )
