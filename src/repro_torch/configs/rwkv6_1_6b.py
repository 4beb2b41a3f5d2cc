"""rwkv6-1.6b [rwkv]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch, data-dependent decay. Same values as ``repro/configs/rwkv6_1_6b.py``
(``remat`` included, which the rwkv family does not read, as in the
reference).

DR-RL is inapplicable here (no QK^T score matrix): the model runs without
the technique, as in the reference."""
from repro_torch.configs.base import ModelConfig, RankConfig, RWKVConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="rwkv",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=7168, vocab_size=65536, head_dim=64,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk_size=128),
        dtype="bfloat16", param_dtype="bfloat16",
        remat="dots",
        rank=RankConfig(mode="off"),
    )


def reduced_config() -> ModelConfig:
    return full_config().with_(
        remat="none",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        rwkv=RWKVConfig(head_dim=16, decay_lora=8, chunk_size=16),
        dtype="float32", param_dtype="float32", max_seq_len=128,
        rank=RankConfig(mode="off", rank_grid=(4, 8, 12, 16)),
    )
