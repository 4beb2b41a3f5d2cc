"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 + shared attn blocks. Same values as
``repro/configs/zamba2_7b.py`` (``remat`` included, which the hybrid family
does not read, as in the reference).

Realised as 54 Mamba2 blocks + 27 shared-attention invocations (period 2),
total 81 'layers'; the shared block carries per-invocation LoRA adapters."""
from repro_torch.configs.base import ModelConfig, RankConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000, head_dim=112, hybrid_period=2,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=128),
        rope_theta=1e4, dtype="bfloat16", param_dtype="bfloat16",
        remat="dots",
        rank=RankConfig(mode="off"),
    )


def reduced_config() -> ModelConfig:
    return full_config().with_(
        remat="none",
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, hybrid_period=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk_size=16),
        dtype="float32", param_dtype="float32", max_seq_len=128,
        rank=RankConfig(mode="off", rank_grid=(4, 8, 12, 16)),
    )
