"""seamless-m4t-medium [encdec]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal. Same values as
``repro/configs/seamless_m4t_medium.py`` (``remat`` included, which the
encdec family does not read, as in the reference).

The audio frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings (b, src_len, d_model) to the 12L encoder; the
12L text decoder attends over the encoder memory."""
from repro_torch.configs.base import ModelConfig, RankConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        num_layers=12, num_encoder_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=256206, head_dim=64,
        frontend_positions=1024,      # audio frames seen by the encoder
        rope_theta=1e4, dtype="bfloat16", param_dtype="bfloat16",
        remat="dots",
        rank=RankConfig(mode="off"),
    )


def reduced_config() -> ModelConfig:
    return full_config().with_(
        remat="none",
        num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        frontend_positions=16,
        dtype="float32", param_dtype="float32", max_seq_len=128,
        rank=RankConfig(mode="off", rank_grid=(4, 8, 12, 16)),
    )
