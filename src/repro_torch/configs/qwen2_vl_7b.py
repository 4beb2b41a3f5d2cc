"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution. Same values as
``repro/configs/qwen2_vl_7b.py`` (``remat="dots"`` included, applied by
``models.common.remat_layer``).

The vision frontend is a stub, as in the reference: the caller supplies
precomputed patch embeddings (b, n_patches, d_model) prepended to the text
tokens; positions are the 3-stream (t, h, w) M-RoPE ids."""
from repro_torch.configs.base import ModelConfig, RankConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
        rope_theta=1e6, mrope=True, mrope_sections=(16, 24, 24),
        frontend_positions=256,
        dtype="bfloat16", param_dtype="bfloat16",
        remat="dots",
        rank=RankConfig(mode="off"),
    )


def reduced_config() -> ModelConfig:
    return full_config().with_(
        remat="none",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, frontend_positions=8,
        mrope_sections=(2, 3, 3),
        dtype="float32", param_dtype="float32", max_seq_len=128,
        rank=RankConfig(mode="off", rank_grid=(4, 8, 12, 16)),
    )
