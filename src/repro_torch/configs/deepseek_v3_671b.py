"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MLA, 1 shared + 256 routed top-8, MTP.

First 3 layers dense (d_ff 18432); MoE layers 1 shared + 256 routed experts
(top-8); MLA q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128. Same
values as ``repro/configs/deepseek_v3_671b.py`` (``remat="full"`` included,
applied to the MoE stack by ``models.common.remat_layer``)."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, RankConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=2048, vocab_size=129280,
        moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                      num_shared_experts=1, d_shared=2048),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        first_dense_layers=3, dense_d_ff=18432, mtp_depth=1,
        rope_theta=1e4, dtype="bfloat16", param_dtype="bfloat16",
        remat="full",
        rank=RankConfig(mode="off"),
    )


def reduced_config() -> ModelConfig:
    return full_config().with_(
        remat="none",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32,
                      num_shared_experts=1, d_shared=32, capacity_factor=2.0),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        first_dense_layers=1, dense_d_ff=128, mtp_depth=1,
        dtype="float32", param_dtype="float32", max_seq_len=128,
        rank=RankConfig(mode="off", rank_grid=(4, 8, 12, 16)),
    )
