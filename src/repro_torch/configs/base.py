"""Config dataclasses of the port: its own copies of the fields of
``repro.configs.base.ModelConfig`` / ``RankConfig`` / ``MoEConfig`` /
``MLAConfig`` / ``SSMConfig`` / ``RWKVConfig`` that the port's model
families and its sharding rules read, and of ``TrainConfig``, with the
same names and defaults. ``remat`` (none | full | dots) is read by
``forward_dense`` and ``forward_deepseek``'s MoE stack, as in the
reference (``models.common.remat_layer``); ``scan_layers``, ``seq_shard``
and ``seq_shard_attn`` are not ported (ROADMAP item 19)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # ffn hidden size per expert
    num_shared_experts: int = 0
    d_shared: int = 0              # ffn hidden of the shared expert(s)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001  # load-balancing loss coefficient


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) dims."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64           # rank of the data-dependent decay LoRA
    token_shift: bool = True
    chunk_size: int = 128


@dataclass(frozen=True)
class RankConfig:
    """DR-RL dynamic low-rank attention configuration.

    mode: 'off' (full rank), 'fixed' (``fixed_rank``), 'adaptive' (NER
    energy threshold, median over heads, snapped to the grid), 'drrl' (the
    agent's policy under the Eq. 9-11 guardrail) and, in serving, 'learned'
    (the same inference path with offline-trained params); the mode
    'random' is not ported yet."""
    mode: str = "off"
    realisation: str = "masked"
    rank_grid: Tuple[int, ...] = (16, 24, 32, 40, 48, 56, 64)
    fixed_rank: int = 32
    energy_threshold: float = 0.90     # Adaptive-SVD NER target
    static_rank: Optional[int] = None
    truncate_values: bool = False
    segment_len: int = 512             # segment-level adaptation period T
    # perturbation guardrail (Eq. 9-11)
    guardrail: bool = True
    epsilon0: float = 1.0
    anneal_lambda: float = 1e-3
    # reward (Eq. 13)
    alpha: float = 1.0
    beta: float = 0.3
    gamma: float = 0.1
    power_iters: int = 3


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 32768
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rank: RankConfig = field(default_factory=RankConfig)
    # encoder-decoder
    num_encoder_layers: int = 0
    # hybrid (zamba2): how many ssm blocks between shared-attention calls
    hybrid_period: int = 2
    # dense layers at the bottom of a MoE stack (deepseek-v3: 3)
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    # multi-token prediction depth (deepseek-v3 MTP)
    mtp_depth: int = 0
    # vlm / audio frontend stub: number of modality-embedding positions
    frontend_positions: int = 0
    mrope: bool = False            # qwen2-vl M-RoPE (3 position streams)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    dtype: str = "float32"         # activation/compute dtype
    param_dtype: str = "float32"
    # distribution (repro_torch.dist), in the reference's field order:
    remat: str = "none"            # none | full | dots (models.common.remat_layer)
    # sharding mode: 'dp' (replicated params), 'tp' (megatron), 'fsdp'
    # (params sharded over data too), 'fsdp_tp'
    sharding: str = "fsdp_tp"
    softmax_dtype: str = "float32"
    mesh_axes: Tuple[str, ...] = ()  # ambient mesh axes that dist.ctx's specs name
    cache_seq_shard: bool = False    # split-KV decode: cache M over 'model'

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head): the
        reference's formula, its crude splits included (the rwkv count is
        the 'rwkv6-ish' time-mix + channel-mix estimate; the hybrid count
        has the ssm blocks and one shared attention block, no LoRA)."""
        d, h = self.d_model, self.resolved_head_dim()
        nq, nkv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "vlm", "hybrid", "encdec"):
            per_layer = d * h * (nq + 2 * nkv) + nq * h * d + 3 * d * self.d_ff + 2 * d
        if self.family == "moe":
            if self.mla is not None:
                m = self.mla
                attn = (d * m.q_lora_rank
                        + m.q_lora_rank * nq * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                        + nq * m.v_head_dim * d)
            else:
                attn = d * h * (nq + 2 * nkv) + nq * h * d
            moe = self.moe
            expert = 3 * d * moe.d_expert
            shared = 3 * d * moe.d_shared * moe.num_shared_experts
            router = d * moe.num_experts
            per_layer = attn + moe.num_experts * expert + shared + router + 2 * d
        if self.family in ("ssm", "rwkv"):
            per_layer = 5 * d * d + 2 * d * self.d_ff + self.d_ff * d + 2 * d
        total = emb + self.num_layers * per_layer
        if self.family == "hybrid":
            d_in = self.ssm.expand * d
            ssm_layer = (2 * d * d_in + d_in * d
                         + 2 * self.ssm.n_groups * self.ssm.d_state * d)
            n_ssm = self.num_layers - self.num_layers // (self.hybrid_period + 1)
            shared = d * h * (nq + 2 * nkv) + nq * h * d + 3 * d * self.d_ff
            total = emb + n_ssm * ssm_layer + shared
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe" or self.moe is None:
            return self.n_params()
        moe = self.moe
        expert = 3 * self.d_model * moe.d_expert
        inactive = (moe.num_experts - moe.top_k) * expert * (
            self.num_layers - self.first_dense_layers)
        return self.n_params() - inactive


@dataclass(frozen=True)
class TrainConfig:
    """``repro.configs.base.TrainConfig``, field for field with its
    defaults: the batch and sequence the LM trainer draws, the optimiser
    and schedule (:mod:`repro_torch.optim`), gradient accumulation and its
    compression, the seed, checkpointing and logging
    (:mod:`repro_torch.train.loop`)."""
    global_batch: int = 32
    seq_len: int = 1024
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    schedule: str = "cosine"        # linear | cosine | constant
    microbatches: int = 1           # gradient accumulation
    grad_compression: str = "none"  # none | bf16
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    log_every: int = 10


# ---------------------------------------------------------------------------
# The assigned input-shape cells (seq_len, global_batch, kind) of the dry run
# (``repro.configs.base``'s, value for value)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

# archs allowed to run the long_500k cell (sub-quadratic sequence mixing)
LONG_CONTEXT_ARCHS = ("zamba2-7b", "rwkv6-1.6b")
